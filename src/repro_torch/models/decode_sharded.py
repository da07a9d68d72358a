"""Decode attention on a mesh of ranks (the reference's
``models/decode_sharded.py``): the sequence-sharded contiguous cache with
its stat merge, and the paged cache's data- and model-axis paths.

Sequence-sharded cache (``decode_attention_update_sharded``): each model
rank holds a contiguous ``S / n_model`` slice of every slot's K/V (the
slice ``runtime.sharding.cache_pspecs`` assigns it); the new token's K/V
is written by the rank owning its position, each rank attends over its
slice producing an *unnormalised* accumulator and online-softmax row
statistics (m, l), and the ranks merge with one all-gather of (acc, m, l)
-- O(B x H x D) bytes a layer instead of the cache (tree attention).

Paged cache under a mesh (``paged_decode_attention_sharded``): a rank
holds its batch shard's pool rows and cold slots
(``kvcache.paged.PagedKVCache(shard=...)``) and runs the step on that
shard's slots only, so with no model axis its program is the one-device
paged decode on its rows (bit-identical outputs): global page ids become
local rows, a write whose page lies outside the shard is parked
(``page_write(park=...)``), the shard's cold pool is decoded where it lies
(``kvcache.kernels.decode_pages_sharded``, B3 on the card).  A model axis
splits each slot's logical pages round-robin (page ``p`` to model rank
``p % n_model``): every model rank of a data group holds the same local
pool and writes the same new K/V, gathers only its page columns, attends
with a per-position validity mask, and the ranks merge (acc, m, l).

``paged_prefill_chunk_sharded`` runs one slot's prefill chunk on the ranks
of the slot's batch shard, which hold all its pages; the other ranks skip
the chunk (``models.model._chunk_stack``), and nothing is summed across
ranks: the engine hands the first token to every rank.

The stat merge is plain PyTorch, as the reference's is jnp outside any
kernel; the page decode and the attention inside go through the port's
usual paths.
"""
from __future__ import annotations

import torch

from ..kvcache import kernels as kv_kernels
from ..kvcache import paged as paged_kv
from ..kvcache.codec import dtype_name
from ..runtime.collectives import gather_rows
from ..runtime.sharding import axis_size, batch_index, n_batch_shards
from .flash_attention import _gqa_combine, _gqa_scores, scale_in_dtype

F32 = torch.float32
NEG = -1e30


def _local_attend_stats(q, k, v, kv_len_local, softcap: float):
    """One-token attention over the local cache slice, unnormalised.

    q: (B, Hq, 1, D); k / v: (B, Hkv, S_loc, D); ``kv_len_local`` a count
    (int or 0-d tensor) -> (acc (B, Hq, 1, D) f32, m (B, Hq, 1) f32,
    l (B, Hq, 1) f32)."""
    D = q.shape[-1]
    s = _gqa_scores(scale_in_dtype(q, D ** -0.5), k)   # (B, Hq, 1, S_loc)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    ok = (torch.arange(k.shape[2], device=q.device) < kv_len_local)[
        None, None, None, :]
    s = torch.where(ok, s, NEG)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = _gqa_combine(p.to(v.dtype), v)               # f32 accumulate
    return acc, m, l


def _merge_stats(acc, m, l, mesh, axis: str = "model"):
    """The flash-attention merge of the ranks' softmax statistics along
    ``axis``: one all-gather of (acc, m, l), then the combine.  A rank with
    no valid position carries m == NEG and weighs exp(NEG - m_g) == 0.
    Every rank computes the same sums in the same order, so the merged
    output is the same bits on each."""
    acc_all = gather_rows(acc, mesh, axis)             # (n, B, Hq, 1, D)
    m_all = gather_rows(m, mesh, axis)                 # (n, B, Hq, 1)
    l_all = gather_rows(l, mesh, axis)
    m_g = m_all.amax(dim=0)
    w = torch.exp(m_all - m_g[None])
    denom = (l_all * w).sum(dim=0)
    num = (acc_all * w[..., None]).sum(dim=0)
    return num / torch.clamp(denom, min=1e-30)[..., None]


def _attend_stats_masked(q, k, v, valid, softcap: float):
    """One-token attention over a gathered history with a per-position
    validity mask, unnormalised.

    q: (B, Hq, 1, D); k / v: (B, Hkv, S, D); valid: (B, S) bool -> (acc,
    m, l) as :func:`_local_attend_stats`."""
    D = q.shape[-1]
    s = _gqa_scores(scale_in_dtype(q, D ** -0.5), k).to(F32)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, NEG)
    m = s.amax(dim=-1)
    p = torch.where(vm, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = _gqa_combine(p.to(v.dtype), v).to(F32)
    return acc, m, l


def _decode_attention_update_sharded(q, k_cache, v_cache, new_k, new_v,
                                     vlen, slot, mesh, *,
                                     softcap: float = 0.0):
    """Sequence-sharded decode: cache update + attention + merge.

    q / new_k / new_v: (B, H*, 1, D); ``k_cache`` / ``v_cache`` this model
    rank's (B, Hkv, S / n_model, D) slice, written in place; ``vlen`` the
    count of valid positions after the update and ``slot`` the global write
    position (ints or 0-d tensors; ``cur_len % W`` and ``min(cur_len + 1,
    W)`` for a ring) -> o (B, Hq, 1, D) in the cache's dtype."""
    s_loc = k_cache.shape[2]
    lo = mesh.get_local_rank("model") * s_loc
    slot = torch.as_tensor(slot, device=q.device)
    slot_l = (slot - lo).clamp(0, s_loc - 1).long()
    owned = (slot >= lo) & (slot < lo + s_loc)
    # the write position stays on the device: indexing with the 0-d
    # tensor would read it back to the host (and cannot on a fake one)
    idx = slot_l.reshape(1)
    for cache, new in ((k_cache, new_k), (v_cache, new_v)):
        cur = cache.index_select(2, idx)
        cache.index_copy_(2, idx, torch.where(owned, new.to(cache.dtype),
                                              cur))
    kv_len_local = (torch.as_tensor(vlen, device=q.device) - lo).clamp(
        0, s_loc)
    acc, m, l = _local_attend_stats(q, k_cache, v_cache, kv_len_local,
                                    softcap)
    return _merge_stats(acc, m, l, mesh).to(v_cache.dtype)


def _paged_shardable(page_table, cur_len, mesh) -> bool:
    """Whether a paged decode step takes :func:`paged_decode_attention_
    sharded`: per-slot timelines, a mesh axis of size > 1, and a batch that
    the batch shards divide (the ``PagedKVCache(n_shards=...)`` layout
    guarantees it)."""
    if mesh is None or page_table is None or cur_len.ndim != 1:
        return False
    n_ba, n_model = n_batch_shards(mesh), axis_size(mesh, "model")
    if n_ba == 1 and n_model == 1:
        return False
    return page_table.shape[0] % n_ba == 0


def _chunk_shardable(mesh) -> bool:
    """Whether a prefill chunk takes :func:`paged_prefill_chunk_sharded`: a
    mesh with batch shards.  A model-axis-only mesh returns False; the
    engine gates chunked prefill off there."""
    return n_batch_shards(mesh) > 1


def _local_ids(pools, ids, mesh):
    """Global page ids of this rank's shard -> (virtual local ids for the
    gather, write rows with other shards' pages parked, the park row, the
    decoded cold pool or None).  Local raw pages sit at rows ``[0,
    L_loc)``, the park row at ``L_loc`` (a sharded rank's pool has one),
    the local cold slots after the pool's rows."""
    k_pool, _, k_cold, _ = pools
    n_ba = n_batch_shards(mesh)
    rows = k_pool.shape[0]
    L_loc = rows - 1 if n_ba > 1 else rows
    d = batch_index(mesh)
    n_pool = L_loc * n_ba
    c_loc = k_cold[0].shape[0] if k_cold is not None else 0
    lo, cold_lo = d * L_loc, d * c_loc
    ids = ids.long()
    raw_loc = ids - lo
    loc = torch.where(ids >= n_pool, rows + (ids - n_pool - cold_lo), raw_loc)
    wrow = torch.where((ids >= lo) & (ids < lo + L_loc), raw_loc, rows)
    park = L_loc if n_ba > 1 else paged_kv.GARBAGE_PAGE
    return loc.clamp(0, rows + c_loc - 1), wrow, park


def _decoded(pools, mesh):
    """The rank's cold pool decoded, K and V (None, None without one)."""
    k_pool = pools[0]
    if pools[2] is None:
        return None, None
    n_elem = k_pool[0].numel()
    name = dtype_name(k_pool.dtype)
    return tuple(kv_kernels.decode_pages_sharded(
        *cold, mesh, n_elem=n_elem, dtype_name=name) for cold in pools[2:])


def _paged_prefill_chunk_sharded(q, new_k, new_v, pools, row, slot: int,
                                 positions, n_valid: int, mesh, *,
                                 n_slots: int, softcap: float = 0.0):
    """One slot's prefill chunk on a rank of the slot's batch shard.

    q / new_k / new_v: (1, H*, C, D), one padded chunk; ``pools`` the
    rank's local (k_pool, v_pool, k_cold, v_cold); ``row`` the slot's
    page-table row (global ids); ``positions`` (C,) absolute positions;
    ``n_slots`` the engine's ``max_batch`` (slot ``s`` lives on batch shard
    ``s // (n_slots / n_ba)``).  The shard holds every page of the slot,
    so this is the one-device chunk on the local pool: write the chunk's
    K/V, gather the history (local cold pages decoded), attend causally
    from ``positions[0]`` -> o (1, Hq, C, D)."""
    from .layers import blockwise_attention
    n_ba = n_batch_shards(mesh)
    if slot // (n_slots // n_ba) != batch_index(mesh):
        raise ValueError(f"slot {slot} is not on this rank's batch shard")
    k_pool, v_pool = pools[0], pools[1]
    loc, wrow, park = _local_ids(pools, row, mesh)
    paged_kv.page_write_chunk(k_pool, wrow, positions, new_k, n_valid,
                              park=park)
    paged_kv.page_write_chunk(v_pool, wrow, positions, new_v, n_valid,
                              park=park)
    dk, dv = _decoded(pools, mesh)
    k_hist = paged_kv.page_gather(k_pool, loc[None], decoded=dk)
    v_hist = paged_kv.page_gather(v_pool, loc[None], decoded=dv)
    start = positions[0]
    return blockwise_attention(q, k_hist, v_hist, causal=True,
                               q_offset=start, kv_len=start + n_valid,
                               attn_softcap=softcap)


def _paged_decode_attention_sharded(q, new_k, new_v, pools, page_table,
                                    cur_len, mesh, *, softcap: float = 0.0):
    """The paged decode step of this rank's batch shard: page write +
    gather + attention.

    q / new_k / new_v: (B_loc, H*, 1, D), the rows of the shard's slots;
    ``pools`` the rank's local (k_pool, v_pool, k_cold, v_cold);
    ``page_table`` (B_loc, P) global ids (swap sentinels clamped to the
    garbage page by the caller); ``cur_len`` (B_loc,) write positions ->
    o (B_loc, Hq, 1, D).  Without a model axis the one-device paged decode
    on these rows; with one, this rank's page columns ``p % n_model`` and
    the stat merge."""
    from .layers import decode_attention
    k_pool, v_pool = pools[0], pools[1]
    loc, wtbl, park = _local_ids(pools, page_table, mesh)
    paged_kv.page_write(k_pool, wtbl, cur_len, new_k, park=park)
    paged_kv.page_write(v_pool, wtbl, cur_len, new_v, park=park)
    dk, dv = _decoded(pools, mesh)
    n_model = axis_size(mesh, "model")
    if n_model == 1:
        k_hist = paged_kv.page_gather(k_pool, loc, decoded=dk)
        v_hist = paged_kv.page_gather(v_pool, loc, decoded=dv)
        return decode_attention(q, k_hist, v_hist, kv_len=cur_len + 1,
                                attn_softcap=softcap)
    # model axis: logical page p belongs to model rank p % n_model
    ps = k_pool.shape[2]
    P_log = page_table.shape[1]
    P_m = -(-P_log // n_model)
    col = mesh.get_local_rank("model") + n_model * torch.arange(
        P_m, device=q.device)
    sub = loc[:, col.clamp(max=P_log - 1)]
    k_hist = paged_kv.page_gather(k_pool, sub, decoded=dk)
    v_hist = paged_kv.page_gather(v_pool, sub, decoded=dv)
    pos = (col[:, None] * ps + torch.arange(ps, device=q.device)).reshape(-1)
    valid = ((pos[None, :] < (cur_len + 1)[:, None])
             & (col < P_log).repeat_interleave(ps)[None, :])
    acc, m, l = _attend_stats_masked(q, k_hist, v_hist, valid, softcap)
    return _merge_stats(acc, m, l, mesh).to(v_pool.dtype)


# Defined under private names and bound here: tools/lint's jit-discipline
# pass resolves a called name across files only when a single file under
# src/ defines it, and the reference's traced model bodies call these.
decode_attention_update_sharded = _decode_attention_update_sharded
paged_shardable = _paged_shardable
chunk_shardable = _chunk_shardable
paged_prefill_chunk_sharded = _paged_prefill_chunk_sharded
paged_decode_attention_sharded = _paged_decode_attention_sharded
