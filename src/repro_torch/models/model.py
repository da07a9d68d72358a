"""Decoder-only LM for the ``("attn",)`` pattern (the dense qwen3 family,
the MLP types of granite and nemotron, and the mixture-of-experts
family), built from ``ArchConfig``.  Plain functions over a nested-dict
parameter tree laid out as the reference's:

    {"embed": (V, d), "final_norm": (d,), ["unembed": (d, V),]
     "units": {"pos0": {"norm1", "attn": {wq, wk, wv, wo[, q_norm,
               k_norm]}, "norm2", "mlp": {wi_gate, wi_up, wo} | {wi, wo}
               | "moe": {gate, wi_gate, wi_up, wo[, shared: {wi_gate,
               wi_up, wo}]}}},
     "tail": {}}

where every leaf under ``"units"`` is stacked over a leading layer dim, and
each weight keeps the ``(in, out)`` layout (``x @ W``) so that its ECF8
container bytes equal the reference's.  The layer loop replaces the
reference's ``lax.scan``; KV pools are updated in place.

Entry points:
  prefill(params, cfg, tokens, max_len)   -> (last-pos logits, cache)
  prefill_chunk(params, cfg, tokens, cache, slot, n_valid)
                                          -> (logits, cache)   [paged cache]
  verify_chunk(params, cfg, tokens, cache, slot, n_valid)
                                          -> (all logits, cache) [paged]
  decode_step(params, cfg, token, cache)  -> (logits, cache)
                                          [paged or contiguous cache]
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.store import is_compressed, torch_dtype
from ..device import resolve
from ..kernels import ops
from ..kvcache import paged as paged_kv
from .layers import (F32, apply_rope, blockwise_attention, decode_attention,
                     mat, mlp_apply, mlp_init, rms_norm)
from .moe import moe_apply, moe_init

SUPPORTED_KINDS = ("attn",)
MLP_TYPES = ("swiglu", "gelu", "geglu", "sqrelu")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for architectures this slice of the port does not serve."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if (not kinds <= set(SUPPORTED_KINDS) or cfg.unit != 1
            or cfg.encoder_decoder or cfg.post_norms
            or cfg.mlp_type not in MLP_TYPES):
        raise NotImplementedError(
            f"{cfg.name}: not yet ported (this slice serves the ('attn',) "
            f"family: dense MLPs {MLP_TYPES} and mixture-of-experts)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

class _Draws:
    """The leaf maker of :func:`init_params`: ``new(name, shape, scale)``
    draws ``normal(shape) * scale`` (zeros when ``scale`` is None) once a
    layer, ``n_layers`` times (None: once, unstacked), from the shared
    generator, and hands the draws to ``leaf``; ``sub(name)`` is the maker
    of a sub-tree."""

    def __init__(self, gen, dtype, leaf, n_layers, path=()):
        self.gen, self.dtype, self.leaf = gen, dtype, leaf
        self.n_layers, self.path = n_layers, path

    def sub(self, name: str) -> "_Draws":
        return _Draws(self.gen, self.dtype, self.leaf, self.n_layers,
                      self.path + (name,))

    def __call__(self, name: str, shape: tuple, scale=None):
        gen, dtype = self.gen, self.dtype

        def draws():
            for _ in range(self.n_layers or 1):
                if scale is None:
                    yield torch.zeros(shape, dtype=dtype, device=gen.device)
                else:
                    yield torch.randn(shape, generator=gen, dtype=dtype,
                                      device=gen.device).mul_(scale)

        return self.leaf(self.path + (name,), draws(), self.n_layers)


def _stack(path, draws, n_layers):
    """The default leaf: the layers' draws stacked (one draw unstacked)."""
    xs = list(draws)
    return xs[0] if n_layers is None else torch.stack(xs)


def _attn_init(new, cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.hd
    s = d ** -0.5
    p = {
        "wq": new("wq", (d, cfg.n_heads * hd), s),
        "wk": new("wk", (d, cfg.n_kv_heads * hd), s),
        "wv": new("wv", (d, cfg.n_kv_heads * hd), s),
        "wo": new("wo", (cfg.n_heads * hd, d), s),
    }
    if cfg.qk_norm:
        p["q_norm"] = new("q_norm", (hd,))
        p["k_norm"] = new("k_norm", (hd,))
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                dtype=torch.float32, leaf=None):
    """Random weights with the reference's distributions (``normal *
    fan_in**-0.5``, norm scales zero), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the draws differ from
    ``jax.random``; parity tests convert the reference's own weights with
    ``repro_torch.convert``).

    A stacked leaf is drawn one layer at a time.  ``leaf(path, draws,
    n_layers)`` builds each leaf from its draws (an iterator of ``dtype``
    tensors, one a layer, ``n_layers`` None for an unstacked leaf) and must
    consume them before it returns; the default stacks them into f32
    masters.  ``core.store.build_trees`` casts and compresses each layer as
    it comes instead, so a caller never holds more than one layer's f32
    draw of a stacked leaf, and both see the same weights."""
    check_supported(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaf = leaf or _stack
    top = _Draws(gen, dtype, leaf, None)
    d, V = cfg.d_model, cfg.vocab_size
    params = {"embed": top("embed", (V, d), d ** -0.5),
              "final_norm": top("final_norm", (d,))}
    if not cfg.tie_embeddings:
        params["unembed"] = top("unembed", (d, V), d ** -0.5)
    new = _Draws(gen, dtype, leaf, cfg.n_layers, ("units", "pos0"))
    layer = {"norm1": new("norm1", (d,)),
             "attn": _attn_init(new.sub("attn"), cfg),
             "norm2": new("norm2", (d,))}
    if cfg.n_experts:
        layer["moe"] = moe_init(new.sub("moe"), d, cfg.n_experts,
                                cfg.moe_d_ff, cfg.n_shared_experts,
                                cfg.moe_d_ff)
    else:
        layer["mlp"] = mlp_init(new.sub("mlp"), d, cfg.d_ff, cfg.mlp_type)
    params["units"] = {"pos0": layer}
    params["tail"] = {}
    return params


def _layer(tree, u: int):
    """Layer ``u`` of the stacked unit parameters (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, u) for k, v in tree.items()}
    return tree.layer(u) if is_compressed(tree) else tree[u]


# --------------------------------------------------------------------------
# sub-blocks
# --------------------------------------------------------------------------

def _qkv(p, x, cfg: ArchConfig, dtype, positions):
    """positions: (T,) shared, or (B, T) per-slot (serving engine)."""
    B, T, _ = x.shape
    hd = cfg.hd
    q = (x @ mat(p["wq"], dtype)).reshape(B, T, cfg.n_heads, hd)
    k = (x @ mat(p["wk"], dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    v = (x @ mat(p["wv"], dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    pos_b = (positions[None, None, :] if positions.ndim == 1
             else positions[:, None, :])
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    return q, k, v


def _attn_out(p, o, dtype):
    B, H, T, hd = o.shape
    o = o.transpose(1, 2).reshape(B, T, H * hd)
    return o @ mat(p["wo"], dtype)


def _self_attention_full(p, x, cfg: ArchConfig, dtype):
    """Full-sequence causal self attention (prefill): the flash kernel."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)
    q, k, v = (t.contiguous() for t in _qkv(p, x, cfg, dtype, positions))
    o = ops.flash_attention(q, k, v, True, cfg.attn_softcap)
    return _attn_out(p, o, dtype), (k, v)


def _self_attention_decode(p, x, cfg: ArchConfig, dtype, pools, cur_len,
                           page_table):
    """One-token decode through the paged cache: the new K/V is written
    into each slot's tail page (in place), each slot's history gathered
    back, and the token attends over ``cur_len + 1`` positions.

    ``pools`` is (k_pool, v_pool, k_cold, v_cold), the cold entries being
    :func:`kvcache.paged.cold_leaves` tuples or None: cold pages are
    decoded by the page-decode kernel, once for K and once for V.
    ``page_table`` comes clamped to the garbage page (:func:`_decode_step`):
    a swap sentinel (negative id) can only sit in a vacated slot's row,
    whose write lands on the garbage page as the reference's does.  Such a
    row's output is never read by its slot, but a mixture-of-experts layer
    routes it with the live rows, so it must be the reference's own."""
    q, k, v = _qkv(p, x, cfg, dtype, cur_len[:, None])
    k_pool, v_pool, k_cold, v_cold = pools
    paged_kv.page_write(k_pool, page_table, cur_len, k)
    paged_kv.page_write(v_pool, page_table, cur_len, v)
    k_hist = paged_kv.page_gather(k_pool, page_table, k_cold)
    v_hist = paged_kv.page_gather(v_pool, page_table, v_cold)
    o = decode_attention(q, k_hist, v_hist, kv_len=cur_len + 1,
                         attn_softcap=cfg.attn_softcap)
    return _attn_out(p, o, dtype)


def _self_attention_decode_contiguous(p, x, cfg: ArchConfig, dtype, kc, vc,
                                      cur_len):
    """One-token decode through the contiguous (monolithic) cache: each
    slot's new K/V is written in place at its own ``cur_len`` in ``kc`` /
    ``vc`` (B, n_kv, max_len, hd), and the token attends over ``cur_len +
    1`` positions.  The write position is clamped to ``max_len - 1`` as
    the reference's ``dynamic_update_slice`` clamps it: a vacated slot
    keeps stepping past the end of its row, and its outputs are never
    read."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, dtype, cur_len[:, None])
    pos = cur_len.clamp(max=kc.shape[2] - 1).long()
    rows = torch.arange(B, device=x.device)
    kc[rows, :, pos] = k[:, :, 0].to(kc.dtype)
    vc[rows, :, pos] = v[:, :, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, kv_len=cur_len + 1,
                         attn_softcap=cfg.attn_softcap)
    return _attn_out(p, o, dtype)


def _self_attention_chunk(p, x, cfg: ArchConfig, dtype, pools, row, start,
                          n_valid: int, path: str = "gather"):
    """One prefill chunk of a single slot through the paged cache.

    x: (1, C, d), a chunk of the slot's prompt padded to the engine's chunk
    size; ``row`` is the slot's page-table row, ``start`` its timeline (a
    0-d tensor: no host sync), ``n_valid`` the count of real tokens.  The
    chunk's K/V is written into the slot's pages (in place), the slot's
    whole history (earlier chunks included, cold pages decoded by the
    page-decode kernel) is gathered back, and the chunk attends causally
    over it from ``q_offset=start``.  ``pools`` is as in
    :func:`_self_attention_decode`; ``path`` tags the page-decode launches
    of its cold pages (``kvcache.kernels.run``)."""
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    q, k, v = _qkv(p, x, cfg, dtype, positions)
    k_pool, v_pool, k_cold, v_cold = pools
    paged_kv.page_write_chunk(k_pool, row, positions, k, n_valid)
    paged_kv.page_write_chunk(v_pool, row, positions, v, n_valid)
    row = row.clamp(min=paged_kv.GARBAGE_PAGE)[None]
    k_hist = paged_kv.page_gather(k_pool, row, k_cold, path=path)
    v_hist = paged_kv.page_gather(v_pool, row, v_cold, path=path)
    o = blockwise_attention(q, k_hist, v_hist, causal=True, q_offset=start,
                            kv_len=start + n_valid,
                            attn_softcap=cfg.attn_softcap)
    return _attn_out(p, o, dtype)


def _ffn(p, x, cfg: ArchConfig, dtype):
    """The layer's feed-forward block: the MoE layer or the dense MLP.  The
    MoE's load-balancing loss is computed and dropped, as the reference's
    serve path drops it."""
    if "moe" in p:
        y, _ = moe_apply(p["moe"], x, cfg, dtype=dtype)
        return y
    return mlp_apply(p["mlp"], x, cfg.mlp_type, dtype)


def _layer_apply_full(p, x, cfg: ArchConfig, dtype):
    """Full-sequence layer (prefill).  Returns (x, (k, v))."""
    h = rms_norm(x, p["norm1"])
    o, kv = _self_attention_full(p["attn"], h, cfg, dtype)
    x = x + o
    h2 = rms_norm(x, p["norm2"])
    return x + _ffn(p, h2, cfg, dtype), kv


def _layer_apply_decode(p, x, cfg: ArchConfig, dtype, pools, cur_len,
                        page_table):
    """Decode layer; ``page_table`` None means ``pools`` is the contiguous
    cache's (k, v) of this layer."""
    h = rms_norm(x, p["norm1"])
    if page_table is None:
        o = _self_attention_decode_contiguous(p["attn"], h, cfg, dtype,
                                              *pools, cur_len)
    else:
        o = _self_attention_decode(p["attn"], h, cfg, dtype, pools, cur_len,
                                   page_table)
    x = x + o
    h2 = rms_norm(x, p["norm2"])
    return x + _ffn(p, h2, cfg, dtype)


def _layer_apply_chunk(p, x, cfg: ArchConfig, dtype, pools, row, start,
                       n_valid: int, path: str):
    """Chunk-mode layer: the decode layer's residual structure at T = C."""
    h = rms_norm(x, p["norm1"])
    x = x + _self_attention_chunk(p["attn"], h, cfg, dtype, pools, row,
                                  start, n_valid, path)
    h2 = rms_norm(x, p["norm2"])
    return x + _ffn(p, h2, cfg, dtype)


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def _embed(params, cfg: ArchConfig, tokens, dtype):
    x = mat(params["embed"], dtype)[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype,
                             device=x.device)
    return x


def _unembed(params, cfg: ArchConfig, x, dtype):
    x = rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        logits = x @ mat(params["embed"], dtype).T
    else:
        logits = x @ mat(params["unembed"], dtype)
    logits = logits.to(F32)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device="cuda", per_slot: bool = False):
    """Contiguous per-layer K/V: ``units/pos0/{k,v}`` is ``(n_layers,
    batch, n_kv, max_len, hd)``.  ``per_slot=True`` makes ``cur_len`` a
    (batch,) vector, every slot on its own timeline (the engine's
    monolithic cache); else it is one shared 0-d length (a prefill's)."""
    dev = resolve(device)
    s = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    cur = (torch.zeros((batch,), dtype=torch.int32, device=dev) if per_slot
           else torch.zeros((), dtype=torch.int32, device=dev))
    return {"units": {"pos0": {"k": torch.zeros(s, dtype=dtype, device=dev),
                               "v": torch.zeros(s, dtype=dtype, device=dev)}},
            "tail": {},
            "cur_len": cur}


def _prefill(params, cfg: ArchConfig, tokens, max_len: int | None = None):
    """Process a prompt, build its cache -> (last-pos logits (B, 1, V),
    cache with K/V zero-padded to ``max_len``)."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    B, T = tokens.shape
    max_len = max_len or T
    cache = init_cache(cfg, B, max_len, dtype, tokens.device)
    x = _embed(params, cfg, tokens, dtype)
    units = params["units"]["pos0"]
    kc, vc = cache["units"]["pos0"]["k"], cache["units"]["pos0"]["v"]
    for u in range(cfg.n_layers):
        x, (k, v) = _layer_apply_full(_layer(units, u), x, cfg, dtype)
        kc[u, :, :, :T] = k
        vc[u, :, :, :T] = v
    logits = _unembed(params, cfg, x[:, -1:], dtype)
    cache["cur_len"] = torch.full((), T, dtype=torch.int32,
                                  device=tokens.device)
    return logits, cache


def _decode_step(params, cfg: ArchConfig, token, cache):
    """token: (B, 1) int -> (logits (B, 1, V), cache).  ``cache`` is a
    paged cache (``kvcache.paged.PagedKVCache.init_cache``) or a contiguous
    one (:func:`init_cache`, ``per_slot`` or a prefill's shared length);
    its K/V is written in place and ``cur_len`` advances by one.  Cold-pool
    leaves, where a paged cache carries them, are decoded in every layer
    (the engine leaves them out while no page is cold)."""
    dtype = torch_dtype(cfg.dtype)
    B = token.shape[0]
    cur_len = cache["cur_len"]
    page_table = cache.get("page_table")
    pools = cache["units"]["pos0"]
    units = params["units"]["pos0"]
    lens = cur_len.expand(B) if cur_len.ndim == 0 else cur_len
    if page_table is not None:
        page_table = page_table.clamp(min=paged_kv.GARBAGE_PAGE)
    x = _embed(params, cfg, token, dtype)
    for u in range(cfg.n_layers):
        if page_table is None:
            layer_pools = (pools["k"][u], pools["v"][u])
        else:
            layer_pools = (pools["k_pool"][u], pools["v_pool"][u],
                           paged_kv.cold_leaves(pools, "k", u),
                           paged_kv.cold_leaves(pools, "v", u))
        x = _layer_apply_decode(_layer(units, u), x, cfg, dtype, layer_pools,
                                lens, page_table)
    logits = _unembed(params, cfg, x, dtype)
    cache["cur_len"] = cur_len + 1
    return logits, cache


def _chunk_stack(params, cfg: ArchConfig, tokens, cache, slot: int,
                 n_valid: int, path: str = "gather"):
    """Embed a chunk, run every layer in chunk mode, advance the slot's
    timeline by ``n_valid`` (in place) -> the residual stream (1, C, d).
    ``path`` tags the page-decode launches of cold pages."""
    dtype = torch_dtype(cfg.dtype)
    cur_len = cache["cur_len"]
    start = cur_len[slot].clone()
    row = cache["page_table"][slot]
    pools = cache["units"]["pos0"]
    units = params["units"]["pos0"]
    x = _embed(params, cfg, tokens, dtype)
    for u in range(cfg.n_layers):
        x = _layer_apply_chunk(_layer(units, u), x, cfg, dtype,
                               (pools["k_pool"][u], pools["v_pool"][u],
                                paged_kv.cold_leaves(pools, "k", u),
                                paged_kv.cold_leaves(pools, "v", u)),
                               row, start, n_valid, path)
    cur_len[slot] = start + n_valid
    return x


def _prefill_chunk(params, cfg: ArchConfig, tokens, cache, slot: int,
                   n_valid: int):
    """Process one fixed-size prompt chunk for ``slot`` of a paged cache.

    tokens: (1, C) int, a chunk of the prompt padded to the engine's chunk
    size; ``n_valid`` counts its real tokens; the chunk starts at
    ``cache["cur_len"][slot]``.  K/V is appended straight into the slot's
    pages across chunk boundaries; the final chunk's last-position logits
    are where the request's first token is sampled from.  Returns (logits
    (1, 1, V) at position ``n_valid - 1`` of the chunk, cache with
    ``cur_len[slot] += n_valid``); the pools and ``cur_len`` are updated in
    place."""
    check_supported(cfg)
    x = _chunk_stack(params, cfg, tokens, cache, slot, n_valid)
    last = x[:, max(n_valid - 1, 0):max(n_valid, 1)]
    return _unembed(params, cfg, last, torch_dtype(cfg.dtype)), cache


def _verify_chunk(params, cfg: ArchConfig, tokens, cache, slot: int,
                  n_valid: int):
    """The speculative-decoding verify forward: :func:`prefill_chunk`'s
    chunk program, unembedding **every** chunk row.

    tokens: (1, C), the slot's last emitted token then the draft's
    proposals, padded to the engine's verify width ``spec_k + 1``.  Returns
    (logits (1, C, V), cache): row ``i`` conditions on the cache prefix
    and ``tokens[:, :i + 1]``, the target distribution proposal ``i + 1``
    is accepted against, and row ``n_valid - 1`` scores the bonus token.
    K/V of all ``n_valid`` tokens lands in the slot's pages and
    ``cur_len[slot]`` advances by ``n_valid`` (in place); the engine rolls
    the rejected suffix back (``PagedKVCache.rollback``).  Cold pages of
    the history are decoded with the page-decode launches tagged
    ``'verify'``."""
    check_supported(cfg)
    x = _chunk_stack(params, cfg, tokens, cache, slot, n_valid, "verify")
    return _unembed(params, cfg, x, torch_dtype(cfg.dtype)), cache


# The entry points are defined under private names and bound to the public
# ones: tools/lint's jit-discipline pass resolves a called name across
# files only when a single file under src/ defines it, and the reference's
# jitted serve steps reach their model through ``M.prefill`` /
# ``M.decode_step`` / ``M.prefill_chunk`` / ``M.verify_chunk``.
prefill = _prefill
prefill_chunk = _prefill_chunk
verify_chunk = _verify_chunk
decode_step = _decode_step
