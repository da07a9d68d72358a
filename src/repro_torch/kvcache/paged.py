"""Paged KV cache: fixed-size pages, per-slot page tables, free-list alloc,
the compressed cold pool and the host swap tier.

Every batch slot owns a list of fixed-size pages (``page_size`` token
positions x all KV heads); a shared ``(max_batch, pages_per_slot)`` page
table maps logical page index -> physical page id, identically for every
global attention layer (one allocation decision serves the whole stack).
A short request only holds the pages it wrote.  A ``local`` (sliding-
window) layer pages nothing: it keeps a per-slot ring of ``ring_len``
positions beside the pools (the monolithic cache's leaf), and a recurrent
layer (``rglru`` / ``slstm`` / ``mlstm``) its per-slot state, in the
units and in the tail alike; the prefill fragment splices them in at
admission and preemption carries them to the host and back
(``snapshot_slot_state`` / ``restore_slot_state``).

Physical id space (the reference's, on one device):
  * id 0 is the **garbage page** — inactive slots' table rows point at it
    so the batched decode step can scatter/gather unconditionally;
  * ids ``1 .. n_pages-1`` are raw pool pages;
  * ids ``>= n_pages`` address the **cold pool**: pages that filled up are
    entropy-coded by ``kvcache.codec`` (lossless, exponent plane) and live
    compressed; the decode step decodes them where it uses them, through
    the page-decode kernel (``kernels.ops.decode_pages``).  A page whose
    coded stream would exceed the uniform stride budget stays raw;
  * **negative** ids are **swapped** pages: ``-(key + 1)`` indexes the
    host-side :class:`swap.SwapStore` (``attach_swap``).  A swapped page
    holds no device memory; the decode step clamps its sentinel to the
    garbage page and drops writes past the raw pool, and the engine faults
    every active slot resident (``fault``) before a step gathers it.

Page lifecycle (with a swap store attached)::

    hot (raw pool) --page full--> cold (compressed pool)
        \\                           |
         \\--evict (encode)--\\      evict (device->host copy)
                              v      v
                            swapped (host SwapStore)
                              |         |
               fault (page decode)    fault (reinstall container)
                              v         v
                             hot       cold

Cross-request prefix sharing (``enable_prefix_sharing``): a
:class:`PrefixIndex` maps the token content of page-aligned prompt blocks
to the raw page holding their K/V, so a request whose prompt starts with an
indexed prefix adopts those pages by reference (``admit_shared``) and its
prefill starts at the match boundary.  A raw page's reference count is its
number of holders (slots whose page list contains it, plus the index); it
frees only at zero.  A shared page is split into a private copy before a
write could land in it (``make_writable``); an index-only page is retired
to the swap store's unpinned LRU cache when the pool runs short
(``_reclaim_prefix``) and faults back bit-exactly on a later match.

Mesh sharding (``n_shards > 1``, the reference's layout): batch shard ``k``
owns slots ``[k*B/n, (k+1)*B/n)``, raw page ids ``[k*n_pages/n,
(k+1)*n_pages/n)`` (shard 0 loses the garbage page) and the matching
cold-slot range, each with its own free list, so every slot's history lies
in its own shard and the sharded decode step gathers no page across ranks
(``models.decode_sharded``).  The allocator's bookkeeping is global and
identical on every rank; a rank built with ``shard=k`` holds only shard
``k``'s pool rows (``pages_per_shard``, plus one park row that takes the
dropped writes of the sharded scatter) and cold slots (``cold_per_shard``),
with the page table in global ids.  Only the ranks of a slot's shard touch
its pages; a host decision that reads page content (an encoded page's byte
count, whether it fits the cold stride budget) is made there and handed to
every rank by ``share`` before any rank acts on it.

``page_write`` / ``page_write_chunk`` / ``page_gather`` are the tensor ops
of the decode step and the prefill chunk (``models.model``); the writes
update the pool in place, where the reference returns a new pool, and so do
the allocator's cache updates.
``PagedKVCache`` is the host-side allocator driven by ``serving.engine``
(admit, admit_slot or admit_shared -> ensure -> compress cold -> evict /
fault -> release), with the reference's descending free lists and page
reference counts.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve
from ..kernels import ops
from . import codec
from .codec import LANES
from .swap import SwapEntry, SwappedPage

GARBAGE_PAGE = 0
PAGED_KINDS = ("attn", "nope")   # "local" keeps its ring, recurrents a state
_STATE_KINDS = ("local", "rglru", "slstm", "mlstm")
_COLD = ("cpl", "csm", "ctab", "cperm")


def ring_len(cfg: ArchConfig, max_len: int) -> int:
    """Positions of a ``local`` layer's ring buffer: the window, or the
    whole timeline when that is shorter."""
    return min(cfg.local_window, max_len)


class OutOfPages(RuntimeError):
    """Raised when the raw pool cannot cover a request's next page."""


# --------------------------------------------------------------------------
# tensor ops of the decode step
# --------------------------------------------------------------------------

def page_write(pool, page_table, cur_len, kv, park: int = GARBAGE_PAGE):
    """Scatter one new token's K (or V) into each slot's tail page, in place.

    pool: (n_pool, n_kv, ps, hd); page_table: (B, P) int page ids;
    cur_len: (B,) write positions; kv: (B, n_kv, 1, hd).  A row whose tail
    id is a swap sentinel (negative: a vacated slot's row, which no one
    reads) or lies past the raw pool (a cold id) is dropped, as the
    reference's ``mode="drop"`` scatter drops it; a negative index would
    otherwise count from the end of the pool and overwrite a live page.
    Dropped rows write the ``park`` row's own contents back (the garbage
    page; a sharded rank's park row, whose local row 0 is a live page),
    which keeps the scatter free of a host sync.  Returns pool."""
    n_pool, _, ps, _ = pool.shape
    P = page_table.shape[1]
    p_idx = (cur_len // ps).clamp(0, P - 1).long()
    off = (cur_len % ps).long()
    pids = page_table.gather(1, p_idx[:, None])[:, 0].long()
    keep = (pids >= 0) & (pids < n_pool)
    pids = torch.where(keep, pids, park)
    new = torch.where(keep[:, None, None], kv[:, :, 0, :].to(pool.dtype),
                      pool[pids, :, off, :])
    pool[pids, :, off, :] = new
    return pool


def page_write_chunk(pool, row, positions, kv, n_valid: int,
                     park: int = GARBAGE_PAGE):
    """Scatter one prefill chunk's K (or V) into a single slot's pages, in
    place.

    pool: (n_pool, n_kv, ps, hd); row: (P,) page ids (the slot's page-table
    row); positions: (C,) absolute token positions of the chunk; kv: (1,
    n_kv, C, hd); n_valid: count of real (unpadded) tokens.  Padded tokens
    are dropped, and so is a position whose page id is a swap sentinel
    (negative) or a cold id (past the raw pool), as the reference's
    ``mode="drop"`` scatter drops them; a negative index would otherwise
    count from the end of the pool and overwrite a live page.  Dropped
    positions write the ``park`` row's own contents back (as
    :func:`page_write`), which keeps the scatter free of a host sync.
    Returns pool."""
    n_pool, _, ps, _ = pool.shape
    P = row.shape[0]
    positions = positions[:n_valid]
    p_idx = (positions // ps).clamp(0, P - 1).long()
    off = (positions % ps).long()
    pids = row[p_idx].long()
    keep = (pids >= 0) & (pids < n_pool)
    pids = torch.where(keep, pids, park)
    new = torch.where(keep[:, None, None],
                      kv[0, :, :n_valid].transpose(0, 1).to(pool.dtype),
                      pool[pids, :, off, :])
    pool[pids, :, off, :] = new
    return pool


def cold_leaves(pools: dict, kn: str, u: int):
    """Layer ``u``'s compressed-pool leaves for ``kn`` in {'k','v'}, or None
    when ``pools`` carries none: (payload (n_cold, stride, LANES) u8,
    signmant (n_cold, sm) u8, tables (n_cold, 3, max_len) i32, perm
    (n_cold, n_sym) i32) — the argument order of ``ops.decode_pages``."""
    if f"{kn}_cpl" not in pools:
        return None
    return tuple(pools[f"{kn}_{c}"][u] for c in _COLD)


def without_cold(cache: dict) -> dict:
    """A view of ``cache`` without its cold-pool leaves (the pools, rings,
    timelines and page table kept): what the decode step reads while no
    page is cold, since decoding an empty cold pool would be waste."""
    units = {name: {k: v for k, v in leaves.items()
                    if k.partition("_")[2] not in _COLD}
             for name, leaves in cache["units"].items()}
    return {**cache, "units": units}


def page_gather(pool, page_table, cpool=None, path: str = "gather",
                decoded=None):
    """Gather each slot's pages into a contiguous KV history.

    pool: (n_pool, n_kv, ps, hd); page_table: (B, P) ids into the
    *virtual* pool; cpool: optional :func:`cold_leaves` tuple.  Cold pages
    (ids >= n_pool) are entropy-decoded by the page-decode kernel and
    appended to the raw pool as a virtual suffix before the gather; ids
    are clipped, so garbage rows gather page 0 (their positions are masked
    by ``kv_len`` downstream).  ``path`` tags the page-decode launches;
    ``decoded``, when given, is the cold pool already decoded, (n_cold,
    n_elem) (the sharded decode's ``kernels.decode_pages_sharded``).
    Returns (B, n_kv, P * ps, hd)."""
    n_kv, ps, hd = pool.shape[1:]
    virtual = pool
    if decoded is None and cpool is not None:
        decoded = ops.decode_pages(*cpool, n_elem=n_kv * ps * hd,
                                   dtype_name=codec.dtype_name(pool.dtype),
                                   path=path)
    if decoded is not None:
        virtual = torch.cat([pool, decoded.view(-1, n_kv, ps, hd)])
    ids = page_table.clamp(0, virtual.shape[0] - 1).long()
    gath = virtual[ids]                            # (B, P, n_kv, ps, hd)
    B, P = page_table.shape
    return gath.permute(0, 2, 1, 3, 4).reshape(B, n_kv, P * ps, hd)


# --------------------------------------------------------------------------
# host-side controller
# --------------------------------------------------------------------------

class PrefixIndex:
    """Content-addressed index of page-aligned prompt-prefix blocks.

    Key: the token content of blocks ``0..i`` as a tuple (the dict hashes
    it; equality is checked on lookup, so a hash collision can never
    mis-match a prefix).  Value: the physical entry holding block ``i``'s
    K/V — a raw pool page id, or a negative swap sentinel (``-(key + 1)``)
    once the page was retired to the swap store's prefix cache.  Dict
    insertion order doubles as LRU order: :meth:`touch` moves a matched
    key to the back, reclaim walks from the front."""

    def __init__(self):
        self._entries: dict[tuple, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key):
        return self._entries.get(key)

    def put(self, key, entry: int) -> None:
        """Insert or update; an update keeps the key's LRU position."""
        self._entries[key] = entry

    def touch(self, key) -> None:
        self._entries[key] = self._entries.pop(key)

    def drop(self, key) -> None:
        self._entries.pop(key, None)

    def lru_keys(self) -> list:
        """Keys, least recently matched first."""
        return list(self._entries)

    def entries(self):
        return self._entries.values()


class PagedKVCache:
    """Allocator + lifecycle manager for the paged, compressible cache."""

    def __init__(self, cfg: ArchConfig, max_batch: int, max_len: int, *,
                 dtype, device="cuda", page_size: int = 16,
                 n_pages: int | None = None, compress_cold: bool = False,
                 n_cold_slots: int | None = None, n_shards: int = 1,
                 shard: int | None = None, share=None):
        """Args:
          cfg: architecture config: paged ('attn'/'nope'), ``local`` and
            recurrent layers (the latter keep rings and states, not pages),
            no paged layer in the tail.
          max_batch/max_len: static engine batch shape; every slot can hold
            at most ``max_len`` tokens (``pages_per_slot`` pages).
          dtype: cache storage dtype (fp8 / bf16 / f32: a page-codec type).
          device: where the pools and the page table live.
          page_size: token positions per page; rounded down to a divisor of
            ``max_len``.
          n_pages: raw pool size (id 0 is the garbage page); defaults to
            the worst case (every slot full) plus the garbage page, and is
            rounded up to a multiple of ``n_shards``.
          compress_cold: entropy-code full pages into the cold pool.
          n_cold_slots: cold pool size (default: worst case minus one tail
            page per slot), rounded up to a multiple of ``n_shards``.
          n_shards: batch shards of the mesh (the batch axes' size): slots,
            raw pages and cold slots split into ``n_shards`` contiguous
            ranges with one free list each; ``max_batch`` must divide.
          shard: the batch shard whose pool rows and cold slots this
            process holds (a mesh rank); None holds every shard's.
          share: ``share(obj, shard) -> obj``, a picklable value as the
            first rank of ``shard`` holds it, on every rank (the mesh
            engine's broadcast); None when every rank reads the same page
            content (one process, or one batch shard).
        """
        from ..models.model import cache_groups
        # (section, key, kind) of every layer group: the pattern positions
        # (stacked over the units), then the tail layers
        self.groups = list(cache_groups(cfg))
        if any(k not in PAGED_KINDS + _STATE_KINDS
               or (sec == "tail" and k in PAGED_KINDS)
               for sec, _, k in self.groups):
            raise NotImplementedError(
                f"{cfg.name}: only 'attn'/'nope'/'local'/recurrent layers "
                f"with no paged layer in the tail are ported")
        self.cfg = cfg
        self.device = resolve(device)
        self.max_batch, self.max_len = max_batch, max_len
        self.dtype = dtype
        self.dtype_name = codec.dtype_name(dtype)
        ps = max(1, min(page_size, max_len))
        while max_len % ps:
            ps -= 1
        if ps != page_size:
            warnings.warn(
                f"page_size={page_size} does not divide max_len={max_len}; "
                f"using {ps} (a tiny page inflates the page table and the "
                f"per-token scatter/gather)", stacklevel=2)
        self.page_size = ps
        self.pages_per_slot = max_len // ps
        if n_shards < 1 or max_batch % n_shards:
            raise ValueError(
                f"max_batch={max_batch} not divisible by n_shards={n_shards}")
        if shard is not None and not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} not in [0, {n_shards})")
        self.n_shards, self.shard, self.share = n_shards, shard, share
        self.slots_per_shard = max_batch // n_shards
        n_pages = n_pages or (n_shards + max_batch * self.pages_per_slot)
        # each shard owns a contiguous, equal range of page ids
        self.n_pages = -(-n_pages // n_shards) * n_shards
        self.pages_per_shard = self.n_pages // n_shards
        self.n_units = cfg.n_layers // cfg.unit
        # pattern positions whose layers page, and the groups that keep
        # per-slot state (rings, recurrent states) beside the pools
        self.paged_pos = [f"pos{j}" for j, k in enumerate(cfg.pattern)
                          if k in PAGED_KINDS]
        self.state_groups = [(sec, key) for sec, key, k in self.groups
                             if k not in PAGED_KINDS]
        self.n_attn_layers = self.n_units * len(self.paged_pos)
        self.page_elems = cfg.n_kv_heads * ps * cfg.hd
        exp_bits, self.max_code_len, _ = codec.plane_spec(self.dtype_name)
        self.n_sym = 1 << exp_bits
        self.S = codec.sym_per_lane(self.page_elems)
        self.sm_nbytes = codec.sm_bytes(self.dtype_name, self.page_elems)
        self.compress = bool(compress_cold)
        # never worse than the raw exponent plane
        self.stride_budget = max(codec.MIN_STRIDE, -(-self.S * exp_bits // 8))
        # device bytes of one cold slot (every layer, K and V): the payload
        # at the uniform stride budget, the plane, the tables and the perm.
        # At this budget a slot is no smaller than a raw page.
        self.cold_slot_bytes = self.n_attn_layers * 2 * (
            self.stride_budget * LANES + self.sm_nbytes
            + 4 * (3 * self.max_code_len + self.n_sym))
        default_cold = max_batch * max(self.pages_per_slot - 1, 1)
        n_cold = ((n_cold_slots if n_cold_slots is not None
                   else default_cold) if self.compress else 0)
        self.n_cold = -(-n_cold // n_shards) * n_shards
        self.cold_per_shard = self.n_cold // n_shards
        # per-shard free lists (descending, so pop() hands out low ids
        # first); shard 0's range excludes the garbage page id 0
        pps, cps = self.pages_per_shard, self.cold_per_shard
        self._free = [list(range((k + 1) * pps - 1, max(k * pps, 1) - 1, -1))
                      for k in range(n_shards)]
        self._cold_free = [list(range((k + 1) * cps - 1, k * cps - 1, -1))
                           for k in range(n_shards)]
        # the device rows this process holds: one shard's pool (and a park
        # row for the sharded scatter's dropped writes) and cold slots, or
        # every shard's
        local = shard is not None and n_shards > 1
        self._row0 = shard * pps if local else 0
        self._cold0 = shard * cps if local else 0
        self.pool_rows = pps + 1 if local else self.n_pages
        self.cold_rows = cps if local else self.n_cold
        self._slot_pages: dict[int, list[int]] = {}
        self._skip: dict[int, set[int]] = {}        # incompressible pages
        self._cold_bytes: dict[int, int] = {}       # cold slot -> bytes
        # physical-page reference counts: every live raw pid has an entry
        # (1 = private).  Holders are slots (one ref per slot whose page
        # list contains the pid) and the prefix index (one per entry); a
        # pid returns to the free list only when its count reaches zero
        self._ref: dict[int, int] = {}
        self.prefix = None              # PrefixIndex (enable_prefix_sharing)
        self.n_prefix_retired = 0       # index pages retired to swap
        self.n_prefix_dropped = 0       # index pages dropped (no swap room)
        self.n_cow_splits = 0           # shared pages split before a write
        self.swap = None                # SwapStore (attach_swap)
        self.telemetry = None           # serving.telemetry.Telemetry
        #   (engine-set; evict / fault publish page counts and host<->device
        #   swap spans through it — observation only)
        # cumulative work of the coded tiers (launch/serve.py's report):
        # pages moved into the cold pool and their coded bytes, host
        # seconds in codec.encode_page (of which retiring prefix pages),
        # page-decode calls made by fault() and admit_shared()
        self.n_compressed = self.compressed_bytes = 0
        self.encode_seconds = self.retire_seconds = 0.0
        self.n_fault_decodes = 0
        self.n_moved_pages = 0          # faulted into another shard

    def _pool_leaves(self) -> dict:
        """One paged position's page pools (and cold-pool leaves), stacked
        over the units."""
        cfg, dev, U = self.cfg, self.device, self.n_units
        pool = (U, self.pool_rows, cfg.n_kv_heads, self.page_size, cfg.hd)
        leaves = {"k_pool": torch.zeros(pool, dtype=self.dtype, device=dev),
                  "v_pool": torch.zeros(pool, dtype=self.dtype, device=dev)}
        if self.compress:
            shapes = {"cpl": ((self.stride_budget, LANES), torch.uint8),
                      "csm": ((self.sm_nbytes,), torch.uint8),
                      "ctab": ((3, self.max_code_len), torch.int32),
                      "cperm": ((self.n_sym,), torch.int32)}
            for kn in ("k", "v"):
                for c, (shape, dt) in shapes.items():
                    leaves[f"{kn}_{c}"] = torch.zeros(
                        (U, self.cold_rows) + shape, dtype=dt, device=dev)
        return leaves

    def init_cache(self) -> dict:
        """The paged cache: page pools (and cold-pool leaves) of every
        paged pattern position, the rings of the ``local`` layers and the
        states of the recurrent ones (the monolithic cache's leaves,
        ``models.model.group_cache``), per-slot timelines and the shared
        page table."""
        from ..models.model import group_cache
        cfg, dev = self.cfg, self.device
        cache = {"units": {}, "tail": {}}
        for section, key, kind in self.groups:
            cache[section][key] = (
                self._pool_leaves() if kind in PAGED_KINDS
                else group_cache(cfg, kind, (self.n_units,) if section ==
                                 "units" else (), self.max_batch,
                                 self.max_len, self.dtype, dev))
        return {
            **cache,
            "cur_len": torch.zeros((self.max_batch,), dtype=torch.int32,
                                   device=dev),
            "page_table": torch.zeros(
                (self.max_batch, self.pages_per_slot), dtype=torch.int32,
                device=dev),
        }

    # -- allocator ---------------------------------------------------------

    def _alloc_raw(self, sh: int) -> int:
        """Pop a raw page off ``sh``'s free list with refcount 1."""
        pid = self._free[sh].pop()
        self._ref[pid] = 1
        return pid

    def _incref(self, pid: int) -> None:
        self._ref[pid] = self._ref.get(pid, 0) + 1

    def _decref(self, pid: int) -> None:
        """Drop one reference; the page frees only when nobody holds it."""
        n = self._ref.get(pid, 1) - 1
        if n <= 0:
            self._ref.pop(pid, None)
            self._free[pid // self.pages_per_shard].append(pid)
        else:
            self._ref[pid] = n

    def _free_cold(self, cs: int) -> None:
        self._cold_free[cs // max(self.cold_per_shard, 1)].append(cs)
        self._cold_bytes.pop(cs, None)

    def shard_of_slot(self, slot: int) -> int:
        """Batch shard owning ``slot`` (contiguous slot ranges per shard)."""
        return slot // self.slots_per_shard

    def holds(self, slot: int) -> bool:
        """Whether this process holds ``slot``'s pages."""
        return self._holds_shard(self.shard_of_slot(slot))

    def _holds_shard(self, sh: int) -> bool:
        return self.shard is None or self.n_shards == 1 or sh == self.shard

    def _row(self, pid: int) -> int:
        """The local pool row of raw page ``pid``."""
        return pid - self._row0

    def _crow(self, cs: int) -> int:
        """The local cold row of cold slot ``cs``."""
        return cs - self._cold0

    def _share(self, obj, sh: int):
        """``obj`` as the first rank of shard ``sh`` holds it."""
        if self.share is None or self.n_shards == 1:
            return obj
        return self.share(obj, sh)

    @property
    def free_pages(self) -> int:
        """Total free raw pages across all shards."""
        return sum(len(f) for f in self._free)

    @property
    def free_pages_per_shard(self) -> list:
        return [len(f) for f in self._free]

    @property
    def has_cold(self) -> bool:
        return bool(self._cold_bytes)

    def pages_needed(self, prompt_len: int) -> int:
        """Pages to cover the prompt and the first decode write."""
        return min(prompt_len // self.page_size + 1, self.pages_per_slot)

    def pages_for_prefix(self, n_tokens: int) -> int:
        """Pages that hold the first ``n_tokens`` cache positions: the
        chunked-prefill admission grant (unlike :func:`pages_needed` it
        does not cover the first decode write; later chunks and the decode
        step grow the slot page by page with :func:`ensure`)."""
        return min(max(-(-n_tokens // self.page_size), 1),
                   self.pages_per_slot)

    def pages_worst_case(self, prompt_len: int, max_new: int) -> int:
        """Pages the request can ever hold at once: its last cache write
        lands at position ``min(prompt+max_new, max_len) - 2`` (the final
        sampled token is never written), floored at ``prompt_len``."""
        last = max(min(prompt_len + max_new, self.max_len) - 2, prompt_len)
        return min(last // self.page_size + 1, self.pages_per_slot)

    def shard_capacity(self, shard: int) -> int:
        """Allocatable raw pages in ``shard``'s id range (shard 0 loses
        the garbage page)."""
        return self.pages_per_shard - (1 if shard == 0 else 0)

    # -- request lifecycle -------------------------------------------------

    def admit(self, cache: dict, slot: int, frag: dict, prompt_len: int):
        """Allocate a fresh slot's pages (from its shard's free list) and
        copy its prefill fragment (``models.model.prefill``'s cache, batch
        1, prefilled with this cache's ``max_len``) into them, and its rings
        into the slot's.  ``frag`` is None on a rank that does not hold the
        slot's shard: the bookkeeping alone."""
        need = self.pages_needed(prompt_len)
        sh = self.shard_of_slot(slot)
        free = self._free[sh]
        if len(free) < need:
            cache = self._reclaim_prefix(cache, need - len(free))
        if len(free) < need:
            raise OutOfPages(f"shard {sh}: slot {slot} needs {need} pages, "
                             f"{len(free)} free")
        pids = [self._alloc_raw(sh) for _ in range(need)]
        self._slot_pages[slot] = pids
        self._skip[slot] = set()
        cache["page_table"][slot] = 0
        cache["page_table"][slot, :need] = torch.tensor(
            pids, dtype=torch.int32, device=self.device)
        cache["cur_len"][slot] = prompt_len
        if frag is None:
            return cache            # another shard's slot: no rows here
        ids = torch.tensor([self._row(p) for p in pids], dtype=torch.int64,
                           device=self.device)
        for name in self.paged_pos:
            dst, src = cache["units"][name], frag["units"][name]
            for kn in ("k", "v"):
                pages = self._frag_pages(src[kn])
                dst[f"{kn}_pool"][:, ids] = pages[:, :need].to(self.dtype)
        for section, key in self.state_groups:
            axis = 1 if section == "units" else 0
            for kn, leaf in cache[section][key].items():
                leaf.select(axis, slot).copy_(
                    frag[section][key][kn].select(axis, 0))
        return cache

    def admit_slot(self, cache: dict, slot: int, need: int):
        """Allocate a fresh slot for chunked prefill: grant ``need`` pages
        (no fragment is copied: the chunks write their K/V with
        :func:`page_write_chunk`) and reset the slot's timeline to 0."""
        sh = self.shard_of_slot(slot)
        free = self._free[sh]
        if len(free) < need:
            cache = self._reclaim_prefix(cache, need - len(free))
        if len(free) < need:
            raise OutOfPages(f"shard {sh}: slot {slot} needs {need} pages, "
                             f"{len(free)} free")
        pids = [self._alloc_raw(sh) for _ in range(need)]
        self._slot_pages[slot] = pids
        self._skip[slot] = set()
        cache["page_table"][slot] = 0
        cache["page_table"][slot, :need] = torch.tensor(
            pids, dtype=torch.int32, device=self.device)
        cache["cur_len"][slot] = 0
        return cache

    def _frag_pages(self, x):
        """Prefill fragment (U, 1, n_kv, max_len, hd) -> (U, P, n_kv, ps,
        hd), U the unit count."""
        cfg, ps, P = self.cfg, self.page_size, self.pages_per_slot
        x = x.reshape(self.n_units, cfg.n_kv_heads, P, ps, cfg.hd)
        return x.permute(0, 2, 1, 3, 4)

    def ensure(self, cache: dict, slot: int, pos: int):
        """Grow the slot's page list to cover a write at ``pos`` (from the
        slot's shard)."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            return cache
        sh = self.shard_of_slot(slot)
        p = min(pos // self.page_size, self.pages_per_slot - 1)
        while len(pages) <= p:
            if not self._free[sh]:
                cache = self._reclaim_prefix(cache, 1)
            if not self._free[sh]:
                raise OutOfPages(
                    f"shard {sh}: slot {slot} needs page {len(pages)}")
            pid = self._alloc_raw(sh)
            cache["page_table"][slot, len(pages)] = pid
            pages.append(pid)
        return cache

    def rollback(self, cache: dict, slot: int, n_tokens: int):
        """Truncate ``slot``'s timeline to ``n_tokens`` cache positions: the
        speculative verify's rejection path (a verify forward appended
        ``k + 1`` tokens' K/V and the rejected suffix must go again).

        Pages past ``ceil(n_tokens / page_size)`` (at least one, so the
        admission grant is never undercut) return to the free list in
        reverse allocation order: :func:`ensure` pops from the tail of the
        descending free list, so popping the slot's page list from its own
        tail and appending each id back restores the free list, and every
        later allocation, bit-exactly.  Such pages are raw: speculation
        allocates and rolls back within one engine step, before cold
        compression or eviction can reach them.  Stale K/V past
        ``n_tokens`` inside kept pages is masked by ``kv_len`` until the
        slot's next write overwrites it; pages return to the slot's shard.
        ``cur_len[slot]`` is set to
        ``n_tokens`` (in place)."""
        pages = self._slot_pages.get(slot)
        if pages is not None:
            keep = min(max(-(-n_tokens // self.page_size), 1),
                       self.pages_per_slot)
            while len(pages) > keep:
                pid = pages.pop()
                if not GARBAGE_PAGE < pid < self.n_pages:
                    raise ValueError(
                        f"rollback({slot}): page {pid} is not raw: only "
                        f"pages allocated by the current verify window can "
                        f"be rolled back")
                cache["page_table"][slot, len(pages)] = GARBAGE_PAGE
                self._decref(pid)
        cache["cur_len"][slot] = n_tokens
        return cache

    def release(self, cache: dict, slot: int):
        """Free a finished slot's raw pages, cold-pool entries and swapped
        pages back to the free lists / swap store that own the ids."""
        for e in self._slot_pages.pop(slot, []):
            if e < 0:
                if self.swap is not None:
                    self.swap.discard(-e - 1)
            elif e >= self.n_pages:
                self._free_cold(e - self.n_pages)
            elif e != GARBAGE_PAGE:
                self._decref(e)     # shared prefix pages stay for the index
        self._skip.pop(slot, None)
        cache["page_table"][slot] = 0
        return cache

    # -- coded pages: host <-> device ----------------------------------------

    def _groups(self):
        """(paged position, 'k' or 'v') in the canonical sub-page order."""
        return [(name, kn) for name in self.paged_pos for kn in ("k", "v")]

    def _encode_host(self, subs) -> list:
        """Entropy-code sub-pages on the host -> [(name, kn, u,
        CompressedPage)] in the canonical order (each paged position's K
        units, then its V units).  ``subs`` maps (name, kn) -> one page of
        every unit, (U, n_kv, ps, hd), on the host."""
        t0 = time.perf_counter()
        out = [(name, kn, u, codec.encode_page(subs[name, kn][u]))
               for name, kn in self._groups() for u in range(self.n_units)]
        self.encode_seconds += time.perf_counter() - t0
        return out

    def _install_cold(self, cache: dict, cs: int, entries) -> None:
        """Write coded sub-pages (``SwapEntry``-like: name, kn, u, payload,
        signmant, tables, perm) into cold slot ``cs``, payloads zero-padded
        to the stride budget; one host->device copy per leaf.  Only a rank
        that holds the slot's shard calls it."""
        row = self._crow(cs)
        for name, kn in self._groups():
            leaves = cache["units"][name]
            mine = [e for e in entries if (e.name, e.kn) == (name, kn)]
            pay = np.zeros((self.n_units, self.stride_budget, LANES),
                           np.uint8)
            for e in mine:
                pay[e.u, : e.payload.shape[0]] = e.payload
            host = {"cpl": pay,
                    "csm": np.stack([e.signmant for e in mine]),
                    "ctab": np.stack([e.tables for e in mine]),
                    "cperm": np.stack([e.perm for e in mine])}
            for c, arr in host.items():
                leaves[f"{kn}_{c}"][:, row] = torch.from_numpy(arr).to(
                    self.device)

    def _raw_page_host(self, cache: dict, pid: int) -> dict:
        row = self._row(pid)
        return {(name, kn): cache["units"][name][f"{kn}_pool"][:, row].cpu()
                for name, kn in self._groups()}

    # -- swap tier (hot/cold -> host, see kvcache/swap.py) -----------------

    def attach_swap(self, store) -> None:
        """Wire a :class:`swap.SwapStore` as the host tier; ``evict`` /
        ``fault`` require one."""
        self.swap = store

    def has_swapped(self, slot: int) -> bool:
        return any(e < 0 for e in self._slot_pages.get(slot, ()))

    def resident_raw_pages(self, slot: int) -> int:
        """Raw pool pages the slot currently holds (what preempting it
        would hand back to the free list; cold and swapped entries free
        cold slots / swap bytes instead)."""
        return sum(1 for e in self._slot_pages.get(slot, ())
                   if GARBAGE_PAGE < e < self.n_pages)

    def n_swapped(self, slot: int) -> int:
        return sum(1 for e in self._slot_pages.get(slot, ()) if e < 0)

    def _encode_raw_page(self, cache: dict, pid: int, sh: int
                         ) -> SwappedPage:
        """Entropy-code one raw pool page of shard ``sh`` into a host
        SwappedPage.  A rank that does not hold the shard keeps an entry-less
        page of the holder's byte count (the swap ledger is every rank's)."""
        page = SwappedPage(was_cold=False)
        if self._holds_shard(sh):
            for name, kn, u, cp in self._encode_host(
                    self._raw_page_host(cache, pid)):
                page.entries.append(SwapEntry(name, kn, u, cp.payload,
                                              cp.signmant, cp.tables(),
                                              cp.perm))
                page.nbytes += cp.nbytes()
        page.nbytes = self._share([page.nbytes], sh)[0]
        return page

    def _copy_cold_page(self, cache: dict, cslot: int, sh: int
                        ) -> SwappedPage:
        """Copy an already-coded cold page's container to the host (the
        cheap, cold-first eviction path: no re-encode); entry-less on a rank
        that does not hold shard ``sh``."""
        page = SwappedPage(was_cold=True,
                           nbytes=self._cold_bytes.get(cslot, 0))
        if not self._holds_shard(sh):
            return page
        row = self._crow(cslot)
        for name, kn in self._groups():
            leaves = cache["units"][name]
            # a copy even on the CPU: the cold slot is reused at once
            host = [leaves[f"{kn}_{c}"][:, row].to("cpu", copy=True)
                    .numpy() for c in _COLD]
            for u in range(self.n_units):
                page.entries.append(SwapEntry(name, kn, u,
                                              *(h[u] for h in host)))
        return page

    def evict(self, cache: dict, slot: int, page_idxs=None):
        """Swap the slot's device-resident pages out to the host store.

        Cold pages go first (their container copies without re-encoding);
        raw pages are entropy-coded on the host — losslessly for *any* bit
        content, so even a half-written tail page round-trips bit-exactly.
        Freed raw pages / cold slots return to their free lists; the page
        list and page-table entries become negative swap sentinels
        (``-(key + 1)``)."""
        if self.swap is None:
            raise RuntimeError("evict() needs attach_swap(SwapStore)")
        pages = self._slot_pages.get(slot)
        if pages is None:
            return cache
        sh = self.shard_of_slot(slot)
        idxs = list(range(len(pages))) if page_idxs is None else list(page_idxs)
        # cold-first: already-compressed pages are the cheapest victims
        idxs.sort(key=lambda p: (pages[p] < self.n_pages, p))
        t0 = time.perf_counter()
        n_moved = 0
        for p in idxs:
            e = pages[p]
            if e < 0 or e == GARBAGE_PAGE:
                continue
            if e >= self.n_pages:
                cs = e - self.n_pages
                key = self.swap.put(self._copy_cold_page(cache, cs, sh),
                                    shard=sh)
                self._free_cold(cs)
            else:
                # a shared page gets a *private* swap copy and a decref:
                # the prefix index keeps its own (still resident) reference
                key = self.swap.put(self._encode_raw_page(cache, e, sh),
                                    shard=sh)
                self._decref(e)
            pages[p] = -(key + 1)
            cache["page_table"][slot, p] = -(key + 1)
            n_moved += 1
        if n_moved and self.telemetry is not None:
            self.telemetry.registry.counter(
                "kvcache_evict_pages_total").inc(n_moved)
            if self.telemetry.tracer is not None:
                self.telemetry.tracer.complete(
                    "swap", "evict", "engine", t0,
                    args={"slot": slot, "pages": n_moved})
        return cache

    def fault(self, cache: dict, slot: int, page_idxs=None):
        """Restore the slot's swapped pages to the device (the inverse of
        :func:`evict`; a no-op when nothing is swapped).

        Cold-swapped pages reinstall their coded container into a fresh
        cold slot (never decoded); raw-swapped pages are **batch-decoded
        through the page-decode kernel** (``ops.decode_pages``) into fresh
        raw pages.  Raises :class:`OutOfPages` — before any state is
        mutated — if the slot's shard cannot cover the restore.  Only the
        ranks holding the shard write device rows."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            return cache
        idxs = [p for p in (range(len(pages)) if page_idxs is None
                            else page_idxs) if pages[p] < 0]
        if not idxs:
            return cache
        sh = self.shard_of_slot(slot)
        mine = self._holds_shard(sh)
        free = self._free[sh]
        # placement plan (peek only): cold-swapped pages take cold slots
        # while they last, everything else needs a raw page
        plan = []                       # (p, SwappedPage, to_cold)
        cold_budget = len(self._cold_free[sh]) if self.compress else 0
        raw_need = 0
        for p in idxs:
            sp = self.swap.peek(-pages[p] - 1)
            to_cold = sp.was_cold and cold_budget > 0
            cold_budget -= int(to_cold)
            raw_need += int(not to_cold)
            plan.append((p, sp, to_cold))
        if raw_need > len(free):
            cache = self._reclaim_prefix(cache, raw_need - len(free))
        if raw_need > len(free):
            raise OutOfPages(
                f"shard {sh}: faulting {len(idxs)} swapped pages of slot "
                f"{slot} needs {raw_need} raw pages, {len(free)} free")

        t0 = time.perf_counter()
        raw_jobs = []                   # (entry, pid) scattered after decode
        for p, sp, to_cold in plan:
            key = -pages[p] - 1
            origin = self.swap.shard_of(key)
            self.swap.pop(key)
            entries = sp.entries
            if origin != sh:
                # the request resumes on another shard than it left: the
                # coded arrays move from the ranks that evicted them
                entries = self._share(
                    entries if self._holds_shard(origin) else None, origin)
                self.n_moved_pages += 1
            if to_cold:
                cs = self._cold_free[sh].pop()
                if mine:
                    self._install_cold(cache, cs, entries)
                self._cold_bytes[cs] = sp.nbytes
                entry = self.n_pages + cs
            else:
                pid = self._alloc_raw(sh)
                if mine:
                    raw_jobs.extend((ent, pid) for ent in entries)
                entry = pid
            pages[p] = entry
            cache["page_table"][slot, p] = entry
        if any(not to_cold for *_, to_cold in plan):
            self._restore_raw(cache, raw_jobs)
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "kvcache_fault_pages_total").inc(len(plan))
            if self.telemetry.tracer is not None:
                self.telemetry.tracer.complete(
                    "swap", "fault", "engine", t0,
                    args={"slot": slot, "pages": len(plan)})
        return cache

    def _restore_raw(self, cache: dict, jobs) -> None:
        """Batch-decode swapped sub-pages and scatter them into the raw
        pool: one ``ops.decode_pages`` call covers every sub-page of every
        page being faulted (stride padded to the batch max, rounded up to
        a multiple of 4 as the reference buckets its shapes).  ``jobs`` is
        empty on a rank that does not hold the pages' shard: the call is
        counted, nothing is decoded there."""
        self.n_fault_decodes += 1
        if not jobs:
            return
        stride = max(e.payload.shape[0] for e, _ in jobs)
        stride = -(-stride // 4) * 4
        pay = np.zeros((len(jobs), stride, LANES), np.uint8)
        for i, (e, _) in enumerate(jobs):
            pay[i, : e.payload.shape[0]] = e.payload
        dev = self.device
        dec = ops.decode_pages(
            torch.from_numpy(pay).to(dev),
            torch.from_numpy(np.stack([e.signmant for e, _ in jobs])).to(dev),
            torch.from_numpy(np.stack([e.tables for e, _ in jobs])).to(dev),
            torch.from_numpy(np.stack([e.perm for e, _ in jobs])).to(dev),
            n_elem=self.page_elems, dtype_name=self.dtype_name, path="fault")
        dec = dec.view(len(jobs), self.cfg.n_kv_heads, self.page_size,
                       self.cfg.hd)
        for name, kn in self._groups():
            rows = [i for i, (e, _) in enumerate(jobs)
                    if (e.name, e.kn) == (name, kn)]
            u = torch.tensor([jobs[i][0].u for i in rows], device=dev)
            pid = torch.tensor([self._row(jobs[i][1]) for i in rows],
                               device=dev)
            cache["units"][name][f"{kn}_pool"][u, pid] = dec[
                torch.tensor(rows, device=dev)]

    def snapshot_slot_state(self, cache: dict, slot: int) -> dict:
        """Host copies of the slot's non-paged per-slot cache state: the
        rings of its ``local`` layers and the states of its recurrent ones,
        which hold no page ids and would be overwritten by the next request
        admitted to the slot.  Preemption stashes them with this and
        reinstalls them with :func:`restore_slot_state` on resume ->
        {(group key, leaf name): the slot's row, a host tensor} (the key
        is a pattern position ``pos<j>`` or a tail layer ``layer<t>``),
        empty for a stack that only pages."""
        return {(key, kn): leaf.select(
                    1 if section == "units" else 0, slot).to("cpu",
                                                             copy=True)
                for section, key in self.state_groups
                for kn, leaf in cache[section][key].items()}

    def swap_shard(self, pages) -> int | None:
        """The batch shard a preempted slot's swapped ``pages`` left (None
        without one): whose ranks hold its coded pages and its
        :func:`snapshot_slot_state`."""
        return self.swap.shard_of(-pages[0] - 1) if pages else None

    def restore_slot_state(self, cache: dict, slot: int, snap: dict,
                           origin: int | None = None) -> dict:
        """Inverse of :func:`snapshot_slot_state`, in place (bit-exact: the
        state never leaves its dtype).  ``origin``: the shard the snapshot
        was taken on; when the slot lies on another, the snapshot moves
        from ``origin``'s first rank (only its ranks held the rows)."""
        sh = self.shard_of_slot(slot)
        if origin is not None and origin != sh:
            snap = self._share(snap if self._holds_shard(origin) else None,
                               origin)
        section = {key: sec for sec, key in self.state_groups}
        for (key, kn), host in snap.items():
            sec = section[key]
            cache[sec][key][kn].select(1 if sec == "units" else 0,
                                       slot).copy_(host)
        return cache

    def detach_slot(self, slot: int):
        """Pop a preempted slot's host state -> (page list, skip set).

        Every entry must already be swapped (call :func:`evict` first);
        the engine stashes the result in its preemption record and
        reinstalls it with :func:`attach_slot` on resume."""
        pages = self._slot_pages.pop(slot)
        if any(e >= 0 for e in pages):
            raise RuntimeError(
                f"detach_slot({slot}): resident pages remain {pages}")
        return pages, self._skip.pop(slot, set())

    def attach_slot(self, cache: dict, slot: int, pages, skip):
        """Reinstall a preempted slot's page list (all swap sentinels) and
        page-table row; follow with :func:`fault` to make it resident."""
        self._slot_pages[slot] = list(pages)
        self._skip[slot] = set(skip)
        row = torch.zeros(self.pages_per_slot, dtype=torch.int32)
        row[: len(pages)] = torch.tensor(pages, dtype=torch.int32)
        cache["page_table"][slot] = row.to(self.device)
        return cache

    # -- cross-request prefix sharing --------------------------------------

    def enable_prefix_sharing(self) -> None:
        """Attach a :class:`PrefixIndex`, so requests with a common
        page-aligned prompt prefix share one physical copy of its pages
        (copy-on-write protected).  Single-shard only, as the reference's:
        page ids are shard-local, so a prefix cached by one shard would be
        unreachable from another's slots."""
        if self.n_shards != 1:
            raise ValueError(
                f"prefix sharing requires n_shards == 1 (got "
                f"{self.n_shards}): pages are shard-local and slots must "
                f"gather only their own shard's pages")
        if self.prefix is None:
            self.prefix = PrefixIndex()

    def _prefix_key(self, prompt, i: int) -> tuple:
        """Content address of prompt block ``i``: the token ids of blocks
        ``0..i``.  Keys are prefix-closed — block ``i``'s K/V is determined
        by (and only by) the tokens in the key, so equal keys imply
        bit-identical page content."""
        return tuple(prompt[: (i + 1) * self.page_size])

    def match_prefix(self, prompt) -> int:
        """Longest index-resident prefix of ``prompt``, in tokens (a
        multiple of ``page_size``).

        Capped at ``(len(prompt) - 1) // page_size`` blocks so the final
        prompt token is always prefilled (it gives the first token's
        logits) and the first unmatched write lands exactly on the match
        boundary: writes never land inside a matched page.  Swap-retired
        entries whose page the store has since evicted drop out of the
        index here."""
        if self.prefix is None or not len(prompt):
            return 0
        n = 0
        for i in range((len(prompt) - 1) // self.page_size):
            key = self._prefix_key(prompt, i)
            ent = self.prefix.get(key)
            if ent is None:
                break
            if ent < 0 and (self.swap is None
                            or not self.swap.contains(-ent - 1)):
                self.prefix.drop(key)
                break
            n += 1
        return n * self.page_size

    def match_page_cost(self, prompt) -> int:
        """Raw pages that adopting ``prompt``'s index match takes from the
        headroom the scheduler counts (free pages plus index-only pages): a
        swap-retired block faults back into a fresh page, and a resident
        index-only block stops being reclaimable once the slot co-holds it.
        The reference's fit test leaves this out, so an admission it passes
        can run out of pages inside ``admit_shared``."""
        if self.prefix is None:
            return 0
        cost = 0
        for i in range(self.match_prefix(prompt) // self.page_size):
            ent = self.prefix.get(self._prefix_key(prompt, i))
            cost += ent < 0 or self._ref.get(ent, 0) == 1
        return cost

    def admit_shared(self, cache: dict, slot: int, prompt, extra: int):
        """Admit a chunked-prefill slot against the prefix index ->
        ``(cache, matched_tokens)``.

        Matched raw pages are increffed (the slot becomes a co-holder of
        the same physical page); matched swap-retired pages are faulted
        back bit-exactly (one batched page decode, ``_restore_raw``) into
        fresh raw pages that the index adopts again; ``extra`` fresh pages
        cover the unmatched suffix.  ``cur_len[slot]`` starts at
        ``matched_tokens``, where the slot's first prefill chunk begins."""
        ps = self.page_size
        shared: list[int] = []
        raw_jobs = []               # (SwapEntry, pid) for _restore_raw
        n_faulted = 0
        t0 = time.perf_counter()
        if self.prefix is not None:
            for i in range((len(prompt) - 1) // ps if len(prompt) else 0):
                key = self._prefix_key(prompt, i)
                ent = self.prefix.get(key)
                if ent is None:
                    break
                if ent < 0:
                    k = -ent - 1
                    if self.swap is None or not self.swap.contains(k):
                        self.prefix.drop(key)
                        break
                    if not self._free[0]:
                        cache = self._reclaim_prefix(cache, 1)
                    if not self._free[0]:
                        break       # match shrinks; the suffix is prefilled
                    sp = self.swap.pop(k)
                    ent = self._alloc_raw(0)         # the index's reference
                    raw_jobs.extend((e, ent) for e in sp.entries)
                    self.prefix.put(key, ent)
                    n_faulted += 1
                self._incref(ent)                   # the slot's reference
                self.prefix.touch(key)
                shared.append(ent)
        if raw_jobs:
            self._restore_raw(cache, raw_jobs)

        extra = max(min(extra, self.pages_per_slot - len(shared)), 0)
        if len(self._free[0]) < extra:
            cache = self._reclaim_prefix(cache, extra - len(self._free[0]))
        if len(self._free[0]) < extra:
            for pid in shared:      # undo: the admission failed whole
                self._decref(pid)
            raise OutOfPages(f"slot {slot} needs {extra} pages past its "
                             f"shared prefix, {len(self._free[0])} free")
        pids = [self._alloc_raw(0) for _ in range(extra)]
        self._slot_pages[slot] = shared + pids
        self._skip[slot] = set()
        cache["page_table"][slot] = 0
        if shared or pids:
            cache["page_table"][slot, :len(shared) + extra] = torch.tensor(
                shared + pids, dtype=torch.int32, device=self.device)
        cache["cur_len"][slot] = len(shared) * ps
        if n_faulted and self.telemetry is not None:
            self.telemetry.registry.counter(
                "kvcache_fault_pages_total").inc(n_faulted)
            if self.telemetry.tracer is not None:
                self.telemetry.tracer.complete(
                    "swap", "prefix_fault", "engine", t0,
                    args={"slot": slot, "pages": n_faulted})
        return cache, len(shared) * ps

    def register_prefix(self, slot: int, prompt, n_tokens: int) -> None:
        """Publish the slot's fully prefilled, page-aligned prompt blocks
        into the index (after each prefill chunk).

        Caps at ``len(prompt) // page_size`` blocks: a full prompt block is
        never written again (the first decode write lands at position
        ``len(prompt)``, in a later block), so published pages are
        immutable while referenced.  A block whose content is already
        indexed keeps the incumbent copy (LRU-touched, not replaced)."""
        if self.prefix is None:
            return
        pages = self._slot_pages.get(slot)
        if pages is None:
            return
        nb = min(min(n_tokens, len(prompt)) // self.page_size, len(pages))
        for i in range(nb):
            pid = pages[i]
            if not GARBAGE_PAGE < pid < self.n_pages:
                continue            # cold/swapped entries are not shareable
            key = self._prefix_key(prompt, i)
            if self.prefix.get(key) is not None:
                self.prefix.touch(key)
                continue
            self.prefix.put(key, pid)
            self._incref(pid)

    def make_writable(self, cache: dict, slot: int, lo: int, hi: int):
        """Copy-on-write guard: split any shared raw page of ``slot``
        covering positions ``[lo, hi]`` into a private copy before a write
        lands there.  The copy (every layer's K and V) and the page-table
        update are issued before the caller's write, in stream order.

        Block-aligned matching makes a split unreachable on the normal path
        (writes start at the match boundary and full prompt blocks are
        never rewritten), so this is a safety invariant; ``n_cow_splits``
        counts actual splits."""
        pages = self._slot_pages.get(slot)
        if pages is None or self.prefix is None:
            return cache
        ps = self.page_size
        for p in range(lo // ps, min(hi // ps, len(pages) - 1) + 1):
            pid = pages[p]
            if (not GARBAGE_PAGE < pid < self.n_pages
                    or self._ref.get(pid, 1) <= 1):
                continue
            if not self._free[0]:
                cache = self._reclaim_prefix(cache, 1)
            if not self._free[0]:
                raise OutOfPages(f"CoW split of slot {slot} page {p} has no "
                                 f"free page")
            new = self._alloc_raw(0)
            for name, kn in self._groups():
                pool = cache["units"][name][f"{kn}_pool"]
                pool[:, self._row(new)] = pool[:, self._row(pid)]
            self._decref(pid)
            pages[p] = new
            cache["page_table"][slot, p] = new
            self.n_cow_splits += 1
        return cache

    def _reclaim_prefix(self, cache: dict, need: int):
        """Retire up to ``need`` index-only prefix pages (refcount 1: no
        slot co-holds them), least recently matched first.  With a swap
        store each page is entropy-coded into the store's **unpinned** LRU
        prefix cache (it faults back bit-exactly on the next match); when
        the store cannot hold it, or there is no store, the entry is
        dropped.  Either way the raw page frees, so every allocation site
        can treat index-only pages as reclaimable headroom."""
        if self.prefix is None or need <= 0:
            return cache
        freed = 0
        for key in self.prefix.lru_keys():
            if freed >= need:
                break
            ent = self.prefix.get(key)
            if ent is None or ent < 0 or self._ref.get(ent, 1) != 1:
                continue
            k = None
            if self.swap is not None:
                t0 = time.perf_counter()
                sp = self._encode_raw_page(cache, ent, 0)
                self.retire_seconds += time.perf_counter() - t0
                k = self.swap.put(sp, pinned=False)
            if k is not None:
                self.prefix.put(key, -(k + 1))      # keeps LRU position
                self.n_prefix_retired += 1
            else:
                self.prefix.drop(key)
                self.n_prefix_dropped += 1
            self._decref(ent)
            freed += 1
        return cache

    def reclaimable_pages(self, shard: int = 0) -> int:
        """Raw pages of ``shard`` held only by the prefix index (refcount
        1): on-demand headroom the scheduler counts as available when
        sizing admission."""
        if self.prefix is None:
            return 0
        return sum(1 for e in self.prefix.entries()
                   if e > 0 and e // self.pages_per_shard == shard
                   and self._ref.get(e, 0) == 1)

    def n_shared_pages(self) -> int:
        """Raw index pages currently co-held by at least one slot."""
        if self.prefix is None:
            return 0
        return sum(1 for e in self.prefix.entries()
                   if e > 0 and self._ref.get(e, 0) > 1)

    # -- cold compression --------------------------------------------------

    def compress_cold_pages(self, cache: dict, slot: int, pos: int):
        """Entropy-code the slot's full (non-tail) pages into the cold pool.

        ``pos`` is the next write position; pages strictly below
        ``pos // page_size`` are complete and never written again."""
        if not self.compress or slot not in self._slot_pages:
            return cache
        sh = self.shard_of_slot(slot)
        pages = self._slot_pages[slot]
        full = min(pos // self.page_size, len(pages))
        for p in range(full):
            # shared prefix pages (refcount > 1) stay raw: compressing the
            # slot's copy would duplicate a page other holders still gather
            if (pages[p] >= self.n_pages or p in self._skip[slot]
                    or self._ref.get(pages[p], 1) > 1):
                continue
            if not self._cold_free[sh]:
                return cache
            if not self._compress_one(cache, slot, p):
                self._skip[slot].add(p)
        return cache

    def _compress_one(self, cache: dict, slot: int, p: int) -> bool:
        """Move page ``p`` of ``slot`` into a cold slot; False (and no
        change) when a sub-page's stream exceeds the stride budget.  The
        ranks holding the slot's shard encode the page; whether it fits and
        its coded bytes reach every rank through ``share``."""
        sh = self.shard_of_slot(slot)
        pid = self._slot_pages[slot][p]
        enc = []
        if self._holds_shard(sh):
            enc = self._encode_host(self._raw_page_host(cache, pid))
        fits, nbytes = self._share(
            [int(all(cp.stride <= self.stride_budget for *_, cp in enc)),
             sum(cp.nbytes() for *_, cp in enc)], sh)
        if not fits:
            return False                # incompressible: stay raw
        cslot = self._cold_free[sh].pop()
        if enc:
            self._install_cold(cache, cslot, [
                SwapEntry(name, kn, u, cp.payload, cp.signmant, cp.tables(),
                          cp.perm)
                for name, kn, u, cp in enc])
        entry = self.n_pages + cslot
        self._slot_pages[slot][p] = entry
        cache["page_table"][slot, p] = entry
        self._decref(pid)
        self._cold_bytes[cslot] = nbytes
        self.n_compressed += 1
        self.compressed_bytes += self._cold_bytes[cslot]
        return True

    # -- accounting --------------------------------------------------------

    def stats(self) -> dict:
        """Live memory accounting (bytes; 'raw_equiv' = the same pages kept
        uncompressed, 'monolithic' = the replaced ``(max_batch, max_len)``
        cache).  Host bookkeeping only: no tensor is read."""
        # physical accounting: with prefix sharing a pid can appear in
        # several slots' page lists (and in the index with no slot at all)
        # but occupies device memory once
        raw_phys = {e for pages in self._slot_pages.values() for e in pages
                    if GARBAGE_PAGE < e < self.n_pages}
        prefix_resident = prefix_only = 0
        if self.prefix is not None:
            for e in self.prefix.entries():
                if e > 0:
                    prefix_resident += 1
                    prefix_only += self._ref.get(e, 0) == 1
                    raw_phys.add(e)
        raw = len(raw_phys)
        cold = len(self._cold_bytes)
        swapped = sum(1 for pages in self._slot_pages.values()
                      for e in pages if e < 0)
        page_bytes = (self.n_attn_layers * 2 * self.page_elems
                      * torch.empty((), dtype=self.dtype).element_size())
        cold_ragged = sum(self._cold_bytes.values())
        per_shard = [0] * self.n_shards
        for slot, pages in self._slot_pages.items():
            per_shard[self.shard_of_slot(slot)] += sum(
                1 for e in pages if e > GARBAGE_PAGE)
        out = {
            "page_size": self.page_size,
            "n_shards": self.n_shards,
            "pages_in_use_per_shard": per_shard,
            "free_pages_per_shard": self.free_pages_per_shard,
            "pages_in_use": raw,
            "free_pages": self.free_pages,
            "cold_pages_in_use": cold,
            "swapped_pages": swapped,
            "page_bytes": page_bytes,
            "raw_bytes_in_use": raw * page_bytes,
            "cold_bytes_ragged": cold_ragged,
            "cold_bytes_uniform": cold * self.cold_slot_bytes,
            "cache_bytes_paged": raw * page_bytes + cold_ragged,
            "cache_bytes_raw_equiv": (raw + cold) * page_bytes,
            "monolithic_bytes": self.max_batch * self.pages_per_slot
            * page_bytes,
        }
        if self.prefix is not None:
            out.update({
                "prefix_index_blocks": len(self.prefix),
                "prefix_resident_blocks": prefix_resident,
                "prefix_reclaimable_pages": prefix_only,
                "prefix_shared_pages": self.n_shared_pages(),
                "prefix_retired_total": self.n_prefix_retired,
                "prefix_dropped_total": self.n_prefix_dropped,
                "prefix_cow_splits_total": self.n_cow_splits,
            })
        if self.swap is not None:
            out.update(self.swap.stats())
        return out
