"""Paged KV cache: fixed-size pages, per-slot page tables, free-list alloc,
the compressed cold pool and the host swap tier.

Every batch slot owns a list of fixed-size pages (``page_size`` token
positions x all KV heads); a shared ``(max_batch, pages_per_slot)`` page
table maps logical page index -> physical page id, identically for every
attention layer (one allocation decision serves the whole stack).  A short
request only holds the pages it wrote.

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

``page_write`` / ``page_write_chunk`` / ``page_gather`` are the tensor ops
of the decode step and the prefill chunk (``models.model``); the writes
update the pool in place, where the reference returns a new pool, and so do
the allocator's cache updates.
``PagedKVCache`` is the host-side allocator driven by ``serving.engine``
(admit or admit_slot -> ensure -> compress cold -> evict / fault ->
release), with the reference's descending free lists and page reference
counts.
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
PAGED_KINDS = ("attn", "nope")
_COLD = ("cpl", "csm", "ctab", "cperm")


class OutOfPages(RuntimeError):
    """Raised when the raw pool cannot cover a request's next page."""


# --------------------------------------------------------------------------
# tensor ops of the decode step
# --------------------------------------------------------------------------

def page_write(pool, page_table, cur_len, kv):
    """Scatter one new token's K (or V) into each slot's tail page, in place.

    pool: (n_pool, n_kv, ps, hd); page_table: (B, P) int page ids;
    cur_len: (B,) write positions; kv: (B, n_kv, 1, hd).  A row whose tail
    id is a swap sentinel (negative: a vacated slot's row, which no one
    reads) or lies past the raw pool (a cold id) is dropped, as the
    reference's ``mode="drop"`` scatter drops it; a negative index would
    otherwise count from the end of the pool and overwrite a live page.
    Dropped rows write the garbage page's own contents back, which keeps
    the scatter free of a host sync.  Returns pool."""
    n_pool, _, ps, _ = pool.shape
    P = page_table.shape[1]
    p_idx = (cur_len // ps).clamp(0, P - 1).long()
    off = (cur_len % ps).long()
    pids = page_table.gather(1, p_idx[:, None])[:, 0].long()
    keep = (pids >= 0) & (pids < n_pool)
    pids = torch.where(keep, pids, GARBAGE_PAGE)
    new = torch.where(keep[:, None, None], kv[:, :, 0, :].to(pool.dtype),
                      pool[pids, :, off, :])
    pool[pids, :, off, :] = new
    return pool


def page_write_chunk(pool, row, positions, kv, n_valid: int):
    """Scatter one prefill chunk's K (or V) into a single slot's pages, in
    place.

    pool: (n_pool, n_kv, ps, hd); row: (P,) page ids (the slot's page-table
    row); positions: (C,) absolute token positions of the chunk; kv: (1,
    n_kv, C, hd); n_valid: count of real (unpadded) tokens.  Padded tokens
    are dropped, and so is a position whose page id is a swap sentinel
    (negative) or a cold id (past the raw pool), as the reference's
    ``mode="drop"`` scatter drops them; a negative index would otherwise
    count from the end of the pool and overwrite a live page.  Dropped
    positions write the garbage page's own contents back, which keeps the
    scatter free of a host sync.  Returns pool."""
    n_pool, _, ps, _ = pool.shape
    P = row.shape[0]
    positions = positions[:n_valid]
    p_idx = (positions // ps).clamp(0, P - 1).long()
    off = (positions % ps).long()
    pids = row[p_idx].long()
    keep = (pids >= 0) & (pids < n_pool)
    pids = torch.where(keep, pids, GARBAGE_PAGE)
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


def page_gather(pool, page_table, cpool=None, path: str = "gather"):
    """Gather each slot's pages into a contiguous KV history.

    pool: (n_pool, n_kv, ps, hd); page_table: (B, P) ids into the
    *virtual* pool; cpool: optional :func:`cold_leaves` tuple.  Cold pages
    (ids >= n_pool) are entropy-decoded by the page-decode kernel and
    appended to the raw pool as a virtual suffix before the gather; ids
    are clipped, so garbage rows gather page 0 (their positions are masked
    by ``kv_len`` downstream).  ``path`` tags the page-decode launches.
    Returns (B, n_kv, P * ps, hd)."""
    n_kv, ps, hd = pool.shape[1:]
    virtual = pool
    if cpool is not None:
        dec = ops.decode_pages(*cpool, n_elem=n_kv * ps * hd,
                               dtype_name=codec.dtype_name(pool.dtype),
                               path=path)
        virtual = torch.cat([pool, dec.view(-1, n_kv, ps, hd)])
    ids = page_table.clamp(0, virtual.shape[0] - 1).long()
    gath = virtual[ids]                            # (B, P, n_kv, ps, hd)
    B, P = page_table.shape
    return gath.permute(0, 2, 1, 3, 4).reshape(B, n_kv, P * ps, hd)


# --------------------------------------------------------------------------
# host-side controller
# --------------------------------------------------------------------------

class PagedKVCache:
    """Allocator + lifecycle manager for the paged, compressible cache."""

    def __init__(self, cfg: ArchConfig, max_batch: int, max_len: int, *,
                 dtype, device="cuda", page_size: int = 16,
                 n_pages: int | None = None, compress_cold: bool = False,
                 n_cold_slots: int | None = None):
        """Args:
          cfg: architecture config; every layer must page ('attn'/'nope').
          max_batch/max_len: static engine batch shape; every slot can hold
            at most ``max_len`` tokens (``pages_per_slot`` pages).
          dtype: cache storage dtype (fp8 / bf16 / f32: a page-codec type).
          device: where the pools and the page table live.
          page_size: token positions per page; rounded down to a divisor of
            ``max_len``.
          n_pages: raw pool size (id 0 is the garbage page); defaults to
            the worst case (every slot full) plus the garbage page.
          compress_cold: entropy-code full pages into the cold pool.
          n_cold_slots: cold pool size (default: worst case minus one tail
            page per slot).
        """
        if any(cfg.layer_kind(i) not in PAGED_KINDS
               for i in range(cfg.n_layers)) or cfg.unit != 1:
            raise NotImplementedError(
                f"{cfg.name}: paging non-'attn' layers is not yet ported")
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
        self.n_pages = n_pages or (1 + max_batch * self.pages_per_slot)
        self.n_attn_layers = cfg.n_layers
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
        self.n_cold = ((n_cold_slots if n_cold_slots is not None
                        else default_cold) if self.compress else 0)
        # descending, so pop() hands out low ids first; excludes the
        # garbage page id 0
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._cold_free = list(range(self.n_cold - 1, -1, -1))
        self._slot_pages: dict[int, list[int]] = {}
        self._skip: dict[int, set[int]] = {}        # incompressible pages
        self._cold_bytes: dict[int, int] = {}       # cold slot -> bytes
        # physical-page reference counts (1 = private; prefix sharing,
        # which adds holders, is not yet ported)
        self._ref: dict[int, int] = {}
        self.swap = None                # SwapStore (attach_swap)
        # cumulative work of the coded tiers (launch/serve.py's report):
        # pages moved into the cold pool and their coded bytes, host
        # seconds in codec.encode_page, page-decode calls made by fault()
        self.n_compressed = self.compressed_bytes = 0
        self.encode_seconds = 0.0
        self.n_fault_decodes = 0

    def init_cache(self) -> dict:
        """The paged cache: per-layer page pools (and cold-pool leaves),
        per-slot timelines and the shared page table."""
        cfg, dev, L = self.cfg, self.device, self.cfg.n_layers
        pool = (L, self.n_pages, cfg.n_kv_heads, self.page_size, cfg.hd)
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
                        (L, self.n_cold) + shape, dtype=dt, device=dev)
        return {
            "units": {"pos0": leaves},
            "tail": {},
            "cur_len": torch.zeros((self.max_batch,), dtype=torch.int32,
                                   device=dev),
            "page_table": torch.zeros(
                (self.max_batch, self.pages_per_slot), dtype=torch.int32,
                device=dev),
        }

    # -- allocator ---------------------------------------------------------

    def _alloc_raw(self) -> int:
        """Pop a raw page off the free list with refcount 1."""
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def _decref(self, pid: int) -> None:
        """Drop one reference; the page frees only when nobody holds it."""
        n = self._ref.get(pid, 1) - 1
        if n <= 0:
            self._ref.pop(pid, None)
            self._free.append(pid)
        else:
            self._ref[pid] = n

    def _free_cold(self, cs: int) -> None:
        self._cold_free.append(cs)
        self._cold_bytes.pop(cs, None)

    @property
    def free_pages(self) -> int:
        return len(self._free)

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

    def shard_capacity(self, shard: int = 0) -> int:
        """Allocatable raw pages (all but the garbage page; the port keeps
        the reference's one-shard layout)."""
        return self.n_pages - 1

    # -- request lifecycle -------------------------------------------------

    def admit(self, cache: dict, slot: int, frag: dict, prompt_len: int):
        """Allocate a fresh slot's pages and copy its prefill fragment
        (``models.model.prefill``'s cache, batch 1) into them."""
        need = self.pages_needed(prompt_len)
        if len(self._free) < need:
            raise OutOfPages(f"slot {slot} needs {need} pages, "
                             f"{len(self._free)} free")
        pids = [self._alloc_raw() for _ in range(need)]
        self._slot_pages[slot] = pids
        self._skip[slot] = set()
        ids = torch.tensor(pids, dtype=torch.int64, device=self.device)
        cache["page_table"][slot] = 0
        cache["page_table"][slot, :need] = ids.to(torch.int32)
        cache["cur_len"][slot] = prompt_len
        dst, src = cache["units"]["pos0"], frag["units"]["pos0"]
        for kn in ("k", "v"):
            pages = self._frag_pages(src[kn])
            dst[f"{kn}_pool"][:, ids] = pages[:, :need].to(self.dtype)
        return cache

    def admit_slot(self, cache: dict, slot: int, need: int):
        """Allocate a fresh slot for chunked prefill: grant ``need`` pages
        (no fragment is copied: the chunks write their K/V with
        :func:`page_write_chunk`) and reset the slot's timeline to 0."""
        if len(self._free) < need:
            raise OutOfPages(f"slot {slot} needs {need} pages, "
                             f"{len(self._free)} free")
        pids = [self._alloc_raw() for _ in range(need)]
        self._slot_pages[slot] = pids
        self._skip[slot] = set()
        cache["page_table"][slot] = 0
        cache["page_table"][slot, :need] = torch.tensor(
            pids, dtype=torch.int32, device=self.device)
        cache["cur_len"][slot] = 0
        return cache

    def _frag_pages(self, x):
        """Prefill fragment (L, 1, n_kv, max_len, hd) -> (L, P, n_kv, ps, hd)."""
        cfg, ps, P = self.cfg, self.page_size, self.pages_per_slot
        x = x.reshape(cfg.n_layers, cfg.n_kv_heads, P, ps, cfg.hd)
        return x.permute(0, 2, 1, 3, 4)

    def ensure(self, cache: dict, slot: int, pos: int):
        """Grow the slot's page list to cover a write at ``pos``."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            return cache
        p = min(pos // self.page_size, self.pages_per_slot - 1)
        while len(pages) <= p:
            if not self._free:
                raise OutOfPages(f"slot {slot} needs page {len(pages)}")
            pid = self._alloc_raw()
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
        slot's next write overwrites it.  ``cur_len[slot]`` is set to
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
                self._decref(e)
        self._skip.pop(slot, None)
        cache["page_table"][slot] = 0
        return cache

    # -- coded pages: host <-> device ----------------------------------------

    def _encode_host(self, subs) -> list:
        """Entropy-code sub-pages on the host -> [(kn, u, CompressedPage)]
        in the canonical order (K layers, then V layers).  ``subs`` maps
        kn -> one page of every layer, (L, n_kv, ps, hd), on the host."""
        t0 = time.perf_counter()
        out = [(kn, u, codec.encode_page(subs[kn][u]))
               for kn in ("k", "v") for u in range(self.cfg.n_layers)]
        self.encode_seconds += time.perf_counter() - t0
        return out

    def _install_cold(self, cache: dict, cs: int, entries) -> None:
        """Write coded sub-pages (``SwapEntry``-like: kn, u, payload,
        signmant, tables, perm) into cold slot ``cs``, payloads zero-padded
        to the stride budget; one host->device copy per leaf."""
        L = self.cfg.n_layers
        leaves = cache["units"]["pos0"]
        for kn in ("k", "v"):
            mine = [e for e in entries if e.kn == kn]
            pay = np.zeros((L, self.stride_budget, LANES), np.uint8)
            for e in mine:
                pay[e.u, : e.payload.shape[0]] = e.payload
            host = {"cpl": pay,
                    "csm": np.stack([e.signmant for e in mine]),
                    "ctab": np.stack([e.tables for e in mine]),
                    "cperm": np.stack([e.perm for e in mine])}
            for c, arr in host.items():
                leaves[f"{kn}_{c}"][:, cs] = torch.from_numpy(arr).to(
                    self.device)

    def _raw_page_host(self, cache: dict, pid: int) -> dict:
        pools = cache["units"]["pos0"]
        return {kn: pools[f"{kn}_pool"][:, pid].cpu() for kn in ("k", "v")}

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

    def _encode_raw_page(self, cache: dict, pid: int) -> SwappedPage:
        """Entropy-code one raw pool page into a host SwappedPage."""
        page = SwappedPage(was_cold=False)
        for kn, u, cp in self._encode_host(self._raw_page_host(cache, pid)):
            page.entries.append(SwapEntry(kn, u, cp.payload, cp.signmant,
                                          cp.tables(), cp.perm))
            page.nbytes += cp.nbytes()
        return page

    def _copy_cold_page(self, cache: dict, cslot: int) -> SwappedPage:
        """Copy an already-coded cold page's container to the host (the
        cheap, cold-first eviction path: no re-encode)."""
        leaves = cache["units"]["pos0"]
        page = SwappedPage(was_cold=True,
                           nbytes=self._cold_bytes.get(cslot, 0))
        for kn in ("k", "v"):
            # a copy even on the CPU: the cold slot is reused at once
            host = [leaves[f"{kn}_{c}"][:, cslot].to("cpu", copy=True)
                    .numpy() for c in _COLD]
            for u in range(self.cfg.n_layers):
                page.entries.append(SwapEntry(kn, u, *(h[u] for h in host)))
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
        idxs = list(range(len(pages))) if page_idxs is None else list(page_idxs)
        # cold-first: already-compressed pages are the cheapest victims
        idxs.sort(key=lambda p: (pages[p] < self.n_pages, p))
        for p in idxs:
            e = pages[p]
            if e < 0 or e == GARBAGE_PAGE:
                continue
            if e >= self.n_pages:
                cs = e - self.n_pages
                key = self.swap.put(self._copy_cold_page(cache, cs))
                self._free_cold(cs)
            else:
                key = self.swap.put(self._encode_raw_page(cache, e))
                self._decref(e)
            pages[p] = -(key + 1)
            cache["page_table"][slot, p] = -(key + 1)
        return cache

    def fault(self, cache: dict, slot: int, page_idxs=None):
        """Restore the slot's swapped pages to the device (the inverse of
        :func:`evict`; a no-op when nothing is swapped).

        Cold-swapped pages reinstall their coded container into a fresh
        cold slot (never decoded); raw-swapped pages are **batch-decoded
        through the page-decode kernel** (``ops.decode_pages``) into fresh
        raw pages.  Raises :class:`OutOfPages` — before any state is
        mutated — if the free list cannot cover the restore."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            return cache
        idxs = [p for p in (range(len(pages)) if page_idxs is None
                            else page_idxs) if pages[p] < 0]
        if not idxs:
            return cache
        # placement plan (peek only): cold-swapped pages take cold slots
        # while they last, everything else needs a raw page
        plan = []                       # (p, SwappedPage, to_cold)
        cold_budget = len(self._cold_free) if self.compress else 0
        raw_need = 0
        for p in idxs:
            sp = self.swap.peek(-pages[p] - 1)
            to_cold = sp.was_cold and cold_budget > 0
            cold_budget -= int(to_cold)
            raw_need += int(not to_cold)
            plan.append((p, sp, to_cold))
        if raw_need > len(self._free):
            raise OutOfPages(
                f"faulting {len(idxs)} swapped pages of slot {slot} needs "
                f"{raw_need} raw pages, {len(self._free)} free")

        raw_jobs = []                   # (entry, pid) scattered after decode
        for p, sp, to_cold in plan:
            self.swap.pop(-pages[p] - 1)
            if to_cold:
                cs = self._cold_free.pop()
                self._install_cold(cache, cs, sp.entries)
                self._cold_bytes[cs] = sp.nbytes
                entry = self.n_pages + cs
            else:
                pid = self._alloc_raw()
                raw_jobs.extend((ent, pid) for ent in sp.entries)
                entry = pid
            pages[p] = entry
            cache["page_table"][slot, p] = entry
        if raw_jobs:
            self._restore_raw(cache, raw_jobs)
        return cache

    def _restore_raw(self, cache: dict, jobs) -> None:
        """Batch-decode swapped sub-pages and scatter them into the raw
        pool: one ``ops.decode_pages`` call covers every sub-page of every
        page being faulted (stride padded to the batch max, rounded up to
        a multiple of 4 as the reference buckets its shapes)."""
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
        self.n_fault_decodes += 1
        dec = dec.view(len(jobs), self.cfg.n_kv_heads, self.page_size,
                       self.cfg.hd)
        pools = cache["units"]["pos0"]
        for kn in ("k", "v"):
            rows = [i for i, (e, _) in enumerate(jobs) if e.kn == kn]
            u = torch.tensor([jobs[i][0].u for i in rows], device=dev)
            pid = torch.tensor([jobs[i][1] for i in rows], device=dev)
            pools[f"{kn}_pool"][u, pid] = dec[torch.tensor(rows, device=dev)]

    def snapshot_slot_state(self, cache: dict, slot: int) -> dict:
        """Host copies of the slot's non-paged per-slot cache state, which
        preemption would have to carry across: none, since every layer the
        port serves pages (the constructor refuses any other)."""
        return {}

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

    # -- cold compression --------------------------------------------------

    def compress_cold_pages(self, cache: dict, slot: int, pos: int):
        """Entropy-code the slot's full (non-tail) pages into the cold pool.

        ``pos`` is the next write position; pages strictly below
        ``pos // page_size`` are complete and never written again."""
        if not self.compress or slot not in self._slot_pages:
            return cache
        pages = self._slot_pages[slot]
        full = min(pos // self.page_size, len(pages))
        for p in range(full):
            if pages[p] >= self.n_pages or p in self._skip[slot]:
                continue
            if not self._cold_free:
                return cache
            if not self._compress_one(cache, slot, p):
                self._skip[slot].add(p)
        return cache

    def _compress_one(self, cache: dict, slot: int, p: int) -> bool:
        """Move page ``p`` of ``slot`` into a cold slot; False (and no
        change) when a sub-page's stream exceeds the stride budget."""
        pid = self._slot_pages[slot][p]
        enc = self._encode_host(self._raw_page_host(cache, pid))
        if any(cp.stride > self.stride_budget for _, _, cp in enc):
            return False                # incompressible: stay raw
        cslot = self._cold_free.pop()
        self._install_cold(cache, cslot, [
            SwapEntry(kn, u, cp.payload, cp.signmant, cp.tables(), cp.perm)
            for kn, u, cp in enc])
        entry = self.n_pages + cslot
        self._slot_pages[slot][p] = entry
        cache["page_table"][slot, p] = entry
        self._decref(pid)
        self._cold_bytes[cslot] = sum(cp.nbytes() for _, _, cp in enc)
        self.n_compressed += 1
        self.compressed_bytes += self._cold_bytes[cslot]
        return True

    # -- accounting --------------------------------------------------------

    def stats(self) -> dict:
        """Live memory accounting (bytes; 'raw_equiv' = the same pages kept
        uncompressed, 'monolithic' = the replaced ``(max_batch, max_len)``
        cache)."""
        raw = len({e for pages in self._slot_pages.values() for e in pages
                   if GARBAGE_PAGE < e < self.n_pages})
        cold = len(self._cold_bytes)
        swapped = sum(1 for pages in self._slot_pages.values()
                      for e in pages if e < 0)
        page_bytes = (self.n_attn_layers * 2 * self.page_elems
                      * torch.empty((), dtype=self.dtype).element_size())
        cold_ragged = sum(self._cold_bytes.values())
        out = {
            "page_size": self.page_size,
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
        if self.swap is not None:
            out.update(self.swap.stats())
        return out
