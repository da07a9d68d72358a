"""Paged KV cache: fixed-size pages, per-slot page tables, free-list alloc.

Every batch slot owns a list of fixed-size pages (``page_size`` token
positions x all KV heads); a shared ``(max_batch, pages_per_slot)`` page
table maps logical page index -> physical page id, identically for every
attention layer (one allocation decision serves the whole stack).  A short
request only holds the pages it wrote.

Physical id space (the port has no cold pool or swap tier yet):
  * id 0 is the **garbage page** — inactive slots' table rows point at it
    so the batched decode step can scatter/gather unconditionally;
  * ids ``1 .. n_pages-1`` are raw pool pages.

``page_write`` / ``page_gather`` are the tensor ops of the decode step
(``models.model``); ``page_write`` updates the pool in place, where the
reference returns a new pool.  ``PagedKVCache`` is the host-side allocator
driven by ``serving.engine`` (admit -> ensure -> release), with the
reference's descending free list and page reference counts.
"""
from __future__ import annotations

import warnings

import torch

from ..configs.base import ArchConfig
from ..device import resolve

GARBAGE_PAGE = 0
PAGED_KINDS = ("attn", "nope")


class OutOfPages(RuntimeError):
    """Raised when the raw pool cannot cover a request's next page."""


# --------------------------------------------------------------------------
# tensor ops of the decode step
# --------------------------------------------------------------------------

def page_write(pool, page_table, cur_len, kv):
    """Scatter one new token's K (or V) into each slot's tail page, in place.

    pool: (n_pool, n_kv, ps, hd); page_table: (B, P) int page ids;
    cur_len: (B,) write positions; kv: (B, n_kv, 1, hd).  Returns pool."""
    ps = pool.shape[2]
    P = page_table.shape[1]
    p_idx = (cur_len // ps).clamp(0, P - 1).long()
    off = (cur_len % ps).long()
    pids = page_table.gather(1, p_idx[:, None])[:, 0].long()
    pool[pids, :, off, :] = kv[:, :, 0, :].to(pool.dtype)
    return pool


def page_gather(pool, page_table):
    """Gather each slot's pages into a contiguous KV history.

    pool: (n_pool, n_kv, ps, hd); page_table: (B, P) ids, clipped to the
    pool, so garbage rows gather page 0 (their positions are masked by
    ``kv_len`` downstream).  Returns (B, n_kv, P * ps, hd)."""
    n_kv, ps, hd = pool.shape[1:]
    ids = page_table.clamp(0, pool.shape[0] - 1).long()
    gath = pool[ids]                               # (B, P, n_kv, ps, hd)
    B, P = page_table.shape
    return gath.permute(0, 2, 1, 3, 4).reshape(B, n_kv, P * ps, hd)


# --------------------------------------------------------------------------
# host-side controller
# --------------------------------------------------------------------------

class PagedKVCache:
    """Allocator + lifecycle manager for the paged cache."""

    def __init__(self, cfg: ArchConfig, max_batch: int, max_len: int, *,
                 dtype, device="cuda", page_size: int = 16,
                 n_pages: int | None = None, compress_cold: bool = False):
        """Args:
          cfg: architecture config; every layer must page ('attn'/'nope').
          max_batch/max_len: static engine batch shape; every slot can hold
            at most ``max_len`` tokens (``pages_per_slot`` pages).
          dtype: cache storage dtype.
          device: where the pools and the page table live.
          page_size: token positions per page; rounded down to a divisor of
            ``max_len``.
          n_pages: raw pool size (id 0 is the garbage page); defaults to
            the worst case (every slot full) plus the garbage page.
          compress_cold: the compressed cold pool, not yet ported.
        """
        if compress_cold:
            raise NotImplementedError("compress_cold: not yet ported")
        if any(cfg.layer_kind(i) not in PAGED_KINDS
               for i in range(cfg.n_layers)) or cfg.unit != 1:
            raise NotImplementedError(
                f"{cfg.name}: paging non-'attn' layers is not yet ported")
        self.cfg = cfg
        self.device = resolve(device)
        self.max_batch, self.max_len = max_batch, max_len
        self.dtype = dtype
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
        # descending, so pop() hands out low ids first; excludes the
        # garbage page id 0
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._slot_pages: dict[int, list[int]] = {}
        # physical-page reference counts (1 = private; prefix sharing,
        # which adds holders, is not yet ported)
        self._ref: dict[int, int] = {}

    def init_cache(self) -> dict:
        """The paged cache: per-layer page pools, per-slot timelines and
        the shared page table."""
        cfg, dev = self.cfg, self.device
        pool = (cfg.n_layers, self.n_pages, cfg.n_kv_heads, self.page_size,
                cfg.hd)
        return {
            "units": {"pos0": {
                "k_pool": torch.zeros(pool, dtype=self.dtype, device=dev),
                "v_pool": torch.zeros(pool, dtype=self.dtype, device=dev)}},
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

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, prompt_len: int) -> int:
        """Pages to cover the prompt and the first decode write."""
        return min(prompt_len // self.page_size + 1, self.pages_per_slot)

    def can_admit(self, prompt_len: int) -> bool:
        return len(self._free) >= self.pages_needed(prompt_len)

    def pages_worst_case(self, prompt_len: int, max_new: int) -> int:
        """Pages the request can ever hold at once: its last cache write
        lands at position ``min(prompt+max_new, max_len) - 2`` (the final
        sampled token is never written), floored at ``prompt_len``."""
        last = max(min(prompt_len + max_new, self.max_len) - 2, prompt_len)
        return min(last // self.page_size + 1, self.pages_per_slot)

    def capacity(self) -> int:
        """Allocatable raw pages (all but the garbage page)."""
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
        ids = torch.tensor(pids, dtype=torch.int64, device=self.device)
        cache["page_table"][slot] = 0
        cache["page_table"][slot, :need] = ids.to(torch.int32)
        cache["cur_len"][slot] = prompt_len
        dst, src = cache["units"]["pos0"], frag["units"]["pos0"]
        for kn in ("k", "v"):
            pages = self._frag_pages(src[kn])
            dst[f"{kn}_pool"][:, ids] = pages[:, :need].to(self.dtype)
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

    def release(self, cache: dict, slot: int):
        """Free a finished slot's pages back to the free list."""
        for e in self._slot_pages.pop(slot, []):
            if e != GARBAGE_PAGE:
                self._decref(e)
        cache["page_table"][slot] = 0
        return cache

    # -- accounting --------------------------------------------------------

    def stats(self) -> dict:
        """Live memory accounting (bytes; 'monolithic' = the replaced
        ``(max_batch, max_len)`` cache)."""
        raw = len({e for pages in self._slot_pages.values() for e in pages
                   if GARBAGE_PAGE < e < self.n_pages})
        page_bytes = (self.n_attn_layers * 2 * self.page_elems
                      * torch.empty((), dtype=self.dtype).element_size())
        return {
            "page_size": self.page_size,
            "pages_in_use": raw,
            "free_pages": self.free_pages,
            "page_bytes": page_bytes,
            "raw_bytes_in_use": raw * page_bytes,
            "cache_bytes_paged": raw * page_bytes,
            "monolithic_bytes": self.max_batch * self.pages_per_slot
            * page_bytes,
        }
