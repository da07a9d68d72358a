"""Host-side swap tier for the paged KV cache: entropy-coded page store.

Cold pages are ~27% smaller *and bit-exact*, which turns host memory into a
second cache tier: a coded page can leave the device entirely and be
restored later with zero output deviation.  ``SwapStore`` is that tier — a
host dict of ``SwappedPage`` containers keyed by an opaque swap id, with
byte accounting, cumulative traffic counters, the LRU cache of retired
shared-prefix pages (unpinned pages) and the telemetry registry's level
gauges (the reference's ``kvcache/swap.py``), with per-shard byte ledgers
for a mesh's batch shards (a swapped page keeps its shard, so a faulting
slot restores into its own shard's free lists).

Lifecycle (driven by ``paged.PagedKVCache.evict`` / ``fault``):

  hot (raw pool page)  --evict-->  swapped: the page is copied off the
      device, entropy-coded by ``codec.encode_page`` (one ``SwapEntry``
      per layer x K/V sub-page) and stored here ragged — there is no
      uniform stride budget, so even incompressible pages swap.
  cold (device cold pool)  --evict-->  swapped: the page is *already*
      entropy-coded on the device; eviction is a plain device->host copy
      of its four container leaves — why victim selection is cold-first.
  swapped  --fault-->  resident: raw-swapped pages batch-decode through
      the page-decode kernel (``kernels.ops.decode_pages``) into fresh raw
      pool pages; cold-swapped pages reinstall their coded container into
      a fresh cold slot without being decoded.
  index-only prefix page  --retire-->  unpinned: the prefix index's page
      is coded like a raw page and kept here until capacity pressure
      evicts it or a later prompt match faults it back
      (``paged.PagedKVCache._reclaim_prefix`` / ``admit_shared``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class SwapExhausted(RuntimeError):
    """Raised when a put would exceed the store's ``capacity_bytes``."""


@dataclass
class SwapEntry:
    """One entropy-coded sub-page (one layer x K-or-V).

    ``payload`` is ragged — ``(stride, 128)`` with the page's own stride,
    zero-padded only to the 4-byte decode-window minimum; ``tables`` is
    the ``(3, L)`` canonical-decode stack and ``perm`` the canonical symbol
    order, exactly as produced by ``codec.CompressedPage``."""

    name: str               # the paged pattern position, "pos<j>"
    kn: str                 # "k" | "v"
    u: int                  # unit index
    payload: np.ndarray     # (stride, LANES) uint8
    signmant: np.ndarray    # raw sign+mantissa plane, uint8
    tables: np.ndarray      # (3, L) int32
    perm: np.ndarray        # (n_sym,) int32


@dataclass
class SwappedPage:
    """All sub-pages of one physical cache page, plus restore metadata.

    ``was_cold`` records which tier the page left from: cold pages
    reinstall into the device cold pool verbatim (their payloads already
    fit the uniform stride budget); raw pages decode back into the raw
    pool.  ``nbytes`` is the ragged compressed size (payload + sign/
    mantissa + serialized codebook per sub-page) used for capacity
    accounting."""

    entries: list = field(default_factory=list)
    was_cold: bool = False
    nbytes: int = 0


class SwapStore:
    """Host store of swapped pages with capacity + traffic accounting.

    ``capacity_bytes``: hard ceiling on resident swapped bytes (``None``
    = unbounded).  ``n_shards`` sizes the per-shard byte ledgers
    (``bytes_used_per_shard``; a mesh engine keeps one free list a batch
    shard and the store the matching ledger, so load imbalance shows in
    ``stats()``).  Every rank of a mesh keeps the same ledger: a rank that
    does not hold a page's shard stores it entry-less, with the holder's
    byte count.

    Pages are **pinned** by default: they belong to a live (possibly
    preempted) request and are never dropped by the store; a pinned put
    over the ceiling raises :class:`SwapExhausted` and the caller rolls the
    eviction back.  ``put(..., pinned=False)`` stores an evictable page
    instead, the retired shared-prefix cache of
    ``paged.PagedKVCache._reclaim_prefix``.  Under capacity pressure the
    store silently evicts unpinned pages in LRU order (oldest retirement
    first) to make room; only when no unpinned page is left does a pinned
    put raise (an unpinned put returns ``None`` instead: dropping a prefix
    is always legal, the caller forgets the index entry).  The allocator
    checks prefix keys with :meth:`contains` when it matches a prompt, so
    a silent eviction needs no callback."""

    def __init__(self, capacity_bytes: int | None = None, n_shards: int = 1):
        self.capacity_bytes = capacity_bytes
        self.n_shards = n_shards
        self._pages: dict[int, SwappedPage] = {}
        self._shard_of: dict[int, int] = {}
        self.bytes_used_per_shard = [0] * n_shards
        self._unpinned: dict[int, None] = {}    # ordered set: LRU order
        self.n_prefix_evicted = 0               # unpinned pages dropped
        self._next_key = 0
        self.bytes_used = 0
        # cumulative traffic (never reset except by the engine's rollback
        # of an aborted eviction)
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.n_swap_out = 0
        self.n_swap_in = 0
        self._registry = None

    def __len__(self) -> int:
        return len(self._pages)

    def attach_registry(self, registry) -> None:
        """Publish the store's *levels* into a telemetry registry as gauges
        (``kvcache_swap_bytes_used`` / ``kvcache_swap_pages``), updated on
        every put / pop / discard.  Levels only: cumulative traffic flows
        through ``stats()`` into the ``kvstat_*`` gauges, because the
        engine rolls the traffic counters back on an aborted eviction and
        a monotone registry counter could not follow."""
        self._registry = registry
        self.sync_registry()

    def sync_registry(self) -> None:
        if self._registry is None:
            return
        self._registry.gauge("kvcache_swap_bytes_used").set(self.bytes_used)
        self._registry.gauge("kvcache_swap_pages").set(len(self._pages))

    def put(self, page: SwappedPage, shard: int = 0, *,
            pinned: bool = True) -> int | None:
        """Store a swapped page; returns its opaque swap key.

        Over capacity, unpinned (prefix-cache) pages are evicted LRU-first
        to make room; if the page still does not fit, a pinned put raises
        :class:`SwapExhausted` and an unpinned put returns ``None`` (the
        page is not stored)."""
        if self.capacity_bytes is not None:
            while (self.bytes_used + page.nbytes > self.capacity_bytes
                   and self._unpinned):
                self._evict_unpinned(next(iter(self._unpinned)))
            if self.bytes_used + page.nbytes > self.capacity_bytes:
                if not pinned:
                    return None
                raise SwapExhausted(
                    f"swap store full: {self.bytes_used}B used + "
                    f"{page.nbytes}B > capacity {self.capacity_bytes}B")
        key = self._next_key
        self._next_key += 1
        self._pages[key] = page
        self._shard_of[key] = shard
        if not pinned:
            self._unpinned[key] = None
        self.bytes_used += page.nbytes
        self.bytes_used_per_shard[shard] += page.nbytes
        self.swap_out_bytes += page.nbytes
        self.n_swap_out += 1
        self.sync_registry()
        return key

    def _evict_unpinned(self, key: int) -> None:
        """Silently drop an unpinned page (capacity pressure: the data is a
        cache of a reproducible prefix, not request state)."""
        page = self._pages.pop(key)
        del self._unpinned[key]
        self.bytes_used -= page.nbytes
        self.bytes_used_per_shard[self._shard_of.pop(key)] -= page.nbytes
        self.n_prefix_evicted += 1
        self.sync_registry()

    def shard_of(self, key: int) -> int:
        """The batch shard whose device rows the page left (whose ranks
        hold its coded arrays)."""
        return self._shard_of[key]

    def contains(self, key: int) -> bool:
        """Whether ``key`` is still resident (an unpinned page may have been
        evicted since it was stored)."""
        return key in self._pages

    def peek(self, key: int) -> SwappedPage:
        """Read without removing (capacity planning before a fault)."""
        return self._pages[key]

    def pop(self, key: int) -> SwappedPage:
        """Remove and return a page on fault (counts swap-in traffic)."""
        page = self._pages.pop(key)
        self._unpinned.pop(key, None)
        self.bytes_used -= page.nbytes
        self.bytes_used_per_shard[self._shard_of.pop(key)] -= page.nbytes
        self.swap_in_bytes += page.nbytes
        self.n_swap_in += 1
        self.sync_registry()
        return page

    def discard(self, key: int) -> None:
        """Drop a page whose request finished while preempted (its data
        will never be read again — not swap-in traffic)."""
        page = self._pages.pop(key, None)
        if page is None:
            return
        self._unpinned.pop(key, None)
        self.bytes_used -= page.nbytes
        self.bytes_used_per_shard[self._shard_of.pop(key)] -= page.nbytes
        self.sync_registry()

    def stats(self) -> dict:
        return {
            "swap_pages": len(self._pages),
            "swap_prefix_pages": len(self._unpinned),
            "swap_prefix_bytes": sum(self._pages[k].nbytes
                                     for k in self._unpinned),
            "swap_prefix_evicted_total": self.n_prefix_evicted,
            "swap_bytes_used": self.bytes_used,
            "swap_capacity_bytes": self.capacity_bytes,
            "swap_out_bytes_total": self.swap_out_bytes,
            "swap_in_bytes_total": self.swap_in_bytes,
            "n_swap_out": self.n_swap_out,
            "n_swap_in": self.n_swap_in,
            "swap_bytes_per_shard": list(self.bytes_used_per_shard),
        }
