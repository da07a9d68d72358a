"""Host-side swap tier for the paged KV cache: entropy-coded page store.

Cold pages are ~27% smaller *and bit-exact*, which turns host memory into a
second cache tier: a coded page can leave the device entirely and be
restored later with zero output deviation.  ``SwapStore`` is that tier — a
host dict of ``SwappedPage`` containers keyed by an opaque swap id, with
byte accounting and cumulative traffic counters (the reference's
``kvcache/swap.py`` on one shard, without the prefix cache's unpinned pages
and the telemetry registry, which the port does not serve yet).

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

    kn: str                 # "k" | "v"
    u: int                  # layer index
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
    = unbounded); a put over the ceiling raises :class:`SwapExhausted` and
    the caller rolls the eviction back.  Every page belongs to a live
    (possibly preempted) request and is never dropped by the store."""

    def __init__(self, capacity_bytes: int | None = None):
        self.capacity_bytes = capacity_bytes
        self._pages: dict[int, SwappedPage] = {}
        self._next_key = 0
        self.bytes_used = 0
        # cumulative traffic (never reset except by the engine's rollback
        # of an aborted eviction)
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.n_swap_out = 0
        self.n_swap_in = 0

    def __len__(self) -> int:
        return len(self._pages)

    def put(self, page: SwappedPage) -> int:
        """Store a swapped page; returns its opaque swap key."""
        if (self.capacity_bytes is not None
                and self.bytes_used + page.nbytes > self.capacity_bytes):
            raise SwapExhausted(
                f"swap store full: {self.bytes_used}B used + "
                f"{page.nbytes}B > capacity {self.capacity_bytes}B")
        key = self._next_key
        self._next_key += 1
        self._pages[key] = page
        self.bytes_used += page.nbytes
        self.swap_out_bytes += page.nbytes
        self.n_swap_out += 1
        return key

    def peek(self, key: int) -> SwappedPage:
        """Read without removing (capacity planning before a fault)."""
        return self._pages[key]

    def pop(self, key: int) -> SwappedPage:
        """Remove and return a page on fault (counts swap-in traffic)."""
        page = self._pages.pop(key)
        self.bytes_used -= page.nbytes
        self.swap_in_bytes += page.nbytes
        self.n_swap_in += 1
        return page

    def discard(self, key: int) -> None:
        """Drop a page whose request finished while preempted (its data
        will never be read again — not swap-in traffic)."""
        page = self._pages.pop(key, None)
        if page is not None:
            self.bytes_used -= page.nbytes

    def stats(self) -> dict:
        return {
            "swap_pages": len(self._pages),
            "swap_bytes_used": self.bytes_used,
            "swap_capacity_bytes": self.capacity_bytes,
            "swap_out_bytes_total": self.swap_out_bytes,
            "swap_in_bytes_total": self.swap_in_bytes,
            "n_swap_out": self.n_swap_out,
            "n_swap_in": self.n_swap_in,
        }
