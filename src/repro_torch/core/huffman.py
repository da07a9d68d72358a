"""Canonical Huffman coding over the 16 fp8 exponent symbols (paper §3.1).

Length-limited code lengths come from the *package-merge* algorithm
(optimal among length-limited prefix codes); the TPU container format
(``tpu_format.py``) caps lengths at 8 so decode is a single 8-bit peek,
the paper's own container (``paper_format.py``) at 16.

Codes are *canonical*: symbols sorted by (length, symbol) receive
lexicographically increasing codes, which enables the gather-free
compare/select decoder of the ECF8 decode kernel.  This module is a numpy
copy of the reference's, tie-breaking included, so the codebooks (and so
the container bytes) come out identical.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

N_SYMBOLS = 16


def huffman_lengths(freqs: np.ndarray) -> np.ndarray:
    """Unrestricted Huffman code lengths (0 for zero-frequency symbols)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    active = [int(s) for s in np.nonzero(freqs)[0]]
    lengths = np.zeros(len(freqs), dtype=np.int32)
    if not active:
        return lengths
    if len(active) == 1:
        lengths[active[0]] = 1
        return lengths
    heap = [(int(freqs[s]), (s,)) for s in active]
    heapq.heapify(heap)
    while len(heap) > 1:
        w1, s1 = heapq.heappop(heap)
        w2, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (w1 + w2, s1 + s2))
    return lengths


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal length-limited code lengths via package-merge."""
    freqs = np.asarray(freqs, dtype=np.int64)
    active = [int(s) for s in np.nonzero(freqs)[0]]
    lengths = np.zeros(len(freqs), dtype=np.int32)
    n = len(active)
    if n == 0:
        return lengths
    if n == 1:
        lengths[active[0]] = 1
        return lengths
    if (1 << max_len) < n:
        raise ValueError(f"max_len={max_len} cannot encode {n} symbols")
    originals = sorted((int(freqs[s]), (s,)) for s in active)
    prev: list[tuple[int, tuple[int, ...]]] = []
    for _ in range(max_len):
        packages = []
        for i in range(0, len(prev) - 1, 2):
            packages.append(
                (prev[i][0] + prev[i + 1][0], prev[i][1] + prev[i + 1][1])
            )
        prev = sorted(originals + packages)
    for _, syms in prev[: 2 * n - 2]:
        for s in syms:
            lengths[s] += 1
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code values (int) per symbol, given code lengths."""
    lengths = np.asarray(lengths, dtype=np.int32)
    order = sorted(s for s in range(len(lengths)) if lengths[s] > 0)
    order.sort(key=lambda s: (lengths[s], s))
    codes = np.zeros(len(lengths), dtype=np.int64)
    code = 0
    prev_len = 0
    for i, s in enumerate(order):
        l = int(lengths[s])
        if i == 0:
            code = 0
        else:
            code = (code + 1) << (l - prev_len)
        codes[s] = code
        prev_len = l
    return codes


def kraft_sum(lengths: np.ndarray) -> float:
    lengths = np.asarray(lengths)
    ls = lengths[lengths > 0]
    return float(np.sum(2.0 ** (-ls.astype(np.float64))))


def expected_length(freqs: np.ndarray, lengths: np.ndarray) -> float:
    freqs = np.asarray(freqs, dtype=np.float64)
    total = freqs.sum()
    if total == 0:
        return 0.0
    return float((freqs * lengths).sum() / total)


@dataclass
class Codebook:
    """A canonical Huffman codebook over the exponent-symbol alphabet."""

    lengths: np.ndarray  # (16,) int32, 0 => unused symbol
    codes: np.ndarray  # (16,) int64 canonical code values
    max_len: int

    # --- canonical-decode tables ---------------------------------------
    # sorted_syms[i]  : i-th symbol in canonical (length, symbol) order
    # lj_limit[l-1]   : exclusive upper bound, left-justified to max_len bits,
    #                   of codes with length <= l (monotone nondecreasing)
    # first_lj[l-1]   : first code of length l, left-justified to max_len bits
    # offset[l-1]     : index into sorted_syms of the first length-l symbol
    sorted_syms: np.ndarray = field(default=None)  # type: ignore[assignment]
    lj_limit: np.ndarray = field(default=None)  # type: ignore[assignment]
    first_lj: np.ndarray = field(default=None)  # type: ignore[assignment]
    offset: np.ndarray = field(default=None)  # type: ignore[assignment]

    @classmethod
    def from_freqs(cls, freqs: np.ndarray, max_len: int = 16) -> "Codebook":
        lengths = package_merge_lengths(freqs, max_len)
        codes = canonical_codes(lengths)
        cb = cls(lengths=lengths, codes=codes, max_len=max_len)
        cb._build_decode_tables()
        return cb

    def _build_decode_tables(self) -> None:
        L = self.max_len
        order = [s for s in range(len(self.lengths)) if self.lengths[s] > 0]
        order.sort(key=lambda s: (self.lengths[s], s))
        n_syms = len(self.lengths)
        self.sorted_syms = np.asarray(order + [0] * (n_syms - len(order)),
                                      dtype=np.int32)
        lj_limit = np.zeros(L, dtype=np.int64)
        first_lj = np.zeros(L, dtype=np.int64)
        offset = np.zeros(L, dtype=np.int64)
        idx = 0
        running_limit = 0
        for l in range(1, L + 1):
            syms_l = [s for s in order if self.lengths[s] == l]
            offset[l - 1] = idx
            if syms_l:
                first = int(self.codes[syms_l[0]])
                first_lj[l - 1] = first << (L - l)
                running_limit = (first + len(syms_l)) << (L - l)
            else:
                first_lj[l - 1] = running_limit
            lj_limit[l - 1] = running_limit
            idx += len(syms_l)
        self.lj_limit = lj_limit
        self.first_lj = first_lj
        self.offset = offset

    def decode_peek(self, peek: int) -> tuple[int, int]:
        """Decode a left-justified ``max_len``-bit peek -> (symbol, length)."""
        L = self.max_len
        for l in range(1, L + 1):
            if peek < self.lj_limit[l - 1]:
                sym_idx = self.offset[l - 1] + (
                    (peek - self.first_lj[l - 1]) >> (L - l)
                )
                return int(self.sorted_syms[sym_idx]), l
        raise ValueError(f"invalid peek {peek:0{L}b}")

    def encode_symbols(self, symbols: np.ndarray) -> tuple[np.ndarray, int]:
        """Encode a symbol sequence into a byte array (MSB-first bitstream)
        -> (bytes, total_bits).

        A code of at most 16 bits starting at bit ``start`` lies within
        bytes ``start // 8`` to ``start // 8 + 2``; codes occupy disjoint
        bits, so summing each code's three byte parts into the stream is
        the bitwise OR of the reference's bit-by-bit blit (the same
        bytes), at three scatter-adds a symbol instead of one a bit."""
        symbols = np.asarray(symbols, dtype=np.int64)
        if self.max_len > 16:
            raise ValueError(f"max_len={self.max_len}: codes of at most 16 "
                             f"bits only")
        lens = self.lengths[symbols].astype(np.int64)
        total_bits = int(lens.sum())
        nbytes = (total_bits + 7) // 8
        if not total_bits:
            return np.zeros(nbytes, dtype=np.uint8), 0
        starts = np.cumsum(lens) - lens
        window = (self.codes[symbols].astype(np.int64)
                  << (24 - (starts & 7) - lens))          # 24-bit window
        byte0 = starts >> 3
        out = np.zeros(nbytes + 2, dtype=np.int64)
        for j, part in enumerate(((window >> 16) & 0xFF,
                                  (window >> 8) & 0xFF, window & 0xFF)):
            out += np.bincount(byte0 + j, weights=part,
                               minlength=nbytes + 2).astype(np.int64)
        return out[:nbytes].astype(np.uint8), total_bits

    def decode_bitstream(self, data: np.ndarray, n_symbols: int,
                         start_bit: int = 0) -> np.ndarray:
        """Sequential oracle decoder (numpy, slow)."""
        out = np.empty(n_symbols, dtype=np.uint8)
        bitpos = start_bit
        data = np.asarray(data, dtype=np.uint8)
        L = self.max_len
        for i in range(n_symbols):
            peek = 0
            for b in range(L):
                byte = bitpos + b
                bit = (int(data[byte // 8]) >> (7 - byte % 8)) & 1 \
                    if byte // 8 < len(data) else 0
                peek = (peek << 1) | bit
            sym, l = self.decode_peek(peek)
            out[i] = sym
            bitpos += l
        return out


def _concat_aranges(lens: np.ndarray) -> np.ndarray:
    """[arange(l) for l in lens], concatenated (vectorized)."""
    total = int(lens.sum())
    ids = np.arange(total)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    return ids - starts
