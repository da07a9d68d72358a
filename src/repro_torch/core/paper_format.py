"""The paper's own ECF8 container (§3.1, Algorithm 1), host side.

Layout (per tensor), byte-equal to the reference package's:
  encoded : Huffman bitstream of the 4-bit exponents, MSB-first   (n_bytes,)
  packed  : sign+mantissa nibbles, two per byte                   (ceil(N/2),)
  LUT     : cascaded 8-bit decode subtables + final length table  (n_luts, 256)
  gaps    : per-thread 4-bit bit offsets, two per byte
  outpos  : per-block cumulative output positions (int64)

Threads process ``B`` bytes each, ``T`` threads per block.  ``gaps[t]`` is the
bit offset, within thread t's byte window, of the first codeword that *starts*
in that window; ``outpos[b]`` is the number of symbols decoded by blocks
``< b``.  Max code length is 16 bits, so a codeword spans at most 2 bytes of
lookahead and gaps always fit 4 bits (paper §3.1).

This is a numpy oracle, as the reference's is: neither package has a kernel
for Algorithm 1.  :func:`decode_blockparallel` runs the algorithm's
block/thread schedule with every thread of a block stepping in lockstep
(one numpy operation a step over all threads), so that it decodes a
full-width matrix in seconds; :func:`decode_sequential` walks the stream
one symbol at a time.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import fp8
from .huffman import Codebook

# Paper constants (Algorithm 1 uses B+2 = 10 lookahead bytes => B = 8).
BYTES_PER_THREAD = 8
THREADS_PER_BLOCK = 128
MAX_CODE_LEN = 16
LUT_POINTER_BASE = 240  # entries >= 240 are pointers; subtable = 256 - entry


def _nibbles_np(packed: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` 4-bit values of a nibble-packed array (high first)."""
    packed = np.asarray(packed, dtype=np.uint8)
    return np.stack([packed >> 4, packed & 0x0F], axis=-1).reshape(-1)[:n]


def _assemble_np(exps: np.ndarray, signmant: np.ndarray) -> np.ndarray:
    return fp8.assemble(torch.from_numpy(np.ascontiguousarray(exps)),
                        torch.from_numpy(np.ascontiguousarray(signmant))
                        ).numpy()


@dataclass
class PaperECF8:
    """The paper's compressed tensor container (host-side numpy arrays)."""

    encoded: np.ndarray  # uint8 bitstream
    packed: np.ndarray  # uint8 nibble-packed sign/mantissa
    lut: np.ndarray  # (n_luts, 256) uint8 cascaded tables + length table
    gaps: np.ndarray  # uint8, two 4-bit gaps per byte
    outpos: np.ndarray  # int64 per-block output positions (n_blocks + 1)
    n_elem: int
    shape: tuple
    codebook: Codebook

    @property
    def n_bytes_total(self) -> int:
        """Total compressed footprint in bytes (all components)."""
        return (self.encoded.nbytes + self.packed.nbytes + self.lut.nbytes
                + self.gaps.nbytes + self.outpos.nbytes)

    @property
    def ratio(self) -> float:
        """Compressed bytes / original fp8 bytes (1 byte per element)."""
        return self.n_bytes_total / max(self.n_elem, 1)


def build_cascaded_lut(cb: Codebook) -> np.ndarray:
    """Build the paper's cascaded 8-bit lookup tables.

    Table 0 is the root.  Entry values:
      < 16               : decoded symbol (complete code within this byte)
      in [240, 255]      : pointer; subtable index = 256 - value
    The *last* table is the length table: ``lut[-1, x] = len(code(x))``.
    """
    # byte-aligned proper prefixes of codes longer than 8 bits
    prefixes: list[int] = []
    for s in range(16):
        l = int(cb.lengths[s])
        if l > 8:
            p = int(cb.codes[s]) >> (l - 8)
            if p not in prefixes:
                prefixes.append(p)
    n_luts = 1 + len(prefixes) + 1  # root + subtables + length table
    if len(prefixes) > 16:
        raise ValueError("too many subtables for pointer encoding")
    lut = np.zeros((n_luts, 256), dtype=np.uint8)

    for b in range(256):
        # a code of length <= 8 that is a left-justified prefix of b, else
        # the start of a longer code (a pointer to its subtable), else an
        # unreachable padding pattern (0)
        for s in range(16):
            l = int(cb.lengths[s])
            if 0 < l <= 8 and (b >> (8 - l)) == int(cb.codes[s]):
                lut[0, b] = s
                break
        else:
            if b in prefixes:
                lut[0, b] = 256 - (prefixes.index(b) + 1)

    for j, p in enumerate(prefixes):
        for b in range(256):
            for s in range(16):
                l = int(cb.lengths[s])
                if l > 8 and (int(cb.codes[s]) >> (l - 8)) == p:
                    # low byte of the 16-bit left-justified code = tail bits
                    tail_byte = (int(cb.codes[s]) << (16 - l)) & 0xFF
                    tail_bits = l - 8
                    if (b >> (8 - tail_bits)) == (tail_byte >> (8 - tail_bits)):
                        lut[1 + j, b] = s
                        break

    lut[-1, :16] = cb.lengths[:16]
    return lut


def encode(weight_bits, max_len: int = MAX_CODE_LEN,
           bytes_per_thread: int = BYTES_PER_THREAD,
           threads_per_block: int = THREADS_PER_BLOCK) -> PaperECF8:
    """Compress an fp8 tensor (uint8 bit view, numpy or torch) into the
    paper's container."""
    if isinstance(weight_bits, torch.Tensor):
        weight_bits = weight_bits.cpu().numpy()
    orig_shape = tuple(weight_bits.shape)
    flat = np.asarray(weight_bits, dtype=np.uint8).reshape(-1)
    n = flat.shape[0]
    exps = (flat >> 3) & 0x0F
    signmant = ((flat >> 4) & 0x08) | (flat & 0x07)
    packed = fp8.pack_nibbles(torch.from_numpy(signmant)).numpy()

    freqs = np.bincount(exps, minlength=16)
    cb = Codebook.from_freqs(freqs, max_len=max_len)
    lut = build_cascaded_lut(cb)

    encoded, _ = cb.encode_symbols(exps)

    # --- synchronization metadata (gaps, outpos) --------------------------
    B, T = bytes_per_thread, threads_per_block
    block_bytes = B * T
    n_bytes = encoded.shape[0]
    n_blocks = max(1, -(-n_bytes // block_bytes))
    n_threads = n_blocks * T

    lens = cb.lengths[exps].astype(np.int64)
    starts = np.cumsum(lens) - lens  # bit position where each symbol starts

    # first symbol starting at or after each thread-window start bit
    window_starts = np.arange(n_threads, dtype=np.int64) * (8 * B)
    first_sym = np.searchsorted(starts, window_starts, side="left")
    gap_bits = np.where(first_sym < n,
                        starts[np.minimum(first_sym, n - 1)] - window_starts,
                        0)
    gap_bits = np.clip(gap_bits, 0, 15).astype(np.uint8)
    gaps = fp8.pack_nibbles(torch.from_numpy(gap_bits)).numpy()

    # symbols whose codeword starts within block b's byte range
    block_starts_bits = (np.arange(n_blocks + 1, dtype=np.int64)
                         * (8 * block_bytes))
    outpos = np.searchsorted(starts, block_starts_bits,
                             side="left").astype(np.int64)
    outpos[-1] = n

    # pad the stream so every thread can read B + 2 lookahead bytes
    padded_len = n_blocks * block_bytes + 2
    if encoded.shape[0] < padded_len:
        encoded = np.concatenate(
            [encoded, np.zeros(padded_len - encoded.shape[0], dtype=np.uint8)])

    return PaperECF8(encoded=encoded, packed=packed, lut=lut, gaps=gaps,
                     outpos=outpos, n_elem=n, shape=orig_shape, codebook=cb)


def decode_sequential(c: PaperECF8) -> np.ndarray:
    """Sequential oracle decode -> original uint8 fp8 bit view."""
    syms = c.codebook.decode_bitstream(c.encoded, c.n_elem)
    out = _assemble_np(syms.astype(np.uint8), _nibbles_np(c.packed, c.n_elem))
    return out.reshape(c.shape)


def _decode_with_lut(encoded: np.ndarray, lut: np.ndarray, bitpos):
    """One LUT-cascade decode step at ``bitpos`` -> (symbol, length,
    newpos); ``bitpos`` is an int or an int64 array (a step of every
    thread at once, the same lookups elementwise)."""
    n_luts = lut.shape[0]
    scalar = np.ndim(bitpos) == 0
    pos = np.asarray(bitpos, dtype=np.int64)

    def peek_byte(p):
        byte0, sh = p // 8, p % 8
        n = len(encoded)
        b0 = np.where(byte0 < n, encoded[np.minimum(byte0, n - 1)], 0)
        b1 = np.where(byte0 + 1 < n, encoded[np.minimum(byte0 + 1, n - 1)],
                      0)
        return (((b0.astype(np.int64) << 8) | b1) >> (8 - sh)) & 0xFF

    x = lut[0, peek_byte(pos)].astype(np.int64)
    ptr = x >= LUT_POINTER_BASE
    if ptr.any():
        x = np.where(ptr, lut[np.where(ptr, 256 - x, 0),
                              peek_byte(pos + 8)], x)
    l = lut[n_luts - 1, x].astype(np.int64)
    if scalar:
        return int(x), int(l), int(pos + l)
    return x, l, pos + l


def decode_blockparallel(c: PaperECF8) -> np.ndarray:
    """Algorithm 1's block/thread structure -> original uint8 fp8 bits.

    Follows the two-phase schedule per block (count -> prefix-sum ->
    decode), every thread starting at its window's bit plus its ``gap``
    and the block's output at ``outpos``: the check that the metadata
    suffices for fully autonomous block decoding (the paper's key kernel
    property).  Every thread of every block steps in lockstep, one array
    operation a step; a thread whose window is done stops counting and
    writing, as the reference's per-thread loops stop."""
    B, T = BYTES_PER_THREAD, THREADS_PER_BLOCK
    n_blocks = len(c.outpos) - 1
    n_threads = n_blocks * T
    gap_vals = _nibbles_np(c.gaps, n_threads).astype(np.int64)
    limit = len(c.encoded) * 8
    tid = np.arange(n_threads, dtype=np.int64)
    begin = tid * 8 * B + gap_vals
    end = np.minimum((tid + 1) * 8 * B, limit)

    # phase 1: per-thread symbol counting
    counts = np.zeros(n_threads, dtype=np.int64)
    pos = begin.copy()
    live = pos < end
    while live.any():
        _, l, nxt = _decode_with_lut(c.encoded, c.lut, pos[live])
        pos[live] = nxt
        counts[live] += 1
        live = pos < end
    # prefix sum within each block -> per-thread output starts
    per_block = counts.reshape(n_blocks, T)
    starts = (np.cumsum(per_block, axis=1) - per_block
              + c.outpos[:-1, None]).reshape(-1)
    # phase 2: decode and write
    out_syms = np.zeros(c.n_elem, dtype=np.uint8)
    o = starts.copy()
    o_end = np.minimum(starts + counts, c.n_elem)
    pos = begin.copy()
    live = o < o_end
    while live.any():
        x, _, nxt = _decode_with_lut(c.encoded, c.lut, pos[live])
        out_syms[o[live]] = x
        pos[live] = nxt
        o[live] += 1
        live = o < o_end
    out = _assemble_np(out_syms, _nibbles_np(c.packed, c.n_elem))
    return out.reshape(c.shape)
