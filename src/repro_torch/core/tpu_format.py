"""ECF8-TPU: the interleaved-lane container of the ECF8 weight format.

Weights are encoded into **128 interleaved lane streams per chunk**:

  * element ``i`` of chunk ``c`` maps to lane ``i % 128``, slot ``i // 128``;
  * every lane of every chunk carries exactly ``sym_per_lane`` symbols, so
    output positions are static (no counting phase / prefix sum needed);
  * codes are canonical Huffman with max length 8 (package-merge), decoded
    by comparing the 8-bit peek against per-length canonical limits;
  * chunk payloads are stored transposed ``(stride, 128)`` so "byte j of
    all lanes" is one contiguous row, padded to the tensor-wide max lane
    stride: ``payload`` is ``(C, stride, 128)`` uint8.

The container bytes are identical to the reference package's (the
``tests/test_torch_format.py`` parity tests hold them byte for byte).  The
encoder here runs as tensor ops on the weights' device in groups of chunks,
so its memory stays bounded at any tensor size (the reference's numpy
encoder builds arrays the size of the total code bits).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import fp8
from .huffman import Codebook

LANES = 128
DEFAULT_SYM_PER_LANE = 256
MAX_CODE_LEN = 8
MIN_STRIDE = 4  # decode window preloads 4 bytes
ENCODE_GROUP_ELEMS = 1 << 24  # symbols blitted per encoder pass


@dataclass
class TpuECF8:
    """ECF8-TPU compressed tensor (tensors on the encoding device)."""

    payload: torch.Tensor    # (C, stride, LANES) uint8
    signmant: torch.Tensor   # (ceil(N/2),) uint8 nibble-packed
    # canonical decode tables (all small)
    lj_limit: torch.Tensor   # (8,) int32, exclusive, left-justified to 8 bits
    first_lj: torch.Tensor   # (8,) int32
    offset: torch.Tensor     # (8,) int32
    perm: torch.Tensor       # (16,) int32 canonical-order symbol values
    lengths: torch.Tensor    # (16,) int32 code length per symbol
    n_elem: int
    shape: tuple
    sym_per_lane: int

    @property
    def stride(self) -> int:
        return self.payload.shape[1]


def _chunk_symbols(exps: torch.Tensor, c0: int, c1: int, S: int,
                   pad_sym: int) -> torch.Tensor:
    """Exponent symbols of chunks ``[c0, c1)`` as ``(c1 - c0, S, LANES)``
    int64, the tail padded with ``pad_sym`` as the reference pads it."""
    cs = S * LANES
    part = exps[c0 * cs: c1 * cs].to(torch.int64)
    short = (c1 - c0) * cs - part.shape[0]
    if short:
        part = torch.cat([part, part.new_full((short,), pad_sym)])
    return part.reshape(c1 - c0, S, LANES)


def encode(weight_bits: torch.Tensor,
           sym_per_lane: int = DEFAULT_SYM_PER_LANE) -> TpuECF8:
    """Compress an fp8 tensor (uint8 bit view) into ECF8-TPU.

    Two passes over groups of chunks, on the tensor's own device: the
    codebook and the uniform stride are tensor-wide, so the first pass
    only counts each lane's code bits; the second blits each group's
    codes into its payload rows.  Peak extra memory is a few int64 arrays
    of ``ENCODE_GROUP_ELEMS`` symbols."""
    orig_shape = tuple(weight_bits.shape)
    flat = weight_bits.reshape(-1)
    if flat.dtype != torch.uint8:
        raise TypeError(f"expected uint8 fp8 bits, got {flat.dtype}")
    dev = flat.device
    n = flat.shape[0]
    exps = fp8.exponent_field(flat)
    freqs = torch.bincount(exps, minlength=16).cpu().numpy()
    cb = Codebook.from_freqs(freqs, max_len=MAX_CODE_LEN)

    # auto-cap the chunk so tensors smaller than one full chunk don't pay
    # a whole chunk of padding (small norm/bias tensors, smoke configs)
    S = min(sym_per_lane, max(-(-n // LANES), MIN_STRIDE))
    C = -(-n // (LANES * S))
    pad_sym = int(np.argmax(freqs))
    lengths = torch.as_tensor(cb.lengths, dtype=torch.int32, device=dev)
    codes = torch.as_tensor(cb.codes, dtype=torch.int32, device=dev)
    G = max(1, ENCODE_GROUP_ELEMS // (S * LANES))
    groups = [(c0, min(c0 + G, C)) for c0 in range(0, C, G)]

    # pass 1: code bits per lane -> the uniform (tensor-wide) stride
    lane_bits_max = 0
    for c0, c1 in groups:
        lens = lengths[_chunk_symbols(exps, c0, c1, S, pad_sym)]
        lane_bits_max = max(lane_bits_max, int(lens.sum(dim=1).max()))
    stride = max((lane_bits_max + 7) // 8, MIN_STRIDE)

    # pass 2: blit.  A code of <= 8 bits starting at bit ``start`` of its
    # lane spans bytes start//8 and start//8 + 1; codes of one lane occupy
    # disjoint bits, so adding the two byte halves into the lane's bytes
    # is the bitwise OR of the reference's bit matrix.
    payload = torch.zeros((C, stride, LANES), dtype=torch.uint8, device=dev)
    for c0, c1 in groups:
        sym = _chunk_symbols(exps, c0, c1, S, pad_sym)
        lens = lengths[sym]
        starts = torch.cumsum(lens, dim=1) - lens          # (g, S, L)
        window = codes[sym] << (16 - (starts & 7) - lens)  # 16-bit window
        byte0 = (starts >> 3).to(torch.int64)
        rows = torch.zeros((c1 - c0, stride + 1, LANES),
                           dtype=window.dtype, device=dev)
        rows.scatter_add_(1, byte0, window >> 8)
        rows.scatter_add_(1, byte0 + 1, window & 0xFF)
        payload[c0:c1] = rows[:, :stride].to(torch.uint8)

    def table(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

    return TpuECF8(
        payload=payload,
        signmant=fp8.pack_nibbles(fp8.signmant_nibble(flat)),
        lj_limit=table(cb.lj_limit),
        first_lj=table(cb.first_lj),
        offset=table(cb.offset),
        perm=table(cb.sorted_syms),
        lengths=table(cb.lengths),
        n_elem=n,
        shape=orig_shape,
        sym_per_lane=S,
    )


def decode_ref(c: TpuECF8) -> torch.Tensor:
    """Readable per-lane oracle (slow; small tensors) -> uint8 fp8 bits."""
    payload = c.payload.cpu().numpy()
    C, stride, L = payload.shape
    S = c.sym_per_lane
    cb = Codebook(lengths=c.lengths.cpu().numpy(), codes=None,  # type: ignore
                  max_len=MAX_CODE_LEN)
    cb.sorted_syms = c.perm.cpu().numpy()
    cb.lj_limit = c.lj_limit.cpu().numpy().astype(np.int64)
    cb.first_lj = c.first_lj.cpu().numpy().astype(np.int64)
    cb.offset = c.offset.cpu().numpy().astype(np.int64)
    syms = np.zeros((C, S, L), dtype=np.uint8)
    for ci in range(C):
        for l in range(L):
            stream = payload[ci, :, l]
            bitpos = 0
            for s in range(S):
                peek = 0
                for b in range(MAX_CODE_LEN):
                    p = bitpos + b
                    bit = (int(stream[p // 8]) >> (7 - p % 8)) & 1 \
                        if p // 8 < stride else 0
                    peek = (peek << 1) | bit
                sym, ln = cb.decode_peek(peek)
                syms[ci, s, l] = sym
                bitpos += ln
    exp = torch.from_numpy(syms.reshape(-1)[: c.n_elem])
    sm = fp8.unpack_nibbles(c.signmant.cpu(), c.n_elem)
    return fp8.assemble(exp, sm).reshape(c.shape)


def decode_plain(payload, signmant, lj_limit, first_lj, offset, perm, *,
                 sym_per_lane: int, n_elem: int,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of the ECF8 decode kernel -> (n_elem,) uint8
    fp8 bits, or with ``out_dtype`` the fp8 values cast to that dtype.

    The same arithmetic as the reference's ``_decode_jnp_impl``: every
    lane keeps a left-aligned 32-bit window (held in int64 and masked),
    decodes one symbol per round with the canonical compare/select on its
    top 8 bits, shifts, and refills at most one byte from
    ``min(byteptr, stride - 1)``.  An out-of-table symbol index (only
    reachable on bits past a lane's stream) yields symbol 0, as the
    reference's ``jnp.take`` fill does.  ``signmant`` is the flat
    nibble array of ``ceil(n_elem / 2)`` bytes."""
    C, stride, L = payload.shape
    S = sym_per_lane
    p = payload[:, :4, :].to(torch.int64)
    win = (p[:, 0] << 24) | (p[:, 1] << 16) | (p[:, 2] << 8) | p[:, 3]
    byteptr = torch.full((C, L), 4, dtype=torch.int64, device=payload.device)
    bits_valid = torch.full_like(byteptr, 32)
    lim = lj_limit.to(torch.int64)
    first = first_lj.to(torch.int64)
    off = offset.to(torch.int64)
    perm_i = perm.to(torch.int64)
    outs = torch.empty((C, S, L), dtype=torch.uint8, device=payload.device)
    for s in range(S):
        peek = win >> 24
        lt = (peek[..., None] < lim).to(torch.uint8)        # (C, L, 8)
        length = torch.argmax(lt, dim=-1) + 1               # first True
        sym_idx = off[length - 1] + ((peek - first[length - 1])
                                     >> (8 - length))
        ok = (sym_idx >= 0) & (sym_idx < perm_i.shape[0])
        sym = torch.where(ok, perm_i[sym_idx.clamp(0, perm_i.shape[0] - 1)],
                          0)
        outs[:, s] = sym.to(torch.uint8)
        win = (win << length) & 0xFFFFFFFF
        bits_valid = bits_valid - length
        need = bits_valid <= 24
        safe_ptr = byteptr.clamp(max=stride - 1)
        nb = torch.gather(payload, 1, safe_ptr[:, None, :])[:, 0]
        win = torch.where(
            need, win | (nb.to(torch.int64) << (24 - bits_valid).clamp(min=0)),
            win)
        byteptr = byteptr + need
        bits_valid = bits_valid + 8 * need
    syms = outs.reshape(-1)[:n_elem]
    bits = fp8.assemble(syms, fp8.unpack_nibbles(signmant, n_elem))
    if out_dtype is None:
        return bits
    return bits.view(fp8.FP8_DTYPE).to(out_dtype)
