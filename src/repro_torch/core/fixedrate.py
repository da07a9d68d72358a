"""ECF8-FR: fixed-rate 2-bit exponent codes with escapes.

Exponent concentration (paper §2) means the top-3 exponent values of a
weight cover most of its mass.  ECF8-FR gives each element a 2-bit code:
codes 0..2 index a per-tensor 3-entry exponent table, code 3 escapes to a
side array of raw 4-bit exponents stored in element order.  Both encode
and decode are static-shape vector ops (no bitstream), at a rate of
``2 + 4 * p_escape`` bits an exponent (+4 sign/mantissa) against the
entropy H(E).

Layout (per tensor), byte-equal to the reference package's container:

  codes    : (ceil(N/4),) uint8, element 4i in bits 7..6 of byte i
  escapes  : (ceil(cap/2),) uint8, nibble-packed raw exponents, element
             order, zero beyond the escape count
  table    : (3,) uint8, the three most frequent exponents (a tie goes to
             the lower exponent)
  signmant : (ceil(N/2),) uint8, nibble-packed sign/mantissa

The encoder and :func:`decode_plain` run as tensor ops on the container's
own device; the decode goes through the container in fixed slices and
carries the running escape count across them, so its transient memory is
bounded at any tensor size.  :func:`decode_ref` is the host oracle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import fp8

TABLE_SIZE = 3  # 2-bit codes: 3 table entries + 1 escape
SLICE_ELEMS = 1 << 24  # elements decoded (and encoded) a pass; a multiple of 4


@dataclass
class FixedRateECF8:
    """ECF8-FR compressed tensor (tensors on the encoding device)."""

    codes: torch.Tensor      # (ceil(N/4),) uint8, four 2-bit codes a byte
    escapes: torch.Tensor    # (ceil(cap/2),) uint8 nibble-packed exponents
    table: torch.Tensor      # (3,) uint8 top-3 exponent values
    signmant: torch.Tensor   # (ceil(N/2),) uint8 nibble-packed
    n_elem: int
    esc_capacity: int
    esc_count: int
    shape: tuple

    @property
    def nbytes(self) -> int:
        return sum(t.numel() for t in (self.codes, self.escapes, self.table,
                                       self.signmant))

    @property
    def ratio(self) -> float:
        return self.nbytes / max(self.n_elem, 1)


def _pack_codes(code: torch.Tensor) -> torch.Tensor:
    """Four 2-bit codes a byte (element 4i -> bits 7..6), the tail padded
    with code 0."""
    n = code.shape[0]
    n4 = -(-n // 4) * 4
    if n4 != n:
        code = torch.cat([code, code.new_zeros(n4 - n)])
    q = code.reshape(-1, 4)
    return (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]


def _table_codes(exps: torch.Tensor, table) -> torch.Tensor:
    """Code ``i`` where the exponent is ``table[i]`` (a later entry wins,
    as in the reference), 3 elsewhere."""
    code = torch.full_like(exps, 3)
    for i in range(TABLE_SIZE):
        code = torch.where(exps == table[i], torch.full_like(code, i), code)
    return code


def encode(weight_bits: torch.Tensor, esc_capacity: int | None = None,
           margin: float = 1.0) -> FixedRateECF8:
    """Compress an fp8 tensor (uint8 bit view) into ECF8-FR, on its device.

    The escape capacity is ``max(ceil(cap * margin), count, 1)`` with
    ``cap`` the given capacity or, by default, the escape count."""
    orig_shape = tuple(weight_bits.shape)
    flat = weight_bits.reshape(-1)
    if flat.dtype != torch.uint8:
        raise TypeError(f"expected uint8 fp8 bits, got {flat.dtype}")
    n = flat.shape[0]
    exps = fp8.exponent_field(flat)
    freqs = torch.bincount(exps.to(torch.int64), minlength=16)
    # the reference's np.argsort(-freqs, kind="stable")
    table = torch.sort(-freqs, stable=True).indices[:TABLE_SIZE].to(
        torch.uint8)
    codes, esc = [], []
    for s0 in range(0, n, SLICE_ELEMS):
        e = exps[s0:s0 + SLICE_ELEMS]
        code = _table_codes(e, table)
        codes.append(_pack_codes(code))
        esc.append(e[code == 3])
    codes = torch.cat(codes) if codes else flat.new_zeros(0)
    esc_vals = torch.cat(esc) if esc else flat.new_zeros(0)
    count = int(esc_vals.shape[0])
    cap = count if esc_capacity is None else int(esc_capacity)
    cap = max(math.ceil(cap * margin), count, 1)
    esc_store = torch.zeros(cap, dtype=torch.uint8, device=flat.device)
    esc_store[:count] = esc_vals
    return FixedRateECF8(
        codes=codes, escapes=fp8.pack_nibbles(esc_store), table=table,
        signmant=fp8.pack_nibbles(fp8.signmant_nibble(flat)),
        n_elem=n, esc_capacity=cap, esc_count=count, shape=orig_shape)


def _unpack_codes(codes: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` 2-bit codes of a packed code array."""
    parts = torch.stack([(codes >> 6) & 3, (codes >> 4) & 3,
                         (codes >> 2) & 3, codes & 3], dim=-1).reshape(-1)
    return parts[:n]


def decode_plain(codes, escapes, table, signmant, *, n_elem: int,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The reference's ``_decode_jnp_impl`` in PyTorch, on the container's
    device -> (n_elem,) uint8 fp8 bits, or with ``out_dtype`` the fp8
    values cast to that dtype.

    An escape's rank is the count of escapes before it (the reference's
    ``cumsum - 1``), clipped to the escape array as the reference clips
    it; non-escapes read the table at ``min(code, 2)``.  Slices of
    ``SLICE_ELEMS`` elements carry the running escape count on the
    device, so no host sync happens and at most one slice's int64 ranks
    are alive."""
    dev = codes.device
    out = torch.empty(n_elem, dtype=out_dtype or torch.uint8, device=dev)
    n_esc = escapes.shape[0] * 2
    tab = table.to(torch.int64)
    seen = torch.zeros((), dtype=torch.int64, device=dev)
    for s0 in range(0, n_elem, SLICE_ELEMS):
        m = min(SLICE_ELEMS, n_elem - s0)
        code = _unpack_codes(codes[s0 // 4: (s0 + m + 3) // 4], m)
        is_esc = code == 3
        rank = (torch.cumsum(is_esc, 0) - 1 + seen).clamp_(0, n_esc - 1)
        byte = escapes[rank >> 1]
        esc_e = torch.where((rank & 1).bool(), byte & 0x0F, byte >> 4)
        tab_e = tab[code.clamp(max=2).to(torch.int64)].to(torch.uint8)
        exps = torch.where(is_esc, esc_e, tab_e)
        sm = fp8.unpack_nibbles(signmant[s0 // 2: (s0 + m + 1) // 2], m)
        bits = fp8.assemble(exps, sm)
        out[s0:s0 + m] = (bits if out_dtype is None
                          else bits.view(fp8.FP8_DTYPE).to(out_dtype))
        seen = seen + is_esc.sum()
    return out


def decode_ref(c: FixedRateECF8) -> torch.Tensor:
    """Host oracle decode (numpy) -> the original uint8 fp8 bit view."""
    codes = c.codes.cpu().numpy()
    code = np.stack([(codes >> 6) & 3, (codes >> 4) & 3, (codes >> 2) & 3,
                     codes & 3], axis=-1).reshape(-1)[:c.n_elem]
    esc = c.escapes.cpu().numpy()
    esc_vals = np.stack([esc >> 4, esc & 0x0F], axis=-1).reshape(-1)
    table = c.table.cpu().numpy()
    is_esc = code == 3
    esc_rank = np.cumsum(is_esc) - 1
    exps = np.where(is_esc,
                    esc_vals[np.clip(esc_rank, 0, len(esc_vals) - 1)],
                    table[np.minimum(code, 2)]).astype(np.uint8)
    sm = fp8.unpack_nibbles(c.signmant.cpu(), c.n_elem)
    return fp8.assemble(torch.from_numpy(exps), sm).reshape(c.shape)


def encode_plain(weight_bits: torch.Tensor, table: torch.Tensor,
                 esc_capacity: int):
    """The reference's ``encode_jnp``: encode with a *fixed* table and
    escape capacity, every output of a static shape.

    Returns ``(codes, escapes, signmant, overflowed)``: packed codes, the
    ``esc_capacity`` raw escape exponents (unpacked; escapes past the
    capacity are dropped), the unpacked sign/mantissa nibbles, and a 0-d
    bool tensor, True iff the escape count exceeded the capacity (the
    result is then invalid and the caller must recalibrate)."""
    flat = weight_bits.reshape(-1)
    exps = fp8.exponent_field(flat)
    code = _table_codes(exps, table.to(torch.uint8))
    is_esc = code == 3
    count = is_esc.sum()
    pos = torch.cumsum(is_esc, 0) - 1
    idx = torch.where(is_esc & (pos < esc_capacity), pos,
                      torch.full_like(pos, esc_capacity))
    store = torch.zeros(esc_capacity + 1, dtype=torch.uint8,
                        device=flat.device)
    store[idx] = exps
    return (_pack_codes(code), store[:esc_capacity],
            fp8.signmant_nibble(flat), count > esc_capacity)
