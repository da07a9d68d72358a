"""Fused ECF8 decode + matrix product on Hopper: ``csrc/fused_decode_matmul.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_decode_matmul.py``
(``_fused_kernel`` / ``_matmul_impl`` / ``matmul_pallas``): ``y = x @
decode(W)`` for the decode-step regime (M <= 512 rows), with the weight in
the tiled ECF8 layout of :func:`encode_tiled`, so that one chunk of the
container decodes to exactly one ``(S, 128)`` weight tile.  The kernel
decodes each tile into shared memory with a table-driven loop like B1's
(payload and nibbles staged by ``cp.async``, the payload transposed into
32-bit words, one table read a symbol) and multiplies it there on the
tensor cores (``wgmma``, the decoded tile as the A operand, x's rows as
B); a CTA takes up to 256 rows of x, so a tile is decoded at most
``ceil(M / 256)`` times a call.  A tile depth S that is not a multiple of
the tensor cores' k-step (16) is zero-padded in shared memory.  The
compressed bytes are the only weight traffic in device memory.

:func:`run` launches the kernel for tensors on the card; :func:`plain` is
the plain PyTorch version (decode with ``tpu_format.decode_plain``, then
one f32 product per tile row, in ``tk`` order as the reference's grid
accumulates), the only path on the CPU and the comparison on the card.  The
dispatch between the two lives in ``kernels/ops.py``.  No serve path calls
this op (the reference's does not either): weights are decoded by
``ecf8_decode`` and multiplied by ``torch.matmul``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..core import fp8, tpu_format
from ..core.tpu_format import LANES, MIN_STRIDE
from . import build

MAX_ROWS = 512                  # the reference's decode-GEMM regime
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_MAX_SMEM = 225 * 1024          # a block's shared memory less the statics
_SMS = 132                      # H100 SXM
_SM_SMEM = 228 * 1024           # shared memory of one of its SMs


@dataclass
class TiledECF8Weight:
    """(K, N) fp8 weight in fused-GEMM tile order (tensors on the weight's
    device)."""

    payload: torch.Tensor    # (TK, TN, stride, LANES) uint8
    signmant: torch.Tensor   # (TK, TN, S * LANES // 2) uint8
    lj_limit: torch.Tensor   # (8,) int32
    first_lj: torch.Tensor
    offset: torch.Tensor
    perm: torch.Tensor       # (16,) int32
    k: int
    n: int
    sym_per_lane: int

    @property
    def nbytes(self) -> int:
        return (self.payload.numel() + self.signmant.numel()
                + 4 * (8 * 3 + 16))


def encode_tiled(w_bits: torch.Tensor,
                 sym_per_lane: int = 256) -> TiledECF8Weight:
    """Pack a (K, N) fp8 weight (uint8 bit view) into fused-GEMM tile order;
    the bytes equal the reference's ``encode_tiled``."""
    K, N = w_bits.shape
    S = sym_per_lane
    if K % S or N % LANES:
        raise ValueError(f"encode_tiled: ({K}, {N}) is not a grid of "
                         f"({S}, {LANES}) tiles")
    TK, TN = K // S, N // LANES
    # tile (tk, tn), element (k=s, n=l) -> chunk tk*TN+tn, slot s, lane l
    perm_elems = (w_bits.reshape(TK, S, TN, LANES).permute(0, 2, 1, 3)
                  .reshape(-1))
    c = tpu_format.encode(perm_elems, sym_per_lane=S)
    C, stride, _ = c.payload.shape
    sm = torch.zeros(C * S * LANES // 2, dtype=torch.uint8,
                     device=c.signmant.device)
    sm[: c.signmant.shape[0]] = c.signmant
    return TiledECF8Weight(
        payload=c.payload.reshape(TK, TN, stride, LANES),
        signmant=sm.reshape(TK, TN, S * LANES // 2),
        lj_limit=c.lj_limit, first_lj=c.first_lj, offset=c.offset,
        perm=c.perm, k=K, n=N, sym_per_lane=S)


def decode_tiled(tiled: TiledECF8Weight) -> torch.Tensor:
    """The tiled container -> the (K, N) fp8 weight as bf16 (plain
    decode)."""
    TK, TN, stride, _ = tiled.payload.shape
    S = tiled.sym_per_lane
    bits = tpu_format.decode_plain(
        tiled.payload.reshape(TK * TN, stride, LANES),
        tiled.signmant.reshape(-1), tiled.lj_limit, tiled.first_lj,
        tiled.offset, tiled.perm, sym_per_lane=S, n_elem=tiled.k * tiled.n)
    w = bits.reshape(TK, TN, S, LANES).permute(0, 2, 1, 3).reshape(
        tiled.k, tiled.n)
    return w.contiguous().view(fp8.FP8_DTYPE).to(torch.bfloat16)


def plain(x: torch.Tensor, tiled: TiledECF8Weight,
          out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``x`` cast to bf16, the weight decoded to
    bf16, and ``x_tk @ W_tk`` accumulated in f32 one tile row at a time in
    ``tk`` order (bf16 products are exact in f32; only the order of the
    sums differs from the kernel's)."""
    w = decode_tiled(tiled).float()
    xb = x.to(torch.bfloat16).float()
    S = tiled.sym_per_lane
    acc = torch.zeros((x.shape[0], tiled.n), dtype=torch.float32,
                      device=x.device)
    for tk in range(tiled.k // S):
        acc += xb[:, tk * S:(tk + 1) * S] @ w[tk * S:(tk + 1) * S]
    return acc.to(out_dtype)


def _plan(M: int, TK: int, TN: int, S: int, stride: int):
    """(row block, K splits, tiles a split, payload buffers) of a launch.

    The row block is the smallest of 8, 32, 128 or 256 rows (the ``wgmma``
    widths of one warpgroup, or two of 128) that holds M, else 256.  The
    decode sets the pace and a CTA decodes its tiles one after another, so
    the plan takes the fewest tile-times: waves of resident CTAs (as many as
    an SM's shared memory holds) x tiles a split, among the K splits that
    give at least one wave of the card's SMs where the tiles allow it.  Two
    payload buffers (the next tile's bytes load while this tile decodes)
    unless one, which lets more CTAs share an SM, takes fewer tile-times;
    then the fewest splits.  Every split is non-empty."""
    mb = next((b for b in (8, 32, 128) if M <= b), 256)
    ctas = TN * -(-M // mb)
    best = None
    for pbufs in (2, 1):
        smem = _smem_bytes(S, stride, mb, pbufs)
        if pbufs == 2 and smem > _MAX_SMEM:
            continue
        resident = _SM_SMEM // (smem + 1024)
        slots = _SMS * max(resident, 1)
        for per in range(TK, 0, -1):
            split = -(-TK // per)
            if (split - 1) * per >= TK or ctas * split < min(_SMS,
                                                            ctas * TK):
                continue
            key = (-(-ctas * split // slots) * per, -pbufs, split)
            if best is None or key < best[0]:
                best = (key, split, per, pbufs)
    return mb, best[1], best[2], best[3]


def _smem_bytes(S: int, stride: int, mb: int, pbufs: int) -> int:
    """Dynamic shared memory of one CTA: 1024 bytes of alignment slack,
    decoded (128, 64) bf16 sub-tiles (two, or one at 32 rows or fewer), x's
    (mb, S) bf16 block, ``pbufs`` buffers of a tile's payload (as 32-bit
    words, ``ceil(stride / 4) + 1`` a lane) and its sign/mantissa nibbles,
    and the 4096-entry decode table."""
    a_buffers = 1 if mb <= 32 else 2
    return (1024 + a_buffers * LANES * 128 + -(-S // 64) * mb * 128
            + pbufs * (((stride + 3) // 4 + 1) * LANES * 4 + S * LANES // 2)
            + 4096 * 4)


def run(x: torch.Tensor, tiled: TiledECF8Weight,
        out_dtype=torch.float32) -> torch.Tensor:
    """``x @ decode(W)`` on the card, one launch: x (M, K) with M <=
    ``MAX_ROWS``, cast to bf16 -> (M, N) of ``out_dtype`` (accumulated in
    f32).  ``ops.fused_decode_matmul`` takes any M, in row blocks."""
    tensors = (tiled.payload, tiled.signmant, tiled.lj_limit,
               tiled.first_lj, tiled.offset, tiled.perm)
    if not (x.is_cuda and all(t.is_cuda and t.is_contiguous()
                              for t in tensors)):
        raise ValueError("fused_decode_matmul: x and every container "
                         "tensor must be (contiguous) CUDA tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_decode_matmul: x and the weight are on "
                         "different devices")
    if tiled.payload.dtype != torch.uint8 or \
            tiled.signmant.dtype != torch.uint8:
        raise TypeError("fused_decode_matmul: payload and signmant must be "
                        "uint8")
    if any(t.dtype != torch.int32 for t in tensors[2:]):
        raise TypeError("fused_decode_matmul: tables and perm must be int32")
    S, K, N = tiled.sym_per_lane, tiled.k, tiled.n
    TK, TN, stride, lanes = tiled.payload.shape
    if (x.ndim != 2 or x.shape[1] != K or not 1 <= x.shape[0] <= MAX_ROWS
            or lanes != LANES or (TK * S, TN * LANES) != (K, N)
            or tiled.signmant.shape != (TK, TN, S * LANES // 2)
            or stride < MIN_STRIDE):
        raise ValueError(
            f"fused_decode_matmul: x {tuple(x.shape)} and payload "
            f"{tuple(tiled.payload.shape)} do not make a ({K}, {N}) "
            f"product of at most {MAX_ROWS} rows in ({S}, {LANES}) tiles")
    M = x.shape[0]
    mb, split, per, pbufs = _plan(M, TK, TN, S, stride)
    if _smem_bytes(S, stride, mb, pbufs) > _MAX_SMEM:
        raise ValueError(
            f"fused_decode_matmul: S={S}, stride={stride} need "
            f"{_smem_bytes(S, stride, mb, pbufs)} bytes of shared memory, "
            f"above {_MAX_SMEM}")
    xb = x.to(torch.bfloat16).contiguous()
    if any(t.data_ptr() % 16 for t in (tiled.payload, tiled.signmant, xb)):
        raise ValueError("fused_decode_matmul: payload, signmant and x must "
                         "be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty((split, M, N), dtype=torch.float32, device=x.device)
          if split > 1 else out)
    lib = build.load("fused_decode_matmul", _ARGTYPES)
    err = lib.fused_decode_matmul(
        xb.data_ptr(), *(t.data_ptr() for t in tensors), out.data_ptr(),
        ws.data_ptr(), M, K, N, S, stride, mb, split, per, pbufs,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_decode_matmul launch failed: CUDA error "
                           f"{err}")
    run.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


run.launches = 0
