"""ECF8-TPU weight decode on Hopper: the CUDA kernel ``csrc/ecf8_decode.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/ecf8_decode.py``
(``_decode_chunk_kernel`` / ``decode_pallas``).  One CTA per chunk, one
thread per lane stream, each keeping its 32-bit bit window in a register
for ``sym_per_lane`` rounds; the chunk's payload is staged in shared
memory with coalesced 16-byte loads, so every refill is a shared-memory
read.  What bounds it on the H100 is bytes: the payload and nibbles read
once, the fp8 bytes written once (3.35 TB/s).

:func:`run` launches the kernel for tensors on the card; :data:`plain`
(``core.tpu_format.decode_plain``) is the plain PyTorch version of the same
arithmetic, the only path on the CPU and the comparison on the card.  The
dispatch between the two lives in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.tpu_format import LANES, MIN_STRIDE, decode_plain
from . import build

plain = decode_plain

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_void_p]
_MAX_STATIC_SMEM = 48 * 1024


def run(payload, signmant, lj_limit, first_lj, offset, perm, *,
        sym_per_lane: int, n_elem: int) -> torch.Tensor:
    """Decode one ECF8-TPU container on the card -> (n_elem,) uint8 fp8 bits.

    ``signmant`` is the flat nibble array (``ceil(n_elem / 2)`` bytes);
    ``payload`` is one layer's ``(C, stride, 128)`` uniform payload (a
    stacked container is sliced per layer by the caller)."""
    C, stride, lanes = payload.shape
    tensors = (payload, signmant, lj_limit, first_lj, offset, perm)
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("ecf8_decode: every input must be a contiguous "
                         "CUDA tensor")
    if payload.dtype != torch.uint8 or signmant.dtype != torch.uint8:
        raise TypeError("ecf8_decode: payload and signmant must be uint8")
    if any(t.dtype != torch.int32 for t in tensors[2:]):
        raise TypeError("ecf8_decode: tables and perm must be int32")
    if (lj_limit.numel(), first_lj.numel(), offset.numel(),
            perm.numel()) != (8, 8, 8, 16):
        raise ValueError("ecf8_decode: tables must be (8,) and perm (16,)")
    if lanes != LANES or not MIN_STRIDE <= stride <= _MAX_STATIC_SMEM // LANES:
        raise ValueError(f"ecf8_decode: bad payload shape {payload.shape}")
    if n_elem > C * sym_per_lane * LANES or signmant.numel() < (n_elem + 1) // 2:
        raise ValueError("ecf8_decode: container smaller than n_elem")
    if payload.data_ptr() % 16:
        raise ValueError("ecf8_decode: payload must be 16-byte aligned")
    out = torch.empty(n_elem, dtype=torch.uint8, device=payload.device)
    lib = build.load("ecf8_decode", _ARGTYPES)
    err = lib.ecf8_decode(
        *(t.data_ptr() for t in tensors), out.data_ptr(), C, stride,
        sym_per_lane, n_elem, torch.cuda.current_stream(payload.device)
        .cuda_stream)
    if err:
        raise RuntimeError(f"ecf8_decode launch failed: CUDA error {err}")
    run.launches += 1
    return out


run.launches = 0
