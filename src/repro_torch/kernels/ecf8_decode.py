"""ECF8-TPU weight decode on Hopper: the CUDA kernel ``csrc/ecf8_decode.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/ecf8_decode.py``
(``_decode_chunk_kernel`` / ``decode_pallas``) together with the
reference's cast of the decoded weight to its dtype.  One CTA of 64
threads decodes one chunk, two lane streams a thread, each keeping a 64-bit
bit window in registers for ``sym_per_lane`` rounds; the chunk's nibbles
and its payload (transposed into 32-bit words of one lane) are staged in
shared memory before the loop, and a round reads two 256-entry tables that
the CTA builds from the canonical tables (peek -> symbol and length,
symbol and nibble -> value), so no round waits on device memory.  The
kernel writes fp8 bits, or with ``out_dtype`` the bf16 / fp16 / f32 values
themselves (an exact conversion), so no cast kernel follows it.  What
bounds it on the H100 is bytes: the payload and nibbles read once, the
output written once (3.35 TB/s).

:func:`run` launches the kernel for tensors on the card; :data:`plain`
(``core.tpu_format.decode_plain``) is the plain PyTorch version of the same
arithmetic, the only path on the CPU and the comparison on the card.  The
dispatch between the two lives in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ..core.tpu_format import LANES, MIN_STRIDE, decode_plain
from . import build

plain = decode_plain

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# output type codes of the C entry point; None = fp8 bits (uint8)
_OUT_CODES = {None: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.float32: 3}
# the dynamic shared memory the kernel allows itself (csrc: kMaxDynSmem):
# the transposed payload words, ceil(stride / 4) + 1 a lane, and the nibbles
_MAX_SMEM = 225 * 1024


def run(payload, signmant, lj_limit, first_lj, offset, perm, *,
        sym_per_lane: int, n_elem: int,
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Decode one ECF8-TPU container on the card -> (n_elem,) uint8 fp8
    bits, or the values in ``out_dtype`` (bf16, fp16 or f32).

    ``signmant`` is the flat nibble array (``ceil(n_elem / 2)`` bytes, any
    alignment); ``payload`` is one layer's ``(C, stride, 128)`` uniform
    payload (a stacked container is sliced per layer by the caller)."""
    C, stride, lanes = payload.shape
    tensors = (payload, signmant, lj_limit, first_lj, offset, perm)
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("ecf8_decode: every input must be a contiguous "
                         "CUDA tensor")
    if payload.dtype != torch.uint8 or signmant.dtype != torch.uint8:
        raise TypeError("ecf8_decode: payload and signmant must be uint8")
    if any(t.dtype != torch.int32 for t in tensors[2:]):
        raise TypeError("ecf8_decode: tables and perm must be int32")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"ecf8_decode: unsupported out_dtype {out_dtype}")
    if (lj_limit.numel(), first_lj.numel(), offset.numel(),
            perm.numel()) != (8, 8, 8, 16):
        raise ValueError("ecf8_decode: tables must be (8,) and perm (16,)")
    if (lanes != LANES or stride < MIN_STRIDE
            or ((stride + 3) // 4 + 1) * LANES * 4
            + sym_per_lane * LANES // 2 + 16 > _MAX_SMEM):
        raise ValueError(f"ecf8_decode: bad payload shape {payload.shape}")
    if n_elem > C * sym_per_lane * LANES or signmant.numel() < (n_elem + 1) // 2:
        raise ValueError("ecf8_decode: container smaller than n_elem")
    if payload.data_ptr() % 16:
        raise ValueError("ecf8_decode: payload must be 16-byte aligned")
    out = torch.empty(n_elem, dtype=out_dtype or torch.uint8,
                      device=payload.device)
    lib = build.load("ecf8_decode", _ARGTYPES)
    err = lib.ecf8_decode(
        *(t.data_ptr() for t in tensors), out.data_ptr(), C, stride,
        sym_per_lane, n_elem, _OUT_CODES[out_dtype],
        torch.cuda.current_stream(payload.device).cuda_stream)
    if err:
        raise RuntimeError(f"ecf8_decode launch failed: CUDA error {err}")
    run.launches += 1
    run.launches_by_dtype[out.dtype] += 1
    return out


run.launches = 0
run.launches_by_dtype = Counter()   # output dtype -> launches
