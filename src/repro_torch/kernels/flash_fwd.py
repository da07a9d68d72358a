"""Flash-attention forward on Hopper: the CUDA kernel ``csrc/flash_fwd.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_fwd.py``
(``_flash_fwd_kernel`` / ``flash_fwd_pallas``).  One CTA per
``(b * Hq + h, 64-row q block)`` loops over 64-key K/V tiles, keeps the
running max and denominator in f32, and maps GQA head ``h`` to kv head
``h // (Hq / Hkv)``; it masks ragged ``Tq``/``Tk`` itself (the Pallas
kernel asserts ``Tq % bq == 0 and Tk % bk == 0``) and, under causality,
skips the K/V tiles no row of its block can see.  What bounds it on the
H100 is operations (``4 * D`` flops per visible query/key pair).  The bf16
and fp16 instances run both products on the tensor cores with warpgroup
MMA (``wgmma``: Q and K from swizzled shared memory, P from the softmax's
registers, V from shared memory; K/V tiles in a two-stage ``cp.async``
ring); at head_dim 256 two warpgroups of the CTA share every tile and
split O's columns, each recomputing S.  The f32 instance keeps scalar f32
FMAs, since TF32 tensor cores would not give f32 results.

Numerics follow the function the reference's serve path runs,
``models/flash_attention.py::_flash_fwd_impl``, not the Pallas kernel: q is
scaled in its own dtype and ``p`` is rounded to v's dtype before the
``p @ v`` product (the Pallas kernel multiplies ``p @ v`` in f32).  At f32
the two agree.

Training asks for the row statistics too (``stats=True``): each row's
final running max m and denominator l, f32 (B, Hq, Tq), the residuals of
the reference's ``_flash_fwd`` that the backward (``kernels/flash_bwd.py``)
rebuilds the probabilities from.  The kernel stores them beside o and
changes nothing else, so o is the same bits with or without them; the
serve path passes none.

:func:`run` launches the kernel for tensors on the card; :data:`plain`
(``models.flash_attention.flash_attention``) is the plain PyTorch version,
the only path on the CPU and the comparison on the card.  The dispatch
between the two lives in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.flash_attention import flash_attention as plain
from ..models.flash_attention import flash_attention_fwd_stats as plain_stats
from . import build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)


def run(q, k, v, causal: bool = True, softcap: float = 0.0,
        stats: bool = False):
    """q: (B, Hq, Tq, D), k/v: (B, Hkv, Tk, D) on the card -> o (B, Hq, Tq, D)
    in v's dtype, or with ``stats`` (o, m, l), m and l f32 (B, Hq, Tq)."""
    if not all(t.is_cuda and t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k, v must be contiguous CUDA tensors")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd: unsupported dtypes "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, Hq, Tq, D = q.shape
    Bk, Hkv, Tk, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k, v must be 16-byte aligned")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {D} not in {_HEAD_DIMS}")
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = build.load("flash_fwd", _ARGTYPES)
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr() if stats else None, l.data_ptr() if stats else None,
        B, Hq, Hkv, Tq, Tk, D, _DTYPE_CODES[q.dtype], int(causal),
        float(softcap), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    run.launches += 1
    return (o, m, l) if stats else o


run.launches = 0
