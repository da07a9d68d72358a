"""Flash-attention backward on Hopper: the CUDA kernel ``csrc/flash_bwd.cu``.

The port's counterpart of the reference's jnp backward
``src/repro/models/flash_attention.py::_flash_bwd`` (l.142), which is no
TPU kernel: XLA compiles it there.  On the card it is a kernel, in two
deterministic launches without atomics: (a) one CTA per ``(b * Hq + h,
64-row q block)`` computes ``delta = rowsum(dO * O)`` for its rows and dq
over the K/V tiles its rows can see; (b) one CTA per ``(b * Hkv + hk,
64-key block)`` computes dk and dv over every head of the GQA group and
the query tiles that can see its keys.  Both recompute the probabilities
from q, k and the forward's row statistics (m, l) (``flash_fwd.run(...,
stats=True)``), with causality, ragged Tq / Tk and the softcap, as the
forward kernel masks them.  What bounds it on the H100 is operations: five
products of ``2 * D`` flops per visible (q, k) pair, 2.5x the forward's.
bf16 and fp16 multiply on the tensor cores (warp-level ``mma.sync``
m16n8k16, f32 accumulators); f32 computes the same fragments with scalar
FMAs.

:func:`run` launches the kernel for tensors on the card; :data:`plain`
(``models.flash_attention.flash_attention_bwd``) is the plain PyTorch
version, the only path on the CPU and the comparison on the card.  The
dispatch between the two lives in ``kernels/ops.py``
(``FlashAttention.backward``).
"""
from __future__ import annotations

import ctypes

import torch

from ..models.flash_attention import flash_attention_bwd as plain
from . import build

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)


def run(q, k, v, o, m, l, do, causal: bool = True, softcap: float = 0.0):
    """The gradients (dq, dk, dv) of the flash forward at q: (B, Hq, Tq, D),
    k / v: (B, Hkv, Tk, D), from its output ``o``, its row statistics ``m``,
    ``l`` (f32 (B, Hq, Tq)) and the output cotangent ``do``, all on the
    card -> dq like q, dk / dv like k / v."""
    if not all(t.is_cuda and t.is_contiguous()
               for t in (q, k, v, o, m, l, do)):
        raise ValueError("flash_bwd: inputs must be contiguous CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype
            and q.dtype in _DTYPE_CODES):
        raise TypeError(f"flash_bwd: unsupported dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{o.dtype}/{do.dtype}")
    B, Hq, Tq, D = q.shape
    Bk, Hkv, Tk, Dk = k.shape
    if ((Bk, Dk) != (B, D) or v.shape != k.shape or Hq % Hkv
            or o.shape != q.shape or do.shape != q.shape
            or m.shape != (B, Hq, Tq) or l.shape != m.shape
            or m.dtype != torch.float32 or l.dtype != torch.float32):
        raise ValueError(f"flash_bwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} o "
                         f"{tuple(o.shape)} do {tuple(do.shape)} m "
                         f"{tuple(m.shape)} l {tuple(l.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_bwd: q, k, v, o, do must be 16-byte aligned")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_bwd: head_dim {D} not in {_HEAD_DIMS}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(m)
    lib = build.load("flash_bwd", _ARGTYPES)
    err = lib.flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Hq, Hkv, Tq, Tk, D,
        _DTYPE_CODES[q.dtype], int(causal), float(softcap), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    run.launches += 1
    return dq, dk, dv


run.launches = 0
