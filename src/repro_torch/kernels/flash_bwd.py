"""Flash-attention backward on Hopper: the CUDA kernel ``csrc/flash_bwd.cu``.

The port's counterpart of the reference's jnp backward
``src/repro/models/flash_attention.py::_flash_bwd`` (l.142), which is no
TPU kernel: XLA compiles it there.  On the card it is a kernel, in two
deterministic launches without atomics: (a) one CTA per ``(b * Hq + h,
64-row q block)`` computes ``delta = rowsum(dO * O)`` for its rows and dq
over the K/V tiles its rows can see; (b) one CTA per ``(b * Hkv + hk,
128-key block)`` (64 keys at D = 256) computes dk and dv over every head of
the GQA group and the query tiles that can see its keys.  Both recompute
the probabilities from q, k and the forward's row statistics (m, l)
(``flash_fwd.run(..., stats=True)``), with causality, ragged Tq / Tk and
the softcap, as the forward kernel masks them.  What bounds it on the H100
is operations: five products of ``2 * D`` flops per visible (q, k) pair,
2.5x the forward's; S and dP are recomputed by both launches (seven
products), so the design reaches at most 5/7 of that bound.

bf16 and fp16 run all seven products on Hopper's warpgroup MMA
(``wgmma``, f32 accumulators), a warpgroup per 64 rows: S / S^T and dP /
dP^T from K-major swizzled tiles, and dS (in (a)), P^T and dS^T (in (b)),
rounded to the input dtype, fed from registers as the A operand of dq +=
dS K, dv += P^T dO and dk += dS^T q, with K, dO and q read MN-major.  The
loop's tiles arrive by ``cp.async`` into a two-stage ring.  At D = 256 two
warpgroups split the output columns, each computing S and dP.  f32
computes the same fragments with scalar FMAs.  :func:`attributes` reads
each instance's registers and spill bytes.

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
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)


def run(q, k, v, o, m, l, do, causal: bool = True, softcap: float = 0.0,
        q_base: int = 0):
    """The gradients (dq, dk, dv) of the flash forward at q: (B, Hq, Tq, D),
    k / v: (B, Hkv, Tk, D), from its output ``o``, its row statistics ``m``,
    ``l`` (f32 (B, Hq, Tq)) and the output cotangent ``do``, all on the
    card -> dq like q, dk / dv like k / v.  ``q_base`` is the global
    position of query row 0 for the causal mask (a model rank's rows of
    the query-row split, its ``m`` / ``l`` from the forward with the same
    ``q_base``); dk / dv are then the shard's part, zero for a key no row
    of the shard sees.  ``run.launches_q_base`` counts the launches with
    ``q_base != 0``."""
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
    if q_base < 0:
        raise ValueError(f"flash_bwd: q_base {q_base} < 0")
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
        int(q_base), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    run.launches += 1
    run.launches_q_base += bool(q_base)
    return dq, dk, dv


run.launches = 0
run.launches_q_base = 0


def attributes(D: int, dtype: torch.dtype) -> dict:
    """Registers a thread and local (spill) bytes a thread of the instance
    ``(D, dtype)``'s two kernels, as ``cudaFuncGetAttributes`` reports them
    on the card: ``{"dq": (regs, local), "dkv": (regs, local)}``."""
    if D not in _HEAD_DIMS or dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_bwd: no instance (D {D}, {dtype})")
    lib = build.load("flash_bwd", _ARGTYPES)
    fn = lib.flash_bwd_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(D, _DTYPE_CODES[dtype], ctypes.addressof(out))
    if err:
        raise RuntimeError(f"flash_bwd_attrs failed: CUDA error {err}")
    return {"dq": (out[0], out[1]), "dkv": (out[2], out[3])}
