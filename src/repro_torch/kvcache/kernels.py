"""KV-cache page decode on Hopper: the CUDA kernel ``csrc/kv_page_decode.cu``.

Replaces the Pallas TPU kernel ``src/repro/kvcache/kernels.py``
(``_decode_page_kernel`` / ``decode_page_indices_pallas``) and the XLA tail
that the reference applies after it (``codec.finish_pages_jnp``): one CTA
per page, one thread per lane stream.  The page's payload and its whole
sign/mantissa plane arrive in shared memory in one trip before the loop,
the payload transposed into 32-bit words of one lane; the CTA builds a
peek -> (symbol, length) table (:func:`codec.decode_table`) while the
copies are in flight, so a symbol costs one shared-memory read and no
round reads device memory.  The perm lookup and sign/mantissa fuse are
done in the kernel, so no int32 index array goes through device memory.
What bounds it on the H100 is bytes: the coded page read once, the values
written once (3.35 TB/s); at a few hundred pages its time is one CTA's
life.  A page too large to stage (:func:`instance`) goes to the kernel's
streamed instance, which reads its payload words and plane from device
memory and so serves every page size the reference serves.

:func:`run` launches the kernel for tensors on the card; :data:`plain`
(``codec.decode_pages_plain``) is the plain PyTorch version of the same
arithmetic, the only path on the CPU and the comparison on the card.  The
dispatch between the two lives in ``kernels/ops.py``.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..kernels import build
from .codec import LANES, MIN_STRIDE, TORCH_BITS, TORCH_DTYPES, \
    decode_pages_plain, plane_spec, sm_bytes, sym_per_lane

plain = decode_pages_plain

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_KIND = {"float8_e4m3fn": 0, "bfloat16": 1, "float32": 2}
# dynamic shared memory the kernel may take (csrc: kMaxDynSmem): the H100's
# 227 KB a block, less the static decode table and perm
_MAX_SMEM = 217 * 1024


def _smem_bytes(stride: int, sm: int) -> int:
    """Dynamic shared memory of one CTA: the payload as 32-bit words,
    ``ceil(stride / 4) + 1`` a lane, and the sign/mantissa plane in 16-byte
    granules from the one that holds its first byte."""
    return ((stride + 3) // 4 + 1) * LANES * 4 + (-(-sm // 16) + 1) * 16


def instance(stride: int, sm: int) -> str:
    """The kernel instance for pages of this shape: ``'staged'`` when the
    payload words and the plane fit the dynamic shared memory
    (:func:`_smem_bytes` <= ``_MAX_SMEM``), else ``'streamed'`` (both read
    from device memory, no size limit).  Chosen by shape alone, never on a
    failed launch."""
    return "staged" if _smem_bytes(stride, sm) <= _MAX_SMEM else "streamed"


def run(payload, signmant, tables, perm, *, n_elem: int, dtype_name: str,
        path: str = "other") -> torch.Tensor:
    """Decode N coded pages on the card -> (N, n_elem) values of
    ``dtype_name`` (the argument order of ``codec.decode_pages_plain``).

    ``path`` names the caller for the launch counts: ``run.launches`` is the
    total, ``run.launches_by_path[path]`` the caller's share ('gather': the
    decode step's and the prefill chunk's cold pool, 'verify': a
    speculative verify's, 'fault': the swap tier), and
    ``run.launches_by_instance`` counts the :func:`instance` launched."""
    tensors = (payload, signmant, tables, perm)
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("kv_page_decode: every input must be a contiguous "
                         "CUDA tensor")
    if payload.dtype != torch.uint8 or signmant.dtype != torch.uint8:
        raise TypeError("kv_page_decode: payload and signmant must be uint8")
    if tables.dtype != torch.int32 or perm.dtype != torch.int32:
        raise TypeError("kv_page_decode: tables and perm must be int32")
    exp_bits, max_len, _ = plane_spec(dtype_name)
    N, stride, lanes = payload.shape
    sm = sm_bytes(dtype_name, n_elem)
    if (lanes != LANES or stride < MIN_STRIDE
            or signmant.shape != (N, sm)
            or tables.shape != (N, 3, max_len)
            or perm.shape != (N, 1 << exp_bits)):
        raise ValueError(
            f"kv_page_decode: shapes payload {tuple(payload.shape)}, "
            f"signmant {tuple(signmant.shape)}, tables "
            f"{tuple(tables.shape)}, perm {tuple(perm.shape)} do not make "
            f"{N} {dtype_name} pages of {n_elem} elements")
    inst = instance(stride, sm)
    if inst == "staged" and payload.data_ptr() % 16:
        raise ValueError("kv_page_decode: payload must be 16-byte aligned")
    out = torch.empty((N, n_elem), dtype=TORCH_BITS[dtype_name],
                      device=payload.device)
    if N:
        lib = build.load("kv_page_decode", _ARGTYPES)
        err = lib.kv_page_decode(
            *(t.data_ptr() for t in tensors), out.data_ptr(), N, stride, sm,
            max_len, 1 << exp_bits, sym_per_lane(n_elem), n_elem,
            _KIND[dtype_name], int(inst == "staged"),
            torch.cuda.current_stream(payload.device).cuda_stream)
        if err:
            raise RuntimeError(f"kv_page_decode launch failed: CUDA error "
                               f"{err}")
        run.launches += 1
        run.launches_by_path[path] += 1
        run.launches_by_instance[inst] += 1
    return out.view(TORCH_DTYPES[dtype_name])


run.launches = 0
run.launches_by_path = collections.Counter()
run.launches_by_instance = collections.Counter()
