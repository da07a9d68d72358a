"""Oracles of the port's kernels that are not their plain versions.

``fused_decode_matmul_ref`` is the reference's own oracle
(``src/repro/kernels/ref.py``): ``x @ upcast(fp8(W))`` in one product with
f32 accumulation, for the tolerance the reference's fused-GEMM test uses.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import fp8


def fused_decode_matmul_ref(x: np.ndarray, w_bits: np.ndarray,
                            out_dtype=torch.float32) -> torch.Tensor:
    """Oracle for ``fused_decode_matmul``: x @ upcast(fp8(W)).

    ``w_bits`` is the (K, N) uint8 bit view of the fp8 weight."""
    w = torch.from_numpy(np.ascontiguousarray(w_bits, np.uint8)).view(
        fp8.FP8_DTYPE).to(torch.bfloat16)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    return (xb.float() @ w.float()).to(out_dtype)
