"""The dispatch point of the port's kernels (the reference's ``ops._on_tpu``).

A tensor on the CPU goes to the kernel's plain PyTorch version; any other
tensor goes to the hand-written CUDA kernel, which launches or raises.
There is no fallback from the card to the CPU or from a kernel to its
plain version.
"""
from __future__ import annotations

import torch

from ..kvcache import kernels as kv_page_decode
from . import ecf8_decode, flash_fwd
from . import fused_decode_matmul as _fused


def decode_ecf8(payload, signmant, lj_limit, first_lj, offset, perm, *,
                sym_per_lane: int, n_elem: int,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One ECF8-TPU container -> (n_elem,) uint8 fp8 bits, or (``out_dtype``
    given) the fp8 values in that dtype, written by the decode itself."""
    fn = ecf8_decode.plain if payload.device.type == "cpu" \
        else ecf8_decode.run
    return fn(payload, signmant, lj_limit, first_lj, offset, perm,
              sym_per_lane=sym_per_lane, n_elem=n_elem, out_dtype=out_dtype)


def flash_attention(q, k, v, causal: bool = True,
                    attn_softcap: float = 0.0) -> torch.Tensor:
    """Full-sequence attention forward, q (B, Hq, Tq, D) -> (B, Hq, Tq, D)."""
    if q.device.type == "cpu":
        return flash_fwd.plain(q, k, v, causal, attn_softcap)
    return flash_fwd.run(q, k, v, causal=causal, softcap=attn_softcap)


def decode_pages(payload, signmant, tables, perm, *, n_elem: int,
                 dtype_name: str, path: str = "other") -> torch.Tensor:
    """N entropy-coded KV pages -> (N, n_elem) values of ``dtype_name``;
    ``path`` tags the kernel's launch count with the caller."""
    if payload.device.type == "cpu":
        return kv_page_decode.plain(payload, signmant, tables, perm,
                                    n_elem=n_elem, dtype_name=dtype_name)
    return kv_page_decode.run(payload, signmant, tables, perm, n_elem=n_elem,
                              dtype_name=dtype_name, path=path)


def fused_decode_matmul(x, tiled, *, out_dtype=torch.float32) -> torch.Tensor:
    """``x @ decode(W)`` with W in the tiled ECF8 layout
    (``fused_decode_matmul.encode_tiled``, any tile depth S that divides K);
    x (M, K), any M >= 1, as the reference's op takes.  M is cut into row
    blocks of at most ``MAX_ROWS`` (the kernel's regime), on the card one
    launch each, on the CPU one call of the plain version each."""
    fn = _fused.plain if x.device.type == "cpu" else _fused.run
    step = _fused.MAX_ROWS
    if x.shape[0] <= step:
        return fn(x, tiled, out_dtype)
    return torch.cat([fn(x[i:i + step], tiled, out_dtype)
                      for i in range(0, x.shape[0], step)])
