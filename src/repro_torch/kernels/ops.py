"""The dispatch point of the port's kernels (the reference's ``ops._on_tpu``).

A tensor on the CPU goes to the kernel's plain PyTorch version; any other
tensor goes to the hand-written CUDA kernel, which launches or raises.
There is no fallback from the card to the CPU or from a kernel to its
plain version.  Attention is differentiable: :class:`FlashAttention` runs
the flash forward with its row statistics and the flash backward.
"""
from __future__ import annotations

import torch

from ..kvcache import kernels as kv_page_decode
from . import ecf8_decode, flash_bwd, flash_fwd
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


class FlashAttention(torch.autograd.Function):
    """Attention with the reference's flash custom VJP
    (``models/flash_attention.py::flash_attention``): the forward is the
    flash kernel with its row statistics (on the CPU the plain
    ``flash_attention_fwd_stats``), and only (q, k, v, o, m, l) are saved:
    no probability tensor.  The backward recomputes the probabilities in
    the flash backward kernel (on the CPU the plain
    ``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softcap: float, q_base: int = 0):
        if q.device.type == "cpu":
            o, m, l = flash_fwd.plain_stats(q, k, v, causal, softcap,
                                            q_base=q_base)
        else:
            o, m, l = flash_fwd.run(q, k, v, causal=causal, softcap=softcap,
                                    stats=True, q_base=q_base)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal, ctx.softcap, ctx.q_base = causal, softcap, q_base
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = flash_bwd.plain(q, k, v, o, m, l, do, ctx.causal,
                                    ctx.softcap, q_base=ctx.q_base)
        else:
            grads = flash_bwd.run(q, k, v, o, m, l, do, causal=ctx.causal,
                                  softcap=ctx.softcap, q_base=ctx.q_base)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = True, attn_softcap: float = 0.0,
                    q_base: int = 0) -> torch.Tensor:
    """Full-sequence attention, q (B, Hq, Tq, D) -> (B, Hq, Tq, D): through
    :class:`FlashAttention` when an input requires a gradient, else one
    forward launch without statistics (every serve path: its weights
    require no gradient).  ``q_base``: the global position of query row 0
    for the causal mask (a model rank's rows of a sharded prefill)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, attn_softcap, q_base)
    if q.device.type == "cpu":
        return flash_fwd.plain(q, k, v, causal, attn_softcap, q_base=q_base)
    return flash_fwd.run(q, k, v, causal=causal, softcap=attn_softcap,
                         q_base=q_base)


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
