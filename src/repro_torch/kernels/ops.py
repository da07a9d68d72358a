"""The dispatch point of the port's kernels (the reference's ``ops._on_tpu``).

A tensor on the CPU goes to the kernel's plain PyTorch version; any other
tensor goes to the hand-written CUDA kernel, which launches or raises.
There is no fallback from the card to the CPU or from a kernel to its
plain version.  Attention is differentiable: :class:`FlashAttention` runs
the flash forward with its row statistics and the flash backward.

A kernel's work counts from its shapes, whatever implements it: while an
``analysis.op_cost`` counter is active each call records the kernel's
FLOPs and bytes (the formulas of PERF.md's bound column) and the counter
ignores the launch or the plain version beneath it.  A ``FakeTensor``
input (the dry run's shape-only tensors, ``launch/dryrun.py``) gets a
shape-only result of the kernel's output shapes and dtypes -- for the
attention its row statistics, never the plain version's temporaries --
so a traced step holds what the card would.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..analysis import op_cost
from ..kvcache import kernels as kv_page_decode
from . import ecf8_decode, flash_bwd, flash_fwd
from . import fused_decode_matmul as _fused


def _traced(name: str, flops: float, nbytes: float, compute):
    """``compute()`` recorded as one call of kernel ``name``."""
    with op_cost.kernel(name, flops, nbytes):
        out = compute()
    return op_cost.produced(out)


def decode_ecf8(payload, signmant, lj_limit, first_lj, offset, perm, *,
                sym_per_lane: int, n_elem: int,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One ECF8-TPU container -> (n_elem,) uint8 fp8 bits, or (``out_dtype``
    given) the fp8 values in that dtype, written by the decode itself."""
    def compute():
        if isinstance(payload, FakeTensor):
            return payload.new_empty((n_elem,),
                                     dtype=out_dtype or torch.uint8)
        fn = ecf8_decode.plain if payload.device.type == "cpu" \
            else ecf8_decode.run
        return fn(payload, signmant, lj_limit, first_lj, offset, perm,
                  sym_per_lane=sym_per_lane, n_elem=n_elem,
                  out_dtype=out_dtype)

    if not (op_cost.counting() or isinstance(payload, FakeTensor)):
        return compute()
    nbytes = op_cost.tensor_bytes(payload, signmant, lj_limit, first_lj,
                                  offset, perm) + \
        n_elem * (out_dtype or torch.uint8).itemsize
    return _traced("ecf8_decode", 0.0, nbytes, compute)


def attention_pairs(Tq: int, Tk: int, causal: bool, q_base: int = 0) -> int:
    """The (query, key) pairs the mask leaves visible: every one when not
    causal; causal, query row ``r`` (global position ``q_base + r``) sees
    ``min(q_base + r + 1, Tk)`` keys."""
    if not causal:
        return Tq * Tk
    a, b = q_base, q_base + Tq
    c = max(a, min(b, Tk))
    return (c * (c + 1) - a * (a + 1)) // 2 + max(0, b - max(a, Tk)) * Tk


def _fwd_cost(q, k, v, causal, q_base, stats):
    B, Hq, Tq, D = q.shape
    flops = 4.0 * B * Hq * D * attention_pairs(Tq, k.shape[2], causal,
                                               q_base)
    nbytes = 2 * op_cost.tensor_bytes(q) + op_cost.tensor_bytes(k, v)
    if stats:
        nbytes += 2 * 4 * B * Hq * Tq
    return flops, nbytes


def _fwd(q, k, v, causal, softcap, q_base, stats):
    """The forward kernel (with ``stats`` its row statistics), or its plain
    version on the CPU, or its outputs' shapes for a fake input."""
    if isinstance(q, FakeTensor):
        o = torch.empty_like(q)
        if not stats:
            return o
        m = q.new_empty(q.shape[:3], dtype=torch.float32)
        return o, m, torch.empty_like(m)
    if q.device.type == "cpu":
        f = flash_fwd.plain_stats if stats else flash_fwd.plain
        return f(q, k, v, causal, softcap, q_base=q_base)
    return flash_fwd.run(q, k, v, causal=causal, softcap=softcap,
                         stats=stats, q_base=q_base)


def _attention(q, k, v, causal, softcap, q_base, stats):
    if not (op_cost.counting() or isinstance(q, FakeTensor)):
        return _fwd(q, k, v, causal, softcap, q_base, stats)
    flops, nbytes = _fwd_cost(q, k, v, causal, q_base, stats)
    return _traced("flash_fwd", flops, nbytes,
                   lambda: _fwd(q, k, v, causal, softcap, q_base, stats))


def _bwd(q, k, v, o, m, l, do, causal, softcap, q_base):
    if isinstance(q, FakeTensor):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return flash_bwd.plain(q, k, v, o, m, l, do, causal, softcap,
                               q_base=q_base)
    return flash_bwd.run(q, k, v, o, m, l, do, causal=causal,
                         softcap=softcap, q_base=q_base)


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
        o, m, l = _attention(q, k, v, causal, softcap, q_base, True)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal, ctx.softcap, ctx.q_base = causal, softcap, q_base
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        args = (q, k, v, o, m, l, do, ctx.causal, ctx.softcap, ctx.q_base)
        if not (op_cost.counting() or isinstance(q, FakeTensor)):
            grads = _bwd(*args)
        else:
            B, Hq, Tq, D = q.shape
            flops = 10.0 * B * Hq * D * attention_pairs(
                Tq, k.shape[2], ctx.causal, ctx.q_base)
            nbytes = 2 * op_cost.tensor_bytes(q, k, v) + \
                op_cost.tensor_bytes(o, m, l, do)
            grads = _traced("flash_bwd", flops, nbytes, lambda: _bwd(*args))
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
    return _attention(q, k, v, causal, attn_softcap, q_base, False)


def decode_pages(payload, signmant, tables, perm, *, n_elem: int,
                 dtype_name: str, path: str = "other") -> torch.Tensor:
    """N entropy-coded KV pages -> (N, n_elem) values of ``dtype_name``;
    ``path`` tags the kernel's launch count with the caller."""
    def compute():
        if isinstance(payload, FakeTensor):
            return payload.new_empty(
                (payload.shape[0], n_elem),
                dtype=kv_page_decode.TORCH_DTYPES[dtype_name])
        if payload.device.type == "cpu":
            return kv_page_decode.plain(payload, signmant, tables, perm,
                                        n_elem=n_elem, dtype_name=dtype_name)
        return kv_page_decode.run(payload, signmant, tables, perm,
                                  n_elem=n_elem, dtype_name=dtype_name,
                                  path=path)

    if not (op_cost.counting() or isinstance(payload, FakeTensor)):
        return compute()
    nbytes = op_cost.tensor_bytes(payload, signmant, tables, perm) + \
        payload.shape[0] * n_elem * \
        kv_page_decode.TORCH_DTYPES[dtype_name].itemsize
    return _traced("kv_page_decode", 0.0, nbytes, compute)


def fused_decode_matmul(x, tiled, *, out_dtype=torch.float32) -> torch.Tensor:
    """``x @ decode(W)`` with W in the tiled ECF8 layout
    (``fused_decode_matmul.encode_tiled``, any tile depth S that divides K);
    x (M, K), any M >= 1, as the reference's op takes.  M is cut into row
    blocks of at most ``MAX_ROWS`` (the kernel's regime), on the card one
    launch each, on the CPU one call of the plain version each."""
    def compute(xb):
        if isinstance(xb, FakeTensor):
            return xb.new_empty((xb.shape[0], tiled.n), dtype=out_dtype)
        fn = _fused.plain if xb.device.type == "cpu" else _fused.run
        return fn(xb, tiled, out_dtype)

    def block(xb):
        if not (op_cost.counting() or isinstance(xb, FakeTensor)):
            return compute(xb)
        M, K = xb.shape
        nbytes = op_cost.tensor_bytes(xb) + tiled.nbytes + \
            M * tiled.n * out_dtype.itemsize
        return _traced("fused_decode_matmul", 2.0 * M * K * tiled.n, nbytes,
                       lambda: compute(xb))

    step = _fused.MAX_ROWS
    if x.shape[0] <= step:
        return block(x)
    return torch.cat([block(x[i:i + step])
                      for i in range(0, x.shape[0], step)])
