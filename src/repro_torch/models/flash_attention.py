"""Flash attention: the plain PyTorch versions of the flash kernels.

The forward is the same chunked online softmax as the reference's
``models/flash_attention.py::_flash_fwd_impl``
(:func:`flash_attention_fwd_stats` also returns its row statistics m and
l, the residuals of the backward):

  * q is scaled in its own dtype (the scalar rounded to q's dtype first,
    as a JAX weak-typed scalar is);
  * scores are f32 sums of q.k products (bf16 inputs are exact in f32);
  * the running max / denominator are f32, the denominator sums the
    unrounded ``p``, while ``p`` is rounded to v's dtype before the
    ``p @ v`` product, which accumulates in f32;
  * ``o = acc / max(l, 1e-30)`` in v's dtype.

The TPU Pallas kernel (``kernels/flash_fwd.py`` in the reference) instead
multiplies ``p @ v`` in f32; the CUDA kernel ``csrc/flash_fwd.cu`` follows
this function.  At f32 all three agree.

The backward, :func:`flash_attention_bwd`, is the reference's ``_flash_bwd``
(a jnp function there, the CUDA kernel ``csrc/flash_bwd.cu`` on the card):
chunked recompute of the probabilities from (q, k, m, l), never stored;
``delta = rowsum(dO * O)`` in f32; ``p`` and ``ds`` rounded to v's dtype
before their products, which accumulate in f32; the softcap's derivative
``1 - tanh^2`` taken from the raw scores; the GQA group summed into dK
and dV; ``dq * scale`` at the end.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def _softcap(x, cap: float):
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


def scale_in_dtype(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` with the scalar rounded to ``x``'s dtype first, then
    the product rounded to it (what ``x * python_float`` does in JAX)."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


def _gqa_scores(q, k):
    """q: (B, Hq, Tq, D), k: (B, Hkv, Tk, D) -> f32 (B, Hq, Tq, Tk)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = qg @ k.float()[:, :, None].transpose(-1, -2)
    return s.reshape(B, Hq, Tq, k.shape[2])


def _gqa_combine(p, v):
    """p: (B, Hq, Tq, Tk), v: (B, Hkv, Tk, D) -> f32 (B, Hq, Tq, D)."""
    B, Hq, Tq, Tk = p.shape
    Hkv = v.shape[1]
    pg = p.float().reshape(B, Hkv, Hq // Hkv, Tq, Tk)
    o = pg @ v.float()[:, :, None]
    return o.reshape(B, Hq, Tq, v.shape[3])


def _pad_to(x, n, axis):
    if x.shape[axis] == n:
        return x
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, n - x.shape[axis]]
    return F.pad(x, pad)


def flash_attention_fwd_stats(q, k, v, causal: bool = True,
                              attn_softcap: float = 0.0, q_chunk: int = 512,
                              kv_chunk: int = 1024, q_base: int = 0):
    """q: (B, Hq, Tq, D); k/v: (B, Hkv, Tk, D) -> (o (B, Hq, Tq, D) in v's
    dtype, m, l): the row max and the softmax denominator (the unrounded
    ``p`` summed), f32 (B, Hq, Tq), as the reference's ``_flash_fwd_impl``
    returns them.

    ``q_base``: global position of q[:, :, 0] for causal masking."""
    B, Hq, Tq, D = q.shape
    Tk = k.shape[2]
    C = min(q_chunk, Tq)
    K = min(kv_chunk, Tk)
    n_q, n_kv = -(-Tq // C), -(-Tk // K)
    qp = _pad_to(scale_in_dtype(q, D ** -0.5), n_q * C, 2)
    kp = _pad_to(k, n_kv * K, 2)
    vp = _pad_to(v, n_kv * K, 2)
    dev = q.device
    outs, ms, ls = [], [], []
    for qi in range(n_q):
        q_blk = qp[:, :, qi * C:(qi + 1) * C]
        q_pos = q_base + qi * C + torch.arange(C, device=dev)
        acc = torch.zeros((B, Hq, C, D), dtype=torch.float32, device=dev)
        m = torch.full((B, Hq, C), NEG, dtype=torch.float32, device=dev)
        denom = torch.zeros((B, Hq, C), dtype=torch.float32, device=dev)
        for ki in range(n_kv):
            k_blk = kp[:, :, ki * K:(ki + 1) * K]
            v_blk = vp[:, :, ki * K:(ki + 1) * K]
            kv_pos = ki * K + torch.arange(K, device=dev)
            s = _softcap(_gqa_scores(q_blk, k_blk), attn_softcap)
            mask = (kv_pos[None, :] < Tk).expand(C, K)
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _gqa_combine(p.to(v.dtype), v_blk)
            m = m_new
        outs.append(acc / torch.clamp(denom[..., None], min=1e-30))
        ms.append(m)
        ls.append(denom)
    o = torch.cat(outs, dim=2) if n_q > 1 else outs[0]
    m = torch.cat(ms, dim=2) if n_q > 1 else ms[0]
    l = torch.cat(ls, dim=2) if n_q > 1 else ls[0]
    return o[:, :, :Tq].to(v.dtype), m[:, :, :Tq], l[:, :, :Tq]


def flash_attention(q, k, v, causal: bool = True, attn_softcap: float = 0.0,
                    q_chunk: int = 512, kv_chunk: int = 1024, q_base: int = 0):
    """q: (B, Hq, Tq, D); k/v: (B, Hkv, Tk, D) -> (B, Hq, Tq, D) in v's dtype.

    ``q_base``: global position of q[:, :, 0] for causal masking."""
    return flash_attention_fwd_stats(q, k, v, causal, attn_softcap, q_chunk,
                                     kv_chunk, q_base)[0]


def flash_attention_bwd(q, k, v, o, m, l, do, causal: bool = True,
                        attn_softcap: float = 0.0, q_chunk: int = 512,
                        kv_chunk: int = 1024, q_base: int = 0):
    """The reference's ``_flash_bwd``: the gradients (dq, dk, dv) of
    :func:`flash_attention` at (q, k, v) for the output cotangent ``do``,
    from the forward's residuals ``o``, ``m``, ``l``
    (:func:`flash_attention_fwd_stats`), in q's / k's / v's dtypes."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    C = min(q_chunk, Tq)
    K = min(kv_chunk, Tk)
    n_q, n_kv = -(-Tq // C), -(-Tk // K)
    scale = D ** -0.5
    dt = v.dtype
    f32 = torch.float32
    qp = _pad_to(scale_in_dtype(q, scale), n_q * C, 2)   # scaled q below
    kp = _pad_to(k, n_kv * K, 2)
    vp = _pad_to(v, n_kv * K, 2)
    do_p = _pad_to(do.to(f32), n_q * C, 2)
    op = _pad_to(o.to(f32), n_q * C, 2)
    delta = (do_p * op).sum(-1)                  # (B, Hq, Tq_p), pad rows 0
    m_p = _pad_to(m, n_q * C, 2)
    l_p = torch.clamp(_pad_to(l, n_q * C, 2), min=1e-30)
    dev = q.device
    dk_acc = torch.zeros((B, Hkv, n_kv * K, D), dtype=f32, device=dev)
    dv_acc = torch.zeros_like(dk_acc)
    dqs = []

    def grouped(x, n):            # (B, Hq, n, X) -> f32 (B, Hkv, g, n, X)
        return x.to(f32).reshape(B, Hkv, g, n, x.shape[-1])

    for qi in range(n_q):
        rows = slice(qi * C, (qi + 1) * C)
        q_blk = qp[:, :, rows]
        do16 = grouped(do_p[:, :, rows].to(dt), C)
        q16 = grouped(q_blk.to(dt), C)
        m_blk, l_blk = m_p[:, :, rows], l_p[:, :, rows]
        dl_blk = delta[:, :, rows]
        q_pos = q_base + qi * C + torch.arange(C, device=dev)
        dq_blk = torch.zeros((B, Hq, C, D), dtype=f32, device=dev)
        for ki in range(n_kv):
            cols = slice(ki * K, (ki + 1) * K)
            k_blk, v_blk = kp[:, :, cols].to(f32), vp[:, :, cols].to(f32)
            kv_pos = ki * K + torch.arange(K, device=dev)
            s_raw = _gqa_scores(q_blk, kp[:, :, cols])       # f32, pre-cap
            s = _softcap(s_raw, attn_softcap)
            mask = (kv_pos[None, :] < Tk).expand(C, K)
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask, s, NEG)
            # normalised probabilities, recomputed (never stored)
            p = torch.exp(s - m_blk[..., None]) / l_blk[..., None]
            p16 = grouped(p.to(dt), C)
            dv_acc[:, :, cols] += torch.einsum("bhgqk,bhgqd->bhkd", p16,
                                               do16)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do16, v_blk).reshape(
                B, Hq, C, K)
            ds = p * (dp - dl_blk[..., None])
            if attn_softcap:
                t = torch.tanh(s_raw / attn_softcap)
                ds = ds * (1.0 - torch.square(t))
            ds = torch.where(mask, ds, 0.0)
            ds16 = grouped(ds.to(dt), C)
            dq_blk = dq_blk + torch.einsum(
                "bhgqk,bhkd->bhgqd", ds16, k_blk).reshape(B, Hq, C, D)
            dk_acc[:, :, cols] += torch.einsum("bhgqk,bhgqd->bhkd", ds16,
                                               q16)
        dqs.append(dq_blk)
    dq = torch.cat(dqs, dim=2) if n_q > 1 else dqs[0]
    return ((dq[:, :, :Tq] * scale).to(q.dtype),
            dk_acc[:, :, :Tk].to(k.dtype), dv_acc[:, :, :Tk].to(v.dtype))


def _flash_attention_sharded(q, k, v, mesh, *, causal: bool = True,
                             attn_softcap: float = 0.0, q_base=None):
    """The reference's ``flash_attention_sharded`` on a mesh of ranks: the
    *query rows* split over ``model`` (GQA-group-agnostic, unlike a head
    split), k / v whole on every model rank, each rank's flash kernel
    (``ops.flash_attention``, B4 on the card, B5 in the backward) masking
    causally from its rows' global position ``q_base``.  The batch stays
    whole: a serving mesh runs a prefill on one data group (its owner's), a
    training rank on its batch shard's rows.  Two layouts:

      * ``q_base`` None: q / k / v whole and the same on every model rank
        (a prefill; training with the stream whole over ``model``).  The
        rank takes its rows ``[i * T / M, (i + 1) * T / M)`` of q, and o is
        all-gathered in the model group.  When ``T`` does not divide by
        ``M`` (or ``T == 1``) every rank runs the unsharded kernel, as the
        reference falls back.  Differentiable: the backward keeps the
        rank's rows of do, sums dk / dv over ``model`` and gathers dq
        whole (``runtime.collectives``: ``RowGather``, ``SumGrad``,
        ``SplitRows``), so every model rank ends with the same gradients;
      * ``q_base`` given (training with the sequence split over
        ``model``): q / k / v are the rank's own positions ``[q_base,
        q_base + t)``; k / v are all-gathered whole in the model group
        (their backward sums dk / dv over it and keeps the rank's rows) and
        o is the rank's rows alone.

    q: (B, Hq, Tq, D), k / v: (B, Hkv, Tk, D) -> o, like q."""
    from ..kernels import ops
    from ..runtime import collectives as C
    from ..runtime.sharding import axis_size
    n_model = axis_size(mesh, "model")
    B, Hq, Tq, D = q.shape
    if q_base is not None:
        k = C.RowGather.apply(k, mesh, "model", 2, True)
        v = C.RowGather.apply(v, mesh, "model", 2, True)
        return ops.flash_attention(q, k, v, causal, attn_softcap,
                                   q_base=q_base)
    if n_model == 1 or Tq % n_model or Tq <= 1:
        return ops.flash_attention(q, k, v, causal, attn_softcap)
    t_loc = Tq // n_model
    base = mesh.get_local_rank("model") * t_loc
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        q = C.SplitRows.apply(q, mesh, "model", 2)
        k = C.SumGrad.apply(k, mesh, "model")
        v = C.SumGrad.apply(v, mesh, "model")
        o = ops.flash_attention(q, k, v, causal, attn_softcap, q_base=base)
        return C.RowGather.apply(o, mesh, "model", 2, False)
    o = ops.flash_attention(q[:, :, base:base + t_loc].contiguous(), k, v,
                            causal, attn_softcap, q_base=base)
    o = C.gather_rows(o, mesh, "model")            # (n_model, B, Hq, t, D)
    return o.permute(1, 2, 0, 3, 4).reshape(B, Hq, Tq, D)


# Defined under a private name and bound here: tools/lint's jit-discipline
# pass resolves a called name across files only when a single file under
# src/ defines it, and the reference's traced prefill calls this one.
flash_attention_sharded = _flash_attention_sharded
