"""Core transformer layers: norms (RMS, and the layer norm no path calls,
as in the reference), RoPE, GQA attention (blockwise / local
window / decode), the MLPs (SwiGLU, GELU, GeGLU, squared ReLU).  Plain
PyTorch functions on tensors.

Weights may be ``CompressedTensor``s (ECF8): every use site goes through
``mat`` = materialize-and-cast, the paper's just-in-time per-layer
decompression (§3.3).  The rounding points follow the reference's
``models/layers.py`` (``rms_norm`` in f32, RoPE angles in f32 with the
rotation in the storage dtype, q scaled in its own dtype).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.store import materialize
from .flash_attention import _softcap, scale_in_dtype

F32 = torch.float32

# full-sequence attention implementation: "flash" (the flash kernels, the
# production default) or "blockwise" (the plain online-softmax
# :func:`blockwise_attention`, the reference's naive baseline).  Switched by
# the dry run's --attn flag.
_ATTN_IMPL = {"full": "flash"}


def set_attention_impl(name: str):
    assert name in ("flash", "blockwise"), name
    _ATTN_IMPL["full"] = name


def _get_attention_impl() -> str:
    return _ATTN_IMPL["full"]


def mat(w, dtype):
    """Materialize (decode if compressed) and cast a weight for use."""
    return materialize(w, dtype=dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """The reference's ``layer_norm``: mean and (population) variance in
    f32, ``y * scale + bias`` in f32, rounded to ``x``'s dtype."""
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., T, head_dim); positions: (..., T) int.

    Angles (position-dependent) are computed in f32; the rotation products
    run in the storage dtype."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=F32,
                            device=x.device)
    ang = positions.to(F32)[..., None] * freqs  # (..., T, hd/2)
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# blockwise attention (online softmax)
# --------------------------------------------------------------------------

def _gqa_scores(q, k):
    """q: (B, Hq, Tq, D), k: (B, Hkv, Tk, D) -> (B, Hq, Tq, Tk) in q's dtype
    (an einsum without a preferred element type: f32 sums, rounded)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    qg = q.to(F32).reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = qg @ k.to(F32)[:, :, None].transpose(-1, -2)
    return s.reshape(B, Hq, Tq, k.shape[2]).to(q.dtype)


def _gqa_combine(p, v):
    """p: (B, Hq, Tq, Tk) f32, v: (B, Hkv, Tk, D) -> f32 (B, Hq, Tq, D)."""
    B, Hq, Tq, Tk = p.shape
    Hkv = v.shape[1]
    pg = p.reshape(B, Hkv, Hq // Hkv, Tq, Tk)
    o = pg @ v.to(F32)[:, :, None]
    return o.reshape(B, Hq, Tq, v.shape[3])


def blockwise_attention(q, k, v, *, causal: bool = True, q_offset=0,
                        attn_softcap: float = 0.0, q_chunk: int = 512,
                        kv_chunk: int = 1024, kv_len=None):
    """Memory-safe attention.  q: (B, Hq, Tq, D), k/v: (B, Hkv, Tk, D).

    ``q_offset``: absolute position of q[0] (for decode / chunked prefill).
    ``kv_len``: valid KV length, an int or a (B,) tensor of per-slot
    lengths (serving engine)."""
    B, Hq, Tq, D = q.shape
    Tk = k.shape[2]
    q = scale_in_dtype(q, D ** -0.5)
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, Tk)
    n_q = -(-Tq // q_chunk)
    n_kv = -(-Tk // kv_chunk)
    Tq_p, Tk_p = n_q * q_chunk, n_kv * kv_chunk
    if Tq_p != Tq:
        q = F.pad(q, (0, 0, 0, Tq_p - Tq))
    if Tk_p != Tk:
        k = F.pad(k, (0, 0, 0, Tk_p - Tk))
        v = F.pad(v, (0, 0, 0, Tk_p - Tk))
    dev = q.device
    kv_len = torch.as_tensor(Tk if kv_len is None else kv_len, device=dev)
    per_batch = kv_len.ndim == 1  # (B,) per-slot lengths (serving engine)

    outs = []
    for qi in range(n_q):
        q_blk = q[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, Hq, q_chunk, D), dtype=F32, device=dev)
        m = torch.full((B, Hq, q_chunk), -1e30, dtype=F32, device=dev)
        denom = torch.zeros((B, Hq, q_chunk), dtype=F32, device=dev)
        for ki in range(n_kv):
            k_blk = k[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = v[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
            kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = _softcap(_gqa_scores(q_blk, k_blk).to(F32), attn_softcap)
            if per_batch:
                mask = kv_pos[None, None, None, :] < kv_len[:, None, None,
                                                            None]
            else:
                mask = (kv_pos[None, :] < kv_len)[None, None]
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])[None, None]
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _gqa_combine(p, v_blk)
            m = m_new
        outs.append(acc / torch.clamp(denom[..., None], min=1e-30))
    out = torch.cat(outs, dim=2) if n_q > 1 else outs[0]
    return out[:, :, :Tq].to(v.dtype)


def local_attention(q, k, v, *, window: int, attn_softcap: float = 0.0,
                    q_chunk: int = 1024, q_base=None):
    """Causal sliding-window attention, O(Tq * window): the reference's
    ``local_attention``, computed outside any kernel there as here.

    q: (B, Hq, Tq, D), k/v: (B, Hkv, Tk, D).  Each q chunk ``[i*C,
    (i+1)*C)`` attends to the K/V slice ``[i*C - W, (i+1)*C)`` (zero-padded
    in front), masked to ``q_pos - W < kv_pos <= q_pos`` and ``kv_pos >=
    0``; the softcap comes before the mask, q is scaled in its own dtype,
    and the softmax is f32.

    ``q_base`` (training's sequence split): q holds positions ``[q_base,
    q_base + Tq)`` of a sequence whose k / v are whole (``Tk >= q_base +
    Tq``), and the chunks, their K/V slices and the mask are shifted by it:
    the reference's whole-sequence call cut to these rows.  None (or 0)
    with ``Tk == Tq`` is the call above, chunk for chunk."""
    B, Hq, Tq, D = q.shape
    base = q_base or 0
    Tk = k.shape[2]
    q = scale_in_dtype(q, D ** -0.5)
    C = min(q_chunk, Tq)
    n_q = -(-Tq // C)
    Tq_p = n_q * C
    if Tq_p != Tq:
        q = F.pad(q, (0, 0, 0, Tq_p - Tq))
    W = min(window, Tk)
    ctx = C + W                     # kv context of one q chunk
    tail = max(base + Tq_p - Tk, 0)
    k_pad = F.pad(k, (0, 0, W, tail))
    v_pad = F.pad(v, (0, 0, W, tail))
    dev = q.device
    outs = []
    for qi in range(n_q):
        lo = base + qi * C          # the chunk's first global position
        q_blk = q[:, :, qi * C:(qi + 1) * C]
        k_blk = k_pad[:, :, lo:lo + ctx]
        v_blk = v_pad[:, :, lo:lo + ctx]
        s = _softcap(_gqa_scores(q_blk, k_blk).to(F32), attn_softcap)
        q_pos = lo + torch.arange(C, device=dev)
        kv_pos = lo + torch.arange(ctx, device=dev) - W
        mask = ((kv_pos[None, :] <= q_pos[:, None])
                & (kv_pos[None, :] > q_pos[:, None] - W)
                & (kv_pos[None, :] >= 0))
        s = torch.where(mask[None, None], s, -1e30)
        outs.append(_gqa_combine(torch.softmax(s, dim=-1), v_blk))
    out = torch.cat(outs, dim=2) if n_q > 1 else outs[0]
    return out[:, :, :Tq].to(v.dtype)


def decode_attention(q, k_cache, v_cache, *, kv_len,
                     attn_softcap: float = 0.0):
    """Single-token decode attention over a cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); kv_len: int or (B,) tensor."""
    return blockwise_attention(
        q, k_cache, v_cache, causal=False, attn_softcap=attn_softcap,
        kv_len=kv_len, q_chunk=1, kv_chunk=min(2048, k_cache.shape[2]),
    )


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_apply(params, x, mlp_type: str, dtype):
    """The reference's four MLP types.  ``swiglu`` and ``geglu`` apply
    their gate's activation in f32; ``gelu`` and ``sqrelu`` apply theirs in
    the compute dtype."""
    if mlp_type == "swiglu":
        g = x @ mat(params["wi_gate"], dtype)
        u = x @ mat(params["wi_up"], dtype)
        return (F.silu(g.to(F32)).to(dtype) * u) @ mat(params["wo"], dtype)
    if mlp_type == "gelu":
        h = F.gelu(x @ mat(params["wi"], dtype), approximate="tanh")
        return h @ mat(params["wo"], dtype)
    if mlp_type == "geglu":
        g = x @ mat(params["wi_gate"], dtype)
        u = x @ mat(params["wi_up"], dtype)
        return (F.gelu(g.to(F32), approximate="tanh").to(dtype) * u) @ mat(
            params["wo"], dtype)
    if mlp_type == "sqrelu":
        h = F.relu(x @ mat(params["wi"], dtype))
        return torch.square(h) @ mat(params["wo"], dtype)
    raise ValueError(mlp_type)


def mlp_init(new, d_model: int, d_ff: int, mlp_type: str):
    """MLP weights with the reference's leaves and distributions (``normal
    * fan_in**-0.5``): ``wi_gate`` / ``wi_up`` / ``wo`` for the gated
    types, ``wi`` / ``wo`` for ``gelu`` and ``sqrelu``.  ``new(name,
    shape, scale)`` draws a leaf (``models.model.init_params``)."""
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    if mlp_type in ("swiglu", "geglu"):
        return {"wi_gate": new("wi_gate", (d_model, d_ff), s_in),
                "wi_up": new("wi_up", (d_model, d_ff), s_in),
                "wo": new("wo", (d_ff, d_model), s_ff)}
    if mlp_type in ("gelu", "sqrelu"):
        return {"wi": new("wi", (d_model, d_ff), s_in),
                "wo": new("wo", (d_ff, d_model), s_ff)}
    raise ValueError(mlp_type)


# Defined under a private name and bound to the public one: tools/lint's
# jit-discipline pass resolves a called name across files only when a
# single file under src/ defines it, and the reference's jitted attention
# calls ``get_attention_impl``.
get_attention_impl = _get_attention_impl
