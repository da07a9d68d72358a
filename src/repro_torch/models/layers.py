"""Core transformer layers: norms, RoPE, GQA attention (blockwise / decode),
the SwiGLU MLP.  Plain PyTorch functions on tensors.

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
    if mlp_type != "swiglu":
        raise ValueError(f"mlp_type {mlp_type!r}: not yet ported")
    g = x @ mat(params["wi_gate"], dtype)
    u = x @ mat(params["wi_up"], dtype)
    return (F.silu(g.to(F32)).to(dtype) * u) @ mat(params["wo"], dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             lead: tuple = (), dtype=F32):
    """SwiGLU weights with the reference's distributions (``normal *
    fan_in**-0.5``); ``lead`` prepends a stacked-layer dim."""
    if mlp_type != "swiglu":
        raise ValueError(f"mlp_type {mlp_type!r}: not yet ported")
    dev = gen.device

    def normal(shape, s):
        return torch.randn(lead + shape, generator=gen, dtype=dtype,
                           device=dev).mul_(s)

    return {
        "wi_gate": normal((d_model, d_ff), d_model ** -0.5),
        "wi_up": normal((d_model, d_ff), d_model ** -0.5),
        "wo": normal((d_ff, d_model), d_ff ** -0.5),
    }
