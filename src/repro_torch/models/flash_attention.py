"""Flash-attention forward: the plain PyTorch version of the flash kernel.

The same chunked online softmax as the reference's
``models/flash_attention.py::_flash_fwd_impl`` (forward only; the backward
arrives with training):

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


def flash_attention(q, k, v, causal: bool = True, attn_softcap: float = 0.0,
                    q_chunk: int = 512, kv_chunk: int = 1024, q_base: int = 0):
    """q: (B, Hq, Tq, D); k/v: (B, Hkv, Tk, D) -> (B, Hq, Tq, D) in v's dtype.

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
    outs = []
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
    o = torch.cat(outs, dim=2) if n_q > 1 else outs[0]
    return o[:, :, :Tq].to(v.dtype)
