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

On a mesh of ranks (``mesh=``, a ``("data", "model")`` DeviceMesh,
``launch/mesh.py``) the layer routes as the reference's does on the same
mesh (its ``shard_map`` branch is taken only for a model axis above 1):

  * a model axis of ``M > 1``: each data group routes its own rows, with
    ``cap`` from those rows, and each rank holds ``E / M`` experts
    (``runtime.sharding.expert_cut``).  The ``(E, cap, d)`` dispatch
    buffer goes out as ``(M, E / M, cap, d)`` through one ``all_to_all``
    over ``model`` (``runtime.collectives.all_to_all``), the rank's
    experts run on the rows of every source, and a second ``all_to_all``
    returns their outputs in global expert order to the combine.  As in
    the reference, the ``M`` ranks of a group hold the same rows, so each
    receives ``M`` identical copies of its experts' rows;
  * without one: the whole batch is routed at once (``cap`` from all its
    rows), every expert local.  Where a rank holds only its data group's
    rows of the batch (``rows="shard"``, the split paged decode step),
    the groups' f32 routing weights are all-gathered over ``data``, each
    expert takes its top ``cap`` over the whole batch (a tie to the lower
    global row), and each rank runs the experts on the selected rows it
    holds: one device's result.

``rows`` says what ``x`` holds: ``"shard"`` this data group's rows of a
batch split over ``data``; ``"own"`` a batch only this group computes (a
prefill, a chunk), routed as one group; ``"all"`` the whole batch, the
same on every rank (the monolithic cache's replicated step), whose rows
the mesh's data groups route apart where a model axis is there (one group
when ``data`` does not divide them).

Training on a mesh (``models.model.forward(mesh=)``) takes ``rows="shard"``
and differentiates both branches: the exchanges are
``collectives.ExpertExchange`` (an ``all_to_all`` whose backward is the
same exchange) and the routing weights' gather over ``data`` a
``collectives.RowGather`` whose backward sums the cotangent over the batch
axes.  On a model axis the gradients are those of the reference's
``shard_map`` (:func:`_expert_parallel_grads`); under the sequence split
(``seq``) the layer gathers its group's positions over ``model`` first.
Each rank's expert gradients are its own experts' (summed over ``data``
by the caller, never over ``model``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import collectives
from ..runtime.sharding import (axis_size, batch_axes, batch_index,
                                n_batch_shards)
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


def _gate(x, gate_w, top_k: int, n_experts: int):
    """x (T, d) -> (each token's weight an expert, 0 where not routed (T,
    E); the softmax probabilities (T, E)), f32."""
    T = x.shape[0]
    logits = (x @ gate_w).to(F32)                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top(probs, top_k)                      # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    w_te = torch.zeros((T, n_experts), dtype=F32, device=x.device)
    w_te.scatter_(1, top_i, top_p)
    return w_te, probs


def _aux(w_te, probs, n_experts: int):
    """The Switch-style load-balancing loss of a routing."""
    frac_tokens = (w_te > 0).to(F32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)


def _route_local(x, gate_w, top_k: int, n_experts: int, capacity: int):
    """Local routing: x (T, d) -> dispatch buffer + combine metadata.

    Returns (buf (E, C, d), sel_idx (E, C), sel_w (E, C), aux_loss)."""
    T = x.shape[0]
    # per-expert weight of each token (0 if not routed there): (E, T)
    w_te, probs = _gate(x, gate_w, top_k, n_experts)
    w_et = w_te.T

    # per-expert top-C token selection
    sel_w, sel_idx = _top(w_et, min(capacity, T))          # (E, C)
    if capacity > T:
        pad = capacity - T
        sel_w = F.pad(sel_w, (0, pad))
        sel_idx = F.pad(sel_idx, (0, pad))
    buf = x[sel_idx]                                       # (E, C, d)
    buf = buf * (sel_w[..., None] > 0).to(x.dtype)

    return buf, sel_idx, sel_w, _aux(w_te, probs, n_experts)


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


def _capacity(n_rows: int, cfg) -> int:
    """Tokens an expert takes from a routing group of ``n_rows`` rows."""
    return max(8, int((n_rows * cfg.top_k * cfg.capacity_factor)
                      / cfg.n_experts + 0.999))


def _expert_parallel(xg, gate_w, experts, cfg, mesh):
    """The reference's ``shard_map`` body on a model axis, for ``G`` data
    groups a rank computes at once: xg (G, n, d), each group routed apart
    -> ((G, n, d), the groups' mean aux loss)."""
    G, n, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    n_ep = axis_size(mesh, "model")
    e_loc = E // n_ep
    cap = _capacity(n, cfg)
    routed = [_route_local(xg[g], gate_w, k, E, cap) for g in range(G)]
    buf = torch.stack([r[0] for r in routed])             # (G, E, cap, d)
    # (n_ep, G, E_loc, cap, d): row j holds rank j's experts' rows
    send = buf.reshape(G, n_ep, e_loc, cap, d).transpose(0, 1)
    got = collectives.ExpertExchange.apply(send, mesh, "model")  # source j
    h = got.permute(2, 0, 1, 3, 4).reshape(e_loc, n_ep * G * cap, d)
    y = _expert_ffn(*experts, h)
    y = y.reshape(e_loc, n_ep, G, cap, d).permute(1, 2, 0, 3, 4)
    y = collectives.ExpertExchange.apply(y, mesh, "model")  # rank j's
    y = y.transpose(0, 1).reshape(G, E, cap, d)           # global experts
    out = torch.stack([_combine(y[g], r[1], r[2], n, k)
                       for g, r in enumerate(routed)])
    return out, torch.stack([r[3] for r in routed]).mean()


def _expert_parallel_grads(x, gate_w, experts, cfg, mesh, seq=None):
    """:func:`_expert_parallel` for a data group's rows x (B, T, d) on a
    model axis of ``M`` ranks, with the gradients of the reference's
    ``shard_map`` (run with ``check_rep=False``) -> ((B, T, d), aux).  Each
    exchange's backward is its transpose; the ``M`` ranks of a group send
    the same rows, so each expert receives ``M`` copies of their
    cotangents.  Two cases, as the caller's cotangents are laid out:

      * ``seq`` None: x is whole on the group's ranks and so is the
        cotangent of the output.  The reference's transpose: the
        output's and the aux loss's cotangents divided by ``M``, and x's
        and the gate's summed over ``model``;
      * ``seq = (start, length)`` (training's sequence split): x holds
        positions ``[start, start + length)`` of the group's sequence, the
        rest on the group's other ranks.  The sequence is gathered over
        ``model``, routed whole, and the rank's positions returned, so the
        output's cotangent here covers those positions alone: the ``M``
        ranks' cotangents add to the whole one, the copies arrive at the
        experts undivided, and the gather's backward sums x's cotangent
        over ``model``; the gate's sums there with the rest of its
        gradient (the caller's)."""
    n_ep = axis_size(mesh, "model")
    if seq is None:
        x = collectives.SumGrad.apply(x, mesh, "model")
        gate_w = collectives.SumGrad.apply(gate_w, mesh, "model")
    else:
        x = collectives.RowGather.apply(x.contiguous(), mesh, "model", 1,
                                        True)
    B, T, d = x.shape
    out, aux = _expert_parallel(x.reshape(1, B * T, d), gate_w, experts, cfg,
                                mesh)
    out = out.reshape(B, T, d)
    if seq is None:
        return (collectives.ScaleGrad.apply(out, 1.0 / n_ep),
                collectives.ScaleGrad.apply(aux, 1.0 / n_ep))
    return out.narrow(1, seq[0], seq[1]), aux


def _routed_over_data(xt, gate_w, experts, cfg, mesh):
    """The whole batch routed at once when a rank holds only its data
    group's rows xt (n, d) of it: the groups' routing weights gathered
    over ``data``, every expert's top ``cap`` chosen over the batch (ties
    to the lower global row), the experts run on the chosen rows held
    here -> ((n, d) one device's rows, the batch's aux loss)."""
    n, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    w_te, probs = _gate(xt, gate_w, k, E)
    # in the backward each rank's rows take the cotangent summed over the
    # ranks (every rank routes the whole batch from them)
    both = collectives.RowGather.apply(torch.cat([w_te, probs], 1), mesh,
                                       batch_axes(mesh), 0, True)
    w_all, p_all = both[:, :E], both[:, E:]
    N = w_all.shape[0]
    cap = _capacity(N, cfg)
    sel_w, sel_idx = _top(w_all.T, min(cap, N))           # (E, C) global
    if cap > N:
        sel_w = F.pad(sel_w, (0, cap - N))
        sel_idx = F.pad(sel_idx, (0, cap - N))
    lo = batch_index(mesh) * n
    here = (sel_idx >= lo) & (sel_idx < lo + n)
    sel_w = torch.where(here, sel_w, 0.0)                  # others' rows: 0
    sel_idx = torch.where(here, sel_idx - lo, 0)
    buf = xt[sel_idx] * (sel_w[..., None] > 0).to(xt.dtype)
    y = _expert_ffn(*experts, buf)
    return _combine(y, sel_idx, sel_w, n, k), _aux(w_all, p_all, E)


def _moe_apply(params, x, cfg, *, mesh=None, rows: str = "all", seq=None,
               dtype=torch.bfloat16):
    """x: (B, T, d) -> ((B, T, d) in x's dtype, aux loss).  ``mesh`` and
    ``rows``: the module docstring.  On a model axis the expert leaves
    must hold this rank's ``E / M`` experts; the aux loss is then the mean
    over the groups this rank routes (the reference's is over all).
    ``seq``: see :func:`_expert_parallel_grads`."""
    if rows not in ("shard", "own", "all"):
        raise ValueError(f"rows={rows!r}: 'shard', 'own' or 'all'")
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_ep = axis_size(mesh, "model")
    n_data = n_batch_shards(mesh)
    if E % n_ep:
        raise ValueError(f"{cfg.name}: {E} experts do not split over a "
                         f"model axis of {n_ep}")

    gate_w = mat(params["gate"], dtype)
    experts = tuple(mat(params[n], dtype) for n in ("wi_gate", "wi_up",
                                                     "wo"))
    if experts[0].shape[0] * n_ep != E:
        raise ValueError(
            f"{cfg.name}: this rank holds {experts[0].shape[0]} experts; a "
            f"model axis of {n_ep} needs {E // n_ep} of {E} a rank "
            f"(runtime.sharding.expert_cut)")
    if seq is not None and (n_ep == 1 or rows != "shard"):
        raise ValueError(f"seq={seq}: the sequence split takes rows='shard' "
                         f"on a model axis")

    xt = x.to(dtype).reshape(B * T, d)
    if n_ep > 1 and rows == "shard":
        out, aux = _expert_parallel_grads(xt.reshape(B, T, d), gate_w,
                                          experts, cfg, mesh, seq)
    elif n_ep > 1:
        G = n_data if rows == "all" and B % n_data == 0 else 1
        out, aux = _expert_parallel(xt.reshape(G, B * T // G, d), gate_w,
                                    experts, cfg, mesh)
    elif rows == "shard" and n_data > 1:
        out, aux = _routed_over_data(xt, gate_w, experts, cfg, mesh)
    else:
        buf, sel_idx, sel_w, aux = _route_local(
            xt, gate_w, k, E, _capacity(B * T, cfg))
        y = _expert_ffn(*experts, buf)
        out = _combine(y, sel_idx, sel_w, B * T, k)
    out = out.reshape(B, T, d)

    if "shared" in params:
        out = out + mlp_apply(params["shared"], x.to(dtype), "swiglu", dtype)
    return out.to(x.dtype), aux


# Defined under a private name and bound to the public one, as
# ``models/model.py``'s entry points are: tools/lint's jit-discipline pass
# resolves a called name across files only when a single file under src/
# defines it, and the reference's jitted model steps reach their MoE layer
# through ``moe_apply``.
moe_apply = _moe_apply
