"""Step functions: train / prefill / decode (the reference's
``runtime/steps.py``).

``make_train_step`` returns ``(params, opt_state, batch, step) -> (params,
opt_state, metrics)`` with the reference's metrics (``loss``, ``lr``,
``nll``, ``aux``, ``grad_norm``): the loss and its gradients through the
differentiable model (``models.model.loss_fn``: B4 with its statistics
forward, B5 backward on the card), the cosine schedule, and AdamW, which
updates the parameters and moments in place (``optim/adamw.py``).  With
``grad_accum > 1`` the batch is cut into micro-batches whose gradients are
summed into f32 buffers and divided, as the reference's ``lax.scan`` sums
them, and ``aux`` is reported as 0, as there.  ``remat`` recomputes each
unit's activations in the backward.

The reference's mesh (sharding rules, sequence-parallel constraints) and
its dry-run specs (``input_specs``, ``param_specs``,
``compressed_param_specs``) are not ported yet: a ``mesh`` is refused.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw, iter_leaves
from ..optim.schedules import cosine_schedule

F32 = torch.float32
_NOT_YET_PORTED = "mesh={!r}: not yet ported (the port trains on one card)"


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(_NOT_YET_PORTED.format(mesh))


def _unflatten(paths, values) -> dict:
    tree: dict = {}
    for path, v in zip(paths, values):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None,
                     mesh=None, remat: bool = True, grad_accum: int = 1,
                     warmup_steps: int = 100, total_steps: int = 10000):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``params`` is a dense tree (a compressed leaf is refused); its leaves
    are marked as requiring gradients and are updated in place, as are the
    moments of ``opt_state``.  ``batch``: ``tokens`` and ``labels`` (B, T)
    int (and ``frames`` for an encoder-decoder); ``step``: the step
    counter the schedule reads."""
    _refuse_mesh(mesh)
    opt_cfg = opt_cfg or AdamWConfig()

    def loss_and_grads(params, leaves, tokens, labels, frames):
        loss, met = M.loss_fn(params, cfg, tokens, labels, frames=frames,
                              remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in met.items()}, grads

    def run_train_step(params, opt_state, batch, step):
        paths, leaves = zip(*iter_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        tokens, labels = batch["tokens"], batch["labels"]
        frames = batch.get("frames")
        if grad_accum > 1:
            mb = tokens.shape[0] // grad_accum
            grads = [torch.zeros(p.shape, dtype=F32, device=p.device)
                     for p in leaves]
            loss = torch.zeros((), dtype=F32, device=tokens.device)
            for i in range(grad_accum):
                rows = slice(i * mb, (i + 1) * mb)
                l, _, g = loss_and_grads(
                    params, leaves, tokens[rows], labels[rows],
                    None if frames is None else frames[rows])
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss = loss + l
            for acc in grads:
                acc.div_(grad_accum)
            loss = loss / grad_accum
            met = {"nll": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, met, grads = loss_and_grads(params, leaves, tokens,
                                               labels, frames)
        lr = cosine_schedule(torch.as_tensor(step, device=tokens.device),
                             warmup_steps, total_steps, opt_cfg.lr)
        params, opt_state, om = adamw(params, _unflatten(paths, grads),
                                      opt_state, opt_cfg, lr=lr)
        return params, opt_state, {"loss": loss, "lr": lr, **met, **om}

    return run_train_step


def _make_prefill_step(cfg: ArchConfig, mesh=None,
                       max_len: int | None = None):
    """(params, batch) -> (last-pos logits, cache)."""
    _refuse_mesh(mesh)

    def run_prefill(params, batch):
        return M.prefill(params, cfg, batch["tokens"], max_len=max_len,
                         frames=batch.get("frames"))

    return run_prefill


def _make_decode_step(cfg: ArchConfig, mesh=None):
    """(params, batch, cache) -> (logits, new cache): one new token."""
    _refuse_mesh(mesh)

    def run_decode(params, batch, cache):
        return M.decode_step(params, cfg, batch["token"], cache)

    return run_decode


# Defined under private names and bound to the public ones: tools/lint's
# jit-discipline pass resolves a called name across files only when a
# single file under src/ defines it, and the reference's launchers reach
# their steps through these names.
make_train_step = _make_train_step
make_prefill_step = _make_prefill_step
make_decode_step = _make_decode_step
