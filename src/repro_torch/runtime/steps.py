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

On a mesh of ranks (``mesh``, ``launch/mesh.py``; every stack, whisper's
encoder-decoder with its ``frames`` too) the step is GSPMD's placement
written out.
Each rank holds its shard (``runtime.sharding.local_shard``) of every
parameter and AdamW moment under the rule table (``param_pspecs`` /
``opt_pspecs``, ``rules``) and the rows of its batch shard
(``data.pipeline.sharded_batch``).  A leaf is gathered whole inside the
unit that uses it (``runtime.collectives.LeafGather``; again in the remat
recompute) and its gradient summed over the ranks that computed on other
data -- the batch axes, and ``model`` under the sequence split -- into
the rank's f32 shard buffer.  An expert leaf of a MoE layer
(``sharding.is_expert_leaf``, its rule ``("model", "data", None)``) is
gathered over ``data`` alone, so the rank keeps its ``E / M`` experts,
and its gradient summed over the batch axes only.
``rules.activation_partitioning`` (``sharding.make_constrainer``) picks
the work of a model axis: ``"seq"`` (the reference's default) splits the
sequence, each rank running its positions of every layer and the flash
attention against k / v gathered over ``model`` (a local window and a
recurrent mixer read the whole sequence, gathered likewise); ``"none"``
keeps the stream whole over ``model``, every rank repeating the layer but
the attention, whose query rows split (``flash_attention_sharded``).  An
encoder runs whole on every model rank, on its group's frames, and its
gradients sum over ``model`` under the sequence split as the decoder's
do.  The loss is the global batch's mean on every rank, AdamW updates the
shards, and the gradient norm is the whole tree's.  ``grad_accum`` cuts
the rank's rows (and frames) into micro-batches.  ``aux`` is the
reference's on the same mesh with one micro-batch (and 0 with more, as
there).

``make_prefill_step`` / ``make_decode_step`` on a mesh run a rank's batch
shard, ``B / n_batch_shards(mesh)`` rows of ``tokens`` (and ``frames``),
against a rank's cache; their docstrings give its layout.

The dry run's specs (``launch/dryrun.py``): :func:`input_specs`,
:func:`param_specs`, :func:`cache_specs`, :func:`compressed_param_specs`
and :func:`opt_specs` give the reference's trees of ``ShapeDtypeStruct``
as tensors on the ``meta`` device (under a ``FakeTensorMode``, fake ones):
shapes and dtypes alone, nothing drawn or allocated.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..core.store import CompressedMeta, CompressedTensor, torch_dtype
from ..core.tpu_format import DEFAULT_SYM_PER_LANE, LANES
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw, adamw_init, iter_leaves
from ..optim.schedules import cosine_schedule
from .collectives import LeafGather
from .sharding import (DEFAULT_RULES, P, ShardingRules, grad_axes,
                       is_expert_leaf, make_constrainer, named, param_pspecs)

F32 = torch.float32


# --------------------------------------------------------------------------
# the dry run's specs: shape-only trees (meta tensors), nothing allocated
# --------------------------------------------------------------------------

def _input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Shape-only tensors for every model input of this (arch, shape) cell.

    train:   {tokens (B, T) i32, labels (B, T) i32 [, frames (B, F, d)]}
    prefill: {tokens (B, T) i32 [, frames]}
    decode:  {token (B, 1) i32}  (the cache is built via cache_specs)
    """
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sds(s, dtype):
        return torch.empty(s, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"tokens": sds((B, T), i32), "labels": sds((B, T), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": sds((B, T), i32)}
    else:  # decode
        specs = {"token": sds((B, 1), i32)}
    if cfg.encoder_decoder and shape.kind != "decode":
        specs["frames"] = sds((B, cfg.encoder_frames, cfg.d_model),
                              torch_dtype(cfg.dtype))
    return specs


def _param_specs(cfg: ArchConfig, dtype=None) -> dict:
    """Shape-only tree of the parameters (``init_params`` on ``meta``)."""
    return M.init_params(cfg, device="meta",
                         dtype=torch_dtype(dtype or cfg.dtype))


def _cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16) -> dict:
    """Shape-only tree of the decode cache (``init_cache`` on ``meta``)."""
    return M.init_cache(cfg, batch, max_len, torch_dtype(dtype),
                        device="meta")


def _compressed_param_specs(cfg: ArchConfig, bits_per_exp: float = 3.43,
                            min_elems: int = 65536,
                            out_dtype: str = "bfloat16") -> dict:
    """Shape-only stand-in for an ECF8-TPU-compressed param tree.

    The payload stride is data-dependent at encode time; for lowering we
    size it from the expected exponent code length (``bits_per_exp``, ~3.4
    bits at the trained-weight alpha~1.9 — table1_memory measures 3.2-3.5)
    plus lane-padding slack, as the reference does.  Dry-run only: real
    serving compresses real weights (launch/serve.py) and gets exact
    strides."""
    return compressed_specs_of(_param_specs(cfg), bits_per_exp, min_elems,
                               out_dtype)


def compressed_specs_of(base: dict, bits_per_exp: float = 3.43,
                        min_elems: int = 65536,
                        out_dtype: str = "bfloat16", names=()) -> dict:
    """:func:`compressed_param_specs` of the shape-only tree ``base`` (a
    rank's experts alone, say): each leaf of at least ``min_elems``
    elements a layer and two or more dims a layer becomes a
    ``CompressedTensor`` of shape-only arrays on ``base``'s device."""
    if isinstance(base, dict):
        return {k: compressed_specs_of(v, bits_per_exp, min_elems,
                                       out_dtype, names + (str(k),))
                for k, v in base.items()}
    leaf = base
    S = DEFAULT_SYM_PER_LANE
    stride = int(np.ceil(S * (bits_per_exp * 1.06) / 8)) + 1
    stacked = int("units" in names or "layers" in names)
    n = int(np.prod(leaf.shape))
    per_layer = n // leaf.shape[0] if stacked else n
    if per_layer < min_elems or len(leaf.shape) < 2 + stacked:
        return leaf
    C = -(-per_layer // (LANES * S))
    lead = (leaf.shape[0],) if stacked else ()

    def sds(s, dtype):
        return torch.empty(lead + s, dtype=dtype, device=leaf.device)

    arrays = {
        "payload": sds((C, stride, LANES), torch.uint8),
        "signmant": sds((-(-per_layer // 2),), torch.uint8),
        "lj_limit": sds((8,), torch.int32),
        "first_lj": sds((8,), torch.int32),
        "offset": sds((8,), torch.int32),
        "perm": sds((16,), torch.int32),
    }
    meta = CompressedMeta(
        fmt="tpu", shape=tuple(leaf.shape[stacked:]),
        n_elem=per_layer, sym_per_lane=S, out_dtype=out_dtype)
    return CompressedTensor(arrays=arrays, meta=meta)


def _opt_specs(cfg: ArchConfig, dtype=None) -> dict:
    """Shape-only AdamW state of the parameters (f32 moments)."""
    return adamw_init(_param_specs(cfg, dtype))


def _unflatten(paths, values) -> dict:
    tree: dict = {}
    for path, v in zip(paths, values):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def train_pspecs(cfg: ArchConfig, mesh,
                 rules: ShardingRules = DEFAULT_RULES) -> dict:
    """The rule table's spec of every parameter of ``cfg`` on ``mesh``
    (read from a shape-only tree: no rank holds the whole)."""
    shapes = M.init_params(cfg, device="meta", dtype=torch_dtype(cfg.dtype))
    return param_pspecs(cfg, shapes, mesh, rules)


def init_sharded(cfg: ArchConfig, seed: int, mesh,
                 rules: ShardingRules = DEFAULT_RULES, device="cuda",
                 dtype=None):
    """This rank's shards of ``models.model.init_params(cfg, seed)``: every
    leaf drawn whole a unit at a time (the same weights as one card's) and
    cut to the rank's part as it comes, so a rank never holds more than one
    unit's draw of a leaf whole -> (params, specs)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    specs = train_pspecs(cfg, mesh, rules)
    flat = dict(iter_leaves(specs))

    def keep(path, draws, n_layers):
        spec = flat[tuple(path)]
        if n_layers is None:
            return named(mesh, spec).shard(next(draws))
        unit = named(mesh, P(*spec[1:]))
        return torch.stack([unit.shard(d) for d in draws])

    return M.init_params(cfg, seed, device=device, dtype=dtype,
                         leaf=keep), specs


def _make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None,
                     mesh=None, rules: ShardingRules = DEFAULT_RULES,
                     remat: bool = True, grad_accum: int = 1,
                     warmup_steps: int = 100, total_steps: int = 10000):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``params`` is a dense tree (a compressed leaf is refused); its leaves
    are marked as requiring gradients and are updated in place, as are the
    moments of ``opt_state``.  ``batch``: ``tokens`` and ``labels`` (B, T)
    int (and ``frames`` for an encoder-decoder); ``step``: the step
    counter the schedule reads.  With ``mesh``: ``params`` and the moments
    are this rank's shards (:func:`init_sharded`, or ``sharding.
    shard_tree`` of a whole tree) and ``batch`` its rows (the module
    docstring)."""
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, mesh, rules, remat,
                                   grad_accum, warmup_steps, total_steps)

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


def _sharded_train_step(cfg, opt_cfg, mesh, rules, remat, grad_accum,
                        warmup_steps, total_steps):
    """:func:`make_train_step` on a mesh (the module docstring)."""
    if rules.activation_partitioning not in ("seq", "none"):
        raise NotImplementedError(
            f"activation_partitioning={rules.activation_partitioning!r}: "
            f"the port trains with 'seq' or 'none'")
    constrain = make_constrainer(mesh, rules)
    specs = train_pspecs(cfg, mesh, rules)
    flat_spec = dict(iter_leaves(specs))
    # an expert leaf: its rank's E / M experts gathered over data alone,
    # and its gradient summed over the batch axes, never over model (the
    # other model ranks hold other experts)
    expert_paths = {path for path in flat_spec if is_expert_leaf(path)}
    expert_axes = grad_axes(mesh, False)

    def spec_of_experts(spec):
        return P(*(None if a == "model" else a for a in spec))

    def run_train_step(params, opt_state, batch, step):
        paths, leaves = zip(*iter_leaves(params))
        dev = leaves[0].device
        tokens, labels = batch["tokens"], batch["labels"]
        frames = batch.get("frames")
        B, T = tokens.shape
        if B % grad_accum:
            raise ValueError(f"{B} rows a rank do not split into "
                             f"grad_accum={grad_accum} micro-batches")
        axes = grad_axes(mesh, constrain.rows(T) is not None)
        # the rank's f32 gradient shards, summed into by the gathers'
        # backward over every micro-batch
        accs = {path: torch.zeros(p.shape, dtype=F32, device=dev)
                for path, p in zip(paths, leaves)}
        token = torch.zeros((), dtype=F32, device=dev, requires_grad=True)

        def gather(path, x, u):
            spec, acc = flat_spec[path], accs[path]
            if u is not None:
                x, acc, spec = x[u], acc[u], P(*spec[1:])
            if path in expert_paths:
                return LeafGather.apply(token, x, spec_of_experts(spec),
                                        mesh, expert_axes, acc)
            return LeafGather.apply(token, x, spec, mesh, axes, acc)

        mb = B // grad_accum
        loss = torch.zeros((), dtype=F32, device=dev)
        for i in range(grad_accum):
            rows = slice(i * mb, (i + 1) * mb)
            l, met = M.loss_fn(params, cfg, tokens[rows], labels[rows],
                               frames=None if frames is None
                               else frames[rows], mesh=mesh, remat=remat,
                               constrain=constrain, gather=gather)
            torch.autograd.grad(l, [token])
            loss = loss + l.detach()
        if grad_accum > 1:
            grads = [accs[p].div_(grad_accum) for p in paths]
            loss = loss / grad_accum
            met = {"nll": loss, "aux": torch.zeros_like(loss)}
        else:       # one micro-batch: the gradient in the leaf's dtype
            grads = [accs.pop(p).to(x.dtype) for p, x in zip(paths, leaves)]
            met = {k: v.detach() for k, v in met.items()}
        del accs
        lr = cosine_schedule(torch.as_tensor(step, device=dev),
                             warmup_steps, total_steps, opt_cfg.lr)
        params, opt_state, om = adamw(params, _unflatten(paths, grads),
                                      opt_state, opt_cfg, lr=lr, mesh=mesh,
                                      specs=specs)
        return params, opt_state, {"loss": loss, "lr": lr, **met, **om}

    return run_train_step


def _make_prefill_step(cfg: ArchConfig, mesh=None,
                       rules: ShardingRules = DEFAULT_RULES,
                       max_len: int | None = None):
    """(params, batch) -> (last-pos logits, cache).

    On a mesh: ``batch`` holds this rank's rows of the global batch,
    ``B / n_batch_shards(mesh)`` of ``tokens`` (and ``frames``), as the
    train step takes them, and the step returns their logits and the
    rank's cache (``models.model.prefill(..., rows="shard")``).  Each model
    rank runs the whole of its rows, the flash attention splitting the
    query rows of every decoder self-attention over ``model`` (B4 with
    ``q_base`` on the ranks past the first); an encoder and the cross
    attention run whole on each rank; a MoE layer routes as the decode
    step does.  The rank's cache holds the rows over the batch axes, as
    ``runtime.sharding.cache_pspecs`` cuts them, and each self-attention
    K/V that the reference's decode sequence-shards (``models.model.
    seq_split``: ``M > 1`` dividing the row's whole length) holds the model
    rank's positions ``[m S / M, (m + 1) S / M)``, as ``cache_pspecs``
    cuts it.  Three kinds of leaf depart from ``cache_pspecs`` and stay
    whole over ``model``, because the decode step reads them whole: the
    cross K/V (``cache_pspecs`` splits their heads: 1500 frames rarely
    divide), the recurrent states (it splits a feature dim of 1024 or
    more) and a row whose length ``M`` does not divide (it splits heads
    or ``head_dim``).  ``cache["max_len"]`` records ``max_len``: a rank's
    row cannot tell by its shape whether it was cut.

    ``params``: a dense or ECF8 tree replicated on every rank, but a MoE
    layer's experts on a model axis (each rank its ``E / M``,
    ``runtime.sharding.expert_cut``), as the engine takes them.  ``rules``
    is the reference's argument: the weights are not placed by it."""

    def run_prefill(params, batch):
        return M.prefill(params, cfg, batch["tokens"], max_len=max_len,
                         frames=batch.get("frames"), mesh=mesh,
                         rows="shard")

    return run_prefill


def _make_decode_step(cfg: ArchConfig, mesh=None,
                      rules: ShardingRules = DEFAULT_RULES):
    """(params, batch, cache) -> (logits, new cache): one new token.  On a
    mesh ``batch["token"]`` holds this rank's rows and ``cache`` is the
    rank's (:func:`make_prefill_step`'s): each cut row decodes through the
    owner's write and the stat merge over ``model``
    (``decode_sharded.decode_attention_update_sharded``), every other row,
    the cross K/V and the recurrent states whole on each rank; a MoE layer
    routes each data group's rows.  ``params`` and ``rules`` as in
    :func:`make_prefill_step`."""

    def run_decode(params, batch, cache):
        return M.decode_step(params, cfg, batch["token"], cache, mesh=mesh)

    return run_decode


# Defined under private names and bound to the public ones: tools/lint's
# jit-discipline pass resolves a called name across files only when a
# single file under src/ defines it, and the reference's launchers reach
# their steps and the dry run its specs through these names.
make_train_step = _make_train_step
make_prefill_step = _make_prefill_step
make_decode_step = _make_decode_step
input_specs = _input_specs
param_specs = _param_specs
cache_specs = _cache_specs
compressed_param_specs = _compressed_param_specs
opt_specs = _opt_specs
