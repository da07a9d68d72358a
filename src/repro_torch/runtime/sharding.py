"""Sharding rules: logical parameter / cache axes -> mesh axes (the
reference's ``runtime/sharding.py``, without GSPMD).

The rule table is data: :func:`param_pspecs` and :func:`cache_pspecs` give
the reference's ``PartitionSpec`` for every leaf, as a port-local :class:`P`
(one mesh axis name, a tuple of names, or None a dim), leaf for leaf equal
to the reference's on the same tree.  Nothing places a tensor by them
implicitly: a rank takes its slice with :func:`local_shard`.  The port's
serve path replicates the weights, as the reference's does, except a
mixture-of-experts layer's expert leaves, which a model axis splits over
their expert dim (:func:`expert_cut`, from the rule table with the data
axis dropped: the reference's serve ``shard_map`` takes them ``P(ep_axis,
None, None)``), and keeps the paged cache's pool / cold-slot rows of its
own batch shard (``kvcache.paged.PagedKVCache(n_shards=..., shard=...)``),
the rows :func:`cache_pspecs` shards over the batch axes.

A ``mesh`` here is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` (``launch/mesh.py``) or a :class:`MeshShape`, the axis
names and sizes alone (enough for the rules: a (16, 16) production mesh
can be reasoned about on a host with one process), with a rank's
coordinates where a caller cuts that rank's slice without a process group.

Training on a mesh places every parameter and AdamW moment by the table:
each rank keeps ``local_shard`` of each leaf (:func:`named` /
:class:`NamedSharding`, :func:`shard_tree`), gathers it whole where a unit
uses it and sums its gradient over :func:`grad_axes`;
:func:`make_constrainer` says whether a model axis splits the sequence
or the stream's ``d_model``.
The batch splits over :func:`batch_axes`, ``pod`` folded into ``data``
(:func:`n_batch_shards`, :func:`batch_index`), for the engine's batch
shards as for training's.

Policy (the reference's DESIGN.md §5): 2-D weights put the input / embed
dim on ``data`` and the output / heads / ffn / vocab dim on ``model``
(``wo``-like matrices transposed); MoE experts on ``model``; the batch on
``("pod", "data")``; the paged pools' page dim, the cold pool's slot dim and
the page table's batch dim on the batch axes; contiguous K/V caches' sequence
on ``model``; a stacked leaf gets a leading None.  A dim is sharded only when
its size divides by the axes' size (:func:`_fit`).

A compressed container's children are keyed the way the reference's pytree
keys them, by position in sorted name order ("0", "1", ...), so they fall
through to replication there and here alike.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.store import CompressedTensor, is_compressed


class P(tuple):
    """A partition spec: one entry a dim (an axis name, a tuple of names, or
    None).  ``P("data", None)`` as the reference writes it."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or process groups;
    ``coords`` (one index an axis) places one rank on it, as
    ``DeviceMesh.get_local_rank`` reads a rank's."""

    axis_names: tuple
    sizes: tuple
    coords: tuple = ()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def get_local_rank(self, axis: str) -> int:
        if not self.coords:
            raise ValueError("a MeshShape without coords places no rank")
        return self.coords[self.axis_names.index(axis)]


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of a MeshShape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh or without that axis)."""
    if mesh is None:
        return 1
    return mesh_shape(mesh).shape.get(axis, 1)


def batch_axes(mesh):
    """Mesh axes the global batch shards over ('pod' folds into DP): a
    tuple of names, a single name, or None when the mesh has no batch axis
    -- all three drop into a :class:`P` entry unchanged."""
    names = mesh_shape(mesh).axis_names
    ax = tuple(a for a in ("pod", "data") if a in names)
    if not ax:
        return None
    return ax if len(ax) != 1 else ax[0]


def axes_size(mesh, axes) -> int:
    """Ranks along ``axes``: one name, a tuple of names (their product), or
    None (1)."""
    return _axis_size(mesh, axes)


def n_batch_shards(mesh) -> int:
    """How many shards the global batch splits into: the product of the
    batch axes' sizes, ``("pod", "data")`` folded (1 without a mesh), as
    the reference's ``EngineConfig.n_shards`` counts them."""
    if mesh is None:
        return 1
    return _axis_size(mesh, batch_axes(mesh))


def batch_index(mesh) -> int:
    """This rank's batch shard, its index along the batch axes folded as
    :func:`n_batch_shards` counts them (0 without a mesh)."""
    if mesh is None:
        return 0
    return axis_index(mesh, batch_axes(mesh))


def _axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh).shape
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([shape[a] for a in axis]))
    return shape[axis]


def _fit(mesh, spec_dims, shape) -> P:
    """Drop axes that don't divide their dim (replicate those dims)."""
    out = []
    for dim, axis in zip(shape, spec_dims):
        if axis is not None and dim % _axis_size(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return P(*out)


# parameter name -> spec of the *unstacked* shape, rank-dispatched
_IN_OUT = ("wq", "wk", "wv", "wi", "wi_gate", "wi_up", "w_in", "w_gate_in",
           "w_up", "w_q", "w_k", "w_v", "w_if", "w", "w_a", "w_x")
_OUT_IN = ("wo", "w_out", "w_down")


@dataclass(frozen=True)
class ShardingRules:
    """The reference's knobs.  Precedence: the name / rank rule picks a base
    spec; ``serve_tp`` drops the data (FSDP) axis from it; :func:`_fit`
    drops any axis whose size does not divide its dim.
    ``activation_partitioning`` is the residual-stream rule of a training
    step (:func:`make_constrainer`)."""

    activation_partitioning: str = "seq"
    vocab_tp: bool = True
    expert_fsdp: bool = True
    serve_tp: bool = False


DEFAULT_RULES = ShardingRules()


def _param_rule(names, shape, mesh, rules: ShardingRules) -> P:
    name = names[-1]
    rank = len(shape)
    stacked = int("units" in names or "layers" in names)
    base_rank = rank - stacked

    def done(spec_dims):
        if rules.serve_tp:  # pure TP: drop the FSDP (data) axis
            spec_dims = tuple(None if d == "data" else d for d in spec_dims)
        return _fit(mesh, (None,) * stacked + tuple(spec_dims), shape)

    if name == "embed":
        return done(("model" if rules.vocab_tp else None, "data"))
    if name == "unembed":
        return done(("data", "model" if rules.vocab_tp else None))
    if name == "pos_embed":
        return done((None, "data"))
    if base_rank <= 1:
        return done((None,) * base_rank)  # norms, biases, lam: replicate

    in_moe = "moe" in names and "shared" not in names
    if in_moe:
        d_ax = "data" if rules.expert_fsdp else None
        if name == "gate":
            return done(("data", None))
        if name in ("wi_gate", "wi_up"):
            return done(("model", d_ax, None))
        if name == "wo":
            return done(("model", None, d_ax))

    if name == "r" and base_rank == 3:       # slstm recurrent: (H, dh, 4dh)
        return done(("model", None, None))
    if name == "conv_w":
        return done((None, "model"))
    if name in _OUT_IN:
        return done(("model", "data"))
    if name in _IN_OUT:
        return done(("data", "model"))
    if name in ("payload", "codes", "signmant", "escapes"):
        return _fit(mesh, (None,) * stacked + ("model",)
                    + (None,) * (base_rank - 1), shape)
    return P(*(None,) * rank)


# the expert-stacked leaves of a mixture-of-experts layer (its shared
# experts are a dense MLP, replicated)
EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")
# serving splits nothing over the data (FSDP) axis: that entry is
# training's
SERVE_RULES = ShardingRules(serve_tp=True)


def is_expert_leaf(names) -> bool:
    """Whether the leaf at path ``names`` holds one matrix an expert."""
    return (names[-1] in EXPERT_LEAVES and "moe" in names
            and "shared" not in names)


def expert_rows(n_experts: int, mesh) -> tuple:
    """``[lo, hi)``: the experts this rank holds on the serve path, the
    block of ``n_experts / M`` at its index along the model axis of size
    ``M`` (all of them without one).  Raises when ``M`` does not divide
    ``n_experts``: the reference's ``shard_map`` cannot split them either."""
    n = axis_size(mesh, "model")
    if n_experts % n:
        raise ValueError(f"{n_experts} experts do not split over a model "
                         f"axis of {n} ({n_experts} % {n} = "
                         f"{n_experts % n})")
    per = n_experts // n
    i = mesh.get_local_rank("model") if n > 1 else 0
    return i * per, (i + 1) * per


def expert_cut(names, shape, mesh):
    """``(dim, lo, hi)``: the rows of the leaf at ``names`` (its whole,
    stacked ``shape``) a serving rank of ``mesh`` keeps, or None for a leaf
    every rank holds whole.  An expert leaf's spec under
    :data:`SERVE_RULES` puts ``model`` on its expert dim; a model axis that
    does not divide it raises, where the rule table would replicate."""
    if not is_expert_leaf(names) or axis_size(mesh, "model") == 1:
        return None
    spec = _param_rule(names, tuple(shape), mesh, SERVE_RULES)
    dim = int("units" in names or "layers" in names)
    lo, hi = expert_rows(shape[dim], mesh)
    if spec[dim] != "model" or any(a is not None for i, a in
                                   enumerate(spec) if i != dim):
        raise ValueError(f"{'/'.join(names)} {tuple(shape)}: spec {spec}, "
                         f"not the expert dim over 'model'")
    return dim, lo, hi


def _walk(tree, names=()):
    """(path names, leaf) of a nested dict; a ``CompressedTensor``'s arrays
    in sorted name order, keyed by their position as the reference's
    pytree keys them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, names + (str(k),))
    elif is_compressed(tree):
        for i, k in enumerate(sorted(tree.arrays)):
            yield names + (str(i),), tree.arrays[k]
    else:
        yield names, tree


def _map(tree, fn, names=()):
    """``tree`` with every leaf replaced by ``fn(names, leaf)`` (a
    compressed container keeps its meta, its arrays mapped)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, names + (str(k),)) for k, v in tree.items()}
    if is_compressed(tree):
        return CompressedTensor(
            {k: fn(names + (str(i),), tree.arrays[k])
             for i, k in enumerate(sorted(tree.arrays))}, tree.meta)
    return fn(names, tree)


def flatten(tree) -> dict:
    """{path: leaf} of a tree of specs or tensors, in walk order (what a
    test compares with the reference's ``tree_flatten_with_path``)."""
    return dict(_walk(tree))


def param_pspecs(cfg: ArchConfig, params, mesh,
                 rules: ShardingRules = DEFAULT_RULES):
    """A :class:`P` for every leaf of ``params`` (tensors, ``meta``-device
    shape-only tensors, or compressed containers), the tree's structure
    kept."""
    return _map(params, lambda names, x: _param_rule(names, tuple(x.shape),
                                                     mesh, rules))


_PAGED_COLD = ("_cpl", "_csm", "_ctab", "_cperm")


def _cache_leaf_rule(names, shape, cfg: ArchConfig, mesh) -> P:
    name = names[-1]
    ba = batch_axes(mesh)
    stacked = int("units" in names)
    rank = len(shape)
    base_rank = rank - stacked
    if name == "cur_len":
        return _fit(mesh, (ba,), shape) if rank == 1 else P()
    if name == "page_table":
        return _fit(mesh, (ba, None), shape)
    if name.endswith("_pool") or name.endswith(_PAGED_COLD):
        return _fit(mesh, (None,) * stacked + (ba,)
                    + (None,) * (base_rank - 1), shape)
    if name in ("k", "v") and base_rank == 4:
        S = shape[stacked + 2]
        n_model = mesh_shape(mesh).shape.get("model", 0)
        if not n_model:
            spec = (ba, None, None, None)
        elif "cross" not in names and S % n_model == 0:
            spec = (ba, None, "model", None)
        elif shape[stacked + 1] % n_model == 0:
            spec = (ba, "model", None, None)
        else:
            spec = (ba, None, None, "model")
        return _fit(mesh, (None,) * stacked + spec, shape)
    if base_rank >= 1:
        spec = [ba] + [None] * (base_rank - 1)
        if base_rank >= 2 and shape[-1] >= 1024:
            spec[-1] = "model"
        return _fit(mesh, (None,) * stacked + tuple(spec), shape)
    return P(*(None,) * rank)


def cache_pspecs(cfg: ArchConfig, cache, mesh):
    """A :class:`P` for every leaf of a decode cache (contiguous or paged),
    the tree's structure kept."""
    return _map(cache, lambda names, x: _cache_leaf_rule(
        names, tuple(x.shape), cfg, mesh))


def opt_pspecs(param_specs):
    """Optimizer-state specs: the moments inherit the parameter sharding."""
    return {"mu": param_specs, "nu": param_specs, "count": P()}


def axis_index(mesh, axis) -> int:
    """This rank's index along ``axis`` (a name or a tuple of names, their
    linear index as the reference folds ``("pod", "data")``)."""
    if axis is None:
        return 0
    if isinstance(axis, (tuple, list)):
        i = 0
        for a in axis:
            i = i * _axis_size(mesh, a) + mesh.get_local_rank(a)
        return i
    return mesh.get_local_rank(axis)


def local_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec`` (a view): each sharded dim
    cut into the axes' size of equal parts, the part at this rank's index
    along them."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = _axis_size(mesh, axis)
        size = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axis) * size, size)
    return x


def grad_axes(mesh, seq: bool) -> tuple:
    """The axes whose ranks compute on other data in a training step, over
    which a gradient (or the loss) sums: the batch axes, and ``model``
    when the sequence is split over it (``seq``).  An axis whose ranks
    compute the same thing is not among them."""
    ba = batch_axes(mesh)
    axes = () if ba is None else (ba if isinstance(ba, tuple) else (ba,))
    return axes + (("model",) if seq else ())


def spec_axes(spec) -> set:
    """The mesh axes a spec shards over."""
    out = set()
    for axis in spec:
        if isinstance(axis, (tuple, list)):
            out.update(axis)
        elif axis is not None:
            out.add(axis)
    return out


def counts_once(spec, mesh) -> bool:
    """Whether this rank is the one that counts its shard of a leaf under
    ``spec`` in a sum over the whole mesh (a global norm): its index is 0
    along every axis the spec leaves the leaf replicated over."""
    used = spec_axes(spec)
    return all(mesh.get_local_rank(a) == 0
               for a in mesh_shape(mesh).axis_names
               if a not in used and axis_size(mesh, a) > 1)


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its :class:`P` on ``mesh`` (the reference's
    ``jax.sharding.NamedSharding``).  :meth:`shard` cuts a rank's part
    from the whole leaf; ``runtime.collectives.gather_leaf`` puts the
    ranks' parts back together."""

    mesh: object
    spec: P

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole ``x``, a tensor of its own (not a
        view that would keep the whole alive)."""
        return local_shard(x, self.spec, self.mesh).clone()


def shard_tree(tree, shardings):
    """Every leaf of a whole ``tree`` cut to this rank's part by the same
    tree of :class:`NamedSharding` (:func:`named`)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    return shardings.shard(tree)


def _named(mesh, tree_of_pspecs):
    """A tree of :class:`P` -> the same tree of :class:`NamedSharding`."""
    if isinstance(tree_of_pspecs, dict):
        return {k: _named(mesh, v) for k, v in tree_of_pspecs.items()}
    return NamedSharding(mesh, tree_of_pspecs)


def _make_constrainer(mesh, rules: ShardingRules):
    """The residual-stream rule between units (the reference's
    ``make_constrainer``).  Each rank holds its batch shard's rows (the
    batch over ``batch_axes``); the rule says what more a model axis cuts:

      * ``"seq"``: the sequence (``P(ba, "model", None)``), when the model
        axis divides ``T > 1``;
      * ``"dmodel"``: the stream's ``d_model`` columns (``P(ba, None,
        "model")``), when the model axis divides ``d``;
      * otherwise the stream is whole over ``model`` (``P(ba, None,
        None)``), as the reference falls back.

    The reference also leaves the stream unconstrained when the batch axes
    do not divide its rows; here a rank's rows are its batch shard's
    (``data.pipeline.sharded_batch`` refuses a batch they do not divide),
    so that case cannot arise.

    ``constrain(x)`` takes a rank's (B_loc, T, d) stream and returns its
    positions under the sequence split (a view), else ``x``;
    ``constrain.rows(T)`` is ``(start, length)`` of the rank's positions,
    or None when the sequence stays whole; ``constrain.cols(d)`` is
    ``(start, width)`` of the rank's columns, or None when ``d`` stays
    whole; ``constrain.spec(x)`` the stream's :class:`P`.  With one
    process a rank the cut, once made after the embedding, holds between
    units: no GSPMD re-lays the stream out there.  The columns are cut by
    the model (``models.model.forward``), which also gathers them where a
    norm reads the stream, so the block's work and its gradients are
    ``"none"``'s."""
    ba = batch_axes(mesh)
    mode = rules.activation_partitioning
    n_model = axis_size(mesh, "model")

    def rows(T: int):
        if mode != "seq" or n_model == 1 or T <= 1 or T % n_model:
            return None
        t = T // n_model
        return mesh.get_local_rank("model") * t, t

    def cols(d: int):
        if mode != "dmodel" or n_model == 1 or d % n_model:
            return None
        w = d // n_model
        return mesh.get_local_rank("model") * w, w

    def spec(x) -> P:
        if x.ndim == 3 and rows(x.shape[1]) is not None:
            return P(ba, "model", None)
        if x.ndim == 3 and cols(x.shape[2]) is not None:
            return P(ba, None, "model")
        return P(ba, *(None,) * (x.ndim - 1))

    def constrain(x):
        cut = rows(x.shape[1]) if x.ndim == 3 else None
        return x if cut is None else x.narrow(1, cut[0], cut[1])

    constrain.rows, constrain.cols, constrain.spec = rows, cols, spec
    return constrain


# Defined under private names and bound to the public ones: tools/lint's
# jit-discipline pass resolves a called name across files only when a
# single file under src/ defines it, and the reference's train step calls
# ``make_constrainer``, its tests ``named``.
named = _named
make_constrainer = _make_constrainer
