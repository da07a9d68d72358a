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
    ``activation_partitioning`` is read by the reference's residual-stream
    constraint, which the training-mesh slice ports."""

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
