"""Collectives of the port's mesh: the ECF8-FR compressed weight all-gather
(the reference's ``runtime/collectives.py``) and the small exchanges that
keep the ranks of a mesh engine in step.

Compressed all-gather.  Exponent concentration holds on the interconnect
too: a weight all-gather moves the same exponent-redundant bytes a step.
ECF8-FR (``core/fixedrate.py``) codes with static shapes, so each rank
encodes its shard with a fixed table and escape capacity
(``fixedrate.encode_plain``), all-gathers three ``uint8`` arrays -- the
2-bit codes, the nibble-packed escapes, the nibble-packed sign/mantissa --
and decodes every shard with ``fixedrate.decode_plain``: bit-exact, the
overflow flag any-reduced.  Wire bytes an element: 0.25 (codes) + 0.5
(sign/mantissa) + 0.5 x the escape share, against 1.0 for a raw fp8
gather and 2.0 for bf16.  There is no kernel: the reference's encode and
decode are jnp, and the collectives are NCCL's (gloo on the CPU).

Rank exchanges.  Every rank of a mesh engine runs the same host engine on
the same inputs; a value only some ranks hold (a sampled token of a data
group's slot, an encoded page's byte count on the shard that holds the
page, a swapped page's coded arrays when its request resumes on another
shard) reaches the others through :func:`broadcast_object` or
:func:`gather_rows` before any host decision reads it.  Weights are
replicated, each rank building its tree from the seed, except the expert
leaves of a mixture-of-experts layer, which a model axis splits
(``runtime.sharding.expert_cut``); :func:`check_replicated` compares a
checksum of every rank's other leaves over the mesh and of its expert
leaves over the ranks that share its model index.

Expert exchange.  :func:`all_to_all` over one axis's group is the
reference's ``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
tiled=False)``: row ``i`` of a ``(n, ...)`` tensor goes to the group's
rank ``i``, and row ``j`` of the result came from its rank ``j``
(``models/moe.py`` sends each model rank its experts' dispatch rows and
returns their outputs).  :func:`gather_rows` over ``data`` carries a
batch shard's routing weights where the whole batch is routed at once.

Training on a mesh (``runtime/steps.py``): the placement GSPMD gives the
reference, written out as differentiable collectives.  :class:`LeafGather`
gathers a parameter whole from the ranks' shards where a unit uses it and,
in its backward, sums the leaf's gradient over the axes whose ranks
computed on other data and adds the rank's shard of it into an f32
buffer.  The attention's query-row split (``models.flash_attention.
flash_attention_sharded``) uses :class:`RowGather` (o gathered over
``model``, or k / v whose dk / dv sum over it), :class:`SplitRows` (q's
rows, dq gathered back) and :class:`SumGrad` (k / v whole, dk / dv
summed); :class:`SumForward` sums the loss's parts.  The MoE layer
(``models/moe.py``) exchanges its dispatch rows through
:class:`ExpertExchange` (an :func:`all_to_all` whose backward is the same
exchange), gathers a data group's routing weights or positions through
:class:`RowGather`, and applies the reference's ``shard_map`` transpose
with :class:`SumGrad` and :class:`ScaleGrad`.  An axis is one name,
a tuple of names (the batch axes ``("pod", "data")`` folded, through
:func:`axes_group`) or None for the world.

A ``mesh`` is a ``DeviceMesh`` with ``("data", "model")`` names
(``launch/mesh.py``).  NCCL moves CUDA tensors; on gloo every exchange
stages through the host, which also serves two ranks sharing one card.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from ..core import fixedrate, fp8
from ..core.store import is_compressed
from .sharding import (axis_index, axis_size, expert_rows, is_expert_leaf,
                       local_shard)


def _comm_device(group, like: torch.Tensor | None = None) -> torch.device:
    """Where a collective's tensors must live for ``group``'s backend, by
    its name: the card for NCCL, the host for gloo; the ``fake`` backend
    (the dry run's process group, ``launch/dryrun.py``, which moves
    nothing) leaves them on ``like``'s device, as NCCL would."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "fake" and like is not None:
        return like.device
    return torch.device("cpu")


def axes_group(mesh, axis):
    """The process group of this rank's ranks along ``axis``: one axis
    name, a tuple of names (their ranks in the order :func:`sharding.
    axis_index` folds them: ``("pod", "data")`` is the batch shards'
    group), or None for the whole world (also returned for a tuple that
    names every axis of the mesh)."""
    if axis is None:
        return None
    if not isinstance(axis, (tuple, list)):
        return mesh.get_group(axis)
    axis = tuple(axis)
    if len(axis) == 1:
        return mesh.get_group(axis[0])
    if set(axis) == set(mesh.mesh_dim_names):
        return None
    # the mesh's bookkeeping runs on its real rank table, outside any
    # dispatch mode (the dry run's fake tensors and its counter)
    with _disable_current_modes():
        return mesh[axis]._flatten().get_group()


def gather_rows(x: torch.Tensor, mesh, axis=None) -> torch.Tensor:
    """All-gather ``x`` over ``axis``'s group of this rank (the whole world
    when None; a tuple of axes as :func:`axes_group` takes it) -> (n,
    *x.shape) on ``x``'s device, in rank order along the axis."""
    group = axes_group(mesh, axis)
    n = dist.get_world_size(group)
    dev = _comm_device(group, x)
    src = x.contiguous().to(dev)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(x.device)


def _all_to_all(x: torch.Tensor, mesh, axis: str = "model"
                ) -> torch.Tensor:
    """``x`` (n, ...), ``n`` the size of ``axis``'s group of this rank ->
    (n, ...) on ``x``'s device whose row ``j`` is row ``i`` (this rank's
    index along ``axis``) of rank ``j``'s ``x``."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks) takes a "
                         f"leading dim of {n}, got {tuple(x.shape)}")
    src = x.contiguous().to(_comm_device(group, x))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def broadcast_object(obj, src: int):
    """``obj`` (anything picklable: a list of ints, a swapped page's coded
    arrays) as the global rank ``src`` holds it, on every rank; the other
    ranks pass a placeholder (None)."""
    box = [obj]
    dist.broadcast_object_list(box, src,
                               device=_comm_device(None))
    return box[0]


def broadcast_tensor(x: torch.Tensor, src: int) -> torch.Tensor:
    """``x`` (the same shape and dtype on every rank) as the global rank
    ``src`` holds it, on ``x``'s device."""
    t = x.contiguous().to(_comm_device(None, x))
    dist.broadcast(t, src)
    return t.to(x.device)


def _tensors(tree, keep=None, names=()):
    """Every tensor of a nested dict of tensors and compressed containers
    (a container's arrays in sorted name order), in walk order; with
    ``keep``, only those of leaves whose path ``keep(names)`` accepts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, keep, names + (str(k),))
    elif keep is not None and not keep(names):
        return
    elif is_compressed(tree):
        for k in sorted(tree.arrays):
            yield tree.arrays[k]
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_checksum(tree, piece: int = 1 << 26, keep=None) -> tuple:
    """(sum, position-weighted sum) of every byte of every tensor of a
    nested dict of tensors and compressed containers (of the leaves
    ``keep`` accepts, all without it), in walk order, as int64 on the
    tensors' device -> two Python ints.  Pieces of ``piece`` bytes bound
    the transient memory."""
    s0 = s1 = None
    for x in _tensors(tree, keep):
        b = x.contiguous().view(-1).view(torch.uint8)
        for i in range(0, b.numel(), piece):
            c = b[i:i + piece].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
            a, p = c.sum(), (c * w).sum()
            s0 = a if s0 is None else s0 + a
            s1 = p if s1 is None else s1 + p
    if s0 is None:
        return 0, 0
    return int(s0), int(s1)


def _tree_bytes(tree, keep) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree, keep))


def check_replicated(tree, mesh, what: str = "weights",
                     n_experts: int = 0) -> dict:
    """Raise unless the ranks' ``tree`` is what a serving mesh holds: the
    checksum (:func:`tree_checksum`) of every leaf but the experts equal
    on every rank, and of the expert leaves equal on the ranks that share
    a model index; with ``n_experts``, each expert leaf holding
    ``n_experts / M`` experts (``M`` the model axis).  Returns this rank's
    ``checksum`` (its other leaves', then its experts') and every rank's
    resident ``expert_bytes`` and ``other_bytes`` (lists in rank order)."""
    n_model = axis_size(mesh, "model")
    if n_experts:
        want = expert_rows(n_experts, mesh)
        want = want[1] - want[0]

        def rows(names, t):
            # a stacked container's shape is one layer's
            stacked = ("units" in names or "layers" in names) and \
                not is_compressed(t)
            return t.shape[int(stacked)]

        bad_rows = [("/".join(names), rows(names, t))
                    for names, t in _expert_leaves(tree)
                    if rows(names, t) != want]
        if bad_rows:
            raise RuntimeError(
                f"{what}: expert leaves hold other than {want} of "
                f"{n_experts} experts on a model axis of {n_model}: "
                f"{bad_rows[:4]}")
    other = tree_checksum(tree, keep=lambda n: not is_expert_leaf(n))
    experts = tree_checksum(tree, keep=is_expert_leaf)
    mine = (*other, *experts, _tree_bytes(tree, is_expert_leaf),
            _tree_bytes(tree, lambda n: not is_expert_leaf(n)))
    got = [tuple(r) for r in gather_rows(
        torch.tensor(mine, dtype=torch.int64), mesh).tolist()]
    if any(r[:2] != got[0][:2] for r in got):
        raise RuntimeError(f"{what} differ across the mesh's ranks: "
                           f"checksums {[r[:2] for r in got]}")
    for r, row in enumerate(got):
        peer = got[r % n_model]
        if row[2:4] != peer[2:4]:
            raise RuntimeError(
                f"{what}: the experts of ranks {r % n_model} and {r} (model "
                f"index {r % n_model}) differ: checksums {peer[2:4]} and "
                f"{row[2:4]}")
    return dict(checksum=mine[:4], expert_bytes=[r[4] for r in got],
                other_bytes=[r[5] for r in got])


def _expert_leaves(tree, names=()):
    """(path names, leaf) of every expert leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _expert_leaves(v, names + (str(k),))
    elif is_expert_leaf(names):
        yield names, tree


def calibrate(w8_bits: torch.Tensor, margin: float = 1.25):
    """Offline: the top-3 exponent table and the escape capacity of a
    tensor -> ((3,) uint8 table on its device, capacity).  A tie goes to
    the lower exponent; the capacity is the escape count times ``margin``,
    rounded up to an even count (nibble packing)."""
    flat = w8_bits.reshape(-1).to(torch.uint8)
    exps = fp8.exponent_field(flat).to(torch.int64)
    freqs = torch.bincount(exps, minlength=16)
    table = torch.argsort(-freqs, stable=True)[:3]
    esc = int(flat.numel() - freqs[table].sum())
    cap = max(1, math.ceil(esc * margin))
    cap += cap % 2
    return table.to(torch.uint8), cap


def compressed_all_gather(mesh, axis: str = "data"):
    """``(w8_local, table, esc_capacity) -> (full bits, overflow)``:
    ``w8_local`` is this rank's shard (the uint8 bit view of an fp8 weight,
    cut over ``axis`` on its leading dim); the result is the whole weight,
    bit-exact, and ``overflow`` a Python bool, True when some shard held
    more escapes than ``esc_capacity`` (the result is then invalid)."""

    def fn(w8_local: torch.Tensor, table: torch.Tensor, esc_capacity: int):
        n_local = w8_local.numel()
        codes, escapes, signmant, overflow = fixedrate.encode_plain(
            w8_local.reshape(-1), table, esc_capacity)
        codes_g = gather_rows(codes, mesh, axis)
        esc_g = gather_rows(fp8.pack_nibbles(escapes), mesh, axis)
        sm_g = gather_rows(fp8.pack_nibbles(signmant), mesh, axis)
        over = gather_rows(overflow.reshape(1).to(torch.uint8), mesh, axis)
        bits = torch.cat([fixedrate.decode_plain(c, e, table, s,
                                                 n_elem=n_local)
                          for c, e, s in zip(codes_g, esc_g, sm_g)])
        return (bits.reshape(codes_g.shape[0] * w8_local.shape[0],
                             *w8_local.shape[1:]),
                bool(over.any()))

    return fn


def wire_bytes_per_elem(esc_frac: float) -> float:
    """Analytic wire cost of the compressed gather (bytes an element)."""
    return 0.25 + 0.5 + 0.5 * esc_frac


def raw_wire_bytes_per_elem(dtype: str = "float8") -> float:
    return {"float8": 1.0, "bfloat16": 2.0, "float32": 4.0}[dtype]


# --------------------------------------------------------------------------
# training on a mesh: the leaf gather and the attention's row exchanges,
# each differentiable (a torch.autograd.Function)
# --------------------------------------------------------------------------

def _all_gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape) on ``x``'s device, this rank's group in rank order;
    one call into a flat buffer (no list of outputs)."""
    n = dist.get_world_size(group)
    src = x.contiguous().to(_comm_device(group, x))
    out = src.new_empty((n,) + tuple(src.shape))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out.view(-1), src.view(-1), group=group)
    return out.to(x.device)


def _cat_over(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """``x`` all-gathered over ``axis`` and concatenated along ``dim`` in
    the axis's rank order (``x`` itself when the axis has one rank)."""
    group = axes_group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return x
    g = _all_gather_stacked(x, group)                   # (n, ...)
    g = g.movedim(0, dim)                               # (.., n, s_dim, ..)
    shape = list(x.shape)
    shape[dim] *= g.shape[dim]
    return g.reshape(shape)


def _sum_over(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` summed over ``axis``'s ranks (a copy on ``x``'s device; ``x``
    itself with one rank)."""
    if axis == ():
        return x
    group = axes_group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return x
    t = x.to(_comm_device(group, x), copy=True).contiguous()
    dist.all_reduce(t, group=group)
    return t.to(x.device)


def sum_over_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over every rank of the mesh (a copy on its device)."""
    return _sum_over(x, mesh, tuple(mesh.mesh_dim_names))


def gather_leaf(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A parameter (or moment) whole from every rank's
    ``sharding.local_shard`` under ``spec``: each sharded dim all-gathered
    over its axes (no gradient; every rank of the mesh takes part)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            shard = _cat_over(shard, mesh, axis, dim)
    return shard


def _own_rows(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim`` by its index along
    ``axis`` (a view)."""
    n = dist.get_world_size(axes_group(mesh, axis))
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axis) * size, size)


class LeafGather(torch.autograd.Function):
    """A leaf gathered whole where a unit uses it.  Forward:
    :func:`gather_leaf`.  Backward: the whole leaf's gradient summed over
    ``reduce_axes`` -- the axes whose ranks computed on other rows or
    other positions (the batch axes, and ``model`` under the sequence
    split); an axis whose ranks computed the same thing is not summed --
    then this rank's shard of it added into ``acc`` (an f32 buffer shaped
    like the shard).  The gradient reaches the shard through that side
    effect, not through autograd: a stacked leaf is gathered one unit at a
    time, and returning a gradient for the whole stack from every unit
    would write the stack once a unit.  ``token`` (a 0-d tensor requiring
    grad) puts the gather on the graph; its gradient is 0."""

    @staticmethod
    def forward(ctx, token, shard, spec, mesh, reduce_axes, acc):
        ctx.spec, ctx.mesh, ctx.axes, ctx.acc = spec, mesh, reduce_axes, acc
        return gather_leaf(shard.detach(), spec, mesh)

    @staticmethod
    def backward(ctx, g):
        g = _sum_over(g, ctx.mesh, ctx.axes)
        ctx.acc.add_(local_shard(g, ctx.spec, ctx.mesh))
        return torch.zeros((), dtype=torch.float32,
                           device=ctx.acc.device), None, None, None, None, \
            None


class RowGather(torch.autograd.Function):
    """``x`` all-gathered along ``dim`` over ``axis`` (rank order).
    Backward: this rank's rows of the cotangent; with ``summed`` the
    cotangent is first summed over the axis, as when each rank's is a
    partial (k / v gathered for the rank's query rows), and without it each
    rank holds the same whole cotangent (o gathered from the ranks' query
    rows for a computation every rank repeats)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim: int, summed: bool):
        ctx.mesh, ctx.axis, ctx.dim, ctx.summed = mesh, axis, dim, summed
        return _cat_over(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _sum_over(g, ctx.mesh, ctx.axis)
        g = _own_rows(g, ctx.mesh, ctx.axis, ctx.dim).contiguous()
        return g, None, None, None, None


class SplitRows(torch.autograd.Function):
    """This rank's rows of ``x`` along ``dim`` (``x`` whole and the same on
    every rank of ``axis``).  Backward: the ranks' cotangents of their rows
    gathered whole, the same on every rank (q's rows of the query-row
    split, whose dq each rank computes for its rows alone)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim: int):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_rows(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _cat_over(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), \
            None, None, None


class SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over ``axis``: k / v
    whole on every model rank, each rank's dk / dv a partial over its
    query rows."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.mesh, ctx.axis), None, None


class SumForward(torch.autograd.Function):
    """``x`` summed over ``axis`` (a loss each rank holds a part of).
    Backward: the identity, each rank's part receiving the whole sum's
    cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum_over(x.detach(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class ScaleGrad(torch.autograd.Function):
    """The identity, whose backward multiplies the cotangent by ``factor``
    (the ``1 / M`` that the transpose of a ``shard_map`` applies to an
    output every one of ``M`` ranks holds a copy of)."""

    @staticmethod
    def forward(ctx, x, factor: float):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class ExpertExchange(torch.autograd.Function):
    """:func:`all_to_all` over ``axis``, differentiable: row ``i`` goes to
    the group's rank ``i``.  Its transpose is the same exchange, so the
    backward sends each row's cotangent back where the row came from.
    Both directions call the module's ``all_to_all`` when they run (a
    caller may wrap it to count or time the exchanges)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.mesh, ctx.axis), None, None


# Defined under a private name and bound to the public one: the reference's
# jitted MoE layer calls ``jax.lax.all_to_all``, and tools/lint's
# jit-discipline pass would resolve that basename to a single ``def``
# under src/.
all_to_all = _all_to_all
