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
replicated, each rank building its tree from the seed;
:func:`check_replicated` compares a checksum of every rank's tree.

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


def tree_checksum(tree, piece: int = 1 << 26) -> tuple:
    """(sum, position-weighted sum) of every byte of every tensor of a
    nested dict of tensors and compressed containers, in walk order, as
    int64 on the tensors' device -> two Python ints.  Pieces of ``piece``
    bytes bound the transient memory."""
    s0 = s1 = None

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif is_compressed(t):
            for k in sorted(t.arrays):
                yield t.arrays[k]
        elif isinstance(t, torch.Tensor):
            yield t

    for x in leaves(tree):
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


def check_replicated(tree, mesh, what: str = "weights") -> tuple:
    """Raise unless every rank's ``tree`` has the same checksum
    (:func:`tree_checksum`); returns this rank's."""
    mine = tree_checksum(tree)
    got = gather_rows(torch.tensor(mine, dtype=torch.int64), mesh)
    sums = [tuple(r) for r in got.tolist()]
    if any(s != sums[0] for s in sums):
        raise RuntimeError(f"{what} differ across the mesh's ranks: "
                           f"checksums {sums}")
    return mine


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
