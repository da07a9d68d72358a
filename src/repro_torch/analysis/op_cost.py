"""Cost of a traced step: FLOPs, bytes and collective bytes a rank, counted
over the operations the step dispatches.  The port's counterpart of both
the reference's ``analysis/hlo_cost.py`` (trip-count-aware FLOPs and bytes
of the compiled HLO) and ``analysis/hlo_parse.py`` (collective wire bytes
and an instruction histogram).

The port has no HLO: :class:`OpCost` is a ``TorchDispatchMode`` that sees
every aten and c10d operation the step runs, on real tensors or on fake
ones (``torch._subclasses.fake_tensor``: the dry run's shape-only
tensors, ``launch/dryrun.py``).  Eager PyTorch has no while loop whose trip
count the counter must recover: a Python loop (micro-batches, units, the
sLSTM loop over time) is counted as it runs, once an iteration.

  * FLOPs: ``torch.utils.flop_counter``'s formulas for the products
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, SDPA), 0 for
    everything else, as XLA's cost model counts products.
  * Bytes: eager PyTorch does not fuse, so each operation reads its
    inputs once and writes its outputs once (a view, an ``empty`` or a
    metadata query moves nothing; an input counts at most its storage's
    bytes, so an expanded tensor counts what it holds).
  * A hand-written kernel counts from its shapes, whatever implements it
    (``kernels/ops.py``): the dispatch point records the kernel's FLOPs
    and bytes (:func:`kernel`) and the counter ignores what runs beneath
    it, the plain version's operations on the CPU included.
  * Collectives (c10d operations): wire bytes a rank by ``hlo_parse``'s
    ring model (:data:`_FACTOR`: all-gather its output, all-reduce twice
    its bytes, reduce-scatter and all-to-all their operand), with the
    group's size and whether its ranks share a host of
    :data:`CARDS_PER_HOST` cards (``analysis.roofline``).
  * Memory (``memory=True``): the bytes of the storages the step allocates
    and has not freed, and their peak, followed by weak references to
    the storages (the live set of a fake step is what the card would
    hold, as no allocator caches it).
"""
from __future__ import annotations

import weakref
from collections import Counter, defaultdict
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

CARDS_PER_HOST = 8          # an HGX H100 host: 8 cards on NVLink
_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0}
# c10d operation -> (collective, the argument whose tensors carry its
# bytes: 0 the outputs / the buffer, 1 the operand)
_C10D = {
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}
# operations that move no bytes besides views (``_unsafe_view`` is a view
# that autograd does not track)
_NO_BYTES = {"empty", "empty_like", "new_empty", "empty_strided",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "set_", "resize_", "record_stream",
             "_unsafe_view", "_reshape_alias"}

_STACK: list = []           # the active counters, innermost last
_INFO: dict = {}            # operation -> OpCost._info


def counting() -> bool:
    """Whether a counter is active (a dispatch point then records)."""
    return bool(_STACK)


def _nbytes(t: torch.Tensor) -> int:
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (NotImplementedError, RuntimeError):
        return n


def _tensors(x, out: list) -> list:
    """The tensors of ``x`` (nested tuples, lists and dict values) appended
    to ``out``: a walk cheaper than a pytree flatten, run once an
    operation."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (nested lists included)."""
    return sum(map(_nbytes, _tensors(tensors, [])))


_GROUPS: dict = {}


def _group(obj) -> tuple:
    """(size, one_host) of the process group a c10d operation names."""
    pg = torch._C._distributed_c10d.ProcessGroup.unbox(obj)
    got = _GROUPS.get(pg)
    if got is None:
        ranks = dist.get_process_group_ranks(pg)
        got = (len(ranks),
               len({r // CARDS_PER_HOST for r in ranks}) == 1)
        _GROUPS[pg] = got
    return got


class OpCost(TorchDispatchMode):
    """Counts the FLOPs, bytes and collectives of the operations run while
    it is active (``with OpCost() as c: step(...)``; :meth:`result`).
    ``memory``: track the live bytes of new storages and their peak;
    ``keep_ops``: keep each operation's name (the dry run's
    ``--keep-hlo`` list)."""

    def __init__(self, memory: bool = False, keep_ops: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = defaultdict(float)
        self.coll_ops: list = []
        self.hist: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.kernels: Counter = Counter()
        self.kernel_flops: Counter = Counter()
        self.ops: list | None = [] if keep_ops else None
        self.memory = memory
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._paused = 0

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        if not _STACK:      # the groups die with their process group
            _GROUPS.clear()
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _free(self, n: int):
        self.live -= n

    def track(self, tensors, old=()):
        """Count the storages of ``tensors`` not among ``old``'s as new
        allocations (once each, until they are freed)."""
        if not self.memory:
            return
        olds = {id(t.untyped_storage()) for t in old}
        for t in tensors:
            st = t.untyped_storage()
            if id(st) in olds or st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    # -- counting ----------------------------------------------------------
    def _collective(self, name: str, args):
        kind, which = _C10D[name]
        group = next(a for a in args if isinstance(a, torch.ScriptObject))
        size, one_host = _group(group)
        wire = tensor_bytes(args[which]) * _FACTOR[kind]
        self.coll[kind] += wire
        self.coll_ops.append((kind, wire, size, one_host))

    def _info(self, func) -> tuple:
        """(name, namespace, FLOP formula or None, moves bytes) of an
        operation, looked up once."""
        info = _INFO.get(func)
        if info is None:
            name = func._overloadpacket.__name__
            info = (name, func.namespace,
                    flop_registry.get(func._overloadpacket),
                    not (func.is_view or name in _NO_BYTES))
            _INFO[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name, namespace, fl, moves = self._info(func)
        if namespace == "prim":
            return out
        self.hist[name] += 1
        if self.ops is not None:
            self.ops.append(f"{namespace}.{name}")
        if namespace == "c10d":
            if name in _C10D:
                self._collective(name, args)
            return out
        if fl is not None:
            self.flops += fl(*args, **kwargs, out_val=out)
        if not (moves or self.memory):
            return out
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if moves:
            b = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes += b
            self.bytes_by_op[name] += b
        self.track(outs, ins)
        return out

    def _kernel(self, name: str, flops: float, nbytes: float):
        if self._paused:
            return
        self.flops += flops
        self.bytes += nbytes
        self.kernels[name] += 1
        self.kernel_flops[name] += flops
        self.bytes_by_op[f"kernel:{name}"] += nbytes
        self.hist[f"kernel:{name}"] += 1
        if self.ops is not None:
            self.ops.append(f"kernel.{name}")

    def result(self) -> dict:
        """``{"flops", "bytes", "coll", "hist", "bytes_by_op", "kernels",
        "kernel_flops", "unknown_trip_loops"}``, ``coll`` as
        ``hlo_parse.collective_bytes`` gives it (``{op: wire bytes, ...,
        "total", "count", "ops": [(op, bytes, group size, one host)]}``);
        with ``memory``, ``"live_bytes"`` and ``"peak_bytes"`` of the new
        storages."""
        coll = dict(self.coll)
        coll["total"] = float(sum(self.coll.values()))
        coll["count"] = len(self.coll_ops)
        coll["ops"] = list(self.coll_ops)
        out = {"flops": self.flops, "bytes": self.bytes, "coll": coll,
               "hist": dict(self.hist),
               "bytes_by_op": dict(self.bytes_by_op.most_common()),
               "kernels": dict(self.kernels),
               "kernel_flops": dict(self.kernel_flops),
               "unknown_trip_loops": 0}
        if self.memory:
            out.update(live_bytes=self.live, peak_bytes=self.peak)
        return out


@contextmanager
def kernel(name: str, flops: float, nbytes: float):
    """Record one call of the hand-written kernel ``name`` (its FLOPs and
    bytes from its shapes) in every active counter, which ignore the
    operations run inside (the kernel's launch, or its plain version)."""
    for c in _STACK:
        c._kernel(name, flops, nbytes)
        c._paused += 1
    try:
        yield
    finally:
        for c in _STACK:
            c._paused -= 1


def produced(out):
    """Count a kernel's outputs as new storages in the active counters
    (their allocation happened inside :func:`kernel`)."""
    outs = _tensors(out, [])
    for c in _STACK:
        c.track(outs)
    return out


def analyze(fn, *args, memory: bool = False, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a counter -> :meth:`OpCost.result`
    (the reference's ``hlo_cost.analyze`` keys: ``flops``, ``bytes``,
    ``coll``)."""
    with OpCost(memory=memory) as c:
        fn(*args, **kwargs)
    return c.result()


def collective_bytes(cost: dict) -> dict:
    """The collective dict of :meth:`OpCost.result` (``hlo_parse``'s
    name)."""
    return cost["coll"]


def op_histogram(cost: dict, kinds=None) -> dict:
    """Operations by kind (aten / c10d names, ``kernel:<name>`` for the
    hand-written kernels), all of them or those of ``kinds``."""
    hist = cost["hist"]
    if kinds is None:
        return dict(sorted(hist.items(), key=lambda kv: -kv[1]))
    return {k: hist[k] for k in kinds if k in hist}
