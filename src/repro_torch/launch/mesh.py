"""Mesh construction and the rank starter (the reference's
``launch/mesh.py``, in PyTorch's idiom: one process a rank).

The reference runs one JAX program over N devices; the port runs N ranks,
each a process with its own card (or the CPU), joined by
``torch.distributed``: NCCL between cards, gloo on the CPU and for ranks
that share one card (NCCL refuses two ranks on one device).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` named ``("data", "model")``:
the reference's ``mesh.shape[a]`` is ``runtime.sharding.axis_size``,
``axis_index(a)``
``mesh.get_local_rank(a)``, and its collectives run on
``mesh.get_group(a)`` (``runtime/collectives.py``).

:func:`spawn` starts ``n`` ranks of a function on this host (a free
localhost port each time) and collects what each returns; :func:`join`
is the same for a process started under ``torchrun``, which exports
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``.  Importing
this module starts nothing.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")
_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(data: int, model: int = 1, device_type: str = "cpu"
              ) -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks of the initialised process
    group, rank ``r`` at ``(r // model, r % model)`` (``model`` innermost,
    as the reference's)."""
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(data, model),
                      mesh_dim_names=AXES)


def make_host_mesh(model: int = 1, device_type: str = "cpu") -> DeviceMesh:
    """A mesh over this host's ranks: ``world // model`` data shards of
    ``model`` ranks (tests, examples)."""
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"{world} ranks do not split into model groups "
                         f"of {model}")
    return make_mesh(world // model, model, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``.  Refused unless the process group
    has that many ranks: no host of this project has 256 cards.  The dry
    run (``launch/dryrun.py``) builds it over a ``fake`` process group of
    that size with ``device_type="cpu"``: a ``"cuda"`` mesh sets up the
    card, and the fake group moves nothing on any device."""
    shape, names = _PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs {need} "
            f"ranks (one a card), the process group has {have}: start it "
            f"under a launcher that spans that many cards")
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def parse_mesh(spec: str) -> tuple:
    """``'D'`` or ``'DxM'`` -> (D, M), the reference's parsing and error."""
    try:
        dims = [int(x) for x in spec.lower().split("x")]
    except ValueError:
        dims = []
    if not 1 <= len(dims) <= 2 or any(d < 1 for d in dims):
        raise ValueError(f"--mesh {spec!r}: expected 'D' or 'DxM' with "
                         f"positive integers (e.g. '2' or '2x2')")
    return dims[0], dims[1] if len(dims) == 2 else 1


def backend_for(device: str, n_ranks: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (the
    CPU, or ranks sharing one card)."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: its own card under NCCL, card 0 for ranks
    sharing it, the CPU for ``device='cpu'``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if backend == "nccl" else 0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, backend, device, args, results):
    """One spawned rank: join the group, run ``fn(rank, world, device,
    *args)``, report its value (or its traceback) to the parent."""
    try:
        dev = rank_device(device, rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:       # the host's cores shared between the ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{port}", rank=rank, world_size=world)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ok", out))


def spawn(fn, n_ranks: int, *args, device: str = "cpu",
          backend: str | None = None, timeout: float = 3600.0) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``n_ranks`` ranks of this
    host (``spawn``-started processes: ``fn``, ``args`` and the values must
    pickle) and return each rank's value, in rank order.  Raises with the
    first failing rank's traceback; the other ranks, which may wait in a
    collective for it, are then stopped."""
    backend = backend or backend_for(device, n_ranks)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, fn, n_ranks, port, backend, device, args, results))
        for r in range(n_ranks)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < n_ranks:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or errors or time.monotonic() > deadline:
                    break
                continue
            if status == "ok":
                got[rank] = value
            else:
                errors.append((rank, value))
                deadline = min(deadline, time.monotonic() + 10.0)
    finally:
        for p in procs:
            p.join(timeout=1.0 if errors or len(got) < n_ranks else None)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        rank, tb = min(errors)
        raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{tb}")
    if len(got) != n_ranks:
        raise RuntimeError(f"only ranks {sorted(got)} of {n_ranks} reported "
                           f"(exit codes {[p.exitcode for p in procs]})")
    return [got[r] for r in range(n_ranks)]


def join(fn, *args, device: str = "cuda"):
    """Run ``fn(rank, world, device, *args)`` as the rank ``torchrun``
    started this process as, and return its value."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = backend_for(device, world)
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)),
                      backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend)
    try:
        return fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ

