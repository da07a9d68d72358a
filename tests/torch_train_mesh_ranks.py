"""Rank bodies of ``tests/test_torch_train_mesh.py``.

Each function runs in a process of its own, started by
``repro_torch.launch.mesh.spawn`` as one gloo rank on the CPU, and returns
plain values (floats, numpy arrays) to the test process, which holds them
against the reference.  This module imports no JAX: the ranks run the port
alone, on weights the test converted from the reference's.  One world runs
several meshes in turn over the same process group.
"""
import os

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import restore_tree, save_tree
from repro_torch.configs import get, smoke_variant
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.kernels import flash_bwd, flash_fwd
from repro_torch.launch import mesh as MESH
from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as SH
from repro_torch.runtime import steps as S

# tests/test_sharding.py:77's cell: phi3-medium-14b smoke, seq 16, global
# batch 4, lr 1e-3
ARCH, SEQ, BATCH, LR = "phi3-medium-14b", 16, 4, 1e-3
CPU = torch.device("cpu")


def smoke():
    return smoke_variant(get(ARCH))


def state_specs(specs):
    return {"params": specs, "opt": SH.opt_pspecs(specs), "step": SH.P()}


def gathered(tree, specs, mesh) -> dict:
    """{path: whole leaf as numpy} of a rank's shards."""
    flat = dict(iter_leaves(specs))
    return {path: collectives.gather_leaf(x, flat[path], mesh).numpy()
            for path, x in iter_leaves(tree)}


def train_step(whole, mesh, rule: str, remat: bool, accum: int) -> dict:
    """One step of the sharded train step on ``mesh`` from the whole tree
    ``whole`` -> metrics, the updated parameters and first moments
    gathered whole, the launch counts of the flash kernels' plain versions
    with ``q_base != 0`` on this rank, and the rank's resident bytes."""
    cfg = smoke()
    rules = SH.ShardingRules(activation_partitioning=rule)
    specs = S.train_pspecs(cfg, mesh, rules)
    params = SH.shard_tree(whole, SH.named(mesh, specs))
    opt = adamw_init(params)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, SEQ, BATCH))
    batch = data.sharded_batch(0, mesh, SH.batch_axes(mesh), CPU)
    step = S.make_train_step(cfg, AdamWConfig(lr=LR), mesh=mesh,
                             rules=rules, remat=remat, grad_accum=accum)
    q_base, undo = _count_q_base()
    try:
        p, o, m = step(params, opt, batch, 0)
    finally:
        undo()
    resident = sum(t.numel() * t.element_size()
                   for tree in (p, o["mu"], o["nu"])
                   for _, t in iter_leaves(tree))
    return dict(metrics={k: float(v) for k, v in m.items()},
                params=gathered(p, specs, mesh),
                mu=gathered(o["mu"], specs, mesh), q_base=q_base,
                resident=resident, rows=batch["tokens"].numpy())


def _count_q_base():
    """Count this rank's plain flash forward / backward calls with ``q_base
    != 0`` (the kernels' own counters count card launches) -> (the counts,
    a function that puts the plain versions back)."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash_fwd.plain_stats, flash_bwd.plain

    def fwd_counted(*a, q_base=0, **kw):
        counts["fwd"] += bool(q_base)
        return fwd(*a, q_base=q_base, **kw)

    def bwd_counted(*a, q_base=0, **kw):
        counts["bwd"] += bool(q_base)
        return bwd(*a, q_base=q_base, **kw)

    def undo():
        flash_fwd.plain_stats, flash_bwd.plain = fwd, bwd

    flash_fwd.plain_stats, flash_bwd.plain = fwd_counted, bwd_counted
    return counts, undo


def world_main(rank, world, dev, spec):
    """Every run of ``spec["runs"]`` ({tag: (data, model, rule, remat,
    grad_accum)}) from the reference's converted weights; rank 0 returns
    the gathered trees, every rank its metrics and counts.  With
    ``spec["ckpt"]`` (a directory): the checkpoint drill across meshes."""
    whole = convert._convert(spec["params"], CPU)
    out = {}
    for tag, (d, m, rule, remat, accum) in spec["runs"].items():
        mesh = MESH.make_mesh(d, m)
        got = train_step(whole, mesh, rule, remat, accum)
        if rank:
            got = {k: got[k] for k in ("metrics", "q_base", "resident",
                                       "rows")}
        out[tag] = got
    if spec.get("ckpt"):
        out["ckpt"] = ckpt_drill(whole, spec["ckpt"], rank)
    return out


def ckpt_drill(whole, directory: str, rank: int) -> dict:
    """A step on ``--mesh 2``, its state saved from the mesh (rank 0
    writes whole leaves), then restored onto ``1x2``'s shards -> both
    states gathered whole (rank 0's)."""
    cfg = smoke()
    mesh2 = MESH.make_mesh(2, 1)
    specs = S.train_pspecs(cfg, mesh2, SH.DEFAULT_RULES)
    params = SH.shard_tree(whole, SH.named(mesh2, specs))
    opt = adamw_init(params)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, SEQ, BATCH))
    step = S.make_train_step(cfg, AdamWConfig(lr=LR), mesh=mesh2,
                             remat=False)
    params, opt, _ = step(params, opt, data.sharded_batch(
        0, mesh2, SH.batch_axes(mesh2), CPU), 0)
    state = {"params": params, "opt": opt,
             "step": torch.tensor(0, dtype=torch.int32)}
    save_tree(state, directory, 1, shardings=SH.named(
        mesh2, state_specs(specs)))
    dist.barrier()
    saved = gathered(state, state_specs(specs), mesh2)
    mesh12 = MESH.make_mesh(1, 2)
    specs12 = S.train_pspecs(cfg, mesh12, SH.DEFAULT_RULES)
    named12 = SH.named(mesh12, state_specs(specs12))
    template = SH.shard_tree({"params": whole, "opt": adamw_init(whole),
                              "step": torch.tensor(0, dtype=torch.int32)},
                             named12)
    restored, at = restore_tree(directory, template, shardings=named12,
                                device="cpu")
    local = {path: tuple(x.shape) for path, x in iter_leaves(restored)}
    whole = gathered(restored, state_specs(specs12), mesh12)   # collective
    return dict(step=at, saved=saved if rank == 0 else None,
                restored=whole if rank == 0 else None, local_shapes=local,
                files=sorted(os.listdir(directory)))
