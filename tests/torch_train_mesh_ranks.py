"""Rank bodies of ``tests/test_torch_train_mesh.py``,
``tests/test_torch_train_moe_mesh.py`` and
``tests/test_torch_train_rec_mesh.py``.

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
MOON = "moonshot-v1-16b-a3b"
CPU = torch.device("cpu")


def smoke(arch: str = ARCH):
    return smoke_variant(get(arch))


def state_specs(specs):
    return {"params": specs, "opt": SH.opt_pspecs(specs), "step": SH.P()}


def gathered(tree, specs, mesh) -> dict:
    """{path: whole leaf as numpy} of a rank's shards."""
    flat = dict(iter_leaves(specs))
    return {path: collectives.gather_leaf(x, flat[path], mesh).numpy()
            for path, x in iter_leaves(tree)}


def train_step(whole, mesh, rule: str, remat: bool, accum: int,
               arch: str = ARCH, seq: int = SEQ, frames=None) -> dict:
    """One step of the sharded train step on ``mesh`` from the whole tree
    ``whole`` (an encoder-decoder's batch with the rank's rows of
    ``frames``, the global batch's numpy array) -> metrics, the updated
    parameters and first moments
    gathered whole, the calls of the flash kernels' plain versions on this
    rank (``q_base``: those with ``q_base != 0``; ``flash``: all) and of
    ``local_attention`` (``local``: {"q_base": with a ``q_base``, "whole":
    without}), and the rank's resident bytes."""
    cfg = smoke(arch)
    rules = SH.ShardingRules(activation_partitioning=rule)
    specs = S.train_pspecs(cfg, mesh, rules)
    params = SH.shard_tree(whole, SH.named(mesh, specs))
    opt = adamw_init(params)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, seq, BATCH))
    batch = data.sharded_batch(0, mesh, SH.batch_axes(mesh), CPU)
    if frames is not None:
        per = BATCH // SH.n_batch_shards(mesh)
        lo = SH.batch_index(mesh) * per
        batch["frames"] = torch.from_numpy(frames[lo:lo + per])
    step = S.make_train_step(cfg, AdamWConfig(lr=LR), mesh=mesh,
                             rules=rules, remat=remat, grad_accum=accum)
    q_base, calls, local, undo = _count_attention_calls()
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
                flash=calls, local=local, resident=resident,
                rows=batch["tokens"].numpy())


def _count_attention_calls():
    """Count this rank's plain flash forward / backward calls, with ``q_base
    != 0`` and in all (the kernels' own counters count card launches), and
    its ``local_attention`` calls with and without a ``q_base`` -> (the
    ``q_base`` counts, the totals, the local counts, a function that puts
    the originals back)."""
    from repro_torch.models import model as M
    counts = {"fwd": 0, "bwd": 0}
    calls = {"fwd": 0, "bwd": 0}
    local = {"q_base": 0, "whole": 0}
    fwd, bwd, loc = flash_fwd.plain_stats, flash_bwd.plain, M.local_attention

    def fwd_counted(*a, q_base=0, **kw):
        counts["fwd"] += bool(q_base)
        calls["fwd"] += 1
        return fwd(*a, q_base=q_base, **kw)

    def bwd_counted(*a, q_base=0, **kw):
        counts["bwd"] += bool(q_base)
        calls["bwd"] += 1
        return bwd(*a, q_base=q_base, **kw)

    def loc_counted(*a, q_base=None, **kw):
        local["whole" if q_base is None else "q_base"] += 1
        return loc(*a, q_base=q_base, **kw)

    def undo():
        flash_fwd.plain_stats, flash_bwd.plain = fwd, bwd
        M.local_attention = loc

    flash_fwd.plain_stats, flash_bwd.plain = fwd_counted, bwd_counted
    M.local_attention = loc_counted
    return counts, calls, local, undo


def world_main(rank, world, dev, spec):
    """Every run of ``spec["runs"]`` ({tag: (data, model, rule, remat,
    grad_accum)}) of ``spec["arch"]`` (phi3's smoke stack by default) from
    the reference's converted weights; rank 0 returns the gathered trees,
    every rank its metrics and counts.  With ``spec["ckpt"]`` ({arch:
    (directory, save mesh, restore mesh)}): the checkpoint drill across
    meshes, an arch's weights from ``spec["ckpt_params"]``."""
    arch = spec.get("arch", ARCH)
    whole = convert._convert(spec["params"], CPU)
    out = {}
    for tag, (d, m, rule, remat, accum) in spec["runs"].items():
        mesh = MESH.make_mesh(d, m)
        got = train_step(whole, mesh, rule, remat, accum, arch)
        if rank:
            got = {k: got[k] for k in ("metrics", "q_base", "resident",
                                       "rows")}
        out[tag] = got
    out["ckpt"] = {}
    for name, (directory, save, load) in spec.get("ckpt", {}).items():
        tree = whole if name == arch else convert._convert(
            spec["ckpt_params"][name], CPU)
        out["ckpt"][name] = ckpt_drill(tree, directory, rank, name, save,
                                       load)
    return out


def ckpt_drill(whole, directory: str, rank: int, arch: str = ARCH,
               save=(2, 1), load=(1, 2)) -> dict:
    """A step on the mesh ``save`` (phi3's on ``--mesh 2``), its state
    saved from the mesh (rank 0 writes whole leaves), then restored onto
    the mesh ``load``'s shards (``1x2``) -> both states gathered whole
    (rank 0's)."""
    cfg = smoke(arch)
    mesh_save = MESH.make_mesh(*save)
    specs = S.train_pspecs(cfg, mesh_save, SH.DEFAULT_RULES)
    params = SH.shard_tree(whole, SH.named(mesh_save, specs))
    opt = adamw_init(params)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, SEQ, BATCH))
    step = S.make_train_step(cfg, AdamWConfig(lr=LR), mesh=mesh_save,
                             remat=False)
    params, opt, _ = step(params, opt, data.sharded_batch(
        0, mesh_save, SH.batch_axes(mesh_save), CPU), 0)
    state = {"params": params, "opt": opt,
             "step": torch.tensor(0, dtype=torch.int32)}
    save_tree(state, directory, 1, shardings=SH.named(
        mesh_save, state_specs(specs)))
    dist.barrier()
    saved = gathered(state, state_specs(specs), mesh_save)
    mesh_load = MESH.make_mesh(*load)
    specs_load = S.train_pspecs(cfg, mesh_load, SH.DEFAULT_RULES)
    named_load = SH.named(mesh_load, state_specs(specs_load))
    template = SH.shard_tree({"params": whole, "opt": adamw_init(whole),
                              "step": torch.tensor(0, dtype=torch.int32)},
                             named_load)
    restored, at = restore_tree(directory, template, shardings=named_load,
                                device="cpu")
    local = {path: tuple(x.shape) for path, x in iter_leaves(restored)}
    whole = gathered(restored, state_specs(specs_load),  # a collective
                     mesh_load)
    return dict(step=at, saved=saved if rank == 0 else None,
                restored=whole if rank == 0 else None, local_shapes=local,
                files=sorted(os.listdir(directory)))


# -- the mixture-of-experts stack (tests/test_torch_train_moe_mesh.py) -----

def _placed(tree, mesh, names=("moe",)):
    """A bare MoE layer's numpy leaves -> tensors of their own that take
    gradients, each expert leaf cut to this rank's experts
    (``sharding.expert_cut``)."""
    if isinstance(tree, dict):
        return {k: _placed(v, mesh, names + (k,)) for k, v in tree.items()}
    x = torch.from_numpy(tree.copy())
    cut = SH.expert_cut(names, x.shape, mesh)
    if cut is not None:
        x = x.narrow(cut[0], cut[1], cut[2] - cut[1])
    return x.clone().requires_grad_(True)


def moe_layer_grads(mesh, layers, x, proj, cfg) -> dict:
    """``moe_apply(rows="shard")`` of each layer of ``layers`` (numpy MoE
    subtrees) on this rank's data group's rows of ``x``, differentiated:
    the group's part of ``sum(y * proj) + aux`` (the aux over the data
    groups, as the reference averages it) -> {name: this rank's x
    gradient, every leaf's gradient summed over ``data`` (an expert leaf
    the rank's experts'), the aux averaged over the groups}."""
    from repro_torch.models import moe
    n_data = mesh.mesh.shape[0]
    d = mesh.get_local_rank("data")
    b = x.shape[0] // n_data
    rows = slice(d * b, (d + 1) * b)
    out = {}
    for name, tree in layers.items():
        p = _placed(tree, mesh)
        xs = torch.from_numpy(x[rows].copy()).requires_grad_(True)
        y, aux = moe.moe_apply(p, xs, cfg, mesh=mesh, rows="shard",
                               dtype=torch.float32)
        ((y * torch.from_numpy(proj[rows].copy())).sum()
         + aux / n_data).backward()
        out[name] = dict(
            x=xs.grad.numpy(),
            grads={"/".join(k): collectives._sum_over(
                v.grad, mesh, "data").numpy() for k, v in iter_leaves(p)},
            aux=float(collectives._sum_over(aux.detach() / n_data, mesh,
                                            "data")),
            experts=list(SH.expert_rows(cfg.n_experts, mesh)))
    return out


def moe_loss(params, mesh, rule: str) -> dict:
    """``models.model.loss_fn`` of moonshot's smoke stack on ``mesh``
    (the experts placed a rank, no gradient) on step 0's batch -> its loss,
    nll and aux."""
    from repro_torch.models import model as M
    cfg = smoke(MOON)
    tree = convert.params_from_numpy(params, cfg, "cpu", mesh=mesh)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, SEQ, BATCH))
    batch = data.sharded_batch(0, mesh, SH.batch_axes(mesh), CPU)
    constrain = SH.make_constrainer(
        mesh, SH.ShardingRules(activation_partitioning=rule))
    with torch.no_grad():
        loss, met = M.loss_fn(tree, cfg, batch["tokens"], batch["labels"],
                              mesh=mesh, constrain=constrain)
    return dict(loss=float(loss), nll=float(met["nll"]),
                aux=float(met["aux"]))


def moe_world_main(rank, world, dev, spec):
    """Everything tests/test_torch_train_moe_mesh.py needs from ``world``
    ranks, in one spawn: the MoE layer's gradients on each mesh of
    ``spec["layer_meshes"]`` (capacity factor 1.0), the train steps of
    ``spec["runs"]`` ({tag: (data, model, rule, remat, grad_accum)}) and
    ``loss_fn`` on the meshes of ``spec["loss_meshes"]`` ({tag: (data,
    model, rule)}), on moonshot's smoke stack from the reference's
    weights."""
    import dataclasses
    tight = dataclasses.replace(smoke(MOON), capacity_factor=1.0)
    out = {"layer": {}, "loss": {}}
    for dims in spec["layer_meshes"]:
        out["layer"][dims] = moe_layer_grads(
            MESH.make_mesh(*dims), spec["layers"], spec["x"], spec["proj"],
            tight)
    whole = convert._convert(spec["params"], CPU)
    for tag, (d, m, rule, remat, accum) in spec["runs"].items():
        got = train_step(whole, MESH.make_mesh(d, m), rule, remat, accum,
                         MOON)
        if rank:
            got = {k: got[k] for k in ("metrics", "resident")}
        out[tag] = got
    for tag, (d, m, rule) in spec["loss_meshes"].items():
        out["loss"][tag] = moe_loss(spec["params"], MESH.make_mesh(d, m),
                                    rule)
    return out


# -- the recurrent and sliding-window stacks
# (tests/test_torch_train_rec_mesh.py) ------------------------------------

def rec_world_main(rank, world, dev, spec):
    """For each arch of ``spec["params"]`` ({arch: the reference's numpy
    tree}), every run of ``spec["runs"]`` ({tag: (data, model, rule,
    remat, grad_accum)}) at ``spec["seq"]``: rank 0 returns the gathered
    trees, every rank its metrics and counts.  With ``spec["ckpt"]``
    ({arch: (directory, save mesh, restore mesh)}): the checkpoint drill
    across meshes of each arch."""
    out = {"ckpt": {}}
    wholes = {arch: convert._convert(tree, CPU)
              for arch, tree in spec["params"].items()}
    for arch, whole in wholes.items():
        out[arch] = {}
        for tag, (d, m, rule, remat, accum) in spec["runs"].items():
            got = train_step(whole, MESH.make_mesh(d, m), rule, remat, accum,
                             arch, spec["seq"])
            if rank:
                got = {k: got[k] for k in ("metrics", "q_base", "flash",
                                           "local")}
            out[arch][tag] = got
    for arch, (directory, save, load) in spec.get("ckpt", {}).items():
        out["ckpt"][arch] = ckpt_drill(wholes[arch], directory, rank, arch,
                                       save, load)
    return out
