"""Rank bodies of ``tests/test_torch_steps_mesh.py``.

Each function runs in a process of its own, started by
``repro_torch.launch.mesh.spawn`` as one gloo rank on the CPU, and returns
plain values (numpy arrays, lists, shapes) to the test process, which
holds them against the reference.  This module imports no JAX: the ranks
run the port alone, on weights the test converted from the reference's.
One world runs several meshes in turn over the same process group.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get, smoke_variant
from repro_torch.kernels import flash_fwd
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M
from repro_torch.runtime import sharding as SH
from repro_torch.runtime import steps as S

import torch_train_mesh_ranks as TR

CPU = torch.device("cpu")


def smoke(arch: str, **over):
    return dataclasses.replace(smoke_variant(get(arch)), **over)


def rank_rows(mesh, x: np.ndarray) -> np.ndarray:
    """This rank's rows of a global batch: its batch shard's block."""
    per = x.shape[0] // SH.n_batch_shards(mesh)
    lo = SH.batch_index(mesh) * per
    return x[lo:lo + per]


def factory_run(mesh, params, cfg, max_len: int, tokens, frames=None,
                steps: int = 4) -> dict:
    """``make_prefill_step`` then ``steps`` greedy ``make_decode_step``
    calls on this rank's rows of ``tokens`` (and ``frames``) -> the rank's
    logits of each call (B_loc, V), its greedy tokens, its cache's leaf
    shapes after the prefill and the flash kernel's plain calls with and
    without ``q_base != 0`` in the prefill."""
    batch = {"tokens": torch.from_numpy(rank_rows(mesh, tokens)).long()}
    if frames is not None:
        batch["frames"] = torch.from_numpy(rank_rows(mesh, frames))
    prefill = S.make_prefill_step(cfg, mesh=mesh, max_len=max_len)
    decode = S.make_decode_step(cfg, mesh=mesh)
    calls = {"q_base": 0, "all": 0}
    plain = flash_fwd.plain

    def counted(*a, q_base=0, **kw):
        calls["q_base"] += bool(q_base)
        calls["all"] += 1
        return plain(*a, q_base=q_base, **kw)

    flash_fwd.plain = counted
    try:
        logits, cache = prefill(params, batch)
    finally:
        flash_fwd.plain = plain
    shapes = {"/".join(k): tuple(v.shape)
              for k, v in SH.flatten(cache).items()}
    out, toks = [logits[:, -1].numpy().copy()], []
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        toks.append(tok[:, 0].numpy().copy())
        logits, cache = decode(params, {"token": tok}, cache)
        out.append(logits[:, -1].numpy().copy())
    return dict(logits=out, tokens=toks, shapes=shapes, flash=calls)


def world_main(rank, world, dev, spec):
    """Every factory run of ``spec["runs"]`` ({tag: (case, (data,
    model))}, a case ``(arch, max_len, config overrides)`` of
    ``spec["cases"]``) on the
    reference's converted weights of ``spec["params"]`` ({arch: numpy
    tree}, placed for the mesh), on ``spec["tokens"]`` ({case: global
    batch}) and ``spec["frames"]`` ({arch: global batch}); the rank caches
    of
    ``spec["wide"]`` (arch, config overrides, mesh, max_len, T): shapes
    alone; and whisper's train steps of ``spec["train"]`` ({tag: (data,
    model, rule, remat, grad_accum)}) on ``spec["train_params"]`` and
    ``spec["train_frames"]`` -> a dict of plain values."""
    torch.manual_seed(0)
    meshes = {}

    def mesh_of(dims):
        if dims not in meshes:
            meshes[dims] = MESH.make_mesh(*dims)
        return meshes[dims]

    out = {"factory": {}, "wide": {}, "train": {}}
    for tag, (case, dims) in spec["runs"].items():
        arch, max_len, over = spec["cases"][case]
        cfg, mesh = smoke(arch, **over), mesh_of(dims)
        params = convert.params_from_numpy(spec["params"][arch], cfg, "cpu",
                                           mesh=mesh)
        out["factory"][tag] = factory_run(
            mesh, params, cfg, max_len, spec["tokens"][case],
            spec["frames"].get(arch))
    if spec.get("wide"):
        arch, over, dims, max_len, T = spec["wide"]
        cfg, mesh = smoke(arch, **over), mesh_of(dims)
        params = M.init_params(cfg, 0, device="cpu")
        toks = np.arange(4 * T).reshape(4, T) % cfg.vocab_size
        got = factory_run(mesh, params, cfg, max_len, toks, steps=1)
        out["wide"] = dict(shapes=got["shapes"], tokens=got["tokens"])
    for tag, (d, m, rule, remat, accum) in spec.get("train", {}).items():
        whole = convert._convert(spec["train_params"], CPU)
        got = TR.train_step(whole, mesh_of((d, m)), rule, remat, accum,
                            "whisper-base", spec["train_seq"],
                            frames=spec["train_frames"])
        if rank:
            got = {k: got[k] for k in ("metrics", "q_base", "flash")}
        out["train"][tag] = got
    return out
