"""Multi-pod dry run: trace one rank's step of every (arch x shape x mesh)
cell on fake tensors (the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step for 512 placeholder
devices.  The port runs one process a rank, so its counterpart makes this
process one rank of the production mesh -- (data 16, model 16), or (pod 2,
data 16, model 16) with ``--mesh multi`` -- over a ``fake`` process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``), builds
that rank's shard of the parameters, optimizer state, cache and inputs
through the port's rule table (``runtime/sharding.py``) as fake ``cuda``
tensors (``FakeTensorMode``: shapes and dtypes, no storage, no card), and
runs one step of ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step(mesh=...)`` under ``analysis.op_cost``.  The kernels'
dispatch points (``kernels/ops.py``) count each kernel from its shapes and
return shape-only outputs, so the trace holds what the card would.

For each cell this produces, without allocating any real buffers:
  * proof the step runs on that rank's shard (the trace ends),
  * ``memory_analysis``  -> argument, output, alias and temporary bytes a
    rank, the temporaries the peak of the storages the step allocates
    (``op_cost``'s tracker), and the argument bytes the rule table gives
    (``rule_table_argument_bytes``: the serve factories hold replicated
    weights, where the reference's rule table shards them),
  * ``cost_analysis``    -> FLOPs and bytes a rank for the roofline,
  * ``collectives``      -> wire bytes a rank by collective, with groups,
  * ``roofline``         -> ``analysis.roofline.roofline_terms`` on one H100,
all dumped to ``experiments/artifacts_torch/<arch>__<shape>__<mesh>[__tag]
.json``.  The traced rank is :data:`RANK`, the last of the first model
group.  ``--jobs N`` traces N cells at once, each in a process of its own.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --mesh single --rules none --tag base
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..analysis import op_cost
from ..analysis.roofline import roofline_terms
from ..configs import ASSIGNED, SHAPES, get, shape_applicable
from ..core.store import CompressedTensor, is_compressed, torch_dtype
from ..models import model as M
from ..models.layers import get_attention_impl
from ..optim.adamw import AdamWConfig, adamw_init
from ..runtime import sharding as SH
from ..runtime.steps import (cache_specs, compressed_specs_of, input_specs,
                             make_decode_step, make_prefill_step,
                             make_train_step, param_specs)
from .mesh import make_production_mesh

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "experiments", "artifacts_torch")
_WORLD = {"single": 256, "multi": 512}
# the traced rank: the last of the first model group (model 16 is the
# innermost axis), whose query rows see the most keys under the causal mask
RANK = 15


def trace_device() -> str:
    """The device of the fake tensors: the card's on a build with CUDA; on
    a CPU-only build ``meta``, whose device guard exists (indexing a fake
    ``cuda`` tensor needs CUDA's).  The step's code takes the same path on
    both: the dispatch points divert every fake input first."""
    return "cuda" if torch.cuda.is_available() else "meta"


def fake_mode():
    """Shape-only tensors; real ones (the mesh's rank table) are let in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def fake_like(tree):
    """``tree`` (dicts, tuples, lists, compressed containers; other leaves
    kept) with every tensor replaced by a fake one of its shape and dtype
    on :func:`trace_device` (call it under :func:`fake_mode`)."""
    if isinstance(tree, dict):
        return {k: fake_like(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(fake_like(v) for v in tree)
    if is_compressed(tree):
        return CompressedTensor({k: _fake(a) for k, a in tree.arrays.items()},
                                tree.meta)
    return _fake(tree) if isinstance(tree, torch.Tensor) else tree


def trace(step, args: tuple, keep_ops: bool = False) -> tuple:
    """Run ``step(*args)`` (fake arguments, under :func:`fake_mode`) under
    an ``op_cost`` counter that tracks memory -> (its ``result()``, the
    reference's ``memory_analysis`` keys for the step, the counter)."""
    arg_bytes = _bytes(*args)
    with op_cost.OpCost(memory=True, keep_ops=keep_ops) as counter:
        out = step(*args)
    return (counter.result(),
            _memory(args, list(_leaves(out)), counter, arg_bytes), counter)


def _init_world(mesh_kind: str, rank: int):
    """This process as ``rank`` of a fake process group of the production
    mesh's size -> its mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=_WORLD[mesh_kind])
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type="cpu")


def _map(tree, fn, names=()):
    """A dense tree with ``fn(path names, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, names + (str(k),)) for k, v in tree.items()}
    return fn(names, tree)


def _fake(x: torch.Tensor, shape=None) -> torch.Tensor:
    """A fake tensor of ``x``'s dtype and ``shape`` (x's) on
    :func:`trace_device`."""
    return torch.empty(tuple(x.shape if shape is None else shape),
                       dtype=x.dtype, device=trace_device())


def _leaves(tree):
    """Every tensor of a tree of dicts, tuples, lists and compressed
    containers."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif is_compressed(tree):
        yield from tree.arrays.values()
    elif isinstance(tree, torch.Tensor):
        yield tree


def _bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tr in trees
               for t in _leaves(tr))


def _local_shape(shape, spec, mesh) -> tuple:
    """A rank's shard shape of a leaf of ``shape`` under ``spec``."""
    return tuple(n if a is None else n // SH.axes_size(mesh, a)
                 for n, a in zip(shape, spec))


def _sharded(tree, specs, mesh):
    """Fake shards of the meta ``tree`` under the spec tree ``specs``."""
    flat = SH.flatten(specs)
    return _map(tree, lambda names, x: _fake(
        x, _local_shape(x.shape, flat[names], mesh)))


def _batch_rows(specs: dict, mesh) -> dict:
    """The rank's rows of each input: its batch shard where the batch
    axes divide the batch, the whole batch where they do not (the
    reference's ``_batch_pspec``)."""
    n = SH.n_batch_shards(mesh)
    return {k: _fake(v, ((v.shape[0] // n if v.shape[0] % n == 0
                          else v.shape[0]),) + tuple(v.shape[1:]))
            for k, v in specs.items()}


def _serve_params(cfg, mesh, dtype, compressed: bool):
    """The weights a rank of the prefill / decode factories holds: every
    leaf whole, a MoE layer's expert leaves cut to the rank's ``E / M``
    (``sharding.expert_cut``), ECF8-compressed stand-ins with
    ``compressed``."""
    base = param_specs(cfg, dtype)

    def cut(names, x):
        got = SH.expert_cut(names, x.shape, mesh)
        if got is None:
            return x
        dim, lo, hi = got
        shape = list(x.shape)
        shape[dim] = hi - lo
        return torch.empty(shape, dtype=x.dtype, device="meta")

    tree = _map(base, cut)
    return fake_like(compressed_specs_of(tree) if compressed else tree)


def _shard_bytes(tree, specs, mesh, itemsize: int | None = None) -> int:
    """Bytes of a rank's shards of the meta ``tree`` under ``specs`` (each
    element ``itemsize`` bytes, else its own dtype's)."""
    flat = SH.flatten(specs)
    return sum(math.prod(_local_shape(x.shape, flat[names], mesh))
               * (itemsize or x.element_size())
               for names, x in SH.flatten(tree).items())


def _rule_table_bytes(cfg, shape, mesh, rules, dtype, compressed) -> int:
    """A rank's argument bytes under the rule table (``param_pspecs``,
    ``opt_pspecs``, ``cache_pspecs`` and the batch rows): what the
    reference's GSPMD placement gives that mesh."""
    p = (compressed_specs_of(param_specs(cfg)) if compressed
         else param_specs(cfg, dtype))
    specs = SH.param_pspecs(cfg, p, mesh, rules)
    total = _shard_bytes(p, specs, mesh)
    if shape.kind == "train":       # f32 moments and the step counter
        total += 2 * _shard_bytes(p, specs, mesh, itemsize=4) + 4
    if shape.kind == "decode":
        c = cache_specs(cfg, shape.global_batch, shape.seq_len,
                        torch_dtype(cfg.dtype))
        total += _shard_bytes(c, SH.cache_pspecs(cfg, c, mesh), mesh)
    n = SH.n_batch_shards(mesh)
    for v in input_specs(cfg, shape).values():
        rows = v.shape[0] // n if v.shape[0] % n == 0 else v.shape[0]
        total += rows * (v.numel() // v.shape[0]) * v.element_size()
    return total


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               rules: SH.ShardingRules = SH.DEFAULT_RULES,
               grad_accum: int = 1, remat: bool = True,
               keep_hlo: bool = False,
               assume_flash_kernel: bool = False,
               param_dtype: str | None = None,
               compressed: bool = False,
               out_dir: str = ARTIFACTS) -> dict:
    """Trace one rank's step of one cell (rank :data:`RANK`); return the
    artifact dict.  ``assume_flash_kernel`` is recorded and changes
    nothing: the port always counts the kernel's bytes."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    runs, why = shape_applicable(cfg, shape)
    if not runs:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": True, "reason": why}
    if rules.activation_partitioning not in ("seq", "none"):
        raise NotImplementedError(
            f"activation_partitioning={rules.activation_partitioning!r}: "
            f"the port trains with 'seq' or 'none'")
    n_chips = _WORLD[mesh_kind]
    dtype = (getattr(torch, param_dtype) if param_dtype
             else torch_dtype(cfg.dtype))
    t0 = time.time()
    mesh = _init_world(mesh_kind, RANK)
    try:
        with fake_mode():
            args, step = _cell_inputs(cfg, shape, mesh, rules, dtype,
                                      compressed, grad_accum, remat)
            cost, art_mem, counter = trace(step, args, keep_hlo)
        art_mem["rule_table_argument_bytes"] = _rule_table_bytes(
            cfg, shape, mesh, rules, dtype, compressed)
    finally:
        dist.destroy_process_group()
    cost_d = {"flops": cost["flops"], "bytes accessed": cost["bytes"]}
    coll = dict(cost["coll"])
    art = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "rank": RANK,
        "rules": {"activation_partitioning": rules.activation_partitioning,
                  "vocab_tp": rules.vocab_tp,
                  "expert_fsdp": rules.expert_fsdp,
                  "serve_tp": rules.serve_tp},
        "grad_accum": grad_accum, "remat": remat,
        "attention_impl": get_attention_impl(),
        "param_dtype": str(dtype).removeprefix("torch."),
        "compressed": compressed,
        "n_chips": n_chips,
        "memory_analysis": art_mem,
        "cost_analysis": cost_d,
        "unknown_trip_loops": 0,
        "assume_flash_kernel": assume_flash_kernel,
        "kernels": cost["kernels"],
        "kernel_flops": cost["kernel_flops"],
        "collectives": {k: v for k, v in coll.items() if k != "ops"},
        "collective_ops_top": sorted(coll["ops"], key=lambda t: -t[1])[:12],
        "bytes_top": dict(list(cost["bytes_by_op"].items())[:12]),
        "op_histogram": op_cost.op_histogram(cost),
        "trace_seconds": time.time() - t0,
        "roofline": roofline_terms(cost_d, coll, n_chips, cfg, shape),
        "skipped": False,
    }
    if keep_hlo:
        art["hlo_text_path"] = _dump_ops(out_dir, arch, shape_name,
                                         mesh_kind, counter.ops)
    return art


def _memory(args, outs, counter, arg_bytes: int) -> dict:
    """The reference's ``memory_analysis`` keys for the traced rank."""
    arg_storages = {id(t.untyped_storage()) for t in _leaves(args)}
    seen, out_b, alias_b = set(), 0, 0
    for t in outs:
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        out_b += st.nbytes()
        if id(st) in arg_storages:
            alias_b += st.nbytes()
    new_out = out_b - alias_b
    return {"argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_b,
            "alias_size_in_bytes": alias_b,
            "temp_size_in_bytes": max(0, counter.peak - new_out),
            "peak_bytes": arg_bytes + counter.peak}


def _cell_inputs(cfg, shape, mesh, rules, dtype, compressed, grad_accum,
                 remat):
    """(the step's arguments, the step) of one rank, as fake tensors."""
    batch = _batch_rows(input_specs(cfg, shape), mesh)
    if shape.kind == "train":
        if compressed:
            raise ValueError("a train step takes a dense tree "
                             "(--compressed serves)")
        p_meta = param_specs(cfg, dtype)
        specs = SH.param_pspecs(cfg, p_meta, mesh, rules)
        params = _sharded(p_meta, specs, mesh)
        opt = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(), mesh=mesh, rules=rules,
                               remat=remat, grad_accum=grad_accum)
        return (params, opt, batch, 0), step
    params = _serve_params(cfg, mesh, dtype, compressed)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, mesh=mesh, rules=rules,
                                 max_len=shape.seq_len)
        return (params, batch), step
    rows = batch["token"].shape[0]
    cache = M.init_cache(cfg, rows, shape.seq_len, torch_dtype(cfg.dtype),
                         device=trace_device(), mesh=mesh)
    step = make_decode_step(cfg, mesh=mesh, rules=rules)
    return (params, batch, cache), step


def _dump_ops(out_dir, arch, shape_name, mesh_kind, ops) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.ops")
    with open(path, "w") as f:
        f.write("\n".join(ops) + "\n")
    return path


def _cell(name: str, arch: str, shape_name: str, mesh_kind: str,
          attn: str, kwargs: dict) -> tuple:
    """One cell -> (name, artifact, outcome): its artifact, or the failure
    recorded as one.  Runs in the calling process or in a worker of
    ``--jobs`` (a process of its own: the fake process group and the
    attention switch are global state)."""
    from ..models.layers import set_attention_impl
    set_attention_impl(attn)
    try:
        art = lower_cell(arch, shape_name, mesh_kind, **kwargs)
    except Exception as e:
        return name, {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                      "skipped": False, "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-3000:]}, "fail"
    return name, art, "skip" if art.get("skipped") else "ok"


def _report(name: str, art: dict, outcome: str):
    if outcome == "fail":
        print(f"[FAIL] {name}: {art['error'][:200]}", flush=True)
    elif outcome == "skip":
        print(f"[skip] {name}: {art['reason'][:80]}", flush=True)
    else:
        r = art["roofline"]
        gib = art["memory_analysis"]["peak_bytes"] / 2 ** 30
        print(f"[ ok ] {name}: compute {r['t_compute']:.4f}s"
              f" memory {r['t_memory']:.4f}s collective "
              f"{r['t_collective']:.4f}s -> {r['dominant']}"
              f", {gib:.2f} GiB a rank (trace "
              f"{art['trace_seconds']:.0f}s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rules", default="seq",
                    choices=["seq", "dmodel", "none"])
    ap.add_argument("--no-vocab-tp", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--attn", default="flash",
                    choices=["flash", "blockwise"],
                    help="full-attention impl (blockwise = naive baseline)")
    ap.add_argument("--assume-flash-kernel", action="store_true",
                    help="recorded only: the port always counts the flash "
                         "kernel's bytes (kernels/ops.py)")
    ap.add_argument("--serve-tp", action="store_true",
                    help="serving rule: weights pure-TP (no FSDP axis)")
    ap.add_argument("--param-dtype", default=None,
                    choices=[None, "bfloat16", "float8_e4m3fn"],
                    help="override parameter storage dtype (fp8 = the "
                         "paper's serving baseline)")
    ap.add_argument("--compressed", action="store_true",
                    help="trace with ECF8-compressed weights (decode-on-"
                         "use inside the step — the paper's technique)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--keep-hlo", action="store_true",
                    help="write the dispatched operations of each cell "
                         "(the port has no HLO) beside its artifact")
    ap.add_argument("--out", default=ARTIFACTS)
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace this many cells at once, each in a process "
                         "of its own (a cell holds one core)")
    args = ap.parse_args(argv)

    rules = SH.ShardingRules(activation_partitioning=args.rules,
                             vocab_tp=not args.no_vocab_tp,
                             serve_tp=args.serve_tp)
    archs = ASSIGNED if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    kwargs = dict(rules=rules, grad_accum=args.grad_accum,
                  remat=not args.no_remat, keep_hlo=args.keep_hlo,
                  assume_flash_kernel=args.assume_flash_kernel,
                  param_dtype=None if args.param_dtype in (None, "None")
                  else args.param_dtype,
                  compressed=args.compressed, out_dir=args.out)
    tag = f"__{args.tag}" if args.tag else ""
    cells = [(f"{arch}__{shape_name}__{mesh_kind}{tag}", arch, shape_name,
              mesh_kind, args.attn, kwargs)
             for arch in archs for shape_name in shapes
             for mesh_kind in meshes]

    os.makedirs(args.out, exist_ok=True)
    counts = {"ok": 0, "fail": 0, "skip": 0}

    def done(name, art, outcome):
        counts[outcome] += 1
        _report(name, art, outcome)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(art, f, indent=1, default=str)

    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor, as_completed
        with ProcessPoolExecutor(args.jobs,
                                 mp_context=mp.get_context("spawn"),
                                 max_tasks_per_child=1) as pool:
            for fut in as_completed([pool.submit(_cell, *c)
                                     for c in cells]):
                done(*fut.result())
    else:
        for c in cells:
            done(*_cell(*c))
    print(f"dry-run done: {counts['ok']} ok, {counts['fail']} failed, "
          f"{counts['skip']} skipped")
    raise SystemExit(1 if counts["fail"] else 0)


if __name__ == "__main__":
    main()
