"""The port's dry run (``launch/dryrun.py``): one rank of the production
mesh traced on fake tensors over a fake process group, in a fresh process
(the fake group is global state): whisper-base's decode on the multi-pod
mesh (the reference's own slow-test cell) and qwen3-8b's training step on
the single-pod one -- collectives, FLOPs, a useful share at most 1, the
flash kernels counted a layer, no real allocation, and a rank's argument
bytes equal to what the reference's rule table gives that mesh; ``--rules
dmodel`` recorded as a failed cell; the attention switch
(``layers.set_attention_impl``) honoured by the model."""
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get as ref_get  # noqa: E402
from repro.runtime import sharding as RSH  # noqa: E402
from repro.runtime import steps as ref_steps  # noqa: E402

from repro_torch.analysis import op_cost  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.models import layers, model as M  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = (("whisper-base", "decode_32k", "multi"),
         ("qwen3-8b", "train_4k", "single"))

_RUN = r"""
import json, resource, sys
from repro_torch.launch.dryrun import lower_cell
out = {}
for arch, shape, mesh in json.loads(sys.argv[1]):
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    art = lower_cell(arch, shape, mesh)
    art["rss_growth"] = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                         - before) * 1024
    out[f"{arch}/{shape}/{mesh}"] = art
print(json.dumps(out, default=str))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


@pytest.fixture(scope="module")
def cells():
    p = subprocess.run([sys.executable, "-c", _RUN, json.dumps(CELLS)],
                       env=_env(), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "/".join(c))
def test_cell_traces_one_rank_without_allocating(cells, cell):
    art = cells["/".join(cell)]
    assert art["skipped"] is False and "error" not in art
    assert art["n_chips"] == {"single": 256, "multi": 512}[cell[2]]
    r = art["roofline"]
    assert art["collectives"]["total"] > 0 and r["t_collective"] > 0
    assert art["cost_analysis"]["flops"] > 0
    assert 0 < r["useful_flops_ratio"] <= 1
    assert r["dominant"] in ("compute", "memory", "collective")
    mem = art["memory_analysis"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    # shapes alone: the process grew by far less than the rank holds
    assert art["rss_growth"] < min(mem["peak_bytes"] / 4, 1 << 30)


def test_train_cell_counts_the_flash_kernels(cells):
    """qwen3-8b's step at grad_accum 1 with remat: B4 twice a layer (the
    recompute), B5 once; the useful share is 6ND over the forward, the
    recompute and the backward."""
    art = cells["qwen3-8b/train_4k/single"]
    L = get("qwen3-8b").n_layers
    assert art["kernels"] == {"flash_fwd": 2 * L, "flash_bwd": L}
    assert 0.55 < art["roofline"]["useful_flops_ratio"] < 0.8


def _ref_mesh(kind):
    names, sizes = {"single": (("data", "model"), (16, 16)),
                    "multi": (("pod", "data", "model"), (2, 16, 16))}[kind]
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _ref_shard_bytes(tree, specs, mesh, itemsize=None) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    pspecs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(leaves, pspecs):
        shape = list(x.shape)
        for i, axis in enumerate(tuple(spec)):
            if axis is not None:
                axes = axis if isinstance(axis, tuple) else (axis,)
                shape[i] //= math.prod(mesh.shape[a] for a in axes)
        total += math.prod(shape) * (itemsize or jnp.dtype(x.dtype).itemsize)
    return total


def _ref_rank_bytes(arch, shape_name, kind) -> int:
    """A rank's arguments under the reference's rule table: parameters
    (``param_pspecs``), f32 moments (``opt_pspecs``) and the step counter
    for training, the cache (``cache_pspecs``) for decode, and the batch
    rows (split over the batch axes where they divide the batch)."""
    cfg, shape, mesh = ref_get(arch), REF_SHAPES[shape_name], _ref_mesh(kind)
    p = ref_steps.param_specs(cfg)
    specs = RSH.param_pspecs(cfg, p, mesh)
    total = _ref_shard_bytes(p, specs, mesh)
    if shape.kind == "train":
        total += 2 * _ref_shard_bytes(p, specs, mesh, itemsize=4) + 4
    if shape.kind == "decode":
        c = ref_steps.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                  jnp.dtype(cfg.dtype))
        total += _ref_shard_bytes(c, RSH.cache_pspecs(cfg, c, mesh), mesh)
    n = math.prod(mesh.shape[a] for a in ("pod", "data")
                  if a in mesh.shape)
    for v in ref_steps.input_specs(cfg, shape).values():
        rows = v.shape[0] // n if v.shape[0] % n == 0 else v.shape[0]
        total += rows * math.prod(v.shape[1:]) * jnp.dtype(v.dtype).itemsize
    return total


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "/".join(c))
def test_rank_bytes_equal_reference_rule_table(cells, cell):
    """The rule table's bytes a rank equal the reference's for that mesh;
    the training step holds exactly those (its state is placed by the
    table), the decode factory its own rank cache beside replicated
    weights."""
    mem = cells["/".join(cell)]["memory_analysis"]
    want = _ref_rank_bytes(*cell)
    assert mem["rule_table_argument_bytes"] == want
    if cell[1] == "train_4k":
        assert mem["argument_size_in_bytes"] == want


def test_dmodel_rules_recorded_as_a_failed_cell(tmp_path):
    """``--rules dmodel`` (not ported) fails each cell with the port's
    refusal and the run exits 1, never counting it a success; two cells
    in two worker processes (``--jobs``)."""
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "train_4k", "--mesh", "both", "--rules",
         "dmodel", "--jobs", "2", "--out", str(tmp_path)], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 1, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == \
        "dry-run done: 0 ok, 2 failed, 0 skipped"
    for mesh in ("single", "multi"):
        art = json.loads((tmp_path / f"qwen3-8b__train_4k__{mesh}.json")
                         .read_text())
        assert art["error"].startswith("NotImplementedError") and \
            "dmodel" in art["error"]


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b"])
def test_attention_switch_is_honoured(arch):
    """``set_attention_impl("blockwise")`` routes the full-sequence self
    attention through the plain ``blockwise_attention`` (a local layer
    through ``local_attention``): no flash kernel counted, the same loss
    as the flash path within f32 rounding."""
    cfg = smoke_variant(get(arch))
    params = M.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    assert layers.get_attention_impl() == "flash"
    flash = op_cost.analyze(lambda: M.loss_fn(params, cfg, toks, toks))
    want, _ = M.loss_fn(params, cfg, toks, toks)
    layers.set_attention_impl("blockwise")
    try:
        got, _ = M.loss_fn(params, cfg, toks, toks)
        block = op_cost.analyze(lambda: M.loss_fn(params, cfg, toks, toks))
    finally:
        layers.set_attention_impl("flash")
    assert flash["kernels"].get("flash_fwd", 0) > 0
    assert "flash_fwd" not in block["kernels"]
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
