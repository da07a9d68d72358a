"""The port's analysis package and the dry run's specs against the
reference: ``roofline.model_flops`` / ``roofline_terms`` on the same cost
and collective dicts with the reference's hardware constants, the workload
shapes, the five specs leaf for leaf against the reference's
``jax.eval_shape`` trees at full width, ``op_cost`` on hand-countable
programs (products, a loop, collectives over a fake 16-rank group against
``hlo_parse``'s wire bytes, the flash kernel counted from its shapes on
fake and on CPU tensors), and every public name of each reference module
importable from the port's module at the same path."""
import ast
import importlib
import inspect
import json
import os
import pkgutil
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.analysis import hlo_parse  # noqa: E402
from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get as ref_get  # noqa: E402
from repro.configs import shape_applicable as ref_applicable  # noqa: E402
from repro.runtime import steps as ref_steps  # noqa: E402

from repro_torch.analysis import op_cost, roofline  # noqa: E402
from repro_torch.configs import SHAPES, get, registry, shape_applicable  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shapes_and_applicability_equal_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in REF_SHAPES.items()}
    for arch in registry.names():
        for name in SHAPES:
            assert shape_applicable(get(arch), SHAPES[name]) == \
                ref_applicable(ref_get(arch), REF_SHAPES[name]), (arch, name)


def _coll(rng, one_host=None):
    ops_ = []
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        b = float(rng.integers(1, 1 << 30))
        ops_.append((kind, b, 16) if one_host is None
                    else (kind, b, 16, one_host))
    d = {}
    for kind, b, *_ in ops_:
        d[kind] = d.get(kind, 0.0) + b
    d["total"] = float(sum(b for _, b, *_ in ops_))
    d["count"] = len(ops_)
    d["ops"] = ops_
    return d


@pytest.mark.parametrize("arch", registry.names())
def test_roofline_equals_reference_with_its_constants(arch):
    """The same cost and collective dicts and the reference's hardware
    (one 50 GB/s link for every collective) give the reference's terms,
    key for key, for every shape."""
    ref_hw = ref_roofline.DEFAULT_HW
    hw = roofline.HW(peak_flops=ref_hw.peak_flops, hbm_bw=ref_hw.hbm_bw,
                     link_bw=ref_hw.ici_bw, net_bw=ref_hw.ici_bw)
    rng = np.random.default_rng(abs(hash(arch)) % (1 << 32))
    for name in SHAPES:
        assert roofline.model_flops(get(arch), SHAPES[name]) == \
            ref_roofline.model_flops(ref_get(arch), REF_SHAPES[name])
        cost = {"flops": float(rng.integers(1, 1 << 50)),
                "bytes accessed": float(rng.integers(1, 1 << 40))}
        coll = _coll(rng)
        for n in (256, 512):
            got = roofline.roofline_terms(cost, coll, n, get(arch),
                                          SHAPES[name], hw)
            want = ref_roofline.roofline_terms(cost, coll, n, ref_get(arch),
                                               REF_SHAPES[name])
            assert set(got) == set(want)
            for k, v in want.items():
                assert got[k] == (v if isinstance(v, str)
                                  else pytest.approx(v, rel=1e-12)), k
    assert roofline.fmt_seconds(0.0123) == ref_roofline.fmt_seconds(0.0123)


def test_collective_term_reads_each_group():
    """On one H100's constants a group inside a host moves over NVLink, a
    group across hosts over the network, a group of one sends nothing."""
    hw = roofline.DEFAULT_HW
    coll = {"total": 3e9, "ops": [("all-gather", 1e9, 8, True),
                                  ("all-reduce", 1e9, 16, False),
                                  ("all-gather", 1e9, 1, True)]}
    assert roofline.collective_seconds(coll, hw) == pytest.approx(
        1e9 / hw.link_bw + 1e9 / hw.net_bw)
    assert roofline.collective_seconds({"total": 2e9}, hw) == \
        pytest.approx(2e9 / hw.net_bw)
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12,
                                                      450e9)


# --------------------------------------------------------------------------
# the specs, leaf for leaf against the reference's eval_shape trees
# --------------------------------------------------------------------------

def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            (tuple(x.shape), str(jnp.dtype(x.dtype)))
            for p, x in flat}


def _port_flat(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in SH.flatten(tree).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("arch", registry.names())
def test_specs_equal_reference_at_full_width(arch):
    """``param_specs`` (bf16 and fp8), ``opt_specs``, ``cache_specs`` at the
    decode shape, ``compressed_param_specs`` and ``input_specs`` of every
    shape: the reference's tree, shapes and dtypes, with nothing
    allocated (every leaf on ``meta``)."""
    cfg, ref_cfg = get(arch), ref_get(arch)
    pairs = [
        (steps.param_specs(cfg), ref_steps.param_specs(ref_cfg)),
        (steps.param_specs(cfg, torch.float8_e4m3fn),
         ref_steps.param_specs(ref_cfg, jnp.float8_e4m3fn)),
        (steps.opt_specs(cfg), ref_steps.opt_specs(ref_cfg)),
        (steps.cache_specs(cfg, 128, 32768),
         ref_steps.cache_specs(ref_cfg, 128, 32768)),
        (steps.compressed_param_specs(cfg),
         ref_steps.compressed_param_specs(ref_cfg)),
    ]
    for name in SHAPES:
        pairs.append((steps.input_specs(cfg, SHAPES[name]),
                      ref_steps.input_specs(ref_cfg, REF_SHAPES[name])))
    for got, want in pairs:
        assert all(x.device.type == "meta"
                   for x in SH.flatten(got).values()
                   if isinstance(x, torch.Tensor))
        assert _port_flat(got) == _ref_flat(want)
    comp = SH.flatten(steps.compressed_param_specs(cfg))
    ref_comp = jax.tree_util.tree_leaves(
        ref_steps.compressed_param_specs(ref_cfg),
        is_leaf=lambda x: type(x).__name__ == "CompressedTensor")
    metas = sorted((vars(t.meta)["shape"], vars(t.meta)["n_elem"])
                   for t in ref_comp if type(t).__name__ ==
                   "CompressedTensor")
    ours = sorted((c.meta.shape, c.meta.n_elem) for c in
                  _containers(steps.compressed_param_specs(cfg)))
    assert ours == metas and len(comp) >= len(ours)


def _containers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _containers(v)
    elif hasattr(tree, "meta") and hasattr(tree, "arrays"):
        yield tree


# --------------------------------------------------------------------------
# op_cost on hand-countable programs
# --------------------------------------------------------------------------

def test_product_and_loop_flops():
    g = torch.Generator().manual_seed(0)
    M, K, N, L = 24, 40, 16, 7
    a = torch.randn(M, K, generator=g)
    b = torch.randn(K, N, generator=g)
    one = op_cost.analyze(lambda: a @ b)
    assert one["flops"] == 2 * M * N * K
    assert one["bytes"] == 4 * (M * K + K * N + M * N)

    def loop():
        x = a
        for _ in range(L):
            y = x @ b
        return y

    many = op_cost.analyze(loop)
    assert many["flops"] == L * 2 * M * N * K
    assert many["hist"]["mm"] == L
    assert op_cost.op_histogram(many, ("mm", "add")) == {"mm": L}


def test_flash_kernel_counted_from_shapes_on_fake_and_cpu():
    """``ops.flash_attention`` records 4 x B x Hq x D x visible pairs (and
    the backward 10 x) whatever runs beneath it: the plain version on CPU
    tensors, a shape-only stand-in on fake ``cuda`` ones; none of the
    plain version's operations is counted."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    g = torch.Generator().manual_seed(1)
    B, Hq, Hkv, T, D = 2, 4, 2, 48, 64
    q = torch.randn(B, Hq, T, D, generator=g)
    k = torch.randn(B, Hkv, T, D, generator=g)
    v = torch.randn(B, Hkv, T, D, generator=g)
    pairs = T * (T + 1) // 2
    cpu = op_cost.analyze(ops.flash_attention, q, k, v, True, 0.0)
    with FakeTensorMode():
        qf, kf, vf = (torch.empty(t.shape, device="cuda") for t in (q, k, v))
        fake = op_cost.analyze(ops.flash_attention, qf, kf, vf, True, 0.0)
        out = ops.flash_attention(qf, kf, vf, True, 0.0)
        assert isinstance(out, FakeTensor) and out.shape == q.shape
    for c in (cpu, fake):
        assert c["flops"] == 4 * B * Hq * D * pairs
        assert c["hist"] == {"kernel:flash_fwd": 1}
    assert cpu["bytes"] == fake["bytes"]
    assert ops.attention_pairs(16, 64, True, q_base=48) == \
        sum(min(48 + r + 1, 64) for r in range(16))
    assert ops.attention_pairs(16, 40, True, q_base=30) == \
        sum(min(30 + r + 1, 40) for r in range(16))

    def fwd_bwd(q):
        q = q.clone().requires_grad_(True)
        ops.flash_attention(q, k, v, True, 0.0).sum().backward()

    both = op_cost.analyze(fwd_bwd, q)
    assert both["kernel_flops"] == {"flash_fwd": 4 * B * Hq * D * pairs,
                                    "flash_bwd": 10 * B * Hq * D * pairs}


_COLL_PROBE = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.analysis import op_cost
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=256)
mesh = make_production_mesh(device_type="cpu")
with FakeTensorMode():
    x = torch.empty(4, 8, dtype=torch.bfloat16, device="cuda")
    out = x.new_empty((16, 4, 8))
    y = torch.empty(4, 8, dtype=torch.float32, device="cuda")
    with op_cost.OpCost() as c:
        dist.all_gather_into_tensor(out.view(-1), x.view(-1),
                                    group=mesh.get_group("model"))
        dist.all_reduce(y, group=mesh.get_group("data"))
        dist.all_reduce(y)
coll = c.result()["coll"]
dist.destroy_process_group()
print(json.dumps(coll))
"""


def test_collective_wire_bytes_over_a_fake_group_equal_hlo_parse():
    """An all-gather over the model group and all-reduces over the data
    group and the world of a fake 256-rank (16, 16) mesh: hlo_parse's wire
    bytes for the same shapes, each with its group's size; the model group
    (ranks 0-15) spans two hosts of 8, as every group does here."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", _COLL_PROBE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    groups = "{" + ",".join(str(i) for i in range(16)) + "}"
    hlo = "\n".join([
        f"  %ag = bf16[16,4,8]{{2,1,0}} all-gather(bf16[1,4,8]{{2,1,0}} %x),"
        f" replica_groups={{{groups}}}, dimensions={{0}}",
        f"  %ar = f32[4,8]{{1,0}} all-reduce(f32[4,8]{{1,0}} %y), "
        f"replica_groups={{{groups}}}, to_apply=%add",
        "  %ar2 = f32[4,8]{1,0} all-reduce(f32[4,8]{1,0} %y), "
        "replica_groups={{" + ",".join(str(i) for i in range(256))
        + "}}, to_apply=%add",
    ])
    want = hlo_parse.collective_bytes(hlo)
    for kind in ("all-gather", "all-reduce"):
        assert got[kind] == want[kind], kind
    assert got["total"] == want["total"] and got["count"] == want["count"]
    assert [(o[0], o[1], o[2]) for o in got["ops"]] == \
        [tuple(o) for o in want["ops"]]
    assert [o[3] for o in got["ops"]] == [False, False, False]


# --------------------------------------------------------------------------
# the packages' surfaces
# --------------------------------------------------------------------------

# What ROADMAP.md lists under "No port needed", by reference module: the
# jit trace counters and their cold-leaf strippers, the JAX profiler hook
# (the port's is ``TorchProfilerHook``), the jnp twins (``*_jnp``) and the
# Pallas entry points (``*_pallas`` and the two that run a Pallas kernel on
# a host container), which are the oracles, and the HLO tools, whose
# counterpart is ``analysis/op_cost.py``.
NO_PORT = {
    "repro.serving.engine": {"compile_count", "strip_cold", "restore_cold"},
    "repro.kvcache.paged": {"strip_cold", "restore_cold"},
    "repro.runtime.tracing": {"JaxProfilerHook"},
    "repro.core.fp8": {"to_bits", "from_bits"},
    "repro.kernels.ops": {"decode_tpu_format"},
    "repro.kvcache.kernels": {"decode_pages"},
    "repro.analysis": {"hlo_parse", "hlo_cost"},
}
ORACLE_SUFFIXES = ("_jnp", "_pallas")
NO_PORT_MODULES = {"repro.analysis.hlo_cost", "repro.analysis.hlo_parse"}


# the reference's dry run sets XLA_FLAGS for 512 devices when it is
# imported: its names are read off its source
SOURCE_ONLY = {"repro.launch.dryrun"}


def _ref_modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro.__path__,
                                                        "repro.")
                  if m.name not in NO_PORT_MODULES)


def _top_level(src: str) -> tuple:
    """(assigned names, defined functions and classes) of a module's
    source."""
    assigned, defined = set(), set()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defined.add(node.name)
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            if isinstance(t, ast.Name):
                assigned.add(t.id)
    return assigned, defined


def _public_names(name: str) -> set:
    """The names a reference module defines: its functions and classes,
    the constants assigned at its top level, and its package's
    submodules (and, for a package, what it re-exports)."""
    if name in SOURCE_ONLY:
        path = os.path.join(REPO, "src", *name.split(".")) + ".py"
        with open(path) as f:
            assigned, defined = _top_level(f.read())
        return {k for k in assigned | defined if not k.startswith("_")}
    mod = importlib.import_module(name)
    assigned, _ = _top_level(inspect.getsource(mod))
    package = hasattr(mod, "__path__")
    out = set()
    for k, v in vars(mod).items():
        if k.startswith("_"):
            continue
        if isinstance(v, types.ModuleType):
            if v.__name__.startswith(mod.__name__ + "."):
                out.add(k)
        elif (getattr(v, "__module__", None) == mod.__name__
              or k in assigned
              or package and str(getattr(v, "__module__", "")
                                 ).startswith(mod.__name__ + ".")):
            out.add(k)
    return out


@pytest.mark.parametrize("name", _ref_modules())
def test_every_reference_name_imports_from_the_port(name):
    """Every public name of each reference module (less ROADMAP's "No port
    needed") imports from the port's module at the same path; the
    ``runtime`` package's is held by ``test_torch_sharding.py`` too."""
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    missing = sorted(k for k in _public_names(name) - NO_PORT.get(name,
                                                                  set())
                     if not (hasattr(port, k)
                             or k.endswith(ORACLE_SUFFIXES)))
    assert not missing, f"{name}: {missing}"
