"""The port's training of the mixture-of-experts stack on a mesh of ranks
against the reference's own run on the same mesh, on the CPU.

The ranks are gloo processes (``launch.mesh.spawn``) running
``tests/torch_train_mesh_ranks.py::moe_world_main``: a 4-rank and a 2-rank
world, spawned once for the module side by side.  The reference runs once,
in a fresh process with four virtual devices (its ``shard_map`` needs
them), while the worlds run.  In f32:

  * the MoE layer (``moe_apply(rows="shard")``) on ``2``, ``1x2``, ``1x4``
    and ``2x2`` with moonshot's smoke experts at capacity factor 1.0 over
    64 rows (capacity binds), with and without the shared expert: the
    gradient of ``sum(y * proj) + aux`` (``proj`` fixed) against
    ``jax.grad`` of the reference's ``moe_apply`` on the same mesh -- x's,
    the gate's, the rank's slice of the experts', the shared expert's --
    and the aux, within the reference's own 2e-4
    (``tests/test_sharding.py:150``);
  * one train step of moonshot's smoke stack on ``2x2``, ``1x4`` and ``4``
    (the sequence split) and ``2x2`` (the stream whole over ``model``)
    against the reference's ``jax.jit(make_train_step(cfg, mesh=...,
    remat=False))`` on that mesh: loss and aux within rtol 2e-4, every
    updated parameter gathered whole within 2e-4, the first moments within
    2e-4 of their largest magnitude (an ``M``-fold expert, gate or
    shared-expert gradient shows there: Adam's first step hides it in the
    parameters);
  * ``grad_accum=2`` with remat on ``1x2`` against the port's one-rank
    step with the same options;
  * ``loss_fn`` on a mesh adds ``0.01 * aux`` to the NLL, the aux the
    reference's on that mesh (the mean over the data groups of ``2x2``);
  * ``make_train_step(mesh=)`` builds for the MoE, recurrent and
    encoder-decoder stacks alike; the encoder-decoder's loss needs its
    frames.
"""
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

import torch_train_mesh_ranks as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-4          # tests/test_sharding.py:150's EP tolerance
RTOL = 2e-4          # tests/test_sharding.py:122
MOMENT_TOL = 2e-4    # relative to the reference moment's largest

LAYER_MESHES = {"2": (2, 1), "1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
# {tag: (data, model, activation_partitioning, remat, grad_accum)}
REF_RUNS = {"2x2": (2, 2, "seq", False, 1), "1x4": (1, 4, "seq", False, 1),
            "4": (4, 1, "seq", False, 1),
            "2x2/none": (2, 2, "none", False, 1)}
ACCUM_RUNS = {"1x2/accum2": (1, 2, "seq", True, 2)}
LOSS_MESHES = {"2x2": (2, 2, "seq"), "4": (4, 1, "seq")}

_REF = """
import numpy as np, jax, jax.numpy as jnp
from dataclasses import replace
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get, smoke_variant
from repro.data import DataConfig, SyntheticLMData
from repro.models import model as RM, moe as MOE
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.runtime import sharding as SH
from repro.runtime.steps import make_train_step

def flat(tree):
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

devs = np.array(jax.devices()[:4])
def mesh_of(dims):
    return Mesh(devs[:dims[0] * dims[1]].reshape(dims), ('data', 'model'))

out = {}
# the layer: grad of sum(y * proj) + aux on each mesh
cfg = replace(smoke_variant(get('moonshot-v1-16b-a3b')), capacity_factor=1.0)
x = jax.random.normal(jax.random.PRNGKey(1), (8, 8, cfg.d_model)) * .3
proj = jax.random.normal(jax.random.PRNGKey(2), (8, 8, cfg.d_model))
out['x'] = np.asarray(x)
for n_shared in (0, 1):
    p = MOE.moe_init(jax.random.PRNGKey(0), cfg.d_model, cfg.n_experts,
                     cfg.moe_d_ff, n_shared, cfg.moe_d_ff, cfg.top_k)
    for name, dims in __LAYER_MESHES__.items():
        mesh = mesh_of(dims)
        def f(p, x):
            y, aux = MOE.moe_apply(p, x, cfg, mesh=mesh, dtype=jnp.float32)
            return jnp.sum(y * proj) + aux, aux
        with mesh:
            (_, aux), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
        out[f'layer/{name}/{n_shared}'] = dict(x=np.asarray(gx),
                                               grads=flat(gp), aux=float(aux))
# the train step on each mesh
cfg = smoke_variant(get('moonshot-v1-16b-a3b'))
params = RM.init_params(jax.random.PRNGKey(0), cfg)
batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=__SEQ__,
                                   global_batch=__BATCH__)).batch(0)
opt = adamw_init(params)
for tag, (d, m, rule, _, _) in __RUNS__.items():
    mesh = mesh_of((d, m))
    rules = SH.ShardingRules(activation_partitioning=rule)
    p_sh = SH.named(mesh, SH.param_pspecs(cfg, params, mesh, rules))
    o_sh = SH.named(mesh, SH.opt_pspecs(SH.param_pspecs(cfg, params, mesh,
                                                        rules)))
    b_sh = {k: NamedSharding(mesh, P('data', None)) for k in batch}
    step = make_train_step(cfg, AdamWConfig(lr=__LR__), mesh=mesh,
                           rules=rules, remat=False)
    with mesh:
        p_new, o_new, met = jax.jit(
            step, in_shardings=(p_sh, o_sh, b_sh, None),
            out_shardings=(p_sh, o_sh, None))(
            jax.device_put(params, p_sh), jax.device_put(opt, o_sh),
            {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()},
            jnp.zeros((), jnp.int32))
    out[f'step/{tag}'] = dict(metrics={k: float(v) for k, v in met.items()},
                              params=flat(p_new), mu=flat(o_new['mu']))
np.save(__OUT__, out, allow_pickle=True)
"""


def _run_reference(directory):
    """The reference's runs on its meshes, from four virtual devices in a
    fresh process -> what it saved under ``directory``."""
    out = directory / "ref.npy"
    src = textwrap.dedent(_REF)
    for key, val in (("__LAYER_MESHES__", LAYER_MESHES),
                     ("__RUNS__", REF_RUNS), ("__SEQ__", R.SEQ),
                     ("__BATCH__", R.BATCH), ("__LR__", R.LR),
                     ("__OUT__", str(out))):
        src = src.replace(key, repr(val))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", src], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(out, allow_pickle=True).item()


def _ref_params_here():
    """moonshot's smoke weights from the reference's ``init_params`` (seed
    0), the same draw as the fresh process's."""
    cfg = ref_smoke(ref_get(R.MOON))
    return jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(0), cfg))


def _layer_inputs():
    """The layer test's x, proj and weights, as the fresh process draws
    them (the same keys, one device here)."""
    from dataclasses import replace
    from repro.models import moe as MOE
    cfg = replace(ref_smoke(ref_get(R.MOON)), capacity_factor=1.0)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 8, cfg.d_model)) * .3
    proj = jax.random.normal(jax.random.PRNGKey(2), (8, 8, cfg.d_model))
    layers = {}
    for n_shared, name in ((0, "plain"), (1, "shared")):
        layers[name] = jax.tree_util.tree_map(np.asarray, MOE.moe_init(
            jax.random.PRNGKey(0), cfg.d_model, cfg.n_experts, cfg.moe_d_ff,
            n_shared, cfg.moe_d_ff, cfg.top_k))
    return np.asarray(x), np.asarray(proj), layers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's runs, the 4- and 2-rank worlds, the port's one-rank
    step with grad_accum 2 and remat): the worlds run while the reference's
    process does."""
    x, proj, layers = _layer_inputs()
    params = _ref_params_here()
    common = dict(layers=layers, x=x, proj=proj, params=params)
    with ThreadPoolExecutor(3) as pool:
        r = pool.submit(_run_reference,
                        tmp_path_factory.mktemp("train_moe_mesh"))
        w4 = pool.submit(MESH.spawn, R.moe_world_main, 4, dict(
            common, layer_meshes=[(1, 4), (2, 2)], runs=REF_RUNS,
            loss_meshes=LOSS_MESHES), device="cpu", timeout=600)
        w2 = pool.submit(MESH.spawn, R.moe_world_main, 2, dict(
            common, layer_meshes=[(2, 1), (1, 2)], runs=ACCUM_RUNS,
            loss_meshes={}), device="cpu", timeout=600)
        cfg = R.smoke(R.MOON)
        p = convert._convert(params, R.CPU)
        data = SyntheticLMData(DataConfig(cfg.vocab_size, R.SEQ, R.BATCH))
        _, o, m = make_train_step(cfg, AdamWConfig(lr=R.LR), remat=True,
                                  grad_accum=2)(
            p, adamw_init(p), data.batch(0, "cpu"), 0)
        one = dict(metrics={k: float(v) for k, v in m.items()},
                   params={"/".join(k): v.detach().numpy()
                           for k, v in iter_leaves(p)},
                   mu={"/".join(k): v.numpy()
                       for k, v in iter_leaves(o["mu"])})
        return r.result(), {4: w4.result(), 2: w2.result()}, one


def _world(runs, dims):
    return runs[1][dims[0] * dims[1]]


def _close_trees(got, want, what, tol):
    assert set(got) == set(want), what
    for path, g in got.items():
        err = float(np.abs(g - want[path]).max())
        assert err <= tol, (what, path, err)


# -- the layer -----------------------------------------------------------

@pytest.mark.parametrize("mesh", list(LAYER_MESHES))
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_layer_gradients_match_reference_on_the_mesh(runs, mesh, shared):
    """x's, the gate's, the rank's experts' and the shared expert's
    gradients, and the aux, on every rank: ``jax.grad`` of the reference's
    ``moe_apply`` on the same mesh (capacity binding; on ``2x2`` each data
    group routed apart, on a model axis the exchanges' backward carrying
    ``M`` copies of each cotangent to the experts)."""
    ref, _, _ = runs
    x, _, _ = _layer_inputs()
    np.testing.assert_array_equal(ref["x"], x)      # the same draw here
    dims = LAYER_MESHES[mesh]
    want = ref[f"layer/{mesh}/{shared}"]
    name = "shared" if shared else "plain"
    b = want["x"].shape[0] // dims[0]
    for rank, got in enumerate(_world(runs, dims)):
        g = got["layer"][dims][name]
        d = rank // dims[1]
        np.testing.assert_allclose(g["x"], want["x"][d * b:(d + 1) * b],
                                   atol=ATOL, rtol=0)
        lo, hi = g["experts"]
        assert hi - lo == 8 // dims[1]
        assert set(g["grads"]) == set(want["grads"])
        for path, w in want["grads"].items():
            if path in ("wi_gate", "wi_up", "wo"):
                w = w[lo:hi]
            np.testing.assert_allclose(g["grads"][path], w, atol=ATOL,
                                       rtol=0, err_msg=f"{mesh} {path}")
        np.testing.assert_allclose(g["aux"], want["aux"], rtol=1e-5)


# -- the train step ------------------------------------------------------

@pytest.mark.parametrize("tag", list(REF_RUNS))
def test_moe_sharded_step_matches_reference_on_the_mesh(runs, tag):
    ref, worlds, _ = runs
    want = ref[f"step/{tag}"]
    ranks = worlds[4]
    for r in ranks:
        for key in ("loss", "aux", "nll"):
            np.testing.assert_allclose(r[tag]["metrics"][key],
                                       want["metrics"][key], rtol=RTOL,
                                       err_msg=key)
        np.testing.assert_allclose(r[tag]["metrics"]["grad_norm"],
                                   want["metrics"]["grad_norm"], rtol=RTOL)
    got = ranks[0][tag]
    _close_trees({"/".join(k): v for k, v in got["params"].items()},
                 want["params"], tag, ATOL)
    scale = max(float(np.abs(m).max()) for m in want["mu"].values())
    _close_trees({"/".join(k): v for k, v in got["mu"].items()},
                 want["mu"], tag, MOMENT_TOL * scale)
    # each rank holds about a quarter of the state, its experts included
    whole = sum(v.nbytes for v in got["params"].values())
    for r in ranks:
        assert r[tag]["resident"] <= 0.3 * 3 * whole, (tag, r[tag])


@pytest.mark.parametrize("tag", list(ACCUM_RUNS))
def test_moe_grad_accum_and_remat_match_one_rank(runs, tag):
    _, worlds, one = runs
    ranks = worlds[2]
    for r in ranks:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[tag]["metrics"][key],
                                       one["metrics"][key], rtol=RTOL)
        assert r[tag]["metrics"]["aux"] == 0.0
    got = ranks[0][tag]
    _close_trees({"/".join(k): v for k, v in got["params"].items()},
                 one["params"], tag, ATOL)
    scale = max(float(np.abs(m).max()) for m in one["mu"].values())
    _close_trees({"/".join(k): v for k, v in got["mu"].items()}, one["mu"],
                 tag, MOMENT_TOL * scale)


@pytest.mark.parametrize("tag", list(LOSS_MESHES))
def test_mesh_loss_adds_the_aux_loss_once(runs, tag):
    """``loss_fn`` on a mesh: the reference's ``nll + 0.01 * aux`` and its
    aux on the same mesh, on every rank (``2x2`` routes each data group
    apart: its aux is the groups' mean, not one device's)."""
    ref, worlds, _ = runs
    want = ref[f"step/{tag}"]["metrics"]
    for r in worlds[4]:
        got = r["loss"][tag]
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL)
        np.testing.assert_allclose(got["nll"], want["nll"], rtol=RTOL)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["loss"],
                                   got["nll"] + 0.01 * got["aux"], rtol=1e-6)


@pytest.mark.parametrize("arch,ok", [(R.MOON, True),
                                     ("recurrentgemma-2b", True),
                                     ("xlstm-350m", True),
                                     ("whisper-base", False)])
def test_check_mesh_trainable(arch, ok):
    """Every stack trains on a mesh (``ok``: from tokens alone; whisper's
    loss needs its frames there as on one card)."""
    from repro_torch.runtime.sharding import MeshShape
    from repro_torch.runtime.steps import make_train_step
    cfg = smoke_variant(get(arch))
    assert callable(make_train_step(cfg, mesh=MeshShape(("data", "model"),
                                                        (1, 2))))
    if ok:
        return
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="pass frames"):
        M.loss_fn(params, cfg, toks, toks)
