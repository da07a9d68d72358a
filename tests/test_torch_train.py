"""The port's training path against the JAX package, on the reference's
qwen3 smoke weights converted with ``repro_torch.convert``: ``loss_fn``
and every gradient, remat, ``make_train_step`` over three steps (and one
step from identical converted states) at ``grad_accum`` 1 and 2, the
optimizer's own cases (``tests/test_optim.py``) against the reference's
functions, and the synthetic data stream.

f32.  Losses, learning rates and norms within 1e-5 relative; gradients,
parameters and moments within 1e-5 x the reference leaf's largest
magnitude (the same math summed in another order: measured 1.4e-6 for the
gradients, 3.9e-6 for the parameters after three steps)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.steps import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, iter_leaves  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

# the modules (each package's ``adamw`` attribute is the function)
ref_adamw = importlib.import_module("repro.optim.adamw")
ref_sched = importlib.import_module("repro.optim.schedules")
port_adamw = importlib.import_module("repro_torch.optim.adamw")
port_sched = importlib.import_module("repro_torch.optim.schedules")

RTOL = 1e-5


@pytest.fixture(scope="module")
def world():
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    return cfg, ref_cfg, ref_params


def _port(tree):
    return convert._convert(jax.tree_util.tree_map(np.asarray, tree),
                            torch.device("cpu"))


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _close_trees(got, want, what):
    ref = _ref_leaves(want)
    mine = dict(iter_leaves(got))
    assert set(mine) == set(ref), what
    for path, t in mine.items():
        w = ref[path]
        err = float(np.abs(t.detach().numpy() - w).max())
        assert err <= RTOL * max(float(np.abs(w).max()), 1e-30), (
            what, path, err)


def _close(got, want, what):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    assert abs(got - want) <= RTOL * max(abs(want), 1e-30), (what, got, want)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port_grads(params, cfg, toks, labels, remat):
    paths, leaves = zip(*iter_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, met = M.loss_fn(params, cfg, torch.from_numpy(toks),
                          torch.from_numpy(labels), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), met, dict(zip(paths, grads))


def test_loss_fn_and_grads_match_reference(world):
    cfg, ref_cfg, ref_params = world
    toks, labels = _batch(cfg)

    def ref_loss(p):
        return RM.loss_fn(p, ref_cfg, jnp.asarray(toks), jnp.asarray(labels))

    (want, want_met), want_g = jax.value_and_grad(ref_loss, has_aux=True)(
        ref_params)
    loss, met, grads = _port_grads(_port(ref_params), cfg, toks, labels,
                                   remat=False)
    _close(loss, want, "loss")
    _close(met["nll"], want_met["nll"], "nll")
    assert float(met["aux"]) == float(want_met["aux"]) == 0.0
    ref = _ref_leaves(want_g)
    assert set(grads) == set(ref)
    for path, g in grads.items():
        err = float(np.abs(g.numpy() - ref[path]).max())
        assert err <= RTOL * float(np.abs(ref[path]).max()), (path, err)


def test_remat_equals_no_remat(world):
    """Recomputing each unit in the backward changes no number."""
    cfg, _, ref_params = world
    toks, labels = _batch(cfg, seed=1)
    plain = _port_grads(_port(ref_params), cfg, toks, labels, remat=False)
    remat = _port_grads(_port(ref_params), cfg, toks, labels, remat=True)
    assert torch.equal(plain[0], remat[0])
    for path, g in plain[2].items():
        assert torch.equal(g, remat[2][path]), path


def test_compressed_tree_is_refused(world):
    cfg, _, ref_params = world
    params, _ = store.compress_tree(_port(ref_params), min_elems=4096,
                                    out_dtype="float32")
    toks, labels = _batch(cfg)
    with pytest.raises(TypeError, match="compressed weight"):
        M.loss_fn(params, cfg, torch.from_numpy(toks),
                  torch.from_numpy(labels))


def test_mesh_is_refused(world):
    """What the port still refuses on a mesh: the engine serving an
    encoder-decoder (a request carries no frames), on a mesh as off one.
    A train step that cuts ``d_model`` over ``model``
    (``activation_partitioning="dmodel"``) builds
    (``tests/test_torch_train_mesh.py`` runs it); the prefill and decode
    step functions build on a mesh for every stack, and a train step for
    every stack, whisper's encoder-decoder included
    (``tests/test_torch_steps_mesh.py``)."""
    from repro_torch.runtime.sharding import MeshShape, ShardingRules
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_prefill_step)
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.config import EngineConfigError
    mesh = MeshShape(("data", "model"), (2, 1))
    dmodel = ShardingRules(activation_partitioning="dmodel")
    assert callable(make_train_step(world[0], mesh=mesh, rules=dmodel))
    whisper = smoke_variant(get("whisper-base"))
    for m in (None, mesh):
        with pytest.raises(EngineConfigError, match="encoder-decoder"):
            EngineConfig(mesh=m).validate(whisper)
    for cfg in (world[0], whisper):
        for make in (make_prefill_step, make_decode_step):
            assert callable(make(cfg, mesh=mesh))
    for arch in ("moonshot-v1-16b-a3b", "recurrentgemma-2b", "xlstm-350m",
                 "whisper-base"):
        assert callable(make_train_step(smoke_variant(get(arch)),
                                        mesh=mesh))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_reference(world, grad_accum):
    """Three steps of ``make_train_step`` from the converted weights and a
    fresh AdamW state (the reference's jitted step beside it, on the same
    synthetic batches), then one step of each from the reference's state
    after two steps converted (``opt_state_from_numpy``): params, mu, nu,
    count and the metrics."""
    cfg, ref_cfg, ref_params = world
    kw = dict(grad_accum=grad_accum, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(
        ref_cfg, ref_adamw.AdamWConfig(lr=1e-3), **kw))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), **kw)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, 16, 4, seed=0))
    ref_data = RefData(RefDataConfig(cfg.vocab_size, 16, 4, seed=0))
    params = _port(ref_params)
    state = port_adamw.adamw_init(params)
    rp, rs = ref_params, ref_adamw.adamw_init(ref_params)
    for i in range(3):
        if i == 2:      # the last step from the reference's own state
            params = _port(rp)
            state = convert.opt_state_from_numpy(
                jax.tree_util.tree_map(np.asarray, rs), "cpu")
        rp, rs, rm = ref_step(rp, rs, ref_data.batch(i),
                              jnp.asarray(i, jnp.int32))
        params, state, m = step(params, state, data.batch(i, "cpu"), i)
        assert set(m) == set(rm)
        for k in ("loss", "lr", "nll", "grad_norm"):
            _close(m[k], rm[k], k)
        assert float(m["aux"]) == float(rm["aux"])
        assert int(state["count"]) == int(rs["count"]) == i + 1
        _close_trees(params, rp, f"params after step {i}")
        _close_trees(state["mu"], rs["mu"], f"mu after step {i}")
        _close_trees(state["nu"], rs["nu"], f"nu after step {i}")


# -- tests/test_optim.py's cases, against the reference's functions --------

def _pair(tree):
    """The same numpy tree as (jnp, torch) trees."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _copy(tree):
    return port_adamw.map_tree(torch.clone, tree)


def test_adamw_matches_scalar_reference():
    """One param, no decay / clip: a hand-rolled Adam step and the
    reference's ``adamw``."""
    kw = dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
              clip_norm=0.0)
    rp, p = _pair({"w": np.asarray([2.0, -3.0], np.float32)})
    rg, g = _pair({"w": np.asarray([0.5, -1.0], np.float32)})
    st = port_adamw.adamw_init(p)
    p1, st1, _ = port_adamw.adamw(_copy(p), g, st, AdamWConfig(**kw))
    m = 0.1 * np.asarray(rg["w"])
    v = 0.01 * np.asarray(rg["w"]) ** 2
    step = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(p1["w"].numpy(),
                               np.asarray(rp["w"]) - 0.1 * step, rtol=1e-6)
    assert int(st1["count"]) == 1
    want, _, _ = ref_adamw.adamw(rp, rg, ref_adamw.adamw_init(rp),
                                 ref_adamw.AdamWConfig(**kw))
    np.testing.assert_array_equal(p1["w"].numpy(), np.asarray(want["w"]))


def test_weight_decay_skips_norms():
    rp, p = _pair({"w": np.ones((2,), np.float32),
                   "norm1": np.ones((2,), np.float32),
                   "b_a": np.ones((2,), np.float32),
                   "lam": np.ones((2,), np.float32)})
    rg, g = _pair({k: np.full((2,), 0.25, np.float32) for k in rp})
    cfg = dict(lr=0.1, weight_decay=0.5, clip_norm=0.0)
    p1, _, _ = port_adamw.adamw(_copy(p), g, port_adamw.adamw_init(p),
                                AdamWConfig(**cfg))
    want, _, _ = ref_adamw.adamw(rp, rg, ref_adamw.adamw_init(rp),
                                 ref_adamw.AdamWConfig(**cfg))
    # a decayed parameter moves further than the no-decay ones
    assert float(p1["w"][0]) < float(p1["norm1"][0])
    for k in rp:
        np.testing.assert_allclose(p1[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_clip_by_global_norm():
    rg, g = _pair({"a": np.asarray([3.0], np.float32),
                   "b": np.asarray([4.0], np.float32)})
    clipped, norm = port_adamw.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 5.0)
    total = np.sqrt(sum(float(torch.sum(torch.square(x)))
                        for x in clipped.values()))
    np.testing.assert_allclose(total, 1.0, rtol=1e-6)
    want, _ = ref_adamw.clip_by_global_norm(rg, 1.0)
    for k in rg:
        np.testing.assert_array_equal(clipped[k].numpy(),
                                      np.asarray(want[k]))
    # under the threshold: untouched
    same, _ = port_adamw.clip_by_global_norm(g, 10.0)
    assert torch.equal(same["a"], g["a"])
    # a bf16 gradient is scaled in f32 and cast back
    b16, _ = port_adamw.clip_by_global_norm(
        {"a": torch.tensor([3.0, 0.1], dtype=torch.bfloat16)}, 1.0)
    assert b16["a"].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 5, 9, 10, 11, 37, 60, 109, 110, 200])
def test_schedules(step):
    s = jnp.asarray(step)
    pairs = [
        (port_sched.linear_warmup(torch.tensor(step), 10, 1.0),
         ref_sched.linear_warmup(s, 10, 1.0)),
        (port_sched.cosine_schedule(torch.tensor(step), 10, 110, 2.0),
         ref_sched.cosine_schedule(s, 10, 110, 2.0)),
        (port_sched.cosine_schedule(torch.tensor(step), 10, 110, 2.0,
                                    floor=0.1),
         ref_sched.cosine_schedule(s, 10, 110, 2.0, floor=0.1))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


def test_optimizer_state_is_param_shaped():
    p = {"layer": {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
                   "b": torch.zeros((4,))}}
    st = port_adamw.adamw_init(p)
    assert st["mu"]["layer"]["w"].shape == (3, 4)
    assert st["nu"]["layer"]["b"].shape == (4,)
    assert st["mu"]["layer"]["w"].dtype == torch.float32
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0


# -- the synthetic data stream ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("idx", [0, 3, 41])
def test_synthetic_batches_bit_identical(seed, idx):
    kw = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=seed)
    got = SyntheticLMData(DataConfig(**kw)).batch_numpy(idx)
    want = RefData(RefDataConfig(**kw)).batch_numpy(idx)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    rows = np.arange(2, 5)
    np.testing.assert_array_equal(
        SyntheticLMData(DataConfig(**kw)).batch_numpy(idx, rows)["tokens"],
        RefData(RefDataConfig(**kw)).batch_numpy(idx, rows)["tokens"])
    t = SyntheticLMData(DataConfig(**kw)).batch(idx, "cpu")
    assert t["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(t["labels"].numpy(), want["labels"])
