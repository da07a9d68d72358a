"""The port's training on a mesh of ranks against the reference, on the CPU.

The ranks are gloo processes (``launch.mesh.spawn``) running
``tests/torch_train_mesh_ranks.py``: a 4-rank and a 2-rank world, spawned
once for the module side by side, each running several meshes in turn.
The reference runs here on one device: its own mesh run
(``tests/test_sharding.py::test_sharded_train_step_matches_single_device``)
is red in this container, and that test's assertion makes its one-device
step the oracle.  f32, phi3-medium-14b's smoke stack, seq 16, global batch
4, AdamW lr 1e-3 (that test's cell):

  * one sharded step on ``2x2`` and ``4`` (the sequence split, the
    reference's default ``activation_partitioning``), on ``2x2`` and
    ``1x2`` with the stream whole over ``model`` (the query-row split of
    ``flash_attention_sharded``), and on ``1x4``, ``2x2`` and ``1x2`` with
    the stream cut over ``d_model`` (``"dmodel"``), against the reference's
    ``jax.jit(make_train_step(cfg, AdamWConfig(lr=1e-3), remat=False))``
    on the same converted weights and ``SyntheticLMData``'s batch: loss
    within rtol 2e-4 and every updated parameter, gathered whole, within
    atol 2e-4 (that test's bounds); the first moments (0.1 x the clipped
    gradient: what the parameters' first Adam step hides) within 2e-4 of
    the reference moment's largest magnitude;
  * ``grad_accum=2`` with remat on ``2x2`` (``"seq"`` and ``"dmodel"``)
    and ``1x2`` against the port's one-rank step with the same options, to
    the same bounds;
  * ``"dmodel"`` against ``"none"`` on the same mesh: step 0's loss
    bit-identical, the gradient norm and first moments within 1e-6
    relative (autograd sums a stream's cotangents in another order);
    where the model axis does not divide ``d_model`` (70 on ``1x4``) the
    step is ``"none"``'s bit for bit; each remat unit's saved input holds
    ``d_model / M`` columns;
  * every rank's gradient norm equal to the one-rank step's (rtol 2e-4);
  * B5's plain version with ``q_base``: four 16-row shards' dq and the sum
    of their dk / dv against ``jax.grad`` of the reference's
    ``flash_attention`` over the whole sequence (causal, softcap, GQA),
    within 2e-5 of the largest magnitude;
  * ``sharded_batch``: each rank's rows equal to the reference's
    ``batch_numpy`` rows, bit for bit, on ``(data, model)`` and ``(pod,
    data, model)`` stand-ins;
  * a checkpoint saved on ``--mesh 2`` restored on ``1x2`` and on one rank,
    every leaf bit-identical; moonshot's (the experts split over
    ``model``) saved on ``1x2`` and restored on ``--mesh 2`` (split over
    ``data``) and on one rank, likewise;
  * ``launch/train.py --smoke --device cpu --mesh host --model-axis 2``
    on 4 gloo ranks, 3 steps, its losses within rtol 2e-4 of the one-rank
    run's; moonshot's on 2 ranks (``1x2``) likewise.
"""
import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.runtime.steps import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import restore_tree  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.data import make_global_array  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd_stats)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves  # noqa: E402
from repro_torch.runtime.sharding import MeshShape, P  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

import torch_train_mesh_ranks as R  # noqa: E402

train_cli = importlib.import_module("repro_torch.launch.train")

RTOL = ATOL = 2e-4          # tests/test_sharding.py:122 and :127
MOMENT_TOL = 2e-4           # relative to the reference moment's largest
FLASH_TOL = 2e-5            # f32 gradients, relative to the largest

# {tag: (data, model, activation_partitioning, remat, grad_accum)}
REF_RUNS4 = {"2x2": (2, 2, "seq", False, 1), "4": (4, 1, "seq", False, 1),
             "2x2/none": (2, 2, "none", False, 1),
             "2x2/dmodel": (2, 2, "dmodel", False, 1),
             "1x4/dmodel": (1, 4, "dmodel", False, 1)}
ACCUM_RUNS4 = {"2x2/accum2": (2, 2, "seq", True, 2),
               "2x2/dmodel/accum2": (2, 2, "dmodel", True, 2)}
REF_RUNS2 = {"1x2/none": (1, 2, "none", False, 1),
             "1x2/dmodel": (1, 2, "dmodel", False, 1)}
# a width the model axis does not divide: {tag: (data, model, rule,
# remat, grad_accum, the smoke stack's fields replaced)}
WIDTHS4 = {f"1x4/d70/{rule}": (1, 4, rule, False, 1, {"d_model": 70})
           for rule in ("none", "dmodel")}
# {"dmodel" run: the "none" run on the same mesh}
DMODEL_PAIRS = {"2x2/dmodel": "2x2/none", "1x2/dmodel": "1x2/none"}
SAME_ORDER_TOL = 1e-6       # relative: the same sums in another order
ACCUM_RUNS2 = {"1x2/accum2": (1, 2, "seq", True, 2)}
# {arch: (the mesh a step is saved from, the mesh it is restored onto)}
CKPT_MESHES = {R.ARCH: ((2, 1), (1, 2)), R.MOON: ((1, 2), (2, 1))}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's weights, its one-device step and the port's one-rank
    steps (plain, and grad_accum 2 with remat); moonshot's weights for its
    checkpoint drill."""
    ref_cfg = ref_smoke(ref_get(R.ARCH))
    params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    moon = _np_tree(RM.init_params(jax.random.PRNGKey(0),
                                   ref_smoke(ref_get(R.MOON))))
    batch = RefData(RefDataConfig(vocab_size=ref_cfg.vocab_size,
                                  seq_len=R.SEQ,
                                  global_batch=R.BATCH)).batch(0)
    step = jax.jit(ref_make_train_step(ref_cfg, RefAdamWConfig(lr=R.LR),
                                       remat=False))
    p_ref, o_ref, m_ref = step(params, ref_adamw_init(params), batch,
                               jnp.zeros((), jnp.int32))
    np_params = _np_tree(params)
    cfg = R.smoke()
    data = SyntheticLMData(DataConfig(cfg.vocab_size, R.SEQ, R.BATCH))
    port = {}
    for accum, remat in ((1, False), (2, True)):
        p = convert._convert(np_params, R.CPU)
        p, o, m = make_train_step(cfg, AdamWConfig(lr=R.LR), remat=remat,
                                  grad_accum=accum)(
            p, adamw_init(p), data.batch(0, "cpu"), 0)
        port[accum] = dict(metrics={k: float(v) for k, v in m.items()},
                           params={k: v.detach().numpy()
                                   for k, v in iter_leaves(p)},
                           mu={k: v.numpy()
                               for k, v in iter_leaves(o["mu"])})
    return dict(params=np_params, loss=float(m_ref["loss"]),
                grad_norm=float(m_ref["grad_norm"]),
                new_params=_ref_leaves(p_ref), mu=_ref_leaves(o_ref["mu"]),
                port=port, moon=moon, ckpt={
                    arch: str(tmp_path_factory.mktemp("ckpt"))
                    for arch in (R.ARCH, R.MOON)})


@pytest.fixture(scope="module")
def worlds(ref):
    """The 4- and 2-rank worlds, spawned side by side."""
    with ThreadPoolExecutor(2) as pool:
        w4 = pool.submit(MESH.spawn, R.world_main, 4, dict(
            params=ref["params"], runs={**REF_RUNS4, **ACCUM_RUNS4},
            widths=WIDTHS4), device="cpu", timeout=600)
        w2 = pool.submit(MESH.spawn, R.world_main, 2, dict(
            params=ref["params"], runs={**REF_RUNS2, **ACCUM_RUNS2},
            ckpt={arch: (ref["ckpt"][arch], *CKPT_MESHES[arch])
                  for arch in CKPT_MESHES},
            ckpt_params={R.MOON: ref["moon"]}), device="cpu", timeout=600)
        return {4: w4.result(), 2: w2.result()}


def _run(worlds, tag):
    return worlds[4 if tag in {**REF_RUNS4, **ACCUM_RUNS4, **WIDTHS4}
                  else 2], tag


def _close_trees(got, want, what, tol):
    assert set(got) == set(want), what
    for path, g in got.items():
        err = float(np.abs(g - want[path]).max())
        assert err <= tol, (what, path, err)


@pytest.mark.parametrize("tag", [*REF_RUNS4, *REF_RUNS2])
def test_sharded_step_matches_reference_single_device(worlds, ref, tag):
    ranks, tag = _run(worlds, tag)
    got = ranks[0][tag]
    for r in ranks:
        np.testing.assert_allclose(r[tag]["metrics"]["loss"], ref["loss"],
                                   rtol=RTOL)
    _close_trees(got["params"], ref["new_params"], tag, ATOL)
    scale = max(float(np.abs(m).max()) for m in ref["mu"].values())
    _close_trees(got["mu"], ref["mu"], tag, MOMENT_TOL * scale)


@pytest.mark.parametrize("tag", [*ACCUM_RUNS4, *ACCUM_RUNS2])
def test_grad_accum_and_remat_match_one_rank(worlds, ref, tag):
    ranks, tag = _run(worlds, tag)
    want = ref["port"][2]
    for r in ranks:
        np.testing.assert_allclose(r[tag]["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=RTOL)
    _close_trees(ranks[0][tag]["params"], want["params"], tag, ATOL)
    scale = max(float(np.abs(m).max()) for m in want["mu"].values())
    _close_trees(ranks[0][tag]["mu"], want["mu"], tag, MOMENT_TOL * scale)


@pytest.mark.parametrize("tag", [*REF_RUNS4, *ACCUM_RUNS4, *REF_RUNS2,
                                 *ACCUM_RUNS2])
def test_global_gradient_norm_equals_one_rank(worlds, ref, tag):
    """Each rank's norm is the whole tree's, every replicated element
    counted once: equal to the one-rank step's (and the reference's)."""
    ranks, tag = _run(worlds, tag)
    accum = ranks[0][tag]["metrics"]
    want = ref["port"][2 if tag.endswith("accum2") else 1]
    norms = [r[tag]["metrics"]["grad_norm"] for r in ranks]
    np.testing.assert_allclose(norms, want["metrics"]["grad_norm"],
                               rtol=RTOL)
    np.testing.assert_allclose(ref["port"][1]["metrics"]["grad_norm"],
                               ref["grad_norm"], rtol=RTOL)
    assert accum["nll"] == accum["loss"] and accum["aux"] == 0.0


def test_model_ranks_split_the_rows_and_launch_with_q_base(worlds):
    """A model axis runs the flash forward and backward with ``q_base != 0``
    on the model ranks past the first alone (one layer each a layer); each
    rank holds about ``1 / n`` of the state; the ranks of a batch shard
    draw its rows."""
    cfg = R.smoke()
    for n, tag in ((4, "2x2"), (4, "2x2/none"), (2, "1x2/none"),
                   (4, "2x2/dmodel"), (4, "1x4/dmodel"), (2, "1x2/dmodel")):
        ranks, m = worlds[n], {**REF_RUNS4, **REF_RUNS2}[tag][1]
        for rank, r in enumerate(ranks):
            want = cfg.n_layers if rank % m else 0
            assert r[tag]["q_base"] == {"fwd": want, "bwd": want}, (
                tag, rank)
        for group in (ranks[i:i + m] for i in range(0, n, m)):
            for r in group[1:]:
                assert np.array_equal(group[0][tag]["rows"], r[tag]["rows"])
    for n, tag, share in ((4, "4", 0.3), (2, "1x2/none", 0.55),
                          (4, "2x2", 0.3), (4, "1x4/dmodel", 0.3),
                          (2, "1x2/dmodel", 0.55)):
        whole = sum(v.nbytes for v in worlds[n][0][tag]["params"].values())
        for r in worlds[n]:
            assert r[tag]["resident"] <= share * 3 * whole, (tag, r)


@pytest.mark.parametrize("tag", list(DMODEL_PAIRS))
def test_dmodel_step_matches_none_on_the_mesh(worlds, tag):
    """The stream cut over ``d_model`` changes no value of the forward:
    step 0's loss bit-identical to ``"none"``'s on the same mesh, on every
    rank.  The backward gathers and cuts each block's cotangent where
    ``"none"`` adds it whole, so autograd sums a stream's three
    cotangents (the norm's two, the residual's) in another order: the
    gradient norm and the first moments within 1e-6 relative (step 0's
    warmup lr is 0, so the moments carry the gradient)."""
    ranks, _ = _run(worlds, tag)
    none = DMODEL_PAIRS[tag]
    for r in ranks:
        got, want = r[tag]["metrics"], r[none]["metrics"]
        assert got["loss"] == want["loss"] and got["nll"] == want["nll"]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=SAME_ORDER_TOL)
    got, want = ranks[0][tag], ranks[0][none]
    for path, x in got["params"].items():
        assert np.array_equal(x, want["params"][path]), path
    scale = max(float(np.abs(m).max()) for m in want["mu"].values())
    _close_trees(got["mu"], want["mu"], tag, SAME_ORDER_TOL * scale)


def test_dmodel_falls_back_to_none_where_the_axis_does_not_divide(worlds):
    """d_model 70 on a model axis of 4: ``constrain.cols`` is None, and the
    step is ``"none"``'s bit for bit on every rank (loss, gradient norm,
    parameters and moments)."""
    ranks = worlds[4]
    for r in ranks:
        assert r["1x4/d70/dmodel"]["metrics"] == \
            r["1x4/d70/none"]["metrics"]
    got, want = ranks[0]["1x4/d70/dmodel"], ranks[0]["1x4/d70/none"]
    for key in ("params", "mu"):
        for path, x in got[key].items():
            assert np.array_equal(x, want[key][path]), (key, path)


def test_constrainer_cuts_d_model_where_the_axis_divides():
    """``make_constrainer``'s ``"dmodel"`` rule: the rank's columns where
    the model axis divides ``d``, None where it does not, under another
    rule or without a model axis; ``P(ba, None, "model")`` the stream's
    spec.  Rows stay whole (``rows`` is None)."""
    from repro_torch.runtime.sharding import (ShardingRules,
                                              make_constrainer)
    rules = {r: ShardingRules(activation_partitioning=r)
             for r in ("seq", "none", "dmodel")}
    x = torch.zeros(2, 16, 64)
    for m in range(4):
        mesh = MeshShape(("data", "model"), (1, 4), coords=(0, m))
        c = make_constrainer(mesh, rules["dmodel"])
        assert c.cols(64) == (16 * m, 16) and c.cols(70) is None
        assert c.rows(16) is None
        assert c.spec(x) == P("data", None, "model")
        for other in ("seq", "none"):
            assert make_constrainer(mesh, rules[other]).cols(64) is None
    one = MeshShape(("data", "model"), (4, 1), coords=(1, 0))
    assert make_constrainer(one, rules["dmodel"]).cols(64) is None


@pytest.mark.parametrize("tag", list(ACCUM_RUNS4))
def test_remat_unit_inputs_hold_the_rank_cut(worlds, tag):
    """What remat saves a unit on each rank: ``"dmodel"`` the micro-batch's
    rows with ``d_model / M`` columns, the sequence split ``T / M``
    positions of the whole width; one a unit a micro-batch."""
    d, m, rule, _, accum = ACCUM_RUNS4[tag]
    cfg = R.smoke()
    rows = R.BATCH // d // accum
    want = ((rows, R.SEQ, cfg.d_model // m) if rule == "dmodel"
            else (rows, R.SEQ // m, cfg.d_model))
    for r in worlds[4]:
        assert r[tag]["units"] == \
            [want] * (cfg.n_layers // cfg.unit * accum), r[tag]["units"]


def test_flash_backward_with_q_base_matches_reference_grad():
    """B5's plain version on four 16-row shards of T = 64 (each from its
    own forward statistics) against ``jax.grad`` of the reference's flash
    attention over the whole sequence: dq shard for shard, dk / dv summed
    over the shards.  Causal, softcap 20, 4 query heads over 2 kv heads."""
    rng = np.random.default_rng(5)
    B, Hq, Hkv, T, D, cap = 1, 4, 2, 64, 16, 20.0
    q, do = (rng.standard_normal((B, Hq, T, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(lambda q, k, v: ref_flash(q, k, v, True, cap, 16, 32),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    dqs, dk, dv = [], 0, 0
    for base in range(0, T, 16):
        qs = tq[:, :, base:base + 16].contiguous()
        o, m, l = flash_attention_fwd_stats(qs, tk, tv, True, cap, 16, 32,
                                            q_base=base)
        g = flash_attention_bwd(qs, tk, tv, o, m, l, torch.from_numpy(
            do[:, :, base:base + 16].copy()), True, cap, 16, 32,
            q_base=base)
        dqs.append(g[0])
        dk, dv = dk + g[1], dv + g[2]
    for name, got, w in (("dq", torch.cat(dqs, 2), want[0]),
                         ("dk", dk, want[1]), ("dv", dv, want[2])):
        err = float(np.abs(got.numpy() - w).max()) / float(np.abs(w).max())
        assert err <= FLASH_TOL, (name, err)


@pytest.mark.parametrize("axes,sizes", [(("data", "model"), (2, 2)),
                                        (("pod", "data", "model"),
                                         (2, 2, 1))])
def test_sharded_batch_rows_are_the_reference_rows(axes, sizes):
    cfg = R.smoke()
    data = SyntheticLMData(DataConfig(cfg.vocab_size, R.SEQ, 8, seed=3))
    ref = RefData(RefDataConfig(vocab_size=cfg.vocab_size, seq_len=R.SEQ,
                                global_batch=8, seed=3)).batch_numpy(5)
    n = int(np.prod([s for a, s in zip(axes, sizes) if a != "model"]))
    ba = tuple(a for a in axes if a != "model")
    ba = ba[0] if len(ba) == 1 else ba
    seen = []
    for coords in np.ndindex(*sizes):
        mesh = MeshShape(axes, sizes, coords=coords)
        got = data.sharded_batch(5, mesh, ba, "cpu")
        i = int(np.ravel_multi_index(coords[:len(sizes) - 1],
                                     sizes[:len(sizes) - 1]))
        rows = slice(i * 8 // n, (i + 1) * 8 // n)
        for key in ("tokens", "labels"):
            assert np.array_equal(got[key].numpy(), ref[key][rows])
        part = make_global_array(ref["tokens"], mesh, P(ba, None), "cpu")
        assert np.array_equal(part.numpy(), ref["tokens"][rows])
        seen.append(i)
    assert sorted(set(seen)) == list(range(n))


def test_checkpoint_restores_across_meshes_bit_identical(worlds, ref):
    """Saved from ``--mesh 2`` (rank 0 writes whole leaves), restored on
    ``1x2`` (each rank its own shards) and on one rank: every leaf's bits
    the saved state's."""
    _check_drill(worlds, ref, R.ARCH)


def test_moe_checkpoint_restores_across_meshes_bit_identical(worlds, ref):
    """moonshot's state saved from ``1x2`` (each model rank its half of
    the experts), restored on ``--mesh 2`` (every expert, half of d_model
    a rank) and on one rank: every leaf's bits the saved state's."""
    _check_drill(worlds, ref, R.MOON)


def _check_drill(worlds, ref, arch):
    drills = [r["ckpt"][arch] for r in worlds[2]]
    drill = drills[0]
    assert drill["step"] == 1 and drill["files"] == ["step_00000001"]
    saved, on_mesh = drill["saved"], drill["restored"]
    assert set(saved) == set(on_mesh)
    for path, x in saved.items():
        assert _same_bits(x, on_mesh[path]), path
    if arch == R.ARCH:
        # the 1x2 ranks hold halves of the model-split leaves
        leaf, dim = ("params", "units", "pos0", "attn", "wq"), -1
    else:
        # the --mesh 2 ranks hold every expert, half of d_model each
        leaf, dim = ("params", "units", "pos0", "moe", "wi_gate"), 2
        assert drills[0]["local_shapes"][leaf][1] == saved[leaf].shape[1]
    shapes = [d["local_shapes"][leaf] for d in drills]
    assert shapes[0] == shapes[1] and \
        shapes[0][dim] * 2 == saved[leaf].shape[dim]
    one, at = restore_tree(ref["ckpt"][arch], _tree_like(saved),
                           device="cpu")
    assert at == 1
    for path, x in iter_leaves(one):
        assert _same_bits(x.numpy(), saved[path]), path


def _same_bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _tree_like(flat: dict) -> dict:
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(x)
    return tree


def test_launch_train_mesh_host_matches_one_rank(tmp_path):
    """The CLI on four gloo ranks (a model axis of 2) against its one-rank
    run: three steps, losses within rtol 2e-4."""
    _check_cli(tmp_path, R.ARCH, 4)


def test_launch_train_mesh_host_moe_matches_one_rank(tmp_path, capfd):
    """moonshot's smoke stack through the CLI on two gloo ranks (``1x2``,
    each rank training half the experts) against its one-rank run: three
    steps, losses within rtol 2e-4; rank 0's closing line names the mesh
    and the expert split."""
    _check_cli(tmp_path, R.MOON, 2)
    assert "mesh {data: 1, model: 2}, experts 4 of 8 a rank" in \
        capfd.readouterr().out


def _check_cli(tmp_path, arch, ranks):
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
              "--batch", "4", "--seq-len", "16", "--log-every", "1"]
    one = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    mesh = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "mesh"),
                                    "--mesh", "host", "--model-axis", "2",
                                    "--ranks", str(ranks)])
    assert len(one) == len(mesh) == 3
    np.testing.assert_allclose(mesh, one, rtol=RTOL)
