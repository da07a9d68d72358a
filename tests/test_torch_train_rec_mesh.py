"""The port's training of the recurrent and sliding-window stacks on a mesh
of ranks against the reference, on the CPU.

The ranks are gloo processes (``launch.mesh.spawn``) running
``tests/torch_train_mesh_ranks.py::rec_world_main``: a 4-rank and a 2-rank
world, spawned once for the module side by side, each running every mesh
of its own for the three stacks in turn.  The reference runs here on one
device: its own mesh step equals its one-device step on these stacks
(loss and updated parameters), so its one-device step is the oracle, as in
``tests/test_torch_train_mesh.py``.  f32, the smoke stacks of
recurrentgemma-2b (RG-LRU + local), xlstm-350m (sLSTM + mLSTM) and
gemma2-9b (local + global), seq 64 (past the smoke window of 32: every
local layer slides), global batch 4, AdamW lr 1e-3:

  * one sharded step on ``2x2``, ``1x4`` and ``4`` under the sequence
    split (each recurrent mixer reading the whole sequence gathered over
    ``model``, each local window k / v gathered likewise), and on ``2x2``
    and ``1x2`` with the stream whole over ``model``, against the
    reference's ``jax.jit(make_train_step(cfg, AdamWConfig(lr=1e-3),
    remat=False))`` on the same converted weights and ``SyntheticLMData``'s
    batch: loss within rtol 2e-4, every updated parameter gathered whole
    within atol 2e-4, the first moments within 2e-4 of the reference
    moment's largest magnitude;
  * ``grad_accum=2`` with remat on ``2x2`` against the port's one-rank
    step with the same options, to the same bounds;
  * the local layers run ``local_attention`` with ``q_base`` on every rank
    under the sequence split (and without it otherwise); the flash kernels
    run only on gemma2's global layers, with ``q_base`` on the model ranks
    past the first;
  * recurrentgemma's and xlstm's states saved on ``--mesh 2`` and restored
    on ``1x2`` (``conv_w`` and the sLSTM ``r`` split over ``model``) and on
    one rank, every leaf bit-identical;
  * ``launch/train.py --smoke --device cpu --mesh host --model-axis 2
    --arch xlstm-350m`` on 4 gloo ranks, 3 steps, its losses within rtol
    2e-4 of the one-rank run's.
"""
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
from repro.optim.adamw import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.runtime.steps import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import restore_tree  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

import torch_train_mesh_ranks as R  # noqa: E402
from test_torch_train_mesh import (_check_cli, _close_trees, _same_bits,  # noqa: E402
                                   _tree_like)

ARCHS = ("recurrentgemma-2b", "xlstm-350m", "gemma2-9b")
SEQ = 64                    # past the smoke stacks' window of 32
RTOL = ATOL = 2e-4          # tests/test_sharding.py:122 and :127
MOMENT_TOL = 2e-4           # relative to the reference moment's largest

# {tag: (data, model, activation_partitioning, remat, grad_accum)}
REF_RUNS4 = {"2x2": (2, 2, "seq", False, 1), "1x4": (1, 4, "seq", False, 1),
             "4": (4, 1, "seq", False, 1),
             "2x2/none": (2, 2, "none", False, 1),
             "1x4/dmodel": (1, 4, "dmodel", False, 1)}
ACCUM_RUNS4 = {"2x2/accum2": (2, 2, "seq", True, 2)}
REF_RUNS2 = {"1x2/none": (1, 2, "none", False, 1),
             "1x2/dmodel": (1, 2, "dmodel", False, 1)}
# {arch: (the mesh a step is saved from, the mesh it is restored onto,
# the leaf the restore mesh splits over model, the dim it splits)}
CKPT = {"recurrentgemma-2b": ((2, 1), (1, 2), ("rglru", "conv_w"), -1),
        "xlstm-350m": ((2, 1), (1, 2), ("cell", "r"), 1)}


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Per arch: the reference's weights and one-device step, and the
    port's one-rank step with grad_accum 2 and remat."""
    out = {}
    for arch in ARCHS:
        ref_cfg = ref_smoke(ref_get(arch))
        params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
        batch = RefData(RefDataConfig(vocab_size=ref_cfg.vocab_size,
                                      seq_len=SEQ,
                                      global_batch=R.BATCH)).batch(0)
        step = jax.jit(ref_make_train_step(ref_cfg, RefAdamWConfig(lr=R.LR),
                                           remat=False))
        p_ref, o_ref, m_ref = step(params, ref_adamw_init(params), batch,
                                   jnp.zeros((), jnp.int32))
        np_params = _np_tree(params)
        cfg = R.smoke(arch)
        p = convert._convert(np_params, R.CPU)
        p, o, m = make_train_step(cfg, AdamWConfig(lr=R.LR), remat=True,
                                  grad_accum=2)(
            p, adamw_init(p), SyntheticLMData(DataConfig(
                cfg.vocab_size, SEQ, R.BATCH)).batch(0, "cpu"), 0)
        out[arch] = dict(
            params=np_params, loss=float(m_ref["loss"]),
            new_params=_ref_leaves(p_ref), mu=_ref_leaves(o_ref["mu"]),
            accum=dict(metrics={k: float(v) for k, v in m.items()},
                       params={k: v.detach().numpy()
                               for k, v in iter_leaves(p)},
                       mu={k: v.numpy() for k, v in iter_leaves(o["mu"])}))
    out["ckpt"] = {arch: str(tmp_path_factory.mktemp("ckpt")) for arch in CKPT}
    return out


@pytest.fixture(scope="module")
def worlds(ref):
    """The 4- and 2-rank worlds, spawned side by side."""
    params = {arch: ref[arch]["params"] for arch in ARCHS}
    with ThreadPoolExecutor(2) as pool:
        w4 = pool.submit(MESH.spawn, R.rec_world_main, 4, dict(
            params=params, seq=SEQ, runs={**REF_RUNS4, **ACCUM_RUNS4}),
            device="cpu", timeout=600)
        w2 = pool.submit(MESH.spawn, R.rec_world_main, 2, dict(
            params=params, seq=SEQ, runs=REF_RUNS2,
            ckpt={arch: (ref["ckpt"][arch], save, load)
                  for arch, (save, load, _, _) in CKPT.items()}),
            device="cpu", timeout=600)
        return {4: w4.result(), 2: w2.result()}


def _ranks(worlds, tag):
    return worlds[4 if tag in {**REF_RUNS4, **ACCUM_RUNS4} else 2]


@pytest.mark.parametrize("tag", [*REF_RUNS4, *REF_RUNS2])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference_single_device(worlds, ref, arch,
                                                       tag):
    ranks, want = _ranks(worlds, tag), ref[arch]
    for r in ranks:
        np.testing.assert_allclose(r[arch][tag]["metrics"]["loss"],
                                   want["loss"], rtol=RTOL)
    got = ranks[0][arch][tag]
    _close_trees(got["params"], want["new_params"], (arch, tag), ATOL)
    scale = max(float(np.abs(m).max()) for m in want["mu"].values())
    _close_trees(got["mu"], want["mu"], (arch, tag), MOMENT_TOL * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_and_remat_match_one_rank(worlds, ref, arch):
    tag, want = "2x2/accum2", ref[arch]["accum"]
    ranks = _ranks(worlds, tag)
    for r in ranks:
        np.testing.assert_allclose(r[arch][tag]["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=RTOL)
        np.testing.assert_allclose(r[arch][tag]["metrics"]["grad_norm"],
                                   want["metrics"]["grad_norm"], rtol=RTOL)
    _close_trees(ranks[0][arch][tag]["params"], want["params"], arch, ATOL)
    scale = max(float(np.abs(m).max()) for m in want["mu"].values())
    _close_trees(ranks[0][arch][tag]["mu"], want["mu"], arch,
                 MOMENT_TOL * scale)


@pytest.mark.parametrize("tag", [*REF_RUNS4, *ACCUM_RUNS4, *REF_RUNS2])
@pytest.mark.parametrize("arch", ARCHS)
def test_local_windows_and_flash_calls_on_the_mesh(worlds, arch, tag):
    """Each local layer past its window runs ``local_attention`` once a
    micro-batch (twice with remat), with ``q_base`` on every rank under the
    sequence split over a model axis and without it otherwise; the flash
    kernels run on gemma2's global layers alone, with ``q_base != 0`` on
    the model ranks past the first (the query-row split of ``"none"``
    too) and nowhere else."""
    d, m, rule, remat, accum = {**REF_RUNS4, **ACCUM_RUNS4,
                                **REF_RUNS2}[tag]
    cfg = R.smoke(arch)
    units = cfg.n_layers // cfg.unit
    passes = accum * (2 if remat else 1)
    n_local = units * cfg.pattern.count("local") * passes
    n_flash = units * cfg.pattern.count("attn") * accum
    split = rule == "seq" and m > 1
    for rank, r in enumerate(_ranks(worlds, tag)):
        got = r[arch][tag]
        assert got["local"] == {"q_base": n_local if split else 0,
                                "whole": 0 if split else n_local}, (
            rank, got["local"])
        assert got["flash"] == {"fwd": n_flash * passes // accum,
                                "bwd": n_flash}, (rank, got["flash"])
        past_first = rank % m != 0
        assert got["q_base"] == {
            "fwd": got["flash"]["fwd"] if past_first else 0,
            "bwd": got["flash"]["bwd"] if past_first else 0}, (rank, got)


@pytest.mark.parametrize("arch", list(CKPT))
def test_checkpoint_restores_across_meshes_bit_identical(worlds, ref, arch):
    """Saved from ``--mesh 2`` (rank 0 writes whole leaves), restored on
    ``1x2`` (each rank its own shards: ``conv_w``'s channels, the sLSTM
    ``r``'s heads) and on one rank: every leaf's bits the saved state's."""
    _, _, sub, dim = CKPT[arch]
    drills = [r["ckpt"][arch] for r in worlds[2]]
    drill = drills[0]
    assert drill["step"] == 1 and drill["files"] == ["step_00000001"]
    saved, on_mesh = drill["saved"], drill["restored"]
    assert set(saved) == set(on_mesh)
    for path, x in saved.items():
        assert _same_bits(x, on_mesh[path]), path
    leaf = ("params", "units", "pos0") + sub
    shapes = [dr["local_shapes"][leaf] for dr in drills]
    assert shapes[0] == shapes[1] and \
        shapes[0][dim] * 2 == saved[leaf].shape[dim]
    one, at = restore_tree(ref["ckpt"][arch], _tree_like(saved),
                           device="cpu")
    assert at == 1
    for path, x in iter_leaves(one):
        assert _same_bits(x.numpy(), saved[path]), path


def test_launch_train_mesh_host_xlstm_matches_one_rank(tmp_path):
    """The CLI trains xlstm-350m's smoke stack on four gloo ranks (a model
    axis of 2, the sequence split gathered around each mixer): three
    steps, losses within rtol 2e-4 of its one-rank run's."""
    _check_cli(tmp_path, "xlstm-350m", 4)
