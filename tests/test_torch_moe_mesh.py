"""The port's mixture-of-experts and recurrent stacks on a mesh of ranks
against the reference, on the CPU.

The ranks are gloo processes (``launch.mesh.spawn``) running
``tests/torch_mesh_ranks.py::moe_world_main``; each world (2 and 4 ranks)
is spawned once for the module.  The reference's ``moe_apply`` on its
meshes runs once, in a fresh process with four virtual devices; its
single-device engine runs here.  In f32:

  * ``moe_apply(mesh=...)`` on ``2``, ``1x2``, ``1x4`` and ``2x2`` with
    moonshot's smoke experts at capacity factor 1.0 over 64 rows (capacity
    binds): within the reference's own 2e-4 of the reference's
    ``moe_apply`` on the same mesh, the 2x2 rows that differ from one
    device's included, with and without the shared expert; the whole batch
    on every rank (``rows="all"``) and a data group's rows (``"shard"``);
  * a rank's expert containers decode to its slice of one device's fp8
    bits, bit for bit; the placed tree's other leaves are equal over the
    mesh, and ``check_replicated`` refuses a rank whose experts differ
    from its model peers' and experts left whole on a model axis;
  * engine tokens of moonshot's and llama4-scout's smoke stacks on
    ``--mesh 2``, ``1x2`` and ``2x2`` (paged, and paged-compressed from
    ECF8) and of recurrentgemma-2b's and xlstm-350m's on ``--mesh 2``
    (monolithic, each rank holding half the rows): the reference's
    single-device run's;
  * a prefill on ``2x2`` (which the reference's ``shard_map`` refuses for a
    batch of one): one device's logits;
  * ``EngineConfig`` on a mesh refuses a model axis that does not divide
    the experts.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from repro_torch.serving import EngineConfig, EngineConfigError  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOON, LLAMA = "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"
RG, XL = "recurrentgemma-2b", "xlstm-350m"
LAYER_MESHES = {"2": (2, 1), "1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
ATOL = 2e-4          # tests/test_sharding.py:150's EP tolerance

_REF_LAYER = """
import numpy as np, jax, jax.numpy as jnp
from dataclasses import replace
from jax.sharding import Mesh
from repro.configs import get, smoke_variant
from repro.models import moe as MOE
cfg = replace(smoke_variant(get('moonshot-v1-16b-a3b')), capacity_factor=1.0)
x = jax.random.normal(jax.random.PRNGKey(1), (8, 8, cfg.d_model)) * .3
out = {'x': np.asarray(x)}
for n_shared in (0, 1):
    p = MOE.moe_init(jax.random.PRNGKey(0), cfg.d_model, cfg.n_experts,
                     cfg.moe_d_ff, n_shared, cfg.moe_d_ff, cfg.top_k)
    out[f'p{n_shared}'] = jax.tree_util.tree_map(np.asarray, p)
    y, aux = MOE.moe_apply(p, x, cfg, mesh=None, dtype=jnp.float32)
    out[f'one/{n_shared}'] = (np.asarray(y), float(aux))
    devs = np.array(jax.devices()[:4])
    for name, dims in (('2', (2,)), ('1x2', (1, 2)), ('1x4', (1, 4)),
                       ('2x2', (2, 2))):
        axes = ('data',) if len(dims) == 1 else ('data', 'model')
        n = int(np.prod(dims))
        mesh = Mesh(devs[:n].reshape(dims), axes)
        with mesh:
            y, aux = jax.jit(lambda p, x: MOE.moe_apply(
                p, x, cfg, mesh=mesh, dtype=jnp.float32))(p, x)
        out[f'{name}/{n_shared}'] = (np.asarray(y), float(aux))
np.save(__OUT__, out, allow_pickle=True)
"""


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_tokens(params, cfg):
    eng = RefEngine(params, cfg, config=RefEngineConfig(
        max_batch=4, max_len=64, cache_mode="monolithic"))
    reqs = [RefRequest(prompt=list(p), max_new_tokens=n, id=9_000 + i)
            for i, (p, n) in enumerate(zip(R.PROMPTS, R.MOE_NEWS))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs]


def _ref_engine_runs():
    """The reference's weights of each smoke stack (seed 0), its
    single-device tokens on f32 weights, on moonshot's fp8 cast (what its
    ECF8 tree decodes to) and its one-device prefill logits of 64 tokens
    at capacity factor 1.0 (capacity binds)."""
    params, tokens = {}, {}
    for arch in (MOON, LLAMA, RG, XL):
        cfg = ref_smoke(ref_get(arch))
        p = RM.init_params(jax.random.PRNGKey(0), cfg)
        params[arch] = _np_tree(p)
        tokens[arch] = _ref_tokens(p, cfg)
        if arch == MOON:
            tokens["moonshot/fp8"] = _ref_tokens(
                ref_store.fp8_cast_tree(p, min_elems=4096), cfg)
            tight = dataclasses.replace(cfg, capacity_factor=1.0)
            toks = np.arange(5, 69, dtype=np.int32)[None] * 7 % 512
            logits, _ = RM.prefill(p, tight, toks, max_len=96)
            prefill = (toks, np.asarray(logits))
    return dict(params=params, tokens=tokens, prefill=prefill)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """(the reference's engine runs here, its ``moe_apply`` on one device
    and on each mesh with its inputs, from four virtual devices in a fresh
    process that runs meanwhile)."""
    out = tmp_path_factory.mktemp("moe_mesh") / "ref_layer.npy"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(
        _REF_LAYER).replace("__OUT__", repr(str(out)))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        runs = _ref_engine_runs()
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return runs, np.load(out, allow_pickle=True).item()


@pytest.fixture(scope="module")
def ref(refs):
    return refs[0]


@pytest.fixture(scope="module")
def ref_layer(refs):
    return refs[1]


def _engines(dims):
    """The engine runs of a mesh: name -> (arch, cache kwargs, ECF8)."""
    runs = {"moonshot": (MOON, {}, False), "llama4": (LLAMA, {}, False),
            "moonshot_ecf8": (MOON, dict(compress_cold=True), True)}
    if dims == (2, 1):
        runs.update(recurrentgemma=(RG, {}, False), xlstm=(XL, {}, False))
    return runs


def _world(n, ref, ref_layer):
    layers = {"plain": ref_layer["p0"], "shared": ref_layer["p1"]}
    layer_meshes = [d for d in LAYER_MESHES.values() if d[0] * d[1] == n]
    engines = {d: _engines(d) for d in ((2, 1), (1, 2), (2, 2))
               if d[0] * d[1] == n}
    return MESH.spawn(R.moe_world_main, n, dict(
        params=ref["params"], layers=layers, x=ref_layer["x"],
        layer_meshes=layer_meshes, engines=engines,
        prefill_tokens=ref["prefill"][0]), device="cpu", timeout=600)


@pytest.fixture(scope="module")
def worlds(ref, ref_layer):
    """The 2- and 4-rank worlds, spawned side by side."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        two, four = (pool.submit(_world, n, ref, ref_layer) for n in (2, 4))
        return two.result(), four.result()


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1]


# -- the MoE layer -------------------------------------------------------

@pytest.mark.parametrize("mesh", list(LAYER_MESHES))
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches_reference_on_the_mesh(ref_layer, world2, world4,
                                                 mesh, shared):
    """The expert-parallel branch (a model axis: each data group routed
    apart, two all_to_all over ``model``) and the data mesh's whole-batch
    routing (the routing weights gathered over ``data`` for a rank's
    shard of the rows): the reference's ``moe_apply`` on the same mesh,
    on every rank, with capacity binding."""
    dims = LAYER_MESHES[mesh]
    world = world2 if dims[0] * dims[1] == 2 else world4
    want, want_aux = ref_layer[f"{mesh}/{shared}"]
    one, _ = ref_layer[f"one/{shared}"]
    differ = int((np.abs(want - one).max(axis=-1) > 1e-3).sum())
    if mesh == "2x2":
        # each data group's own capacity drops other rows than one
        # device's: the test holds the mesh's semantics, not one device's
        assert differ > 0
    else:
        assert differ == 0
    name = "shared" if shared else "plain"
    b = want.shape[0] // dims[0]
    for rank, got in enumerate(world):
        y_all, y_shard, aux = got["layer"][dims][name]
        np.testing.assert_allclose(y_all, want, atol=ATOL, rtol=0)
        d = rank // dims[1]
        np.testing.assert_allclose(y_shard, want[d * b:(d + 1) * b],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(aux, want_aux, rtol=1e-5)


@pytest.mark.parametrize("arch", [MOON, LLAMA])
@pytest.mark.parametrize("m", [2, 4])
def test_expert_containers_decode_to_the_slice_of_one_devices_bits(arch, m):
    """A rank's ECF8 expert containers (its slice of each layer compressed
    with its own codebook) decode to its slice of one device's fp8 bits,
    bit for bit; the placed fp8 baseline is the slice of the whole one and
    every other leaf is one device's."""
    cfg = smoke_variant(get(arch))
    whole_c, whole_b, whole_r, _ = serve.build_params(cfg, 3, "tpu",
                                                      device="cpu")

    def bits(ct, layer):
        a = ct.layer(layer).arrays
        return ops.decode_ecf8(
            a["payload"], a["signmant"], a["lj_limit"], a["first_lj"],
            a["offset"], a["perm"], sym_per_lane=ct.meta.sym_per_lane,
            n_elem=ct.meta.n_elem).reshape(ct.shape)

    whole_bits = {}
    for idx in range(m):
        coords = SH.MeshShape(("data", "model"), (1, m), (0, idx))
        got_c, got_b, report, _ = serve.build_params(cfg, 3, "tpu",
                                                     device="cpu",
                                                     mesh=coords)
        lo, hi = SH.expert_rows(cfg.n_experts, coords)
        n_exp = 0
        for names, leaf in SH.flatten(got_b).items():
            want = SH.flatten(whole_b)[names]
            if SH.is_expert_leaf(names):
                want = want[:, lo:hi]
                n_exp += 1
            assert torch.equal(leaf.view(torch.uint8) if leaf.element_size()
                               == 1 else leaf,
                               want.view(torch.uint8) if want.element_size()
                               == 1 else want), names
        assert n_exp == 3 * len(cfg.pattern)
        units = got_c["units"]
        for pos in units:
            for name in ("wi_gate", "wi_up", "wo"):
                ct, wct = units[pos]["moe"][name], whole_c["units"][pos][
                    "moe"][name]
                assert ct.shape[0] == hi - lo
                for layer in range(ct.arrays["payload"].shape[0]):
                    key = (pos, name, layer)
                    if key not in whole_bits:
                        whole_bits[key] = bits(wct, layer)
                    got = bits(ct, layer)
                    assert torch.equal(got, whole_bits[key][lo:hi])
                    assert torch.equal(got, whole_b["units"][pos]["moe"][
                        name][layer, lo:hi].view(torch.uint8))
        # the report counts the rank's bytes: its share of the experts'
        n_exp_b = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * \
            cfg.moe_d_ff
        assert report["fp8_bytes"] == whole_r["fp8_bytes"] - n_exp_b + \
            n_exp_b // m


def test_placed_tree_checked_over_the_mesh(world4):
    """On 2x2 every rank's other leaves have one checksum, each model
    index's experts one of their own (the two indices' differ), and each
    rank holds half the experts' bytes; ``check_replicated`` refuses a rank
    whose experts differ from its model peer's, and experts left whole."""
    for run in ("moonshot", "llama4"):
        sums = [r["engine"][(2, 2)][run][3] for r in world4]
        assert len({tuple(s[:2]) for s in sums}) == 1
        assert sums[0][2:] == sums[2][2:] and sums[1][2:] == sums[3][2:]
        assert sums[0][2:] != sums[1][2:]
        resident = world4[0]["engine"][(2, 2)][run][2]
        assert len(resident) == 4
        assert len({e for e, _ in resident}) == 1 and resident[0][0] > 0
    for r in world4:
        assert "experts of ranks 0 and 2" in r["refused"]["perturbed"]
        assert "hold other than 4 of 8 experts" in r["refused"]["unplaced"]


# -- the engine ----------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2", "1x2", "2x2"])
@pytest.mark.parametrize("run", ["moonshot", "llama4", "moonshot_ecf8"])
def test_moe_engine_tokens_on_the_mesh(ref, world2, world4, mesh, run):
    """moonshot's and llama4-scout's smoke stacks served paged on the mesh
    (paged-compressed from ECF8 weights, pages going cold): the reference's
    single-device tokens, on every rank."""
    dims = LAYER_MESHES[mesh]
    world = world2 if dims[0] * dims[1] == 2 else world4
    want = ref["tokens"]["moonshot/fp8" if run == "moonshot_ecf8" else
                         {"moonshot": MOON, "llama4": LLAMA}[run]]
    for r in world:
        toks, mode, _, _, _ = r["engine"][dims][run]
        assert mode == "paged"
        assert toks == want


@pytest.mark.parametrize("run,arch", [("recurrentgemma", RG),
                                      ("xlstm", XL)])
def test_recurrent_engine_tokens_on_the_mesh(ref, world2, run, arch):
    """The recurrent stacks on ``--mesh 2``: the monolithic cache split
    over the data groups, each rank holding ``max_batch / 2`` of its rows;
    the reference's single-device tokens."""
    for r in world2:
        toks, mode, _, _, rows = r["engine"][(2, 1)][run]
        assert mode == "monolithic"
        assert rows == [R.MOE_ENGINE_KW["max_batch"] // 2]
        assert toks == ref["tokens"][arch]


def test_prefill_on_data_and_model_axes(ref, world4):
    """A whole-prompt prefill on 2x2 routes the prompt's 64 tokens as one
    group over the model axis (the reference's ``shard_map`` raises on a
    batch of one there): one device's logits, capacity binding."""
    for r in world4:
        np.testing.assert_allclose(r["prefill_2x2"], ref["prefill"][1],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("model,ok", [(2, True), (3, False), (4, True)])
def test_engine_config_refuses_a_model_axis_that_splits_no_expert(model, ok):
    cfg = smoke_variant(get(MOON))                  # 8 experts
    mesh = SH.MeshShape(("data", "model"), (1, model))
    if ok:
        assert EngineConfig(max_batch=4, mesh=mesh).validate(
            cfg).cache_mode == "paged"
        return
    for strict in (False, True):
        with pytest.raises(EngineConfigError, match="8 experts do not "
                           "split over a model axis of 3"):
            EngineConfig(max_batch=4, mesh=mesh).validate(cfg,
                                                          strict=strict)
