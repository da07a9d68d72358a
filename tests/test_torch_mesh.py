"""The port's serving on a mesh of ranks against the reference, on the CPU.

The ranks are gloo processes (``launch.mesh.spawn``) running
``tests/torch_mesh_ranks.py``; each world (2 and 4 ranks) is spawned once
for the module and returns everything the tests read.  The reference runs
in this process on one device, and its model-axis decode once in a fresh
process with two virtual devices.  Ports of tests/test_kvcache.py:262,
:314 and :363 and tests/test_serving.py:495 and :548, in f32:

  * tokens of the paged and paged-compressed engine on ``--mesh 2`` and
    ``4`` (qwen3's and gemma2's smoke stacks), of the oversubscribed
    workload with swap and preemption and of chunked prefill on ``--mesh
    2``: identical to the reference's single-device monolithic run and to
    the port's one-rank run;
  * decode-step logits on a 2-way data mesh with cold pages bit-identical
    to the one-device cache's; on the model axis within 3e-4 of the
    reference's own model-axis run;
  * a prefill on ``1x2`` at T divisible and not by 2;
  * every rank's engine state alike after a run;
  * ``EngineConfig`` on a mesh: the reference's gate texts; a MoE stack
    resolves paged, a recurrent one monolithic, the encoder-decoder is
    refused as on one device (``tests/test_torch_moe_mesh.py`` serves
    them).
"""
import os
import subprocess
import sys
import textwrap
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.kvcache import codec as ref_codec  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.runtime.sharding import MeshShape  # noqa: E402
from repro_torch.serving import EngineConfig, EngineConfigError  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_tokens(params, cfg, stream, **kw):
    eng = RefEngine(params, cfg, config=RefEngineConfig(**kw))
    reqs = [RefRequest(prompt=list(p), max_new_tokens=n, priority=pr,
                       id=9_000 + i) for i, (p, n, pr) in enumerate(stream)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs]


def _pages():
    """A cold pool of four bf16 pages at mixed scales, the reference's
    container arrays (tests/test_kvcache.py:363)."""
    rng = np.random.default_rng(3)
    import jax.numpy as jnp
    pages = [np.asarray(jnp.asarray(rng.standard_normal(2048) * s,
                                    jnp.bfloat16))
             for s in (0.05, 1.0, 300.0, 7.0)]
    cps = [ref_codec.encode_page(p) for p in pages]
    sb = max(c.stride for c in cps)
    pay = np.zeros((len(cps), sb, ref_codec.LANES), np.uint8)
    for i, c in enumerate(cps):
        pay[i, : c.stride] = c.payload
    return [pay, np.stack([c.signmant for c in cps]),
            np.stack([c.tables() for c in cps]).astype(np.int32),
            np.stack([c.perm for c in cps]).astype(np.int32)]


@pytest.fixture(scope="module")
def ref():
    """The reference's weights (qwen3 seed 0 and 1, gemma2 seed 0) and its
    single-device monolithic tokens of the workloads the ranks serve."""
    q_cfg, g_cfg = ref_smoke(ref_get("qwen3-8b")), ref_smoke(
        ref_get("gemma2-9b"))
    q0 = RM.init_params(jax.random.PRNGKey(0), q_cfg)
    q1 = RM.init_params(jax.random.PRNGKey(1), q_cfg)
    g0 = RM.init_params(jax.random.PRNGKey(0), g_cfg)
    stream = [(p, n, 0) for p, n in zip(R.PROMPTS, R.NEWS)]
    mono = dict(max_batch=4, max_len=64, cache_mode="monolithic")
    over = dict(max_batch=4, max_len=48, cache_mode="monolithic")
    return SimpleNamespace(
        q0=_np_tree(q0), q1=_np_tree(q1), g0=_np_tree(g0),
        qwen3=_ref_tokens(q0, q_cfg, stream, **mono),
        gemma2=_ref_tokens(g0, g_cfg, stream, **mono),
        oversub=_ref_tokens(q0, q_cfg, R.oversub_stream(), **over),
        gemma2_oversub=_ref_tokens(g0, g_cfg, R.oversub_stream(), **over))


@pytest.fixture(scope="module")
def world2(ref):
    return MESH.spawn(R.world_main, 2, dict(
        params=ref.q0, params1=ref.q1, g2_params=ref.g0, compressed=True,
        pages=_pages()), device="cpu", timeout=600)


@pytest.fixture(scope="module")
def world4(ref):
    return MESH.spawn(R.world_main, 4, dict(params=ref.q0), device="cpu",
                      timeout=600)


@pytest.fixture(scope="module")
def one_rank(ref):
    """The port's one-rank (no mesh) tokens of the same workloads."""
    cfg = R.smoke("qwen3-8b")
    params = convert.params_from_numpy(ref.q0, cfg, "cpu")
    g2 = convert.params_from_numpy(ref.g0, R.smoke("gemma2-9b"), "cpu")
    stream = [(p, n, 0) for p, n in zip(R.PROMPTS, R.NEWS)]
    pc = dict(max_batch=4, max_len=64, page_size=16, compress_cold=True)
    ecf8, _ = store.compress_tree(params, min_elems=4096, out_dtype="float32")
    return dict(
        qwen3=R.serve_tokens(params, cfg, EngineConfig(**pc), stream)[0],
        ecf8=R.serve_tokens(ecf8, cfg, EngineConfig(**pc), stream)[0],
        gemma2=R.serve_tokens(g2, R.smoke("gemma2-9b"), EngineConfig(**pc),
                              stream)[0])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cache", ["paged", "paged_compressed"])
def test_data_mesh_tokens_identical(ref, one_rank, world2, world4, n, cache):
    """tests/test_kvcache.py:262 on gloo ranks: the paged (and the
    paged-compressed, pages going cold) engine on ``--mesh 2`` and ``4``
    gives the reference's single-device monolithic tokens and the port's
    one-rank run's, on every rank."""
    world = world2 if n == 2 else world4
    for rank in world:
        toks = rank["engine"][cache][0]
        assert toks == ref.qwen3 == one_rank["qwen3"]
    if cache == "paged_compressed":
        assert world[0]["engine"][cache][3] > 0, "no page went cold"


def test_gemma2_data_mesh_tokens_identical(ref, one_rank, world2):
    """gemma2's ("local", "attn") smoke stack on ``--mesh 2``: its rings
    ride each rank's rows beside the sharded pools."""
    for rank in world2:
        assert rank["engine"]["gemma2"][0] == ref.gemma2 == one_rank["gemma2"]


def test_ecf8_tree_on_the_mesh(one_rank, world2):
    """ECF8 weights (the fp8 cast of the same weights, compressed) on
    ``--mesh 2``: the one-rank run's tokens on the same tree."""
    for rank in world2:
        assert rank["ecf8"] == one_rank["ecf8"]


def test_speculative_decoding_on_data_mesh(ref, world2):
    """A draft on ``--mesh 2`` (its cache whole on every rank, the verify
    on the slot's shard, its logits broadcast): the one-rank run's tokens,
    which are target-only decoding's under greedy."""
    cfg = R.smoke("qwen3-8b")
    params = convert.params_from_numpy(ref.q0, cfg, "cpu")
    draft = convert.params_from_numpy(ref.q1, cfg, "cpu")
    stream = [(p, n, 0) for p, n in zip(R.PROMPTS, R.NEWS)]
    want, eng = R.serve_tokens(params, cfg, EngineConfig(
        **R.SPEC_KW, draft_cfg=cfg, draft_params=draft), stream)
    assert eng.n_spec_rollbacks > 0
    assert want == ref.qwen3
    for rank in world2:
        assert rank["spec"] == want


@pytest.mark.parametrize("run", ["oversub", "chunked"])
def test_oversubscribed_and_chunked_on_mesh(ref, world2, run):
    """tests/test_serving.py:495 / :548 on gloo ranks: per-shard free lists
    and swap ledgers under a pool smaller than the workload, whole-prompt
    and chunked (owner-shard chunks): preempting, and tokens identical to
    the reference's single-device monolithic run."""
    toks, state, preempted, _, n_chunks, moved = world2[0]["engine"][run]
    assert toks == ref.oversub
    assert preempted > 0
    assert state["swap"]["swap_in_bytes_total"] > 0
    assert state["swap"]["swap_pages"] == 0
    if run == "chunked":
        assert n_chunks > 0
    else:
        assert moved > 0, "no request resumed on another shard"
    for rank in world2[1:]:
        assert rank["engine"][run][0] == toks


def test_gemma2_oversubscribed_on_mesh(ref, world2):
    """gemma2 under the oversubscribed pools on ``--mesh 2``: a preempted
    slot's local rings go to the host with its pages and come back (moved
    from the shard it left when it resumes on the other) bit-exactly:
    the reference's single-device monolithic tokens."""
    toks, _, preempted, _, _, moved = world2[0]["engine"]["gemma2_oversub"]
    assert preempted > 0 and moved > 0
    assert toks == ref.gemma2_oversub


@pytest.mark.parametrize("run", ["paged_compressed", "oversub", "chunked",
                                 "gemma2", "gemma2_oversub"])
def test_ranks_hold_the_same_engine_state(world2, world4, run):
    """Every host decision is made from values all ranks hold: after a run
    the ranks' free lists, cold bytes, page tables, swap ledgers, timelines
    and scheduler counters are equal."""
    for world in (world2, world4):
        if run not in world[0]["engine"]:
            continue
        states = [rank["engine"][run][1] for rank in world]
        assert all(s == states[0] for s in states)
        assert len(states[0]["free"]) == len(world)


@pytest.mark.parametrize("B", [2, 4])
def test_decode_step_logits_bit_identical_on_data_mesh(world2, B):
    """tests/test_kvcache.py:314: decode-step logits on a 2-way data mesh
    (paged, cold pages coded on each shard), step by step.  Each rank runs
    the one-device program on its rows: its logits are bit-identical to a
    one-device monolithic cache holding its slots alone.  Against one
    device holding all ``B`` slots they agree within 1e-5 (measured
    1.9e-6 at B = 2, 7.2e-7 at 4): PyTorch's CPU product by the transposed
    tied embedding sums a row in another order at 1 or 2 rows than at 2
    or 4 (the reference's XLA dot does not), so the unembedding is where
    the bits part."""
    half = B // 2
    mine = [tuple(range(r * half, (r + 1) * half)) for r in range(2)]
    ones = world2[0]["one_device_logits"]
    steps, cold = zip(*(world2[r]["logits_data"][B] for r in range(2)))
    assert any(cold), "no page went cold: the test is vacuous"
    for i, want in enumerate(ones[tuple(range(B))]):
        for r in range(2):
            np.testing.assert_array_equal(steps[r][i], ones[mine[r]][i])
        np.testing.assert_allclose(
            np.concatenate([steps[0][i], steps[1][i]]), want, atol=1e-5,
            rtol=0)


_REF_MODEL_AXIS = """
from jax.experimental import pallas as pl
if not hasattr(pl, "store"):
    def _store(ref, idx, val):
        ref[idx] = val
    pl.store = _store
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get, smoke_variant
from repro.kvcache import PagedKVCache
from repro.models import model as M

cfg = smoke_variant(get('qwen3-8b'))
params = M.init_params(jax.random.PRNGKey(1), cfg)
B, max_len, ps = 2, 32, 8
mesh = Mesh(np.array(jax.devices()[:2]), ('model',))
pkv = PagedKVCache(cfg, B, max_len, dtype=jnp.float32, page_size=ps,
                   compress_cold=True)
cache = pkv.init_cache()
lens = [11, 6]
for slot, T in enumerate(lens):
    toks = jnp.arange(1, T + 1, dtype=jnp.int32)[None] + 3 * slot
    _, frag = M.prefill(params, cfg, toks, max_len=max_len)
    cache = pkv.admit(cache, slot, frag, T)
dec = jax.jit(lambda p, t, c: M.decode_step(p, cfg, t, c, mesh=mesh))
tok = jnp.asarray([[17], [29]], jnp.int32)
out = []
for step in range(12):
    for slot in range(B):
        cache = pkv.ensure(cache, slot, lens[slot])
    lg, cache = dec(params, tok, cache)
    out.append(np.asarray(lg)[:, 0])
    for slot in range(B):
        lens[slot] += 1
        cache = pkv.compress_cold_pages(cache, slot, lens[slot])
    tok = (tok + 7) % cfg.vocab_size
np.save(__OUT__, np.stack(out))
"""


def test_model_axis_logits_match_reference_model_axis(world2, tmp_path):
    """tests/test_kvcache.py:363: the model axis's page split (each rank's
    columns ``p % 2``, local attend statistics, the merge) on ``1x2``
    within 3e-4 of the reference's own model-axis run (two virtual devices
    in a fresh process), and of the one-device logits; both ranks return
    the same merged logits."""
    out = tmp_path / "ref_model_axis.npy"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _REF_MODEL_AXIS).replace("__OUT__", repr(str(out)))], env=env,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    want = np.load(out)
    steps0, cold = world2[0]["logits_model"]
    assert cold
    for i, got in enumerate(steps0):
        np.testing.assert_allclose(got, want[i], atol=3e-4)
        np.testing.assert_allclose(
            got, world2[0]["one_device_logits"][(0, 1)][i], atol=3e-4)
        np.testing.assert_array_equal(got, world2[1]["logits_model"][0][i])


@pytest.mark.parametrize("T", [10, 9])
def test_prefill_on_model_axis(world2, T):
    """``prefill`` on ``1x2``: at T = 10 the query rows split over the two
    model ranks (flash with ``q_base``), at T = 9 both run the unsharded
    flash, as the reference falls back; logits and K as one device's."""
    want_l, want_k = world2[0]["one_device_prefill"][T]
    for rank in world2:
        got_l, got_k = rank["prefill_model"][T]
        np.testing.assert_allclose(got_l, want_l, atol=1e-5)
        np.testing.assert_array_equal(got_k, want_k)


def test_sequence_sharded_decode_on_model_axis(world2):
    """The reference's ``decode_attention_update_sharded`` route: a
    prefill's cache with one shared timeline, each model rank holding its
    half of every K/V's positions, decoded with the owner's write and the
    stat merge: within 1e-5 of the whole cache's steps, the same merged
    logits on both ranks."""
    for rank in world2:
        got, want = rank["shared_decode"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    for g0, g1 in zip(world2[0]["shared_decode"][0],
                      world2[1]["shared_decode"][0]):
        np.testing.assert_array_equal(g0, g1)


def test_decode_pages_sharded_bit_exact(world2):
    """``decode_pages_sharded`` on each rank's half of a cold pool,
    gathered: bit-exact against the reference's whole-pool decode."""
    pages = _pages()
    import jax.numpy as jnp
    want = ref_codec.decode_pages_jnp(*(jnp.asarray(a) for a in pages),
                                      n_elem=2048, dtype_name="bfloat16")
    want = np.asarray(want).view(np.uint8).reshape(len(pages[0]), -1)
    for rank in world2:
        np.testing.assert_array_equal(rank["pages_sharded"], want)


def test_weights_replicated_checksums_equal(world2, world4):
    for world in (world2, world4):
        assert len({tuple(r["weights_checksum"]) for r in world}) == 1


def test_model_axis_engine_tokens(ref, world2, world4):
    """The engine on ``1x2`` and ``2x2`` (the decode step's page split and
    the prefill's row split): greedy tokens as the single device's."""
    for world in (world2, world4):
        for rank in world:
            assert rank["model_axis"]["paged_compressed"][0] == ref.qwen3


# -- EngineConfig on a mesh ------------------------------------------------

def _ref_mesh(data, model=1):
    return SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": data, "model": model})


@pytest.mark.parametrize("kw,data,model", [
    (dict(max_batch=3), 2, 1),
    (dict(max_batch=4, prefill_chunk=8), 1, 2),
    (dict(max_batch=4, prefill_chunk=8, prefix_sharing=True), 2, 1),
    (dict(max_batch=4, cache_mode="monolithic", prefill_chunk=8), 2, 1),
])
def test_engine_config_mesh_gates_match_reference(kw, data, model):
    """The reference's mesh gates (``max_batch`` divisible by the batch
    shards, chunks off on a model axis, prefix sharing on one batch shard),
    their resolved fields and warning texts, and one strict error."""
    cfg, ref_cfg = smoke_variant(get("qwen3-8b")), ref_smoke(
        ref_get("qwen3-8b"))
    mesh = MeshShape(("data", "model"), (data, model))
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        want = RefEngineConfig(**kw, mesh=_ref_mesh(data, model)).validate(
            ref_cfg)
    with warnings.catch_warnings(record=True) as w_got:
        warnings.simplefilter("always")
        got = EngineConfig(**kw, mesh=mesh).validate(cfg)
    assert [str(x.message) for x in w_got] == [str(x.message) for x in w_ref]
    for name in ("cache_mode", "prefill_chunk", "prefill_budget",
                 "prefix_sharing"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_shards() == data and got.n_model_shards() == model
    with pytest.raises(EngineConfigError) as e_got:
        EngineConfig(**kw, mesh=mesh).validate(cfg, strict=True)
    assert str(e_got.value).splitlines()[1:] == [
        "  - " + str(x.message) for x in w_ref]


def test_speculation_off_on_a_model_axis():
    cfg = smoke_variant(get("qwen3-8b"))
    got = EngineConfig(max_batch=4, draft_cfg=cfg, draft_params={},
                       mesh=MeshShape(("data", "model"), (1, 2)))
    with pytest.warns(UserWarning, match="speculative decoding needs"):
        assert got.validate(cfg).draft_cfg is None


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "recurrentgemma-2b",
                                  "xlstm-350m", "whisper-base"])
def test_unported_stacks_refused_on_a_mesh(arch):
    """What each stack resolves to on a mesh, in both modes, on ``2`` and
    ``2x2``: the mixture-of-experts one paged, the recurrent ones
    monolithic (nothing to page), the encoder-decoder refused with the
    engine's own error; a model axis that does not divide the experts is
    refused; the dense and local stacks resolve paged."""
    cfg = smoke_variant(get(arch))
    want = {"moonshot-v1-16b-a3b": "paged", "recurrentgemma-2b": "monolithic",
            "xlstm-350m": "monolithic"}.get(arch)
    for dims in ((2, 1), (2, 2)):
        mesh = MeshShape(("data", "model"), dims)
        for strict in (False, True):
            ecfg = EngineConfig(max_batch=4, mesh=mesh)
            if want is None:
                with pytest.raises(EngineConfigError, match="the engine "
                                   "does not serve an encoder-decoder"):
                    ecfg.validate(cfg, strict=strict)
            else:
                assert ecfg.validate(cfg, strict=strict).cache_mode == want
    if cfg.n_experts:
        with pytest.raises(EngineConfigError, match=f"{cfg.n_experts} "
                           "experts do not split over a model axis of 3"):
            EngineConfig(max_batch=3, mesh=MeshShape(
                ("data", "model"), (1, 3))).validate(cfg)
    mesh = MeshShape(("data", "model"), (2, 1))
    for ok in ("qwen3-8b", "gemma2-9b", "llama4-scout-17b-a16e"):
        c = smoke_variant(get(ok))
        assert EngineConfig(max_batch=4, mesh=mesh).validate(c).cache_mode \
            == "paged"


# -- launch/mesh.py and the CLI -------------------------------------------

@pytest.mark.parametrize("spec,want", [("2", (2, 1)), ("2x2", (2, 2)),
                                       ("4X1", (4, 1))])
def test_parse_mesh(spec, want):
    assert MESH.parse_mesh(spec) == want


@pytest.mark.parametrize("spec", ["0", "2x", "x2", "2x2x2", "a", "-1"])
def test_parse_mesh_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError, match="expected 'D' or 'DxM'"):
        MESH.parse_mesh(spec)


def test_serve_cli_mesh_errors(capsys):
    """``--mesh`` with a bad shape, or more cards than are visible, exits
    with the reference's words: how many devices it needs and sees."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="expected 'D' or 'DxM'"):
        serve.main(["--smoke", "--mesh", "2x", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs 4 devices, 0 visible"):
            serve.main(["--smoke", "--mesh", "2x2"])
    with pytest.raises(SystemExit):     # the engine's gate, strictly
        serve.main(["--smoke", "--device", "cpu", "--mesh", "2",
                    "--max-batch", "3", "--prefix-sharing",
                    "--prefill-chunk", "8"])
    assert "not divisible by the mesh" in capsys.readouterr().err


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_refused_without_its_ranks(multi_pod):
    with pytest.raises(ValueError, match="needs (256|512) ranks"):
        MESH.make_production_mesh(multi_pod=multi_pod)
