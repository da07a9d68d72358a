"""The recurrent families in the port against the JAX package: the RG-LRU,
mLSTM and sLSTM mixers (``models/recurrent.py``), recurrentgemma's
``("rglru", "rglru", "local")`` and xlstm's ``("slstm", "mlstm")`` stacks
with their tail layers, their ECF8 trees, and their serving by the engine:
the monolithic cache, slot reuse, a recurrent hybrid on the paged cache
under preemption, and a recurrent speculative draft.

Weights are the reference's own, converted with ``repro_torch.convert``,
with norm scales and biases redrawn in both trees (the reference draws
zeros, under which a misplaced norm or bias would not show).  Mixer outputs
and states are f32 and held within 1e-5, whole-model logits within 1e-4
(the same operations in another summation order); tokens, containers and
snapshots are held exactly.  The reference reads its recurrent weights
with ``.astype``, which its compressed leaves lack, so the port's ECF8 tree
is held against the reference on the fp8 tree (which decodes to the same
bits)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine, Request  # noqa: E402

from test_torch_spec import _lockstep_draft_states, _target_only  # noqa: E402

MIXER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
F32 = torch.float32
D, HEADS = 64, 4
MIN_ELEMS = 256         # selects every recurrent matrix at d_model 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomized(tree, rng, path=()):
    """The tree with every norm scale and bias redrawn (normal * 0.3)."""
    if isinstance(tree, dict):
        return {k: _randomized(v, rng, path + (k,)) for k, v in tree.items()}
    name = path[-1]
    if "norm" in name or name in ("b", "conv_b", "b_a", "b_x", "b_if"):
        return (rng.normal(size=tree.shape) * 0.3).astype(tree.dtype)
    return tree


def _mixer(init, *args, seed=0):
    """(reference params, port params) of one mixer, biases randomized."""
    tree = _randomized(_np(init(jax.random.PRNGKey(seed), *args)),
                       np.random.default_rng(seed + 100))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(
        np.float32)


def _close(got, want, atol=MIXER_ATOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0, err_msg=msg)


def _states_close(got: dict, want: dict, atol=MIXER_ATOL):
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k], atol, msg=k)


# -- the mixers ---------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 37, 300])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_apply_and_step_match_reference(T, carried):
    """The log-depth scan over T (1 pass short of a power of two at 37,
    nine passes at 300) from zero or a carried ``h0`` and ``conv`` state,
    then five decode steps from the final state."""
    ref_p, p = _mixer(ref_rec.rglru_init, D, D)
    x = _x((2, T, D), T)
    kw, ref_kw = {}, {}
    if carried:
        h0, conv = _x((2, D), 1), _x((2, rec.CONV_WIDTH - 1, D), 2)
        kw = dict(h0=torch.from_numpy(h0), conv_state=torch.from_numpy(conv))
        ref_kw = dict(h0=jnp.asarray(h0), conv_state=jnp.asarray(conv))
    want, ref_st = ref_rec.rglru_apply(ref_p, jnp.asarray(x),
                                       dtype=jnp.float32, **ref_kw)
    got, st = rec.rglru_apply(p, torch.from_numpy(x), dtype=F32, **kw)
    _close(got, want)
    _states_close(st, ref_st)
    for i in range(5):
        xt = _x((2, D), 10 + i)
        want, ref_st = ref_rec.rglru_step(ref_p, jnp.asarray(xt), ref_st,
                                          dtype=jnp.float32)
        got, st = rec.rglru_step(p, torch.from_numpy(xt), st, dtype=F32)
        _close(got, want, msg=f"step {i}")
        _states_close(st, ref_st)


@pytest.mark.parametrize("chunk", [1, 8, 16, 64])
def test_mlstm_apply_matches_reference_and_sequential(chunk):
    """The chunkwise form at four chunk sizes over T = 64 against the
    reference's at the same chunk and against the sequential oracle (the
    port's and the reference's), then four decode steps."""
    ref_p, p = _mixer(ref_rec.mlstm_init, D, HEADS)
    x = _x((2, 64, D), chunk)
    want, ref_st = ref_rec.mlstm_apply(ref_p, jnp.asarray(x), HEADS,
                                       dtype=jnp.float32, chunk=chunk)
    got, st = rec.mlstm_apply(p, torch.from_numpy(x), HEADS, dtype=F32,
                              chunk=chunk)
    _close(got, want)
    _states_close(st, ref_st)
    seq = ref_rec.mlstm_seq_ref(ref_p, jnp.asarray(x), HEADS,
                                dtype=jnp.float32)
    _close(got, seq)
    _close(rec.mlstm_seq_ref(p, torch.from_numpy(x), HEADS, dtype=F32), seq)
    for i in range(4):
        xt = _x((2, D), 20 + i)
        want, ref_st = ref_rec.mlstm_step(ref_p, jnp.asarray(xt), ref_st,
                                          HEADS, dtype=jnp.float32)
        got, st = rec.mlstm_step(p, torch.from_numpy(xt), st, HEADS,
                                 dtype=F32)
        _close(got, want, msg=f"step {i}")
        _states_close(st, ref_st)


def test_slstm_apply_and_step_match_reference():
    ref_p, p = _mixer(ref_rec.slstm_init, D, HEADS)
    x = _x((2, 29, D), 3)
    want, ref_st = ref_rec.slstm_apply(ref_p, jnp.asarray(x), HEADS,
                                       dtype=jnp.float32)
    got, st = rec.slstm_apply(p, torch.from_numpy(x), HEADS, dtype=F32)
    _close(got, want)
    _states_close(st, ref_st)
    for i in range(5):
        xt = _x((2, D), 30 + i)
        want, ref_st = ref_rec.slstm_step(ref_p, jnp.asarray(xt), ref_st,
                                          HEADS, dtype=jnp.float32)
        got, st = rec.slstm_step(p, torch.from_numpy(xt), st, HEADS,
                                 dtype=F32)
        _close(got, want, msg=f"step {i}")
        _states_close(st, ref_st)


def test_mlstm_length_contract_matches_reference():
    """A length that is not a multiple of the chunk raises the reference's
    ``ValueError``, in the mixer and in a whole-prompt prefill (chunk
    ``min(128, T)``: 200 tokens); the port pads nothing."""
    ref_p, p = _mixer(ref_rec.mlstm_init, D, HEADS)
    x = _x((1, 200, D), 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref_rec.mlstm_apply(ref_p, jnp.asarray(x), HEADS, dtype=jnp.float32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        rec.mlstm_apply(p, torch.from_numpy(x), HEADS, dtype=F32)
    cfg = smoke_variant(get("xlstm-350m"))
    toks = torch.zeros((1, 200), dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        M.prefill(M.init_params(cfg, 0, "cpu"), cfg, toks)


# -- the models ---------------------------------------------------------------

# recurrentgemma at 2 units + 2 tail RG-LRU layers, xlstm at 2 units + a
# tail sLSTM layer
DEPTHS = {"recurrentgemma-2b": 8, "xlstm-350m": 5}


def _cfgs(arch, **kw):
    kw = dict(n_layers=DEPTHS[arch], **kw)
    return (dataclasses.replace(smoke_variant(get(arch)), **kw),
            dataclasses.replace(ref_smoke(ref_get(arch)), **kw))


@pytest.fixture(scope="module", params=sorted(DEPTHS))
def model(request):
    """(cfg, ref cfg, ref params, port params) at a depth with a tail."""
    cfg, ref_cfg = _cfgs(request.param)
    tree = _randomized(_np(RM.init_params(jax.random.PRNGKey(0), ref_cfg)),
                       np.random.default_rng(5))
    return (cfg, ref_cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tree, cfg, "cpu"))


def _shapes(t):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in t.items()}


def test_param_and_cache_trees_match_reference(model):
    cfg, ref_cfg, ref_params, params = model
    assert _shapes(M.init_params(cfg, 0, "cpu")) == _shapes(params) == \
        _shapes(ref_params)
    assert len(params["tail"]) == cfg.n_layers % cfg.unit > 0
    cache = M.init_cache(cfg, 3, 64, F32, "cpu", per_slot=True)
    ref_cache = RM.init_cache(ref_cfg, 3, 64, dtype=jnp.float32,
                              per_slot=True)
    assert _shapes(cache) == _shapes(ref_cache)
    for a, b in zip(jax.tree_util.tree_leaves(_np(ref_cache)),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda t: t.numpy(), cache))):
        np.testing.assert_array_equal(a, b)     # zeros, m at -1e30
    lam = M.init_params(cfg, 3, "cpu")["units"]["pos0"].get("rglru", {}).get(
        "lam")
    if lam is not None:                         # lam ~ U(2, 6)
        assert 2.0 <= float(lam.min()) and float(lam.max()) < 6.0


def _run_model(ref_params, ref_cfg, params, cfg, toks, n_steps):
    want, ref_cache = RM.prefill(ref_params, ref_cfg, jnp.asarray(toks),
                                 max_len=96)
    got, cache = M.prefill(params, cfg, torch.from_numpy(toks), max_len=96)
    _close(got, want, LOGIT_ATOL, "prefill")
    last = np.asarray(jnp.argmax(want[:, -1], axis=-1))
    for i in range(n_steps):
        tok = last.astype(np.int32)[:, None]
        want, ref_cache = RM.decode_step(ref_params, ref_cfg,
                                         jnp.asarray(tok), ref_cache)
        got, cache = M.decode_step(params, cfg,
                                   torch.from_numpy(tok).long(), cache)
        _close(got, want, LOGIT_ATOL, f"step {i}")
        last = np.asarray(jnp.argmax(want[:, -1], axis=-1))
        assert got[:, -1].argmax(-1).tolist() == last.tolist()
    return cache, ref_cache


@pytest.mark.parametrize("T", [20, 45, 128])
def test_prefill_and_decode_match_reference(model, T):
    """Prefill logits and 8 decode steps; T = 45 passes recurrentgemma's
    window of 32 at prefill (``local_attention``, a rolled ring) and 128
    runs xlstm's mLSTM as one 128-token chunk.  The final caches (rings,
    every unit's and tail layer's recurrent state) agree too."""
    cfg, ref_cfg, ref_params, params = model
    toks = np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T))
    cache, ref_cache = _run_model(ref_params, ref_cfg, params, cfg, toks, 8)
    ref_cache = _np(ref_cache)
    for section, key, kind in M.cache_groups(cfg):
        for name, leaf in cache[section][key].items():
            _close(leaf, ref_cache[section][key][name], LOGIT_ATOL,
                   f"{section}/{key}/{name}")


# -- ECF8 -----------------------------------------------------------------------

def _containers(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _containers(v, path + (k,))
    elif hasattr(tree, "arrays"):
        yield path, tree


def test_containers_bit_equal_to_reference(model):
    """Every stacked and tail leaf, the recurrent matrices, ``conv_w`` and
    sLSTM's 3-D ``r`` among them, compresses into the reference's bytes."""
    cfg, _, ref_params, params = model
    ref_c, ref_rep = ref_store.compress_tree(ref_params, min_elems=MIN_ELEMS,
                                             out_dtype="float32")
    got_c, rep = store.compress_tree(params, min_elems=MIN_ELEMS,
                                     out_dtype="float32")
    assert rep == ref_rep
    ref_map, mine = dict(_containers(ref_c)), dict(_containers(got_c))
    assert sorted(mine) == sorted(ref_map)
    names = {p[-1] for p in mine}
    assert any(p[0] == "tail" for p in mine)
    assert names >= ({"w_a", "conv_w", "w_out"} if "rglru" in cfg.pattern
                     else {"r", "w_q", "w_if", "w_down"})
    for path, ct in mine.items():
        ref = ref_map[path]
        assert ct.meta.shape == tuple(ref.meta.shape), path
        for name, a in ct.arrays.items():
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(ref.arrays[name]),
                                          err_msg=f"{path}/{name}")


@pytest.mark.parametrize("arch", sorted(DEPTHS))
def test_streamed_build_equals_casting_the_masters(arch):
    """``store.build_trees`` streams the unit leaves a unit at a time and
    the tail leaves unstacked: bit-equal to compressing and casting the f32
    masters of ``init_params``."""
    cfg, _ = _cfgs(arch)
    tree, base, report = store.build_trees(
        lambda leaf: M.init_params(cfg, 5, "cpu", leaf=leaf),
        min_elems=MIN_ELEMS, out_dtype="float32")
    masters = M.init_params(cfg, 5, "cpu")
    want, want_rep = store.compress_tree(masters, min_elems=MIN_ELEMS,
                                         out_dtype="float32")
    assert report == want_rep
    got_c, want_c = dict(_containers(tree)), dict(_containers(want))
    assert sorted(got_c) == sorted(want_c)
    assert any(p[0] == "tail" for p in got_c)
    for path, ct in got_c.items():
        for name, a in ct.arrays.items():
            assert torch.equal(a, want_c[path].arrays[name]), (path, name)
    want_base = store.fp8_cast_tree(masters, min_elems=MIN_ELEMS)
    got_b, want_b = dict(_flat(base)), dict(_flat(want_base))
    assert sorted(got_b) == sorted(want_b)
    for path, a in got_b.items():
        b = want_b[path]
        assert a.dtype == b.dtype, path
        if a.element_size() == 1:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        assert torch.equal(a, b), path


def _flat(t, path=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, t


def test_ecf8_tree_matches_reference_fp8_tree(model):
    """The port on its ECF8 tree (every recurrent matrix selected) against
    the reference on the fp8 tree, prefill and 6 decode steps; the port's
    ECF8 logits are bit-equal to its own fp8 tree's."""
    cfg, ref_cfg, ref_params, params = model
    ref_fp8 = ref_store.fp8_cast_tree(ref_params, min_elems=MIN_ELEMS)
    ecf8, _ = store.compress_tree(params, min_elems=MIN_ELEMS,
                                  out_dtype="float32")
    fp8 = store.fp8_cast_tree(params, min_elems=MIN_ELEMS)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 40))
    cache, _ = _run_model(ref_fp8, ref_cfg, ecf8, cfg, toks, 6)
    # the same run on the fp8 tree, bit for bit
    a, ca = M.prefill(ecf8, cfg, torch.from_numpy(toks), max_len=96)
    b, cb = M.prefill(fp8, cfg, torch.from_numpy(toks), max_len=96)
    assert torch.equal(a, b)
    tok = a[:, -1].argmax(-1, keepdim=True)
    for _ in range(3):
        a, ca = M.decode_step(ecf8, cfg, tok, ca)
        b, cb = M.decode_step(fp8, cfg, tok, cb)
        assert torch.equal(a, b)
        tok = a[:, -1].argmax(-1, keepdim=True)


# -- the engine ---------------------------------------------------------------

def _requests(Req, lens, max_new, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [Req(prompt=rng.integers(1, vocab, n).tolist(),
                max_new_tokens=m, id=48_000 + i)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.fixture
def pallas_store(monkeypatch):
    """The reference engine's fault decodes through its Pallas page kernel,
    which writes with ``pl.store`` (dropped by newer JAX releases)."""
    if not hasattr(pl, "store"):
        def pl_store(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", pl_store, raising=False)


def test_recurrentgemma_monolithic_engine_matches_reference():
    """recurrentgemma (2 units + 2 tail layers) resolves to the monolithic
    cache as the reference does; prompts of 5-45 tokens (two past the
    window of 32 at prefill) and decodes that wrap the rings give the
    reference engine's greedy tokens in as many steps."""
    cfg, ref_cfg = _cfgs("recurrentgemma-2b")
    tree = _randomized(_np(RM.init_params(jax.random.PRNGKey(1), ref_cfg)),
                       np.random.default_rng(6))
    params = convert.params_from_numpy(tree, cfg, "cpu")
    lens, new = (45, 12, 33, 5, 28), (16, 24, 12, 20, 30)
    kw = dict(max_batch=3, max_len=64)
    ref_eng = RefEngine(jax.tree_util.tree_map(jnp.asarray, tree), ref_cfg,
                        config=RefEngineConfig(**kw))
    eng = GenerationEngine(params, cfg, config=EngineConfig(**kw),
                           device="cpu")
    assert eng.cache_mode == ref_eng.cache_mode == "monolithic"
    want = _drain(ref_eng, _requests(RefRequest, lens, new, 3))
    assert _drain(eng, _requests(Request, lens, new, 3)) == want
    assert eng.steps == ref_eng.steps


def test_xlstm_engine_slot_reuse_and_occupancy():
    """tests/test_serving.py's slot-reuse test on the port: five one-token
    prompts through two slots of the monolithic cache, each slot's
    recurrent state replaced at admission; the tokens are the reference
    engine's."""
    cfg, ref_cfg = smoke_variant(get("xlstm-350m")), ref_smoke(
        ref_get("xlstm-350m"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(_np(ref_params), cfg, "cpu")
    kw = dict(max_batch=2, max_len=32)
    eng = GenerationEngine(params, cfg, config=EngineConfig(**kw),
                           device="cpu")
    reqs = [Request(prompt=[i + 1], max_new_tokens=3) for i in range(5)]
    got = _drain(eng, reqs)
    assert all(len(t) == 3 for t in got)
    # 5 requests x 3 tokens across batch-2 decode steps: slots were reused
    assert eng.steps < 15
    ref_eng = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(**kw))
    assert _drain(ref_eng, [RefRequest(prompt=[i + 1], max_new_tokens=3)
                            for i in range(5)]) == got


# a recurrent hybrid that pages: ("rglru", "attn") units and a tail RG-LRU
HYBRID = dict(name="rglru-attn-hybrid", pattern=("rglru", "attn"),
              n_layers=5)
_WORK = [(40, 16), (12, 24), (33, 12), (25, 20), (5, 14)]


def test_paged_hybrid_with_tail_preempts_and_matches_reference(
        pallas_store, monkeypatch):
    """The hybrid on the paged cache (pools for the 'attn' layers, RG-LRU
    states beside them in the units and the tail) with a pool too small for
    both slots and a swap tier: preempted slots resume with their recurrent
    states reinstalled bit for bit, and the tokens equal the reference
    engine's under the same pressure and the port's unpreempted run."""
    cfg = dataclasses.replace(smoke_variant(get("recurrentgemma-2b")),
                              **HYBRID)
    ref_cfg = dataclasses.replace(ref_smoke(ref_get("recurrentgemma-2b")),
                                  **HYBRID)
    tree = _randomized(_np(RM.init_params(jax.random.PRNGKey(2), ref_cfg)),
                       np.random.default_rng(8))
    params = convert.params_from_numpy(tree, cfg, "cpu")
    lens, new = zip(*_WORK)
    kw = dict(max_batch=2, max_len=64, page_size=8, n_pages=9,
              swap_bytes=1 << 28)
    ref_eng = RefEngine(jax.tree_util.tree_map(jnp.asarray, tree), ref_cfg,
                        config=RefEngineConfig(**kw))
    want = _drain(ref_eng, _requests(RefRequest, lens, new, 4))
    eng = GenerationEngine(params, cfg, config=EngineConfig(**kw),
                           device="cpu")
    assert eng.cache_mode == "paged"
    reinstalled = []
    resume = eng._resume

    def spy(slot, st):
        resume(slot, st)
        assert sorted(st.state) == sorted(
            (key, n) for key in ("pos0", "layer0") for n in ("h", "conv"))
        for (key, n), host in st.state.items():
            sec = "units" if key.startswith("pos") else "tail"
            leaf = eng.cache[sec][key][n]
            row = leaf.select(1 if sec == "units" else 0, slot)
            assert torch.equal(row, host), (key, n)
        reinstalled.append(slot)

    monkeypatch.setattr(eng, "_resume", spy)
    got = _drain(eng, _requests(Request, lens, new, 4))
    assert got == want
    assert eng.scheduler.counters() == ref_eng.scheduler.counters()
    assert eng.scheduler.n_preempted > 0 and len(reinstalled) == \
        eng.scheduler.n_resumed > 0
    free = GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=2, max_len=64, page_size=8), device="cpu")
    assert _drain(free, _requests(Request, lens, new, 4)) == got
    assert free.scheduler.n_preempted == 0


def test_xlstm_draft_matches_reference_every_round():
    """tests/test_speculative.py's recurrent draft: xlstm's smoke stack
    (here with a tail sLSTM layer) beside the qwen3 target.  Its states
    cannot be rolled back by a timeline: after every round each active
    slot's sLSTM and mLSTM states equal the reference engine's, which
    re-splices whole draft rows, and the greedy tokens equal target-only
    decoding.  States are held within the whole model's 1e-4: each is a
    function of every earlier token through every earlier layer."""
    cfg, ref_cfg = smoke_variant(get("qwen3-8b")), ref_smoke(
        ref_get("qwen3-8b"))
    ref_p = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = convert.params_from_numpy(_np(ref_p), cfg, "cpu")
    dcfg, ref_dcfg = _cfgs("xlstm-350m")
    ref_d = RM.init_params(jax.random.PRNGKey(1), ref_dcfg)
    d = convert.params_from_numpy(_np(ref_d), dcfg, "cpu")
    prompts = [r.prompt for r in _requests(Request, (4, 9, 30, 17),
                                           (0,) * 4, 7)]
    got, want, eng = _lockstep_draft_states(
        cfg, ref_cfg, p, ref_p, dcfg, ref_dcfg, d, ref_d, prompts, 12, 64,
        atol=LOGIT_ATOL)
    assert got == want == _target_only(p, cfg, prompts, 12, 64)
    assert eng.n_draft_state_rollbacks > 0 and eng.n_draft_ring_wraps == 0
