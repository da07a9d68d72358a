"""The port's mixture-of-experts family against the JAX package:
``models/moe.py`` (routing, per-expert capacity with its drops, ties, the
combine), the MoE leaves of the compressed store, the architectures
``EngineConfig.validate`` admits, the streamed weight build of
``launch/serve.py``, and the serving engine on moonshot-v1-16b-a3b's smoke
variant (64 -> 8 experts, top-6 -> top-2, one shared expert).  The model's
prefill and decode logits are held in tests/test_torch_mlp.py.

Layer outputs are f32 and held within 1e-5 of the reference's, the
selections (experts a token, tokens an expert) exactly; greedy tokens,
container bytes and the streamed trees exactly."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import EngineConfigError as RefEngineConfigError  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.configs.registry import names  # noqa: E402
from repro_torch.serving import EngineConfig, EngineConfigError, \
    GenerationEngine, Request  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
MOE_ATOL = 1e-5


@pytest.fixture
def pallas_store(monkeypatch):
    """The reference's swap faults decode through its Pallas page kernel,
    which writes with ``pl.store`` (dropped by newer JAX releases)."""
    if not hasattr(pl, "store"):
        def store_(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", store_, raising=False)


def _cfgs(**kw):
    return (replace(smoke_variant(get(ARCH)), **kw),
            replace(ref_smoke(ref_get(ARCH)), **kw))


def _layer_params(cfg, seed=0):
    """The reference's ``moe_init`` leaves, as numpy and as tensors."""
    ref_p = ref_moe.moe_init(jax.random.PRNGKey(seed), cfg.d_model,
                             cfg.n_experts, cfg.moe_d_ff,
                             cfg.n_shared_experts, cfg.moe_d_ff, cfg.top_k)
    return ref_p, jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), ref_p)


def _x(cfg, B=2, T=16, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, T, cfg.d_model)).astype(np.float32) * 0.5


def _drops(w_te, cap):
    """Tokens the capacity turned away: routed entries beyond ``cap`` an
    expert."""
    load = (np.asarray(w_te) > 0).sum(axis=0)
    return int(np.maximum(load - cap, 0).sum())


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_matches_reference(cf, n_shared):
    cfg, ref_cfg = _cfgs(capacity_factor=cf, n_shared_experts=n_shared)
    ref_p, p = _layer_params(cfg)
    x = _x(cfg)
    want, want_aux = ref_moe.moe_apply(ref_p, jnp.asarray(x), ref_cfg,
                                       dtype=jnp.float32)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg,
                             dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MOE_ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert ("shared" in p) == bool(n_shared)
    # the routing itself: the same experts a token, the same tokens an
    # expert, and (at 1.25) tokens turned away by the capacity
    T = x.shape[0] * x.shape[1]
    cap = max(8, int((T * cfg.top_k * cf) / cfg.n_experts + 0.999))
    xt = x.reshape(T, -1)
    r_buf, r_idx, r_w, _ = ref_moe._route_local(
        jnp.asarray(xt), ref_p["gate"], cfg.top_k, cfg.n_experts, cap)
    buf, idx, w, _ = moe._route_local(torch.from_numpy(xt), p["gate"],
                                      cfg.top_k, cfg.n_experts, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(r_w), atol=1e-6)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(r_buf))
    logits = xt @ np.asarray(ref_p["gate"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    w_te = np.zeros_like(logits)
    np.put_along_axis(w_te, top, 1.0, axis=-1)
    assert (_drops(w_te, cap) > 0) == (cf == 1.25)


def test_ties_break_to_the_lower_index_like_reference():
    """Duplicated token rows and two identical gate columns: the routing
    ties for the second expert of every token and for every capacity place
    of an expert, and the port picks what ``jax.lax.top_k`` picks."""
    cfg, ref_cfg = _cfgs(capacity_factor=1.25, n_shared_experts=0)
    ref_p, p = _layer_params(cfg)
    d, E = cfg.d_model, cfg.n_experts
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(4, d)).astype(np.float32) * 0.3
    rows[:, 0] = 1.0 + np.abs(rows[:, 0])          # x . e0 > 0 on every row
    xt = np.repeat(rows, 4, axis=0)[rng.permutation(16)]     # 16 tokens
    gate = rng.normal(size=(d, E)).astype(np.float32) * 1e-3
    gate[:, 0] = 0.0
    gate[0, 0] = 2.0                                # expert 0 first
    gate[:, 3] = gate[:, 5] = 0.0
    gate[0, 3] = gate[0, 5] = 1.0                   # 3 and 5 tie for second
    ref_p = dict(ref_p, gate=jnp.asarray(gate))
    p = dict(p, gate=torch.from_numpy(gate))
    cap = 8                                         # 16 tokens on 2 experts
    got = moe._route_local(torch.from_numpy(xt), p["gate"], cfg.top_k, E,
                           cap)
    want = ref_moe._route_local(jnp.asarray(xt), ref_p["gate"], cfg.top_k,
                                E, cap)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # expert 3 takes its eight places among tied tokens, lowest first;
    # expert 5 none
    taken = got[1].numpy()[3][got[2].numpy()[3] > 0]
    assert len(taken) == cap and (got[2].numpy()[5] == 0).all()
    x = xt.reshape(2, 8, d)
    y_ref, _ = ref_moe.moe_apply(ref_p, jnp.asarray(x), ref_cfg,
                                 dtype=jnp.float32)
    y, _ = moe.moe_apply(p, torch.from_numpy(x), cfg, dtype=torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=MOE_ATOL)


def test_moe_matches_dense_reference():
    """tests/test_models.py::test_moe_matches_dense_reference on the port:
    at a capacity nothing exceeds, the layer is each token's top-k experts
    weighted by their renormalised probabilities."""
    cfg, _ = _cfgs(capacity_factor=100.0, n_shared_experts=0)
    _, p = _layer_params(cfg)
    x = torch.from_numpy(_x(cfg, B=2, T=9, seed=5) * 0.6)
    y, aux = moe.moe_apply(p, x, cfg, dtype=torch.float32)
    probs = torch.softmax(x @ p["gate"], -1)
    tp, ti = torch.topk(probs, cfg.top_k)
    tp = tp / tp.sum(-1, keepdim=True)

    def expert(e, xt):
        g = xt @ p["wi_gate"][e]
        u = xt @ p["wi_up"][e]
        return (torch.nn.functional.silu(g) * u) @ p["wo"][e]

    ref = torch.zeros_like(x)
    for b in range(2):
        for t in range(9):
            ref[b, t] = sum(tp[b, t, j] * expert(int(ti[b, t, j]), x[b, t])
                            for j in range(cfg.top_k))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-4)
    assert np.isfinite(float(aux))


def test_combine_adds_in_ascending_expert_order():
    """In bf16 the order of the adds shows: the port's combine equals a
    sequential scatter over the flattened (E, C) entries, each add rounded,
    on inputs where another order rounds differently."""
    g = torch.Generator().manual_seed(0)
    E, C, T, d, k = 6, 5, 7, 16, 3
    y = (torch.randn((E, C, d), generator=g) * 10).to(torch.bfloat16)
    w = torch.rand((E, C), generator=g)
    idx = torch.stack([torch.randperm(T, generator=g)[:C] for _ in range(E)])
    # at most k entries a token: drop the rest to weight 0
    seen = {}
    for e in range(E):
        for c in range(C):
            t = int(idx[e, c])
            seen[t] = seen.get(t, 0) + 1
            if seen[t] > k:
                w[e, c] = 0.0
    w[0, -1] = 0.0
    idx[0, -1] = 0                   # a padded entry: index 0, weight 0
    want = torch.zeros((T, d), dtype=torch.bfloat16)
    contrib = y * w.to(torch.bfloat16)[..., None]
    for e in range(E):
        for c in range(C):
            want[idx[e, c]] = want[idx[e, c]] + contrib[e, c]
    got = moe._combine(y, idx, w, T, k)
    assert torch.equal(got, want)
    rev = torch.zeros((T, d), dtype=torch.bfloat16)
    for e in reversed(range(E)):
        for c in range(C):
            rev[idx[e, c]] = rev[idx[e, c]] + contrib[e, c]
    assert not torch.equal(rev, want)       # the order is observable


# --------------------------------------------------------------------------
# the model and the store
# --------------------------------------------------------------------------

# the ('attn',) stacks (every MLP type and the MoE), gemma2's ('local',
# 'attn') stack with post-norms and the recurrent families
SERVED = {"qwen3-8b", "granite-20b", "phi3-medium-14b", "nemotron-4-15b",
          "chameleon-34b", "gemma2-9b", "recurrentgemma-2b", "xlstm-350m",
          "llama4-scout-17b-a16e", ARCH}


@pytest.mark.parametrize("arch", names())
def test_engine_config_serves_the_moe_and_mlp_families(arch):
    """``validate`` (and through it ``convert`` and ``launch/serve.py``)
    admits the MoE family, every dense MLP type, gemma2's and llama4's
    stacks and the recurrent families, resolving as the reference does (a
    stack with rings or recurrent states cannot chunk its prefill, so
    strict mode refuses ``prefill_chunk`` in both; lenient mode resolves
    the cache alike); the encoder-decoder, whose model functions the port
    runs, is refused by the engine, as the reference's engine cannot serve
    it either."""
    cfg = smoke_variant(get(arch))
    if arch not in SERVED:
        assert cfg.encoder_decoder
        with pytest.raises(EngineConfigError, match="encoder-decoder"):
            EngineConfig().validate(cfg)
        return
    ref_cfg = ref_smoke(ref_get(arch))
    if set(ref_cfg.pattern) - {"attn"}:
        with pytest.raises(RefEngineConfigError, match="prefill_chunk"):
            RefEngineConfig(prefill_chunk=8).validate(ref_cfg, strict=True)
        with pytest.raises(EngineConfigError, match="prefill_chunk"):
            EngineConfig(prefill_chunk=8).validate(cfg, strict=True)
        with pytest.warns(UserWarning, match="prefill_chunk"):
            got = EngineConfig(prefill_chunk=8).validate(cfg)
        with pytest.warns(UserWarning, match="prefill_chunk"):
            want = RefEngineConfig(prefill_chunk=8).validate(ref_cfg)
    else:
        want = RefEngineConfig(prefill_chunk=8).validate(ref_cfg,
                                                         strict=True)
        got = EngineConfig(prefill_chunk=8).validate(cfg, strict=True)
    assert (got.cache_mode, got.prefill_chunk) == (want.cache_mode,
                                                   want.prefill_chunk)


@pytest.fixture(scope="module")
def moe_model():
    cfg, ref_cfg = _cfgs(capacity_factor=1.25)
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


def test_init_params_lays_out_the_reference_tree(moe_model):
    cfg, _, ref_params, params = moe_model
    mine = M.init_params(cfg, 0, device="cpu")

    def shapes(t):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), t)

    assert shapes(mine) == shapes(params) == shapes(
        jax.tree_util.tree_map(np.asarray, ref_params))
    assert shapes(mine)["units"]["pos0"]["moe"]["wi_gate"] == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert "mlp" not in mine["units"]["pos0"]


def test_vacated_sentinel_row_writes_the_garbage_page_like_reference(
        moe_model):
    """A preempted slot's row holds swap sentinels; the batched decode step
    still computes it.  Its K/V lands on the garbage page, as the
    reference's clamped table writes it, so the rows that later attend
    over that page (vacated slots, routed with the live rows by the MoE
    layer) see the reference's values."""
    from repro.kvcache import paged as ref_paged
    from repro.kvcache import swap as ref_swap
    from repro_torch.kvcache import paged, swap
    cfg, ref_cfg, ref_params, params = moe_model
    ref_pc = ref_paged.PagedKVCache(ref_cfg, 2, 32, dtype=jnp.float32,
                                    page_size=4, n_pages=6)
    pc = paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                            page_size=4, n_pages=6)
    ref_pc.attach_swap(ref_swap.SwapStore())
    pc.attach_swap(swap.SwapStore())
    ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
    for slot, p in ((1, [5, 6, 7, 8, 9]), (0, [11, 12, 13])):
        _, frag = RM.prefill(ref_params, ref_cfg, jnp.asarray(p)[None],
                             max_len=32)
        _, frag_t = M.prefill(params, cfg, torch.tensor(p)[None], max_len=32)
        ref_cache = ref_pc.admit(ref_cache, slot, frag, len(p))
        cache = pc.admit(cache, slot, frag_t, len(p))
        if slot == 1:                       # preempted: row -> sentinels
            ref_cache = ref_pc.evict(ref_cache, 1)
            cache = pc.evict(cache, 1)
    assert (cache["page_table"][1, :2] < 0).all()
    ref_cache = ref_pc.ensure(ref_cache, 0, 3)
    cache = pc.ensure(cache, 0, 3)
    tok = np.array([[3], [4]], np.int32)
    _, ref_cache = RM.decode_step(ref_params, ref_cfg, jnp.asarray(tok),
                                  ref_cache)
    _, cache = M.decode_step(params, cfg, torch.from_numpy(tok).long(),
                             cache)
    for kn in ("k", "v"):
        got = cache["units"]["pos0"][f"{kn}_pool"]
        want = np.asarray(ref_cache["units"]["pos0"][f"{kn}_pool"])
        # slot 1 wrote at its position 5: offset 1 of the garbage page
        assert np.abs(want[:, 0, :, 1]).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=kn)


def test_compress_tree_moe_leaves_match_reference(moe_model):
    """The per-layer 3-D expert containers (one codebook a layer) are the
    reference's bytes, and each layer materialises to its fp8 values in
    the expert shape."""
    cfg, _, ref_params, params = moe_model
    ref_c, ref_report = ref_store.compress_tree(ref_params, min_elems=4096,
                                                out_dtype="float32")
    got_c, report = store.compress_tree(params, min_elems=4096,
                                        out_dtype="float32")
    assert report == ref_report
    ref_moe_c = ref_c["units"]["pos0"]["moe"]
    got_moe = got_c["units"]["pos0"]["moe"]
    names = ("wi_gate", "wi_up", "wo", "shared/wi_gate", "shared/wi_up",
             "shared/wo")
    for name in names:
        ref_leaf, leaf = ref_moe_c, got_moe
        for part in name.split("/"):
            ref_leaf, leaf = ref_leaf[part], leaf[part]
        assert store.is_compressed(leaf), name
        for arr_name, arr in ref_leaf.arrays.items():
            np.testing.assert_array_equal(leaf.arrays[arr_name].numpy(),
                                          np.asarray(arr),
                                          err_msg=f"{name}/{arr_name}")
        for i in range(cfg.n_layers):
            want = ref_store.materialize(
                jax.tree_util.tree_map(lambda a: a[i], ref_leaf),
                jnp.float32)
            got = store.materialize(leaf.layer(i), torch.float32)
            assert tuple(got.shape) == tuple(want.shape) == tuple(
                leaf.shape), name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the router (8 experts x 64) stays below the smoke threshold, as in
    # the reference
    assert not store.is_compressed(got_moe["gate"])
    assert not ref_store.is_compressed(ref_moe_c["gate"])


@pytest.mark.parametrize("arch", [ARCH, "qwen3-8b", "granite-20b"])
@pytest.mark.parametrize("fmt", ["tpu", "none"])
def test_streamed_build_equals_init_then_cast(arch, fmt):
    """``build_params`` streams each stacked leaf a layer at a time; its
    trees are bit-equal to casting and compressing ``init_params``'s f32
    masters, report included."""
    cfg = smoke_variant(get(arch))
    served, base, report, _ = serve.build_params(cfg, 7, fmt, device="cpu")
    params = M.init_params(cfg, 7, device="cpu")
    want_base = store.fp8_cast_tree(params, min_elems=serve.MIN_ELEMS)
    flat = jax.tree_util.tree_leaves_with_path
    got_l = flat(base, is_leaf=torch.is_tensor)
    want_l = flat(want_base, is_leaf=torch.is_tensor)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b), path
    if fmt == "none":
        assert served is base and report is None
        return
    want_c, want_report = store.compress_tree(
        params, min_elems=serve.MIN_ELEMS, out_dtype=cfg.dtype)
    assert report == want_report
    got_c = flat(served, is_leaf=store.is_compressed)
    want_cl = flat(want_c, is_leaf=store.is_compressed)
    assert [p for p, _ in got_c] == [p for p, _ in want_cl]
    for (path, a), (_, b) in zip(got_c, want_cl):
        if store.is_compressed(b):
            assert a.meta == b.meta, path
            for name in b.arrays:
                assert torch.equal(a.arrays[name], b.arrays[name]), path
        else:
            assert torch.equal(a, b), path


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _work(Req, n, seed, lo=4, hi=30):
    rng = np.random.default_rng(seed)
    return [Req(prompt=rng.integers(1, 512, int(rng.integers(lo, hi)))
                .tolist(), max_new_tokens=3 + i % 6, id=50_000 + i)
            for i in range(n)]


# name -> (requests, seed, engine settings); "batch12" runs 16 requests on
# 12 slots at capacity factor 1.25: a decode step routes 12 rows, live and
# vacated slots' alike, against 8 places an expert
_ENGINE = {
    "paged": (6, 0, dict(max_batch=3, max_len=64)),
    "chunked": (6, 1, dict(max_batch=3, max_len=64, prefill_chunk=8)),
    "monolithic": (6, 0, dict(max_batch=3, max_len=64,
                              cache_mode="monolithic")),
    "speculative": (4, 2, dict(max_batch=3, max_len=64, spec_k=2)),
    "prefix": (6, 3, dict(max_batch=3, max_len=64, page_size=8,
                          prefill_chunk=8, prefix_sharing=True)),
    "swap": (6, 5, dict(max_batch=2, max_len=48, page_size=8, n_pages=5,
                        compress_cold=True, n_cold_slots=1,
                        swap_bytes=1 << 28)),
    "batch12": (16, 4, dict(max_batch=12, max_len=64)),
}


def _engine_run(Eng, Cfg, Req, params, cfg, name, draft=None, box=None):
    n, seed, kw = _ENGINE[name]
    reqs = _work(Req, n, seed)
    if name == "prefix":
        system = list(range(1, 17))
        for r in reqs:
            r.prompt = system + r.prompt[:6]
    if draft is not None:
        kw = dict(kw, draft_cfg=cfg, draft_params=draft)
    eng_kw = {"device": "cpu"} if Eng is GenerationEngine else {}
    eng = Eng(params, cfg, config=Cfg(**kw), **eng_kw)
    if box is not None:
        box.append(eng)
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("name", list(_ENGINE))
def test_engine_tokens_match_reference(moe_model, name, monkeypatch,
                                      pallas_store):
    cfg, ref_cfg, ref_params, params = moe_model
    ref_d = params_d = None
    if name == "speculative":
        ref_d = RM.init_params(jax.random.PRNGKey(1), ref_cfg)
        params_d = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, ref_d), cfg, "cpu")
    box, routed = [], []
    route = moe._route_local

    def counting(x, gate_w, top_k, n_experts, capacity):
        w_te = torch.zeros((x.shape[0], n_experts))
        w_te.scatter_(1, torch.topk(x @ gate_w, top_k).indices, 1.0)
        vacated = sum(r is None for r in box[0].slots)
        routed.append((x.shape[0], _drops(w_te.numpy(), capacity), vacated))
        return route(x, gate_w, top_k, n_experts, capacity)

    monkeypatch.setattr(moe, "_route_local", counting)
    got, eng = _engine_run(GenerationEngine, EngineConfig, Request, params,
                           cfg, name, params_d, box)
    want, ref_eng = _engine_run(RefEngine, RefEngineConfig, RefRequest,
                                ref_params, ref_cfg, name, ref_d)
    assert got == want
    assert eng.steps == ref_eng.steps
    if name == "speculative":
        assert eng.spec_on and eng.spec_counters() == ref_eng.spec_counters()
    if name == "prefix":
        assert eng.paged.stats()["prefix_index_blocks"] > 0
        assert eng.n_chunk_tokens == ref_eng.n_chunk_tokens
    if name == "swap":
        assert eng.scheduler.counters() == ref_eng.scheduler.counters()
        assert eng.scheduler.n_preempted > 0 and eng.paged.n_compressed > 0
    if name == "batch12":
        # decode steps of 12 rows turned tokens away while slots stood
        # vacated: those slots' rows competed for the experts' places
        assert any(T == 12 and n > 0 and v > 0 for T, n, v in routed), \
            routed
