"""gemma2's stack in the port against the JAX package: sliding-window
attention, the plain flash forward at head_dim 256, the ("local", "attn")
unit-2 model (post-norms, softcaps, embedding scale, the local layers'
rings), its ECF8 containers, and its serving by the engine over the paged
cache (rings beside the pools, carried across preemption), the monolithic
cache and the swap tier.

The weights are the reference's own smoke weights converted with
``repro_torch.convert``, with random norm scales set in both trees (the
reference draws zeros, under which a swapped ``post_norm1`` /
``post_norm2`` would not show).  Logits and ring contents are f32 and held
within 1e-5 (the same operations in another summation order); tokens,
scheduler counters and containers are held exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.kvcache import paged as ref_paged  # noqa: E402
from repro.models import flash_attention as ref_fa  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import flash_attention as fa  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import EngineConfig, EngineConfigError, \
    GenerationEngine, Request  # noqa: E402

ATOL = 1e-5
ARCH = "gemma2-9b"


def _qkv(Hq, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(2, h, T, D)) * 0.5).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("T", [16, 32, 33, 100, 1030])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_local_attention_matches_reference(T, cap):
    """Window 32, GQA 4/2; T = 1030 crosses the 1024-row q chunk."""
    q, k, v = _qkv(4, 2, T, 16, seed=T)
    want = ref_layers.local_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=32,
                                      attn_softcap=cap)
    got = layers.local_attention(*map(torch.from_numpy, (q, k, v)),
                                 window=32, attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _local_attention_whole_only(q, k, v, *, window, attn_softcap=0.0,
                                q_chunk=1024):
    """``layers.local_attention`` as it was before it took ``q_base``
    (whole sequences only), kept to hold the new one's ``q_base=None``
    bit-identical to it."""
    B, Hq, Tq, D = q.shape
    q = fa.scale_in_dtype(q, D ** -0.5)
    C = min(q_chunk, Tq)
    n_q = -(-Tq // C)
    Tq_p = n_q * C
    if Tq_p != Tq:
        q = torch.nn.functional.pad(q, (0, 0, 0, Tq_p - Tq))
    W = min(window, k.shape[2])
    ctx = C + W
    k_pad = torch.nn.functional.pad(k, (0, 0, W, Tq_p - Tq))
    v_pad = torch.nn.functional.pad(v, (0, 0, W, Tq_p - Tq))
    outs = []
    for qi in range(n_q):
        q_blk = q[:, :, qi * C:(qi + 1) * C]
        k_blk = k_pad[:, :, qi * C:qi * C + ctx]
        v_blk = v_pad[:, :, qi * C:qi * C + ctx]
        s = fa._softcap(layers._gqa_scores(q_blk, k_blk).to(torch.float32),
                        attn_softcap)
        q_pos = qi * C + torch.arange(C)
        kv_pos = qi * C + torch.arange(ctx) - W
        mask = ((kv_pos[None, :] <= q_pos[:, None])
                & (kv_pos[None, :] > q_pos[:, None] - W)
                & (kv_pos[None, :] >= 0))
        s = torch.where(mask[None, None], s, -1e30)
        outs.append(layers._gqa_combine(torch.softmax(s, dim=-1), v_blk))
    out = torch.cat(outs, dim=2) if n_q > 1 else outs[0]
    return out[:, :, :Tq].to(v.dtype)


@pytest.mark.parametrize("T,dtype", [(33, torch.float32),
                                     (1030, torch.float32),
                                     (100, torch.bfloat16)])
def test_local_attention_without_q_base_is_bit_identical(T, dtype):
    """``q_base`` None (and 0) computes what the whole-sequence call
    computed before it took one: same chunks, padding and rounding
    points, so every serving path that calls it is unchanged."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(4, 2, T, 16, T))
    want = _local_attention_whole_only(q, k, v, window=32,
                                       attn_softcap=50.0)
    for q_base in (None, 0):
        got = layers.local_attention(q, k, v, window=32, attn_softcap=50.0,
                                     q_base=q_base)
        assert got.dtype == want.dtype and torch.equal(got, want), q_base


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_local_attention_q_base_shards_match_reference_vjp(cap):
    """Four 24-row shards of T = 96 (window 32, GQA 4 / 2), each from its
    ``q_base`` against the whole k / v (training's sequence split, k / v
    gathered over ``model``): each shard's output and q cotangent, and the
    k / v cotangents summed over the shards, against the reference's
    ``local_attention`` and ``jax.vjp`` over the whole sequence, within
    1e-5 of the largest magnitude (f32)."""
    T, n, W = 96, 4, 32
    q, k, v = _qkv(4, 2, T, 16, seed=96)
    do = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: ref_layers.local_attention(
        q, k, v, window=W, attn_softcap=cap), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (k, v))
    outs, dqs, t = [], [], T // n
    for i in range(n):
        rows = slice(i * t, (i + 1) * t)
        qs = torch.from_numpy(q[:, :, rows].copy()).requires_grad_(True)
        o = layers.local_attention(qs, tk, tv, window=W, attn_softcap=cap,
                                   q_base=i * t)
        o.backward(torch.from_numpy(do[:, :, rows].copy()))
        outs.append(o.detach())
        dqs.append(qs.grad)
    for name, got, w in (("o", torch.cat(outs, 2), want[0]),
                         ("dq", torch.cat(dqs, 2), want[1]),
                         ("dk", tk.grad, want[2]), ("dv", tv.grad, want[3])):
        err = float(np.abs(got.numpy() - w).max()) / float(np.abs(w).max())
        assert err <= ATOL, (name, err)


@pytest.mark.parametrize("T,causal,cap", [(37, True, 50.0), (64, True, 0.0),
                                          (45, False, 50.0)])
def test_plain_flash_head_dim_256_matches_reference(T, causal, cap):
    """The plain version of the flash kernel at gemma2's head_dim (GQA
    16/8), against the reference's ``flash_attention``."""
    q, k, v = _qkv(16, 8, T, 256, seed=1)
    q, k, v = (x[:1] for x in (q, k, v))
    want = ref_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, cap, 16, 16)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal, cap,
                             16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# -- the model ----------------------------------------------------------------

def _with_random_norms(tree, rng, path=()):
    """The tree with every norm scale redrawn (normal * 0.3, f32)."""
    if isinstance(tree, dict):
        return {k: _with_random_norms(v, rng, path + (k,))
                for k, v in tree.items()}
    if "norm" in path[-1]:
        return (rng.normal(size=tree.shape) * 0.3).astype(tree.dtype)
    return tree


@pytest.fixture(scope="module")
def gemma():
    cfg = smoke_variant(get(ARCH))
    ref_cfg = ref_smoke(ref_get(ARCH))
    tree = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(0), ref_cfg))
    tree = _with_random_norms(tree, np.random.default_rng(7))
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg, ref_cfg, ref_params, convert.params_from_numpy(tree, cfg,
                                                               "cpu")


def test_smoke_config_matches_reference():
    for port, ref in ((get(ARCH), ref_get(ARCH)),
                      (smoke_variant(get(ARCH)), ref_smoke(ref_get(ARCH)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    small = smoke_variant(get(ARCH))
    assert (small.local_window, small.hd, small.pattern, small.unit) == (
        32, 32, ("local", "attn"), 2)


def test_check_supported_admits_gemma2_and_refuses_the_rest():
    """gemma2 and, since the recurrent layers and the 'nope' kind were
    ported, recurrentgemma, xlstm and llama4-scout are served; the model
    functions admit the encoder-decoder (whisper) and the engine refuses
    it; a paged layer in the tail is still refused."""
    for arch in (ARCH, "recurrentgemma-2b", "xlstm-350m",
                 "llama4-scout-17b-a16e", "whisper-base"):
        M.check_supported(get(arch))
        M.check_supported(smoke_variant(get(arch)))
    with pytest.raises(EngineConfigError, match="encoder-decoder"):
        EngineConfig().validate(get("whisper-base"))
    for cfg in (dataclasses.replace(get(ARCH), pattern=("attn", "local"),
                                    n_layers=43),
                dataclasses.replace(get("llama4-scout-17b-a16e"),
                                    pattern=("nope", "local", "local",
                                             "local"), n_layers=45)):
        with pytest.raises(NotImplementedError):
            M.check_supported(cfg)


def test_param_tree_matches_reference(gemma):
    cfg, _, ref_params, params = gemma
    mine = M.init_params(cfg, 0, "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(mine) == shapes(ref_params) == shapes(params)
    assert list(mine["units"]) == ["pos0", "pos1"]
    assert mine["units"]["pos0"]["attn"]["wq"].shape[0] == cfg.n_layers // 2


@pytest.mark.parametrize("T", [20, 45])
def test_prefill_logits_and_rings_match_reference(gemma, T):
    """T = 20 fills less than the window of 32 (flash in every layer);
    T = 45 runs ``local_attention`` in the local layers and rolls their
    rings by T % W."""
    cfg, ref_cfg, ref_params, params = gemma
    toks = np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T))
    want, ref_cache = RM.prefill(ref_params, ref_cfg, jnp.asarray(toks),
                                 max_len=64)
    got, cache = M.prefill(params, cfg, torch.from_numpy(toks), max_len=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert cache["units"]["pos0"]["k"].shape[3] == 32       # the ring
    for pos in ("pos0", "pos1"):
        for kn in ("k", "v"):
            np.testing.assert_allclose(
                cache["units"][pos][kn].numpy(),
                np.asarray(ref_cache["units"][pos][kn]), atol=ATOL,
                err_msg=f"{pos}/{kn}")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_steps_across_the_ring_wrap(gemma, layout):
    """40 greedy decode steps past the window: logits within 1e-5 and the
    same tokens, on a prefill's contiguous cache (one timeline) and on the
    paged cache (two slots on their own timelines, rings beside pools)."""
    cfg, ref_cfg, ref_params, params = gemma
    rng = np.random.default_rng(3)
    if layout == "contiguous":
        toks = rng.integers(0, cfg.vocab_size, (2, 20))
        logits, ref_cache = RM.prefill(ref_params, ref_cfg,
                                       jnp.asarray(toks), max_len=64)
        _, cache = M.prefill(params, cfg, torch.from_numpy(toks), max_len=64)
        ref_pc = pc = None
        last = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
    else:
        ref_pc = ref_paged.PagedKVCache(ref_cfg, 2, 96, dtype=jnp.float32,
                                        page_size=8)
        pc = paged.PagedKVCache(cfg, 2, 96, dtype=torch.float32,
                                device="cpu", page_size=8)
        ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
        lens, last = [20, 45], []
        for slot, n in enumerate(lens):
            p = rng.integers(0, cfg.vocab_size, n)
            logits, frag = RM.prefill(ref_params, ref_cfg,
                                      jnp.asarray(p)[None], max_len=96)
            ref_cache = ref_pc.admit(ref_cache, slot, frag, n)
            _, frag_t = M.prefill(params, cfg, torch.from_numpy(p)[None],
                                  max_len=96)
            cache = pc.admit(cache, slot, frag_t, n)
            last.append(int(jnp.argmax(logits[0, -1])))
        last = np.asarray(last)
    for step in range(40):
        if pc is not None:
            for slot, n in enumerate(lens):
                ref_cache = ref_pc.ensure(ref_cache, slot, n + step)
                cache = pc.ensure(cache, slot, n + step)
        tok = last.astype(np.int32)[:, None]
        want, ref_cache = RM.decode_step(ref_params, ref_cfg,
                                         jnp.asarray(tok), ref_cache)
        got, cache = M.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"step {step}")
        last = np.asarray(jnp.argmax(want[:, -1], axis=-1))
        assert got[:, -1].argmax(-1).tolist() == last.tolist()
    for kn in ("k", "v"):
        np.testing.assert_allclose(cache["units"]["pos0"][kn].numpy(),
                                   np.asarray(ref_cache["units"]["pos0"][kn]),
                                   atol=ATOL)


# -- ECF8 containers ----------------------------------------------------------

def _containers(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _containers(v, path + (k,))
    elif hasattr(tree, "arrays"):
        yield path, tree


def test_containers_bit_equal_to_reference(gemma):
    """Every stacked gemma2 leaf (units/pos0 = local, pos1 = global, 2
    units each) compresses into the reference's container bytes."""
    _, _, ref_params, params = gemma
    ref_c, ref_rep = ref_store.compress_tree(ref_params, min_elems=4096,
                                             out_dtype="float32")
    got_c, rep = store.compress_tree(params, min_elems=4096,
                                     out_dtype="float32")
    assert rep == ref_rep
    ref_map = dict(_containers(ref_c))
    mine = dict(_containers(got_c))
    assert sorted(mine) == sorted(ref_map)
    assert {p[:2] for p in mine if p[0] == "units"} == {
        ("units", "pos0"), ("units", "pos1")}
    for path, ct in mine.items():
        ref = ref_map[path]
        assert ct.meta.shape == tuple(ref.meta.shape), path
        for name, a in ct.arrays.items():
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(ref.arrays[name]),
                                          err_msg=f"{path}/{name}")


def test_streamed_build_equals_casting_the_masters():
    cfg = smoke_variant(get(ARCH))
    tree, base, report = store.build_trees(
        lambda leaf: M.init_params(cfg, 5, "cpu", leaf=leaf),
        min_elems=4096, out_dtype="float32")
    masters = M.init_params(cfg, 5, "cpu")
    want, want_rep = store.compress_tree(masters, min_elems=4096,
                                         out_dtype="float32")
    assert report == want_rep
    want_base = store.fp8_cast_tree(masters, min_elems=4096)
    got_c, want_c = dict(_containers(tree)), dict(_containers(want))
    assert sorted(got_c) == sorted(want_c) and len(got_c) == 15
    for path, ct in got_c.items():
        for name, a in ct.arrays.items():
            assert torch.equal(a, want_c[path].arrays[name]), (path, name)

    def flat(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, path + (k,))
        else:
            yield path, t

    for (pa, a), (pb, b) in zip(flat(base), flat(want_base)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b), pa


# -- the paged cache's rings -------------------------------------------------

def test_slot_state_snapshot_and_restore_bit_exact(gemma):
    cfg, _, _, params = gemma
    pc = paged.PagedKVCache(cfg, 2, 64, dtype=torch.float32, device="cpu",
                            page_size=8)
    cache = pc.init_cache()
    rng = np.random.default_rng(11)
    for slot, n in enumerate((45, 13)):
        p = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))[None]
        _, frag = M.prefill(params, cfg, p, max_len=64)
        cache = pc.admit(cache, slot, frag, n)
    snap = pc.snapshot_slot_state(cache, 0)
    assert sorted(snap) == [("pos0", "k"), ("pos0", "v")]
    want = {kn: cache["units"]["pos0"][kn][:, 0].clone() for kn in "kv"}
    other = {kn: cache["units"]["pos0"][kn][:, 1].clone() for kn in "kv"}
    assert snap[("pos0", "k")].shape == (cfg.n_layers // 2, cfg.n_kv_heads,
                                         32, cfg.hd)
    assert not torch.equal(want["k"], torch.zeros_like(want["k"]))
    for kn in "kv":                         # another request overwrites
        cache["units"]["pos0"][kn][:, 0] = torch.randn_like(want[kn])
    cache = pc.restore_slot_state(cache, 0, snap)
    for kn in "kv":
        assert torch.equal(cache["units"]["pos0"][kn][:, 0], want[kn])
        assert torch.equal(cache["units"]["pos0"][kn][:, 1], other[kn])
    qwen = paged.PagedKVCache(smoke_variant(get("qwen3-8b")), 2, 64,
                              dtype=torch.float32, device="cpu")
    assert qwen.snapshot_slot_state(qwen.init_cache(), 0) == {}


# -- the engine ---------------------------------------------------------------

# prompts longer and shorter than the window of 32, decodes that wrap it
_WORK = [(40, 16, 0), (12, 24, 1), (33, 12, 0), (25, 20, 2), (5, 14, 0)]
_MODES = {
    "paged": dict(page_size=8),
    "monolithic": dict(cache_mode="monolithic"),
    # a pool too small for both slots, no cold pool: page pressure
    # preempts a slot whose ring has wrapped, which resumes from swap
    "swap": dict(page_size=8, n_pages=9, swap_bytes=1 << 28),
    "compressed-swap": dict(page_size=8, n_pages=9, compress_cold=True,
                            n_cold_slots=2, swap_bytes=1 << 28),
}


def _serve(eng, Req):
    rng = np.random.default_rng(17)
    reqs = [Req(prompt=rng.integers(1, 512, n).tolist(), max_new_tokens=m,
                priority=pr, id=11_000 + i)
            for i, (n, m, pr) in enumerate(_WORK)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_engine_matches_reference_engine(gemma, mode, monkeypatch):
    cfg, ref_cfg, ref_params, params = gemma
    if not hasattr(pl, "store"):
        # the reference engine's fault decodes through its Pallas page
        # kernel, which writes with ``pl.store`` (dropped by newer JAX
        # releases); assigning through the ref is the same write
        def pl_store(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", pl_store, raising=False)
    kw = dict(max_batch=2, max_len=64, **_MODES[mode])
    ref_eng = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(**kw))
    ref_reqs = _serve(ref_eng, RefRequest)
    eng = GenerationEngine(params, cfg, config=EngineConfig(**kw),
                           device="cpu")
    wrapped = []                # host lengths of preempted slots
    preempt = eng._preempt

    def spy(slot):
        wrapped.append(eng._host_len[slot])
        return preempt(slot)

    monkeypatch.setattr(eng, "_preempt", spy)
    reqs = _serve(eng, Request)
    assert all(r.done for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert eng.steps == ref_eng.steps
    assert eng.scheduler.counters() == ref_eng.scheduler.counters()
    if "swap" in mode:
        assert eng.scheduler.n_preempted > 0
        assert max(wrapped) > 32        # a ring that had wrapped swapped
        assert eng.paged.free_pages == eng.paged.n_pages - 1
        assert len(eng.paged.swap) == 0 and not eng.paged._cold_bytes
