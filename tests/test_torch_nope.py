"""llama4-scout's stack in the port against the JAX package: the ``nope``
kind (a global attention layer that skips RoPE) in a ("local", "local",
"local", "nope") unit with 8 experts top-1 and a shared expert, at the
smoke size (window 32).

The weights are the reference's own smoke weights converted with
``repro_torch.convert``, with random norm scales set in both trees.
Logits are f32 and held within 1e-5, cached K/V (of magnitude up to ~5,
after eight layers of experts) within 1e-5 absolute plus 1e-5 relative;
tokens, scheduler counters and containers exactly.  The engine runs are
held against the reference engine from ECF8-TPU and ECF8-FR trees through
decodes past the rings' wrap."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine, Request  # noqa: E402

ATOL = 1e-5
ARCH = "llama4-scout-17b-a16e"


def _with_random_norms(tree, rng, path=()):
    """The tree with every norm scale redrawn (normal * 0.3, f32)."""
    if isinstance(tree, dict):
        return {k: _with_random_norms(v, rng, path + (k,))
                for k, v in tree.items()}
    if "norm" in path[-1]:
        return (rng.normal(size=tree.shape) * 0.3).astype(tree.dtype)
    return tree


@pytest.fixture(scope="module")
def llama():
    cfg = smoke_variant(get(ARCH))
    ref_cfg = ref_smoke(ref_get(ARCH))
    tree = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(0), ref_cfg))
    tree = _with_random_norms(tree, np.random.default_rng(5))
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg, ref_cfg, ref_params, convert.params_from_numpy(tree, cfg,
                                                               "cpu")


def test_check_supported_admits_llama4_and_param_tree_matches_reference(
        llama):
    cfg, ref_cfg, ref_params, _ = llama
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.pattern == ("local", "local", "local", "nope")
    for c in (get(ARCH), cfg):
        M.check_supported(c)
    mine = M.init_params(cfg, 0, "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(mine) == shapes(jax.tree_util.tree_map(np.asarray,
                                                         ref_params))
    assert set(mine["units"]["pos3"]["moe"]) == {"gate", "wi_gate", "wi_up",
                                                 "wo", "shared"}


@pytest.mark.parametrize("T", [20, 37])
def test_prefill_logits_match_reference(llama, T):
    """T = 20 is within the window of 32 (flash in every layer); T = 37 runs
    ``local_attention`` in the local layers and flash in the NoPE one.  The
    same reference stack with RoPE in its fourth layer ('attn') gives other
    logits, so the comparison sees a NoPE layer that rotates."""
    cfg, ref_cfg, ref_params, params = llama
    toks = np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T))
    want, ref_cache = RM.prefill(ref_params, ref_cfg, jnp.asarray(toks),
                                 max_len=64)
    got, cache = M.prefill(params, cfg, torch.from_numpy(toks), max_len=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for pos in ("pos0", "pos3"):
        for kn in ("k", "v"):
            np.testing.assert_allclose(
                cache["units"][pos][kn].numpy(),
                np.asarray(ref_cache["units"][pos][kn]), atol=ATOL,
                rtol=ATOL, err_msg=f"{pos}/{kn}")
    assert cache["units"]["pos0"]["k"].shape[3] == 32          # a ring
    assert cache["units"]["pos3"]["k"].shape[3] == 64          # a full row
    roped = dataclasses.replace(ref_cfg, pattern=("local",) * 3 + ("attn",))
    other, _ = RM.prefill(ref_params, roped, jnp.asarray(toks), max_len=64)
    assert float(jnp.abs(other - want).max()) > 1e-3


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_steps_across_the_ring_wrap(llama, layout):
    """16 greedy decode steps: the 20-token slot's local rings wrap at
    position 32 (the 37-token one's at prefill), the NoPE layer's rows or
    pages grow; logits within 1e-5 and the same tokens."""
    cfg, ref_cfg, ref_params, params = llama
    rng = np.random.default_rng(3)
    if layout == "contiguous":
        toks = rng.integers(0, cfg.vocab_size, (2, 20))
        logits, ref_cache = RM.prefill(ref_params, ref_cfg,
                                       jnp.asarray(toks), max_len=64)
        _, cache = M.prefill(params, cfg, torch.from_numpy(toks), max_len=64)
        pc = None
        last = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
    else:
        from repro.kvcache import paged as ref_paged
        ref_pc = ref_paged.PagedKVCache(ref_cfg, 2, 80, dtype=jnp.float32,
                                        page_size=8)
        pc = paged.PagedKVCache(cfg, 2, 80, dtype=torch.float32,
                                device="cpu", page_size=8)
        ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
        lens, last = [20, 37], []
        for slot, n in enumerate(lens):
            p = rng.integers(0, cfg.vocab_size, n)
            logits, frag = RM.prefill(ref_params, ref_cfg,
                                      jnp.asarray(p)[None], max_len=80)
            ref_cache = ref_pc.admit(ref_cache, slot, frag, n)
            _, frag_t = M.prefill(params, cfg, torch.from_numpy(p)[None],
                                  max_len=80)
            cache = pc.admit(cache, slot, frag_t, n)
            last.append(int(jnp.argmax(logits[0, -1])))
        last = np.asarray(last)
    for step in range(16):
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


def test_paged_cache_pools_the_nope_layer_and_rings_the_local_ones(llama):
    cfg = llama[0]
    pc = paged.PagedKVCache(cfg, 2, 64, dtype=torch.float32, device="cpu",
                            page_size=8)
    cache = pc.init_cache()
    assert set(cache["units"]["pos3"]) >= {"k_pool", "v_pool"}
    for j in range(3):
        leaves = cache["units"][f"pos{j}"]
        assert "k_pool" not in leaves
        assert leaves["k"].shape == (cfg.n_layers // 4, 2, cfg.n_kv_heads,
                                     32, cfg.hd)
    assert cache["units"]["pos3"]["k_pool"].shape[0] == cfg.n_layers // 4


def test_chunks_sharing_and_speculation_fall_back_with_reference_warnings(
        llama):
    """llama4's stack is not all paged: the reference's warnings (lenient)
    and its strict error, the same texts."""
    cfg, ref_cfg = llama[0], llama[1]
    kw = dict(max_len=64, prefill_chunk=8, prefix_sharing=True)
    texts = []
    for Cfg, arch, dcfg in ((EngineConfig, cfg, cfg),
                            (RefEngineConfig, ref_cfg, ref_cfg)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = Cfg(**kw).validate(arch)
            spec = Cfg(max_len=64, draft_cfg=dcfg).validate(arch)
        texts.append([str(w.message) for w in rec])
        assert (got.prefill_chunk, got.prefix_sharing, got.cache_mode,
                spec.draft_cfg) == (0, False, "paged", None)
    assert texts[0] == texts[1] and len(texts[0]) == 3
    from repro_torch.serving import EngineConfigError
    with pytest.raises(EngineConfigError, match="all-'attn'/'nope'"):
        EngineConfig(**kw).validate(cfg, strict=True)


# -- the engine ---------------------------------------------------------------

# a prompt past the window at prefill, one whose rings wrap in decode, a
# short one; two slots
_WORK = [(37, 6, 0), (20, 16, 1), (5, 8, 0)]


def _serve(eng, Req, work=_WORK):
    rng = np.random.default_rng(17)
    reqs = [Req(prompt=rng.integers(1, 512, n).tolist(), max_new_tokens=m,
                priority=pr, id=12_000 + i)
            for i, (n, m, pr) in enumerate(work)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


@pytest.mark.parametrize("fmt", ["tpu", "fixedrate"])
def test_engine_matches_reference_engine_from_compressed_trees(llama, fmt):
    cfg, ref_cfg, ref_params, params = llama
    ref_c, ref_rep = ref_store.compress_tree(ref_params, fmt=fmt,
                                             min_elems=4096,
                                             out_dtype="float32")
    got_c, rep = store.compress_tree(params, fmt=fmt, min_elems=4096,
                                     out_dtype="float32")
    assert rep == ref_rep and rep["n_compressed"] > 20
    kw = dict(max_batch=2, max_len=64, page_size=8)
    ref_eng = RefEngine(ref_c, ref_cfg, config=RefEngineConfig(**kw))
    ref_reqs = _serve(ref_eng, RefRequest)
    eng = GenerationEngine(got_c, cfg, config=EngineConfig(**kw),
                           device="cpu")
    assert eng.cache_mode == "paged"
    reqs = _serve(eng, Request)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert eng.steps == ref_eng.steps
    assert eng.paged.free_pages == eng.paged.n_pages - 1


@pytest.mark.parametrize("mode", ["monolithic", "swap"])
def test_engine_layouts_match_reference_engine(llama, mode, monkeypatch):
    """The monolithic cache, and a pool too small for both slots (page
    pressure preempts a slot whose rings have wrapped; it resumes from
    swap): tokens and counters equal the reference engine's, and the
    preempted run's tokens equal the unpreempted paged run's."""
    cfg, ref_cfg, ref_params, params = llama
    if not hasattr(pl, "store"):
        # the reference engine's fault decodes through its Pallas page
        # kernel, which writes with ``pl.store`` (dropped by newer JAX
        # releases); assigning through the ref is the same write
        def pl_store(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", pl_store, raising=False)
    work = [(37, 12, 0), (20, 24, 1), (5, 8, 0)]
    extra = (dict(cache_mode="monolithic") if mode == "monolithic"
             else dict(page_size=8, n_pages=9, swap_bytes=1 << 28))
    kw = dict(max_batch=2, max_len=64, **extra)
    ref_eng = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(**kw))
    ref_reqs = _serve(ref_eng, RefRequest, work)
    eng = GenerationEngine(params, cfg, config=EngineConfig(**kw),
                           device="cpu")
    preempted_at = []
    preempt = eng._preempt

    def spy(slot):
        preempted_at.append(eng._host_len[slot])
        return preempt(slot)

    monkeypatch.setattr(eng, "_preempt", spy)
    reqs = _serve(eng, Request, work)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert eng.steps == ref_eng.steps
    assert eng.scheduler.counters() == ref_eng.scheduler.counters()
    plain = _serve(GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=2, max_len=64, page_size=8), device="cpu"), Request, work)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]
    if mode == "swap":
        assert eng.scheduler.n_preempted > 0
        assert eng.scheduler.n_resumed == eng.scheduler.n_preempted
        assert max(preempted_at) > 32       # a slot whose rings had wrapped
        assert eng.paged.free_pages == eng.paged.n_pages - 1
        assert len(eng.paged.swap) == 0
