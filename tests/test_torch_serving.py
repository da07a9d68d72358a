"""The port's serving engine, allocator and sampler against the JAX
package: greedy tokens identical to the reference engine on the same
(converted) ECF8 weights, ECF8 tokens identical to the fp8 baseline,
allocator state identical after the same operation sequence, and a sampled
stream independent of the batch size."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.kvcache import paged as ref_paged  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.serving import EngineConfig, EngineConfigError, \
    GenerationEngine, Request  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402

# tests/test_serving.py:38's workload (more requests than slots) and
# :128's mixed-length one (6 requests, 2 slots)
WORKLOADS = {
    "oversubscribed": (3, [([1, 2, 3, 4], 5), ([5, 6, 7], 6), ([9, 10], 4),
                           ([11, 12, 13], 4)]),
    "mixed-length": (2, [([i + 1, i + 2, i + 3], n)
                         for i, n in enumerate([2, 9, 4, 7, 3, 5])]),
}


@pytest.fixture(scope="module")
def weights():
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    ref_c, _ = ref_store.compress_tree(ref_params, min_elems=4096,
                                       out_dtype="float32")
    got_c, _ = store.compress_tree(params, min_elems=4096,
                                   out_dtype="float32")
    return cfg, ref_cfg, ref_c, got_c, params


def _run(params, cfg, workload, temperature=0.0, **ecfg):
    eng = GenerationEngine(params, cfg, config=EngineConfig(**ecfg),
                           device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n, temperature=temperature,
                    id=i) for i, (p, n) in enumerate(workload)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert all(r.done for r in reqs) and len(done) == len(reqs)
    return reqs, eng


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_greedy_tokens_match_reference_engine(weights, workload):
    cfg, ref_cfg, ref_c, got_c, _ = weights
    max_batch, work = WORKLOADS[workload]
    ref_eng = RefEngine(ref_c, ref_cfg, config=RefEngineConfig(
        max_batch=max_batch, max_len=48))
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=n) for p, n in work]
    for r in ref_reqs:
        ref_eng.submit(r)
    ref_eng.run()
    reqs, eng = _run(got_c, cfg, work, max_batch=max_batch, max_len=48)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert eng.steps == ref_eng.steps
    # every page went back to the pool
    assert eng.paged.free_pages == eng.paged.n_pages - 1
    assert not eng.paged._slot_pages


def test_ecf8_tokens_equal_fp8_baseline(weights):
    cfg, _, _, got_c, params = weights
    rng = np.random.default_rng(4)
    work = [(rng.integers(0, cfg.vocab_size, n).tolist(), 6)
            for n in (3, 17, 8, 30)]
    base = store.fp8_cast_tree(params, min_elems=4096)
    a, _ = _run(got_c, cfg, work, max_batch=3, max_len=64)
    b, _ = _run(base, cfg, work, max_batch=3, max_len=64)
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]


def test_sampled_stream_is_independent_of_batch_size(weights):
    cfg, _, _, _, params = weights
    work = [([7, 8, 9, 10], 6), ([3, 1], 5), ([11, 12, 13], 7)]
    one, _ = _run(params, cfg, work, temperature=0.8, max_batch=1,
                  max_len=32, rng_seed=3)
    four, _ = _run(params, cfg, work, temperature=0.8, max_batch=4,
                   max_len=32, rng_seed=3)
    assert [r.out_tokens for r in one] == [r.out_tokens for r in four]
    other, _ = _run(params, cfg, work, temperature=0.8, max_batch=4,
                    max_len=32, rng_seed=4)
    assert [r.out_tokens for r in other] != [r.out_tokens for r in four]


def test_allocator_state_matches_reference():
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # page_size 5 -> 4 on both sides
        ref_pc = ref_paged.PagedKVCache(ref_cfg, 3, 32, dtype=jnp.float32,
                                        page_size=5)
        pc = paged.PagedKVCache(cfg, 3, 32, dtype=torch.float32,
                                device="cpu", page_size=5)
    ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
    ref_frag = RM.init_cache(ref_cfg, 1, 32, dtype=jnp.float32)
    frag = {"units": {"pos0": {
        kn: torch.from_numpy(np.array(ref_frag["units"]["pos0"][kn]))
        for kn in ("k", "v")}}}
    ops = [("admit", 0, 6), ("admit", 1, 13), ("ensure", 0, 9),
           ("admit", 2, 2), ("release", 1, 0), ("ensure", 2, 8),
           ("admit", 1, 20), ("ensure", 0, 16), ("release", 0, 0),
           ("ensure", 1, 27), ("admit", 0, 4)]
    for op, slot, n in ops:
        if op == "admit":
            ref_cache = ref_pc.admit(ref_cache, slot, ref_frag, n)
            cache = pc.admit(cache, slot, frag, n)
        elif op == "ensure":
            ref_cache = ref_pc.ensure(ref_cache, slot, n)
            cache = pc.ensure(cache, slot, n)
        else:
            ref_cache = ref_pc.release(ref_cache, slot)
            cache = pc.release(cache, slot)
        assert pc._free == ref_pc._free[0], (op, slot, n)
        assert pc._slot_pages == ref_pc._slot_pages
        np.testing.assert_array_equal(cache["page_table"].numpy(),
                                      np.asarray(ref_cache["page_table"]))
        np.testing.assert_array_equal(cache["cur_len"].numpy(),
                                      np.asarray(ref_cache["cur_len"]))
    assert pc.pages_needed(13) == ref_pc.pages_needed(13)
    small = paged.PagedKVCache(cfg, 1, 32, dtype=torch.float32,
                               device="cpu", page_size=4, n_pages=3)
    with pytest.raises(paged.OutOfPages):
        small.admit(small.init_cache(), 0, frag, 20)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                           compress_cold=True)


@pytest.mark.parametrize("field,value", [
    ("cache_mode", "monolithic"), ("prefill_chunk", 8),
    ("swap_bytes", -1), ("prefix_sharing", True), ("compress_cold", True),
    ("spec_k", 2)])
def test_unported_engine_options_raise(field, value):
    with pytest.raises(EngineConfigError, match="not yet ported"):
        EngineConfig(**{field: value})


def test_sampler_keys_and_filters():
    k = sampler.request_key(sampler.root_key(0), 5, 3)
    assert k == sampler.request_key(sampler.root_key(0), 5, 3)
    assert len({k, sampler.request_key(sampler.root_key(0), 5, 4),
                sampler.request_key(sampler.root_key(0), 6, 3),
                sampler.request_key(sampler.root_key(1), 5, 3)}) == 4
    logits = torch.tensor([[[0.0, 5.0, 1.0, -2.0]]])
    assert int(sampler.greedy(logits)[0, 0]) == 1
    gen = sampler.key_generator(k, "cpu")
    toks = sampler.sample_logits(logits.repeat(64, 1, 1), gen,
                                 temperature=1.0, top_k=2)
    assert set(toks.reshape(-1).tolist()) <= {1, 2}
    x = torch.tensor([[3.0, 2.0, 1.0, 0.0]])
    kept = sampler.filter_logits(x, top_p=0.7)
    assert torch.isfinite(kept).tolist() == [[True, True, False, False]]
