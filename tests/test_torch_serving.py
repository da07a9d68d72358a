"""The port's serving engine, allocator and sampler against the JAX
package: greedy tokens identical to the reference engine on the same
(converted) ECF8 weights, ECF8 tokens identical to the fp8 baseline,
allocator state identical after the same operation sequence, a sampled
stream independent of the batch size, and — under the reference's
oversubscribed configuration (cold pool + swap tier) — tokens, preemption
counts and swap traffic equal to the reference engine's, with whole-prompt
and with chunked, decode-interleaved prefill."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

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
    # the cold pool: the reference's default size and stride budget, its
    # leaves in the cache, and a full page moved into it
    cold = paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                              page_size=4, compress_cold=True)
    ref_cold = ref_paged.PagedKVCache(ref_cfg, 2, 32, dtype=jnp.float32,
                                      page_size=4, compress_cold=True)
    assert (cold.n_cold, cold.stride_budget) == (ref_cold.n_cold,
                                                 ref_cold.stride_budget)
    c = cold.admit(cold.init_cache(), 0, frag, 9)
    assert c["units"]["pos0"]["k_cpl"].shape == (
        cfg.n_layers, cold.n_cold, cold.stride_budget, 128)
    c = cold.compress_cold_pages(c, 0, 9)
    assert cold.has_cold and cold._slot_pages[0][:2] == [
        cold.n_pages + 0, cold.n_pages + 1]


@pytest.mark.parametrize("field,value", [
    ("cache_mode", "monolithic"), ("mesh", object()),
    ("draft_cfg", smoke_variant(get("qwen3-8b"))), ("prefix_sharing", True),
    ("telemetry", object()), ("spec_k", 2)])
def test_unported_engine_options_raise(field, value):
    """Every option of the reference that the port does not serve yet
    raises; the monolithic cache and the speculative fields (``cache_mode``,
    ``draft_cfg``, ``spec_k``), ported since, are accepted."""
    if field in ("cache_mode", "draft_cfg", "spec_k"):
        assert getattr(EngineConfig(**{field: value}), field) == value
        return
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


# --------------------------------------------------------------------------
# oversubscription: cold pool + swap tier + preemption
# --------------------------------------------------------------------------

# tests/test_serving.py:175's configuration and :181's workload
_OVERSUB = dict(cache_mode="paged", page_size=8, n_pages=5,
                compress_cold=True, n_cold_slots=1, swap_bytes=1 << 28)
_OVERSUB_WL = ([[i + 1] * (7 + 3 * (i % 3)) for i in range(6)],
               [14, 10, 16, 9, 12, 11], [0, 1, 0, 2, 1, 0])


@pytest.fixture
def pallas_store(monkeypatch):
    """The reference engine's fault decodes through its Pallas page kernel,
    which writes with ``pl.store`` (dropped by newer JAX releases);
    assigning through the ref is the same write."""
    if not hasattr(pl, "store"):
        def store(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", store, raising=False)


def _oversubscribed(eng, Req):
    prompts, news, prios = _OVERSUB_WL
    reqs = [Req(prompt=p, max_new_tokens=n, priority=pr, id=5_000 + i)
            for i, (p, n, pr) in enumerate(zip(prompts, news, prios))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


def _differential_fixed(eng, Req):
    """tests/test_serving.py:367's preempting workload."""
    wl = [(20, 12, 1), (16, 10, 2), (9, 12, 0), (14, 8, 0)]
    rng = np.random.default_rng(123)
    prompts = [rng.integers(1, 512, size=p).tolist() for p, _, _ in wl]
    reqs = [Req(prompt=prompts[i], max_new_tokens=n, priority=pr,
                id=8_000 + i) for i, (_, n, pr) in enumerate(wl)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


def _priority(eng, Req):
    """tests/test_serving.py:228: a late high-priority request preempts
    running priority-0 work."""
    lo = [Req(prompt=[i + 1] * 9, max_new_tokens=14, id=6_000 + i)
          for i in range(2)]
    hi = Req(prompt=[40] * 9, max_new_tokens=8, priority=5, id=6_100)
    for r in lo:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.submit(hi)
    eng.step()
    assert eng.scheduler.n_preempted >= 1 and hi in eng.slots
    eng.run()
    return lo + [hi]


def _page_boundary(k):
    """tests/test_serving.py:307: a prompt of exactly k pages survives a
    forced compress -> swap -> restore round trip."""
    def scenario(eng, Req):
        req = Req(prompt=list(range(1, 8 * k + 1)), max_new_tokens=10,
                  id=7_000 + k)
        eng.submit(req)
        for _ in range(3):
            eng.step()
        assert eng._preempt(eng.slots.index(req))
        assert req not in eng.slots
        eng.run()
        return [req]
    return scenario


_SCENARIOS = {"oversubscribed": _oversubscribed,
              "differential-fixed": _differential_fixed,
              "priority": _priority,
              "page-boundary-1": _page_boundary(1),
              "page-boundary-2": _page_boundary(2)}
_TRAFFIC = ("swap_out_bytes_total", "swap_in_bytes_total", "n_swap_out",
            "n_swap_in")


@pytest.fixture(scope="module")
def raw_weights():
    """The reference's f32 smoke weights and their conversion (the ECF8
    trees of ``weights`` decode every weight in every step, which on the
    CPU costs ~20x the step itself; ECF8 serving parity is held above)."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
def test_oversubscribed_serving_matches_reference_engine(raw_weights,
                                                         scenario,
                                                         pallas_store):
    cfg, ref_cfg, ref_params, params = raw_weights
    run = _SCENARIOS[scenario]
    ref_eng = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(
        max_batch=2, max_len=48, **_OVERSUB))
    ref_reqs = run(ref_eng, RefRequest)
    eng = GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=2, max_len=48, **_OVERSUB), device="cpu")
    reqs = run(eng, Request)
    assert all(r.done for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert (eng.scheduler.n_preempted, eng.scheduler.n_resumed) == (
        ref_eng.scheduler.n_preempted, ref_eng.scheduler.n_resumed)
    assert eng.scheduler.n_resumed > 0
    got, want = eng.paged.swap.stats(), ref_eng.paged.swap.stats()
    assert {k: got[k] for k in _TRAFFIC} == {k: want[k] for k in _TRAFFIC}
    assert got["swap_in_bytes_total"] == got["swap_out_bytes_total"] > 0
    # everything drained: no host-resident swap, full free lists
    assert len(eng.paged.swap) == 0 and eng.paged.swap.bytes_used == 0
    assert eng.paged.free_pages == eng.paged.n_pages - 1
    assert not eng.paged._cold_bytes and not eng.paged._slot_pages


def test_sampled_stream_is_unchanged_by_forced_preemption(raw_weights):
    cfg, _, _, params = raw_weights
    work = [([7, 8, 9, 10, 11, 12, 13, 14, 15], 9), ([3, 1], 6)]

    def serve(preempt_at):
        eng = GenerationEngine(params, cfg, config=EngineConfig(
            max_batch=2, max_len=48, rng_seed=5, **_OVERSUB), device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=n, temperature=0.9,
                        id=9_000 + i) for i, (p, n) in enumerate(work)]
        for r in reqs:
            eng.submit(r)
        for i in range(50):
            if i == preempt_at:
                assert eng._preempt(eng.slots.index(reqs[0]))
            if not eng.step() and not any(eng.slots):
                break
        assert all(r.done for r in reqs)
        return [r.out_tokens for r in reqs], eng

    plain, _ = serve(None)
    swapped, eng = serve(3)
    assert eng.scheduler.n_preempted == 1 and eng.scheduler.n_resumed == 1
    assert eng.paged.swap.n_swap_out > 0
    assert swapped == plain


# --------------------------------------------------------------------------
# chunked, decode-interleaved prefill
# --------------------------------------------------------------------------

# tests/test_serving.py:379-391's fixed workloads, greedy (sampled draws
# differ between jax.random and torch.Generator): (prompt length,
# max_new_tokens, priority) from a seed
_CHUNK_WL = {"preempting": ([(20, 12, 1), (16, 10, 2), (9, 12, 0),
                             (14, 8, 0)], 123),
             "mixed": ([(13, 8, 0), (5, 6, 1), (18, 5, 0)], 7)}


def _chunk_workload(eng, Req, name):
    wl, seed = _CHUNK_WL[name]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 512, size=p).tolist() for p, _, _ in wl]
    reqs = [Req(prompt=prompts[i], max_new_tokens=n, priority=pr,
                id=8_000 + i) for i, (_, n, pr) in enumerate(wl)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("workload", sorted(_CHUNK_WL))
def test_chunked_serving_matches_reference_engine(raw_weights, workload,
                                                  chunk, pallas_store):
    """The reference engine's chunked run of the same workload under the
    oversubscribed configuration: greedy tokens, engine steps, chunk
    counters and preemption counters equal."""
    cfg, ref_cfg, ref_params, params = raw_weights
    kw = dict(max_batch=2, max_len=48, prefill_chunk=chunk, **_OVERSUB)
    ref_eng = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(**kw))
    ref_reqs = _chunk_workload(ref_eng, RefRequest, workload)
    eng = GenerationEngine(params, cfg, config=EngineConfig(**kw),
                           device="cpu")
    reqs = _chunk_workload(eng, Request, workload)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    counters = ("steps", "n_chunks", "n_chunk_tokens", "n_interleaved_steps")
    assert {c: getattr(eng, c) for c in counters} == {
        c: getattr(ref_eng, c) for c in counters}
    assert (eng.scheduler.n_preempted, eng.scheduler.n_resumed) == (
        ref_eng.scheduler.n_preempted, ref_eng.scheduler.n_resumed)
    assert eng.n_chunks > len(reqs) and eng.n_interleaved_steps > 0
    assert (eng.prefill_chunk, eng.prefill_budget) == (chunk, chunk)
    assert len(eng.paged.swap) == 0 and not eng.paged._slot_pages
    assert eng.paged.free_pages == eng.paged.n_pages - 1


def test_chunked_tokens_equal_whole_prompt_tokens(raw_weights):
    """The reference's invariant, in f32 on the port alone: chunked
    prefill (under preemption) gives the whole-prompt engine's tokens."""
    cfg, _, _, params = raw_weights
    runs = {}
    for chunk in (0, 4):
        eng = GenerationEngine(params, cfg, config=EngineConfig(
            max_batch=2, max_len=48, prefill_chunk=chunk, **_OVERSUB),
            device="cpu")
        runs[chunk] = [r.out_tokens for r in
                       _chunk_workload(eng, Request, "preempting")]
        assert eng.scheduler.n_preempted > 0
    assert runs[4] == runs[0]


def test_midprefill_preempt_resume_matches_unpreempted_run(raw_weights):
    """tests/test_serving.py:425's scenario: a request preempted after its
    first 4-token chunk records ``prefill_pos``, resumes prefill there and
    finishes with the tokens of the port's own unpreempted chunked run."""
    cfg, _, _, params = raw_weights

    def serve(preempt):
        eng = GenerationEngine(params, cfg, config=EngineConfig(
            max_batch=2, max_len=48, prefill_chunk=4, prefill_budget=4,
            **_OVERSUB), device="cpu")
        req = Request(prompt=list(range(1, 21)), max_new_tokens=8,
                      id=12_000)
        eng.submit(req)
        if preempt:
            eng.step()                              # one 4-token chunk in
            slot = eng.slots.index(req)
            assert eng._prefill_pos[slot] == 4
            assert eng._preempt(slot)
            assert req not in eng.slots and not req.out_tokens
            st = eng.scheduler.head()
            assert st.prefill_pos == 4 and st.prefill_tokens_left == 16
        eng.run()
        assert req.done
        return req.out_tokens, eng

    plain, _ = serve(False)
    resumed, eng = serve(True)
    assert resumed == plain and len(plain) == 8
    assert eng.scheduler.n_resumed == 1 and len(eng.paged.swap) == 0


def test_scheduler_token_budget_blocks_new_prefill_work():
    """pick() with an exhausted prefill budget admits only zero-prefill
    items (decode-phase resumes); a budget-blocked class head blocks its
    class, preserving FIFO."""
    from repro_torch.kvcache import SwapStore
    from repro_torch.serving.scheduler import Preempted, Scheduler
    cfg = smoke_variant(get("qwen3-8b"))
    pkv = paged.PagedKVCache(cfg, 2, 64, dtype=torch.float32, device="cpu",
                             page_size=16)
    pkv.attach_swap(SwapStore())
    sched = Scheduler(paged=pkv, chunk_tokens=8)
    a = Request(prompt=[1] * 10, max_new_tokens=4, id=13_000)
    b = Request(prompt=[1] * 3, max_new_tokens=4, id=13_002)
    sched.submit(a)
    sched.submit(b)
    assert sched.admission_grant(a) == 1            # the first chunk's page
    assert sched.pick(0, prefill_budget=0) is None  # needs prefill
    assert sched.pick(0, prefill_budget=8) is a     # FIFO within the class
    # a decode-phase resume admits even with no budget left
    done = Preempted(req=Request(prompt=[1] * 4, max_new_tokens=4,
                                 id=13_001),
                     pages=[], skip=set(), host_len=5, last_tok=3)
    sched.requeue(done)
    assert sched.prefill_tokens(done) == 0
    assert sched.pick(1, prefill_budget=0) is done
    assert sched.pick(1, prefill_budget=0) is None  # b still needs prefill


# --------------------------------------------------------------------------
# the monolithic cache
# --------------------------------------------------------------------------

def test_splice_fragment_roundtrips_prefill(raw_weights):
    """tests/test_serving.py:99: splicing a single-row prefill fragment at
    slot s reproduces that request's cache at batch row s and nothing
    else; ``cur_len`` is a per-slot vector indexed directly."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import splice_fragment
    cfg, _, _, params = raw_weights
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 6)))
    _, frag = M.prefill(params, cfg, toks, max_len=16)
    cache = M.init_cache(cfg, 3, 16, torch.float32, "cpu", per_slot=True)
    cache = splice_fragment(cache, frag, 2)
    for kn in ("k", "v"):
        leaf, fr = cache["units"]["pos0"][kn], frag["units"]["pos0"][kn]
        assert torch.equal(leaf[:, 2:3], fr)
        assert float(leaf[:, :2].abs().max()) == 0.0
    assert cache["cur_len"].tolist() == [0, 0, 6]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_monolithic_tokens_match_reference_and_paged(raw_weights, workload):
    """Greedy tokens over the monolithic cache equal the reference engine's
    monolithic tokens and the port's paged tokens (the same decode
    attention over the same values)."""
    cfg, ref_cfg, ref_params, params = raw_weights
    max_batch, work = WORKLOADS[workload]
    ref_eng = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(
        max_batch=max_batch, max_len=48, cache_mode="monolithic"))
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=n) for p, n in work]
    for r in ref_reqs:
        ref_eng.submit(r)
    ref_eng.run()
    mono, eng = _run(params, cfg, work, max_batch=max_batch, max_len=48,
                     cache_mode="monolithic")
    pag, _ = _run(params, cfg, work, max_batch=max_batch, max_len=48)
    assert eng.paged is None and eng.cache_mode == "monolithic"
    want = [r.out_tokens for r in ref_reqs]
    assert [r.out_tokens for r in mono] == want
    assert [r.out_tokens for r in pag] == want
    assert eng.steps == ref_eng.steps


def test_vacated_slot_write_clamps_at_max_len(raw_weights):
    """A vacated slot keeps stepping past the end of its row: its write
    position is clamped to ``max_len - 1`` as the reference's
    ``dynamic_update_slice`` clamps it (a PyTorch index there would be out
    of range), and the live slot's logits and both rows equal the
    reference's decode step on the same state."""
    from repro_torch.models import model as M
    cfg, ref_cfg, ref_params, params = raw_weights
    max_len = 16
    rng = np.random.default_rng(9)
    k0 = rng.normal(size=(cfg.n_layers, 2, cfg.n_kv_heads, max_len,
                          cfg.hd)).astype(np.float32)
    v0 = rng.normal(size=k0.shape).astype(np.float32)
    lens = np.array([max_len, 5], np.int32)       # slot 0 at the end
    tok = np.array([[7], [11]])
    ref_cache = {"units": {"pos0": {"k": jnp.asarray(k0),
                                    "v": jnp.asarray(v0)}},
                 "tail": {}, "cur_len": jnp.asarray(lens)}
    want, ref_out = RM.decode_step(ref_params, ref_cfg, jnp.asarray(tok),
                                   ref_cache)
    cache = {"units": {"pos0": {"k": torch.from_numpy(k0.copy()),
                                "v": torch.from_numpy(v0.copy())}},
             "tail": {}, "cur_len": torch.from_numpy(lens.copy())}
    got, out = M.decode_step(params, cfg, torch.from_numpy(tok), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert out["cur_len"].tolist() == [max_len + 1, 6]
    for kn in ("k", "v"):
        got_c = out["units"]["pos0"][kn].numpy()
        want_c = np.asarray(ref_out["units"]["pos0"][kn])
        np.testing.assert_allclose(got_c, want_c, atol=1e-5)
        # slot 0's write landed at max_len - 1, slot 1's at 5; nothing else
        changed = np.argwhere((got_c != (k0 if kn == "k" else v0)).any(
            axis=(0, 2, 4)))
        assert changed.tolist() == [[0, max_len - 1], [1, 5]]
