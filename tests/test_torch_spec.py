"""The port's speculative decoding against the JAX package: the serving
engine's draft / verify rounds, ``serving.spec``'s rejection sampling,
``sampler.residual_probs``, ``models.model.verify_chunk`` and
``PagedKVCache.rollback``.

Weights are the reference's smoke qwen3-8b (f32) converted with
``convert.params_from_numpy``; the draft is the same architecture at seed
1 (the port serves attention-only drafts).  Greedy tokens are held
identical to the reference engine's and to target-only decoding; sampled
draws cannot match JAX's bits, so the sampled tests hold the key
discipline and the sampling theorem instead: a self-draft reproduces the
port's own plain-decode stream, the emitted marginal is the target's
(chi-square), and a draw depends only on its absolute position."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.kvcache import PagedKVCache as RefPagedKVCache  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import sampler as ref_sampler  # noqa: E402
from repro.serving import spec as ref_spec  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine, \
    Request  # noqa: E402
from repro_torch.serving import sampler, spec  # noqa: E402
from repro_torch.serving.engine import splice_fragment  # noqa: E402

try:
    from hypothesis import given, strategies as st
except ImportError:          # hypothesis is optional
    given = None

LOGIT_ATOL = 1e-4       # tests/test_torch_model.py's: f32, another order


@pytest.fixture(scope="module")
def trees():
    """Target (seed 0) and draft (seed 1) smoke qwen3-8b weights, the
    reference's and their conversion."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    out = {}
    for name, seed in (("target", 0), ("draft", 1)):
        ref_p = RM.init_params(jax.random.PRNGKey(seed), ref_cfg)
        out[name] = (ref_p, convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, ref_p), cfg, "cpu"))
    return cfg, ref_cfg, out


@pytest.fixture
def pallas_store(monkeypatch):
    """The reference engine's fault decodes through its Pallas page kernel,
    which writes with ``pl.store`` (dropped by newer JAX releases)."""
    if not hasattr(pl, "store"):
        def store(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", store, raising=False)


def _stream(Req, temps=(0.0,)):
    """tests/test_speculative.py's request stream."""
    return [Req(prompt=[i + 1] * (4 + 2 * i), max_new_tokens=5 + i,
                temperature=temps[i % len(temps)], id=40_000 + i)
            for i in range(4)]


def _serve(params, cfg, reqs, **kw):
    eng = GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=3, max_len=64, **kw), device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


def _ref_serve(params, cfg, reqs, **kw):
    eng = RefEngine(params, cfg, config=RefEngineConfig(
        max_batch=3, max_len=64, **kw))
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


# --------------------------------------------------------------------------
# the engine: greedy speculation is target-only decoding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_spec_matches_reference_and_target_only(trees, k):
    cfg, ref_cfg, t = trees
    (ref_p, p), (ref_d, d) = t["target"], t["draft"]
    base, _ = _serve(p, cfg, _stream(Request))
    got, eng = _serve(p, cfg, _stream(Request), draft_params=d,
                      draft_cfg=cfg, spec_k=k)
    want, ref_eng = _ref_serve(ref_p, ref_cfg, _stream(RefRequest),
                               draft_params=ref_d, draft_cfg=ref_cfg,
                               spec_k=k)
    assert eng.spec_on and got == base == want
    sc = eng.spec_counters()
    assert sc == ref_eng.spec_counters()
    assert sc["spec_drafted"] >= sc["spec_rounds"] > 0
    assert eng.steps == ref_eng.steps
    assert eng.paged.free_pages == eng.paged.n_pages - 1


def _near_draft(tree, scale, seed=7):
    """The target's weights with noise on one layer's MLP output: a draft
    that agrees with the target on most tokens, so rounds mix accepted and
    rejected proposals and every rollback length occurs."""
    d = jax.tree_util.tree_map(np.array, tree)
    wo = d["units"]["pos0"]["mlp"]["wo"]
    wo[0] += np.random.default_rng(seed).normal(
        size=wo[0].shape).astype(wo.dtype) * scale
    return d


def test_partial_acceptance_matches_reference(trees):
    """With a draft close to the target, rounds accept some proposals and
    reject the rest, so the draft's state after each rollback decides the
    next proposals: the accepted counts (and the tokens) equal the
    reference engine's, whose draft rollback re-splices whole snapshots
    where the port resets the timeline alone."""
    cfg, ref_cfg, t = trees
    ref_p, p = t["target"]
    near = _near_draft(jax.tree_util.tree_map(np.asarray, ref_p), 0.03)
    d = convert.params_from_numpy(near, cfg, "cpu")
    ref_d = jax.tree_util.tree_map(jnp.asarray, near)
    base, _ = _serve(p, cfg, _stream(Request))
    got, eng = _serve(p, cfg, _stream(Request), draft_params=d,
                      draft_cfg=cfg, spec_k=4)
    want, ref_eng = _ref_serve(ref_p, ref_cfg, _stream(RefRequest),
                               draft_params=ref_d, draft_cfg=ref_cfg,
                               spec_k=4)
    assert got == base == want
    sc = eng.spec_counters()
    assert sc == ref_eng.spec_counters()
    assert 0 < sc["spec_accepted"] < sc["spec_drafted"], sc


def test_self_draft_sampled_identical_to_plain_decode(trees):
    """draft == target: every proposal is accepted, and since proposals and
    the bonus token draw with the plain-decode rule and key, the sampled
    stream equals the port's own plain decoding at any temperature."""
    cfg, _, t = trees
    p = t["target"][1]
    temps = (0.9, 0.0, 0.6)
    base, _ = _serve(p, cfg, _stream(Request, temps))
    for k in (1, 3):
        got, eng = _serve(p, cfg, _stream(Request, temps), draft_params=p,
                          draft_cfg=cfg, spec_k=k)
        assert eng.spec_on and got == base, k
        assert eng.spec_counters()["spec_accept_rate"] == 1.0


def test_spec_under_forced_preemption_and_pressure(trees, pallas_store):
    """Page pressure preempts draft / target pairs mid-stream, plus one
    explicit mid-generation ``_preempt``; the resumed pair (target pages
    faulted back, the draft row reinstalled from its host stash) keeps the
    greedy stream identical to the reference engine's under the same
    pressure and to target-only decoding."""
    cfg, ref_cfg, t = trees
    (ref_p, p), (ref_d, d) = t["target"], t["draft"]
    stashed = []

    def run(Eng, Cfg, Req, params, dparams, arch, spec_on, **dev):
        eng = Eng(params, arch, config=Cfg(
            max_batch=2, max_len=64, page_size=4, n_pages=10, swap_bytes=-1,
            **(dict(draft_params=dparams, draft_cfg=arch, spec_k=4)
               if spec_on else {})), **dev)
        rs = [Req(prompt=[i + 1] * (6 + 3 * i), max_new_tokens=10 + i,
                  priority=i % 2, id=41_000 + i) for i in range(6)]
        for r in rs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        occupied = [s for s in range(eng.max_batch)
                    if eng.slots[s] is not None]
        if occupied:
            victim = eng.slots[occupied[0]]
            assert eng._preempt(occupied[0])
            if dev and spec_on:
                rec = eng.scheduler._classes[victim.priority][0]
                stashed.append((rec.host_len, rec.draft_state))
        eng.run()
        assert all(r.done for r in rs)
        return [r.out_tokens for r in rs], eng

    base, _ = run(GenerationEngine, EngineConfig, Request, p, d, cfg, False,
                  device="cpu")
    got, eng = run(GenerationEngine, EngineConfig, Request, p, d, cfg, True,
                   device="cpu")
    want, ref_eng = run(RefEngine, RefEngineConfig, RefRequest, ref_p, ref_d,
                        ref_cfg, True)
    assert eng.spec_on
    assert eng.scheduler.n_preempted > 0 and eng.scheduler.n_resumed > 0
    assert (eng.scheduler.n_preempted, eng.scheduler.n_resumed) == (
        ref_eng.scheduler.n_preempted, ref_eng.scheduler.n_resumed)
    assert got == base == want
    assert eng.spec_counters() == ref_eng.spec_counters()
    # the forced preemption stashed the draft row on the host, its timeline
    # at the target's
    host_len, snap = stashed[0]
    assert snap is not None and all(x.device.type == "cpu" for x in snap)
    assert int(snap[-1]) == host_len
    assert len(eng.paged.swap) == 0


# --------------------------------------------------------------------------
# the model: verify_chunk, the monolithic draft's rollback
# --------------------------------------------------------------------------

def test_verify_chunk_logits_match_reference(trees):
    """``verify_chunk`` unembeds every row of the window: its logits and the
    advanced timeline equal the reference's on the same paged cache."""
    cfg, ref_cfg, t = trees
    ref_p, p = t["target"]
    ref_pc = RefPagedKVCache(ref_cfg, 2, 32, dtype=jnp.float32, page_size=4)
    pc = paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                            page_size=4)
    prompt = np.arange(1, 10)[None]
    _, ref_frag = RM.prefill(ref_p, ref_cfg, jnp.asarray(prompt), max_len=32)
    _, frag = M.prefill(p, cfg, torch.from_numpy(prompt), max_len=32)
    ref_cache = ref_pc.admit(ref_pc.init_cache(), 1, ref_frag, 9)
    cache = pc.admit(pc.init_cache(), 1, frag, 9)
    ref_cache = ref_pc.ensure(ref_cache, 1, 12)
    cache = pc.ensure(cache, 1, 12)
    toks = np.array([[5, 17, 3, 250, 0]])
    want, ref_cache = RM.verify_chunk(ref_p, ref_cfg, jnp.asarray(toks),
                                      ref_cache, 1, 4)
    got, cache = M.verify_chunk(p, cfg, torch.from_numpy(toks), cache, 1, 4)
    assert got.shape == (1, 5, cfg.vocab_size)
    np.testing.assert_allclose(got[0, :4].numpy(), np.asarray(want)[0, :4],
                               atol=LOGIT_ATOL)
    assert cache["cur_len"].tolist() == np.asarray(
        ref_cache["cur_len"]).tolist() == [0, 13]


def test_draft_timeline_rollback_is_exact(trees):
    """The port rolls the draft back by its timeline alone: after steps
    that consumed rejected tokens, resetting ``cur_len`` gives the next
    step exactly the logits of a draft that never saw them (the positions
    past ``cur_len`` are masked, then rewritten)."""
    cfg, _, t = trees
    d = t["draft"][1]

    def fresh():
        cache = M.init_cache(cfg, 2, 32, torch.float32, "cpu", per_slot=True)
        for slot, n in ((0, 7), (1, 11)):
            _, frag = M.prefill(d, cfg, torch.arange(1, n + 1)[None],
                                max_len=32)
            cache = splice_fragment(cache, frag, slot)
        return cache

    a, b = fresh(), fresh()
    steps = [[3, 8], [40, 41], [7, 9], [100, 101], [13, 12]]
    for tok in steps:                     # a: five steps, rejected later
        _, a = M.decode_step(d, cfg, torch.tensor(tok)[:, None], a)
    for tok in steps[:2]:                 # b: only the kept two
        _, b = M.decode_step(d, cfg, torch.tensor(tok)[:, None], b)
    a["cur_len"][:] = torch.tensor([9, 13], dtype=torch.int32)
    assert torch.equal(a["cur_len"], b["cur_len"])
    for tok in ([21, 22], [23, 24]):
        la, a = M.decode_step(d, cfg, torch.tensor(tok)[:, None], a)
        lb, b = M.decode_step(d, cfg, torch.tensor(tok)[:, None], b)
        assert torch.equal(la, lb)


def _state_leaves(cfg, cache):
    """(path, leaf) of every ring and recurrent-state leaf of a draft cache:
    what its rollback must restore beyond the timeline."""
    for section, key, kind in M.cache_groups(cfg):
        if kind in paged.PAGED_KINDS:
            continue
        for name, leaf in cache[section][key].items():
            yield (section, key, name), leaf


def _lockstep_draft_states(cfg, ref_cfg, p, ref_p, dcfg, ref_dcfg, d, ref_d,
                           prompts, max_new, max_len, atol=1e-5):
    """Serve ``prompts`` on the port's engine and the reference's in
    lockstep (``spec_k`` 4, greedy, f32) and, after every round, hold each
    active slot's draft rings and recurrent states within ``atol`` of the
    reference's and its draft timeline equal to it.  -> (port tokens,
    reference tokens, port engine)."""
    kw = dict(max_batch=3, max_len=max_len, spec_k=4)
    eng = GenerationEngine(p, cfg, config=EngineConfig(
        draft_params=d, draft_cfg=dcfg, **kw), device="cpu")
    ref_eng = RefEngine(ref_p, ref_cfg, config=RefEngineConfig(
        draft_params=ref_d, draft_cfg=ref_dcfg, **kw))
    reqs, ref_reqs = ([Req(prompt=list(q), max_new_tokens=max_new,
                           id=47_000 + i) for i, q in enumerate(prompts)]
                      for Req in (Request, RefRequest))
    for r, rr in zip(reqs, ref_reqs):
        eng.submit(r)
        ref_eng.submit(rr)
    n_compared = 0
    for rnd in range(200):
        busy, ref_busy = eng.step(), ref_eng.step()
        assert busy == ref_busy
        ref_dc = jax.tree_util.tree_map(np.asarray, ref_eng.draft_cache)
        for s in range(eng.max_batch):
            assert (eng.slots[s] is None) == (ref_eng.slots[s] is None)
            if eng.slots[s] is None:
                continue
            assert int(eng.draft_cache["cur_len"][s]) == int(
                ref_dc["cur_len"][s])
            for (section, key, name), leaf in _state_leaves(
                    dcfg, eng.draft_cache):
                axis = 1 if section == "units" else 0
                want = np.take(ref_dc[section][key][name], s, axis=axis)
                np.testing.assert_allclose(
                    leaf.select(axis, s).numpy(), want, atol=atol,
                    err_msg=f"round {rnd}, slot {s}, {section}/{key}/{name}")
                n_compared += 1
        if not busy and all(x is None for x in eng.slots):
            break
    assert n_compared and all(r.done for r in reqs)
    return ([r.out_tokens for r in reqs], [r.out_tokens for r in ref_reqs],
            eng)


def _target_only(p, cfg, prompts, max_new, max_len):
    eng = GenerationEngine(p, cfg, config=EngineConfig(
        max_batch=3, max_len=max_len), device="cpu")
    reqs = [Request(prompt=list(q), max_new_tokens=max_new) for q in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs]


def test_ring_draft_rollback_matches_reference_every_round(trees):
    """A draft with ``local`` layers (gemma2's smoke stack, window 32)
    beside the qwen3 target, on 40-60-token prompts: every draft step
    writes ring slot ``cur_len % 32``, overwriting the position 32 back,
    which stays inside the next step's window.  A rejected proposal must
    therefore be undone in the ring as well as in the timeline: after every
    round each active slot's draft rings equal the reference engine's,
    which re-splices whole draft rows from per-step snapshots."""
    cfg, ref_cfg, t = trees
    ref_p, p = t["target"]
    dcfg, ref_dcfg = smoke_variant(get("gemma2-9b")), ref_smoke(
        ref_get("gemma2-9b"))
    ref_d = RM.init_params(jax.random.PRNGKey(2), ref_dcfg)
    d = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_d),
                                  dcfg, "cpu")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in rng.integers(40, 61, size=3)]
    got, want, eng = _lockstep_draft_states(
        cfg, ref_cfg, p, ref_p, dcfg, ref_dcfg, d, ref_d, prompts, 20, 96)
    assert got == want == _target_only(p, cfg, prompts, 20, 96)
    assert eng.n_spec_rollbacks > 0
    assert eng.n_draft_ring_wraps == eng.n_draft_state_rollbacks > 0


# --------------------------------------------------------------------------
# exact rejection sampling
# --------------------------------------------------------------------------

def test_residual_probs_match_reference_on_handbuilt_cases():
    cases = [
        ([0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.5, 0.5]),    # zero overlap: p
        ([0.5, 0.5, 0.0, 0.0], [0.5, 0.5, 0.0, 0.0]),    # Z = 0: p
        ([0.0, 1.0, 0.0, 0.0], [0.25, 0.25, 0.25, 0.25]),  # one-hot p
        ([[0.6, 0.2, 0.1, 0.1]], [[0.1, 0.5, 0.2, 0.2]]),  # batched
        ([0.3, 0.3, 0.2, 0.2], [0.1, 0.4, 0.4, 0.1]),
    ]
    for p, q in cases:
        want = np.asarray(ref_sampler.residual_probs(
            jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32)))
        got = sampler.residual_probs(torch.tensor(p), torch.tensor(q))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    # the generic case: max(0, p - q) / Z, exactly the one hot token
    got = sampler.residual_probs(torch.tensor([[0.6, 0.2, 0.1, 0.1]]),
                                 torch.tensor([[0.1, 0.5, 0.2, 0.2]]))
    assert got.tolist() == [[1.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("seed", range(6))
def test_greedy_verify_equals_reference(seed):
    """Greedy verify is argmax on numpy: the same (tokens, n_accepted) as
    the reference's on the same logits, for proposals that match the
    target's argmax up to every possible point."""
    V, n = 13, 4
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n + 1, V)).astype(np.float32)
    q = rng.normal(size=(n, V)).astype(np.float32)
    arg = [int(np.argmax(r)) for r in p]
    for cut in range(n + 1):
        props = arg[:cut] + [(a + 1 + seed) % V for a in arg[cut:n]]
        for m in range(n + 1):
            got = spec.verify(p[:m + 1], q[:m], props[:m], rng0=0, req_id=1,
                              pos0=0, temperature=0.0, device="cpu")
            want = ref_spec.verify(p[:m + 1], q[:m], props[:m],
                                   rng0=jax.random.PRNGKey(0), req_id=1,
                                   pos0=0, temperature=0.0)
            assert got == want, (cut, m)


def _chi_square(counts, probs):
    exp = probs * counts.sum()
    return float(((counts - exp) ** 2 / np.maximum(exp, 1e-12)).sum())


def test_verify_marginal_matches_target_chi_square():
    """Over seeded trials through ``spec.propose`` / ``spec.verify``, the
    emitted token's empirical distribution matches the target's softmax
    (chi-square below the 0.999 quantile, 5 degrees of freedom) and not
    the draft's (the power check), and the acceptance rate is
    sum(min(p, q))."""
    V, T, N = 6, 0.9, 1500
    rng = np.random.default_rng(5)
    p_log = (rng.normal(size=(2, V)) * 2).astype(np.float32)
    q_log = (rng.normal(size=(1, V)) * 2).astype(np.float32)
    p = torch.softmax(torch.from_numpy(p_log[0]) / T, -1).numpy()
    q = torch.softmax(torch.from_numpy(q_log[0]) / T, -1).numpy()
    rng0 = sampler.root_key(0)
    counts = np.zeros(V)
    accepted = 0
    for trial in range(N):
        t = spec.propose(torch.from_numpy(q_log)[None], rng0, trial, 9,
                         temperature=T)
        out, m = spec.verify(p_log, q_log, [t], rng0=rng0, req_id=trial,
                             pos0=9, temperature=T, device="cpu")
        counts[out[0]] += 1
        accepted += m
    crit = 20.52        # chi-square 0.999 quantile, dof 5
    chi_p, chi_q = _chi_square(counts, p), _chi_square(counts, q)
    assert chi_p < crit, (chi_p, counts / N, p)
    assert chi_q > crit, (chi_q, counts / N, q)
    assert abs(accepted / N - float(np.minimum(p, q).sum())) < 0.05


def test_verify_key_stream_matches_plain_decode_when_q_equals_p():
    """With q == p every proposal is accepted, and the stream over any
    window split equals the plain-decode stream token for token."""
    V, T = 11, 0.8
    rows = (np.random.default_rng(2).normal(size=(12, V)) * 1.5).astype(
        np.float32)
    rng0, rid = sampler.root_key(7), 123

    def row(i):
        return torch.from_numpy(rows[i])[None, None]

    plain = [int(sampler.sample_logits(
        row(i), sampler.key_generator(sampler.request_key(rng0, rid, i),
                                      "cpu"), temperature=T)[0, 0])
        for i in range(10)]
    for k in (1, 2, 5):
        got, pos = [], 0
        while len(got) < 10:
            n = min(k, 10 - pos - 1) if pos < 9 else 0
            props = [spec.propose(row(pos + i), rng0, rid, pos + i,
                                  temperature=T) for i in range(n)]
            out, m = spec.verify(rows[pos:pos + n + 1], rows[pos:pos + n],
                                 props, rng0=rng0, req_id=rid, pos0=pos,
                                 temperature=T, device="cpu")
            assert m == n
            got.extend(out)
            pos += len(out)
        assert got[:10] == plain, k


def test_rejection_draw_invariant_to_window_offset():
    """The accept and residual draws at an absolute position depend only
    on (root key, request, position): a rejection at position 7 draws the
    same token whether the window started at 7 or at 5."""
    V, T = 9, 1.0
    rng = np.random.default_rng(3)
    p_row = rng.normal(size=V).astype(np.float32)
    q_row = p_row[::-1].copy() * 3          # rejections are common
    shared = rng.normal(size=(2, V)).astype(np.float32)   # positions 5, 6
    rng0, rid = sampler.root_key(11), 9
    hits = 0
    for trial in range(20):
        rid = 9 + trial
        prop7 = spec.propose(torch.from_numpy(q_row)[None, None], rng0,
                             rid, 7, temperature=T)
        p_log = np.stack([p_row, rng.normal(size=V).astype(np.float32)])
        out_a, m_a = spec.verify(p_log, q_row[None], [prop7], rng0=rng0,
                                 req_id=rid, pos0=7, temperature=T,
                                 device="cpu")
        props = [spec.propose(torch.from_numpy(shared[i])[None, None], rng0,
                              rid, 5 + i, temperature=T) for i in range(2)]
        props.append(prop7)
        out_b, m_b = spec.verify(np.concatenate([shared, p_log]),
                                 np.stack([shared[0], shared[1], q_row]),
                                 props, rng0=rng0, req_id=rid, pos0=5,
                                 temperature=T, device="cpu")
        assert m_b >= 2, "q == p must accept"
        assert out_b[2] == out_a[0] and m_b - 2 == m_a, (out_a, out_b)
        hits += m_a == 0
    assert hits > 0, "no rejection: the residual draw was not exercised"
    keys = {sampler.request_key(rng0, rid, 7), spec.accept_key(rng0, rid, 7),
            spec.residual_key(rng0, rid, 7)}
    assert len(keys) == 3                   # the streams never alias


# --------------------------------------------------------------------------
# rollback: the allocator restored bit-exactly, as the reference's
# --------------------------------------------------------------------------

_FRAGS = []


def _frags():
    """(reference, port) prefill fragments, zero (only the allocator is
    compared)."""
    if not _FRAGS:
        _FRAGS.append(RM.init_cache(ref_smoke(ref_get("qwen3-8b")), 1, 64,
                                    dtype=jnp.float32))
        _FRAGS.append(M.init_cache(smoke_variant(get("qwen3-8b")), 1, 64,
                                   torch.float32, "cpu"))
    return _FRAGS


def _check_rollback(ps, lens, target, d, j):
    """Allocator A (port and reference) admits slots, grows the target slot
    for a (d + 1)-token verify window, advances its timeline and rolls back
    to keep j tokens; allocator B only ever allocated for the kept tokens.
    Free lists (order included), slot page lists, the page table and
    ``cur_len`` must match across all four."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    target %= len(lens)
    L0 = lens[target]
    d = min(d, 64 - 1 - L0)
    j = min(j, d + 1)
    new_len = L0 + j
    states = []
    for port in (True, False):
        for rolled in (True, False):
            pkv = (paged.PagedKVCache(cfg, 4, 64, dtype=torch.float32,
                                      device="cpu", page_size=ps,
                                      n_pages=40) if port else
                   RefPagedKVCache(ref_cfg, 4, 64, dtype=jnp.float32,
                                   page_size=ps, n_pages=40))
            cache = pkv.init_cache()
            for s, n in enumerate(lens):
                cache = pkv.admit(cache, s, _frags()[int(port)], n)
            if rolled:
                cache = pkv.ensure(cache, target, L0 + d)
                cache = _set_len(cache, target, L0 + d + 1, port)
                cache = pkv.rollback(cache, target, new_len)
            else:
                cache = pkv.ensure(cache, target, new_len - 1)
                cache = _set_len(cache, target, new_len, port)
            free = pkv._free[0]
            states.append((list(free),
                           {s: list(p) for s, p in pkv._slot_pages.items()},
                           np.asarray(cache["page_table"]).tolist(),
                           np.asarray(cache["cur_len"]).tolist()))
    assert states[0] == states[1] == states[2] == states[3]


def _set_len(cache, slot, n, port):
    if port:
        cache["cur_len"][slot] = n
        return cache
    cache = dict(cache)
    cache["cur_len"] = cache["cur_len"].at[slot].set(n)
    return cache


@pytest.mark.parametrize("ps,lens,target,d,j", [
    (4, [3], 0, 9, 1), (4, [3, 9, 17], 1, 6, 3), (8, [9, 17], 0, 9, 10),
    (16, [17, 3, 9], 2, 9, 2), (8, [3, 3, 3], 2, 0, 1),
    (4, [17, 9], 0, 7, 4), (16, [3], 0, 9, 7), (4, [9, 9, 17], 2, 8, 1)])
def test_rollback_matches_reference_allocator(ps, lens, target, d, j):
    _check_rollback(ps, lens, target, d, j)


if given is not None:
    @given(ps=st.sampled_from((4, 8, 16)),
           lens=st.lists(st.sampled_from((3, 9, 17)), min_size=1,
                         max_size=3),
           target=st.integers(0, 2), d=st.integers(0, 9),
           j=st.integers(1, 10))
    def test_rollback_matches_reference_allocator_property(ps, lens, target,
                                                           d, j):
        _check_rollback(ps, lens, target, d, j)
