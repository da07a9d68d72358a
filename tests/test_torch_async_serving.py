"""The port's async front end and router against the JAX package.

The reference's eleven tests of ``tests/test_async_serving.py`` on the
port's engine: token streams flushed by ``AsyncServingFrontend`` are
identical to a synchronous ``GenerationEngine.run()`` of the same requests,
under whole-request preemption, under prefix sharing and across two
replicas behind the least-loaded router; streaming, both shed policies,
``close``, prefix affinity, deterministic placement and the metrics.  Then
three checks across the packages: ``launch/load_replay.py::build_trace``
is the reference's numpy stream, and on the reference's load-replay
configuration the port's placements, shed set and greedy streams equal the
reference front end's over reference engines (on the same converted
weights).

Tests run the driver with ``asyncio.run``; where a test needs concurrent
consumption it spawns ``frontend.run()`` as a task inside one loop.
"""
import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import load_replay as ref_replay  # noqa: E402
from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import AsyncServingFrontend as RefFrontend  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import __all__ as ref_all  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.launch import load_replay  # noqa: E402
from repro_torch.runtime.monitor import KVCacheMonitor  # noqa: E402
from repro_torch.serving import (AsyncServingFrontend, EngineConfig,  # noqa: E402
                                 FrontendClosed, FrontendOverloaded,
                                 GenerationEngine, Request, Router,
                                 Telemetry)


@pytest.fixture(scope="module")
def world():
    """The reference's smoke qwen3 weights, in both packages."""
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = smoke_variant(get("qwen3-8b"))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return params, cfg, ref_params, ref_cfg


def _engine(params, cfg, ecfg):
    return GenerationEngine(params, cfg, config=ecfg, device="cpu")


def _requests(id_base=8_000, n=5):
    return [Request(prompt=[i + 1] * (3 + i % 4), max_new_tokens=4 + i % 3,
                    priority=i % 2, id=id_base + i) for i in range(n)]


def _sync_reference(params, cfg, ecfg, reqs):
    """Serve clones of ``reqs`` (same ids => same sampling keys) on one
    synchronous engine; returns {id: out_tokens}."""
    eng = _engine(params, cfg, ecfg)
    clones = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                      priority=r.priority, id=r.id) for r in reqs]
    for r in clones:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in clones)
    return {r.id: r.out_tokens for r in clones}


def _serve_async(params, cfg, ecfg, reqs, *, n_replicas=1, **fe_kw):
    """Submit all of ``reqs`` up front, drain, return {id: stream}."""
    replicas = [_engine(params, cfg, ecfg) for _ in range(n_replicas)]
    fe = AsyncServingFrontend(replicas, **fe_kw)

    async def go():
        streams = {r.id: fe.submit_nowait(r) for r in reqs}
        await fe.drain()
        return streams

    return asyncio.run(go()), fe


def test_async_stream_bit_identical_to_sync(world):
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=2, max_len=48)
    reqs = _requests()
    ref = _sync_reference(params, cfg, ecfg, reqs)
    streams, fe = _serve_async(params, cfg, ecfg, reqs)
    assert fe.n_completed == len(reqs) and fe.n_shed == 0
    for r in reqs:
        assert r.done and streams[r.id].finished
        assert streams[r.id].tokens == r.out_tokens == ref[r.id], r.id


def test_async_bit_identical_under_preemption(world):
    """The differential holds through eviction and whole-request
    preemption: the front end over the reference's oversubscribed
    swap-tier configuration streams the same tokens as the monolithic
    synchronous engine."""
    from test_serving import _OVERSUB, _OVERSUB_WL
    params, cfg = world[:2]
    prompts, news, prios = _OVERSUB_WL
    reqs = [Request(prompt=p, max_new_tokens=n, priority=pr, id=8_100 + i)
            for i, (p, n, pr) in enumerate(zip(prompts, news, prios))]
    ref = _sync_reference(
        params, cfg, EngineConfig(max_batch=2, max_len=48,
                                  cache_mode="monolithic"), reqs)
    mon = KVCacheMonitor()
    ecfg = EngineConfig(max_batch=2, max_len=48, kv_monitor=mon, **_OVERSUB)
    streams, _ = _serve_async(params, cfg, ecfg, reqs)
    assert mon.summary()["n_preempted"] > 0      # preemption really fired
    for r in reqs:
        assert streams[r.id].tokens == ref[r.id], r.id


def test_async_bit_identical_with_prefix_sharing(world):
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=3, max_len=64, prefill_chunk=8,
                        prefix_sharing=True)
    system = [7] * 16
    reqs = [Request(prompt=system + [i + 1] * 3, max_new_tokens=4,
                    id=8_200 + i) for i in range(4)]
    ref = _sync_reference(params, cfg, ecfg, reqs)
    tel = Telemetry(trace=False)
    streams, _ = _serve_async(params, cfg,
                              dataclasses.replace(ecfg, telemetry=tel),
                              reqs, telemetry=tel)
    assert tel.registry.value("prefix_hit_total") > 0
    for r in reqs:
        assert streams[r.id].tokens == ref[r.id], r.id


def test_two_replicas_bit_identical_and_balanced(world):
    """Replica placement cannot change tokens (shared rng_seed), and the
    least-loaded router uses both replicas."""
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=2, max_len=48)
    reqs = _requests(id_base=8_300, n=6)
    ref = _sync_reference(params, cfg, ecfg, reqs)
    streams, fe = _serve_async(params, cfg, ecfg, reqs, n_replicas=2)
    for r in reqs:
        assert streams[r.id].tokens == ref[r.id], r.id
    used = {idx for _, idx, _ in fe.router.placements}
    assert used == {0, 1}, fe.router.placements


def test_streaming_consumer_sees_tokens_incrementally(world):
    """``async for`` over a stream while ``run()`` drives in the
    background yields every token in order and terminates."""
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=2, max_len=48)
    req = Request(prompt=[1, 2, 3], max_new_tokens=5, id=8_400)
    ref = _sync_reference(params, cfg, ecfg, [req])

    async def go():
        fe = AsyncServingFrontend(_engine(params, cfg, ecfg))
        driver = asyncio.create_task(fe.run())
        stream = await fe.submit(req)
        got = [tok async for tok in stream]
        await fe.close()
        await driver
        return got

    assert asyncio.run(go()) == ref[req.id]


def test_backpressure_reject(world):
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=2, max_len=48)
    fe = AsyncServingFrontend(_engine(params, cfg, ecfg), max_pending=2,
                              shed_policy="reject")
    a, b = _requests(id_base=8_500, n=2)
    fe.submit_nowait(a), fe.submit_nowait(b)
    with pytest.raises(FrontendOverloaded):
        fe.submit_nowait(Request(prompt=[9], max_new_tokens=2, id=8_510))
    assert fe.n_shed == 1
    asyncio.run(fe.drain())
    assert a.done and b.done


def test_backpressure_drop_lowest(world):
    """A full queue under ``drop-lowest``: a higher-priority newcomer
    evicts the lowest-priority queued request (latest arrival within the
    class); a lowest-or-equal newcomer is itself shed."""
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=1, max_len=48)
    fe = AsyncServingFrontend(_engine(params, cfg, ecfg), max_pending=2,
                              shed_policy="drop-lowest")
    lo1 = Request(prompt=[1], max_new_tokens=2, priority=0, id=8_600)
    lo2 = Request(prompt=[2], max_new_tokens=2, priority=0, id=8_601)
    s_lo1, s_lo2 = fe.submit_nowait(lo1), fe.submit_nowait(lo2)

    # equal priority: the newcomer is the victim, stream pre-terminated
    eq = Request(prompt=[3], max_new_tokens=2, priority=0, id=8_602)
    s_eq = fe.submit_nowait(eq)
    assert s_eq.shed and s_eq.finished and fe.n_shed == 1

    # higher priority: sheds the latest-queued lowest-priority request
    hi = Request(prompt=[4], max_new_tokens=2, priority=2, id=8_603)
    s_hi = fe.submit_nowait(hi)
    assert s_lo2.shed and not s_hi.shed and fe.n_shed == 2

    asyncio.run(fe.drain())
    assert lo1.done and hi.done and not lo2.done
    assert s_lo1.tokens == lo1.out_tokens
    assert s_hi.tokens == hi.out_tokens


def test_close_semantics(world):
    """``close(drain=False)`` sheds the queue but finishes in-flight
    work; submissions after close raise ``FrontendClosed``."""
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=1, max_len=48)

    async def go():
        fe = AsyncServingFrontend(_engine(params, cfg, ecfg), max_pending=8)
        reqs = _requests(id_base=8_700, n=4)
        streams = {r.id: fe.submit_nowait(r) for r in reqs}
        await fe.step()                      # admits up to the backlog cap
        await fe.close(drain=False)
        with pytest.raises(FrontendClosed):
            fe.submit_nowait(Request(prompt=[1], max_new_tokens=1, id=8_710))
        return fe, reqs, streams

    fe, reqs, streams = asyncio.run(go())
    assert fe.n_shed > 0 and fe.n_completed > 0
    assert fe.n_shed + fe.n_completed == len(reqs)
    for r in reqs:
        s = streams[r.id]
        assert s.finished and (s.shed or (r.done and s.tokens == r.out_tokens))


def test_router_prefix_affinity(world):
    """A request sharing a served prefix routes to the replica holding it
    even when that replica is busier."""
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=3, max_len=64, prefill_chunk=8,
                        prefix_sharing=True)
    replicas = [_engine(params, cfg, ecfg) for _ in range(2)]
    router = Router(replicas)
    system = [5] * 16
    warm = Request(prompt=system + [1, 2], max_new_tokens=2, id=8_800)
    router.submit_to(1, warm, reason="warm")     # replica 1 owns the prefix
    replicas[1].run()
    assert replicas[1].prefix_match_tokens(system + [9]) > 0
    # replica 1 is also the busier one -> affinity must win over load
    router.submit_to(1, Request(prompt=[3], max_new_tokens=8, id=8_801),
                     reason="fill")
    idx, reason = router.place(
        Request(prompt=system + [4], max_new_tokens=2, id=8_802))
    assert (idx, reason) == (1, "prefix-affinity")
    # no shared prefix -> plain least-loaded (replica 0 is idle)
    idx, reason = router.place(
        Request(prompt=[6, 7], max_new_tokens=2, id=8_803))
    assert (idx, reason) == (0, "least-loaded")


def test_router_placement_deterministic_under_seeded_trace(world):
    """The seeded bursty trace replayed twice through identical fleets
    produces identical placements and identical shed sets: front-end
    decisions are functions of tick state, never of the wall clock."""
    params, cfg = world[:2]
    ecfg = EngineConfig(max_batch=2, max_len=64, prefill_chunk=8,
                        prefix_sharing=True)
    trace = load_replay.build_trace(seed=3, n_requests=12,
                                    vocab=cfg.vocab_size)

    def once():
        fe = AsyncServingFrontend(
            [_engine(params, cfg, ecfg) for _ in range(2)],
            max_pending=4, shed_policy="reject")
        streams, _ = asyncio.run(load_replay.replay(fe, trace))
        shed = [i for i, s in enumerate(streams) if s is None]
        toks = [s.tokens for s in streams if s is not None]
        return list(fe.router.placements), shed, toks

    p1, shed1, t1 = once()
    p2, shed2, t2 = once()
    assert p1 == p2 and shed1 == shed2 and t1 == t2
    assert len(p1) + len(shed1) == len(trace)


def test_frontend_metrics_published(world):
    """frontend_* / router_* metrics land in the shared registry."""
    params, cfg = world[:2]
    tel = Telemetry(trace=False)
    ecfg = EngineConfig(max_batch=2, max_len=48, telemetry=tel)
    reqs = _requests(id_base=8_900, n=3)
    streams, fe = _serve_async(params, cfg, ecfg, reqs, n_replicas=2,
                               telemetry=tel)
    reg = tel.registry
    assert reg.value("frontend_requests_total") == 3
    assert reg.value("frontend_completed_total") == 3
    assert reg.value("frontend_stream_tokens_total") == \
        sum(len(s.tokens) for s in streams.values())
    assert reg.value("router_placements_total") == 3
    assert reg.value("frontend_queue_depth") == 0
    assert reg.get("frontend_stream_ttft_seconds").count == 3
    assert reg.value("router_replica0_load") == 0
    assert reg.value("router_replica1_load") == 0


# -- across the packages ----------------------------------------------------

def test_public_serving_api_is_the_references():
    assert serving.__all__ == list(ref_all)
    assert all(hasattr(serving, name) for name in serving.__all__)


@pytest.mark.parametrize("seed,n,vocab", [(0, 24, 512), (3, 12, 512),
                                          (7, 40, 151_936)])
def test_build_trace_equals_the_references(seed, n, vocab):
    assert load_replay.build_trace(seed, n, vocab) == \
        ref_replay.build_trace(seed, n, vocab)


@pytest.fixture(scope="module")
def replays(world):
    """The reference's load-replay configuration (two replicas,
    ``max_pending`` 6, ``reject``) on its seed-0 trace, through the
    reference's front end over reference engines and through the port's
    over the port's, on the same weights."""
    params, cfg, ref_params, ref_cfg = world
    trace = load_replay.build_trace(seed=0, vocab=cfg.vocab_size)
    ecfg = load_replay.engine_config()
    ref_ecfg = RefEngineConfig(max_batch=3, max_len=64, prefill_chunk=8,
                               prefix_sharing=True)
    ref_fe = RefFrontend([RefEngine(ref_params, ref_cfg, config=ref_ecfg)
                          for _ in range(2)], max_pending=6,
                         shed_policy="reject")
    ref_streams, _ = asyncio.run(ref_replay.replay(ref_fe, trace))
    fe = AsyncServingFrontend([_engine(params, cfg, ecfg)
                               for _ in range(2)], max_pending=6,
                              shed_policy="reject")
    streams, _ = asyncio.run(load_replay.replay(fe, trace))
    return (ref_fe, ref_streams), (fe, streams)


def test_placements_and_sheds_equal_the_references(replays):
    (ref_fe, ref_streams), (fe, streams) = replays
    assert fe.router.placements == ref_fe.router.placements
    assert [s is None for s in streams] == [s is None for s in ref_streams]
    assert any(s is None for s in streams)          # the burst sheds
    assert {r for _, _, r in fe.router.placements} == {
        "least-loaded", "prefix-affinity"}


def test_greedy_streams_equal_the_references(replays):
    (_, ref_streams), (_, streams) = replays
    got = [s.tokens for s in streams if s is not None]
    want = [s.tokens for s in ref_streams if s is not None]
    assert got == want and all(got)
