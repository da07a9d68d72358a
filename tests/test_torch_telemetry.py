"""The port's serving telemetry against the JAX package's: the metrics
registry (histogram percentiles, gauges, kind conflicts), the span tracer
and request-state tracker, the straggler and KV-cache monitors give the
reference's outputs on the same inputs; the engine's tokens are identical
with telemetry on and off, and its counters equal the reference engine's on
the same workloads; an oversubscribed run's Chrome trace validates; the
``torch.profiler`` hook writes a trace on the CPU; ``launch/serve.py``
serves a shared-prefix chat stream with telemetry and a trace file."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime import monitor as ref_monitor  # noqa: E402
from repro.runtime import trace_export as ref_export  # noqa: E402
from repro.runtime import tracing as ref_tracing  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import telemetry as ref_tel  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.runtime import monitor, trace_export, tracing  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine, \
    Request  # noqa: E402
from repro_torch.serving import telemetry as tel  # noqa: E402


@pytest.fixture
def pallas_store(monkeypatch):
    """The reference's swap faults decode through its Pallas page kernel,
    which writes with ``pl.store`` (dropped by newer JAX releases);
    assigning through the ref is the same write."""
    if not hasattr(pl, "store"):
        def store(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", store, raising=False)


@pytest.fixture(scope="module")
def raw_weights():
    """The reference's f32 smoke weights and their conversion."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


# --------------------------------------------------------------------------
# host classes: the same outputs on the same inputs
# --------------------------------------------------------------------------

def _samples(kind):
    rng = np.random.default_rng(7)
    if kind == "linear":
        return rng.uniform(0.0, 1.0, 2_000), dict(
            edges_fn="linear_edges", args=(0.0, 1.0, 500))
    if kind == "geometric":
        return np.exp(rng.normal(-4.0, 1.0, 5_000)), dict(edges_fn=None)
    # edge cases: one overflow sample, then one underflow sample
    return np.array([5.0, 0.25]), dict(edges=[1.0, 2.0])


@pytest.mark.parametrize("kind", ["linear", "geometric", "edges"])
def test_histogram_matches_reference(kind):
    xs, spec = _samples(kind)
    hists = []
    for mod in (tel, ref_tel):
        if spec.get("edges_fn"):
            edges = getattr(mod, spec["edges_fn"])(*spec["args"])
        else:
            edges = spec.get("edges")
        h = mod.Histogram("t", edges=edges)
        empty = (h.percentile(0.5), h.mean)
        for x in xs:
            h.observe(float(x))
        hists.append((empty, h.describe(),
                      [h.percentile(q) for q in (0.0, 0.5, 0.95, 0.99, 1.0)]))
    (e_got, got, p_got), (e_want, want, p_want) = hists
    assert all(math.isnan(v) for v in e_got + e_want)
    assert got == want and p_got == p_want
    assert tel.geometric_edges(1e-5, 60.0) == \
        ref_tel.geometric_edges(1e-5, 60.0)
    with pytest.raises(ValueError):
        tel.Histogram("bad", edges=[2.0, 1.0])


def test_registry_and_report_line_match_reference():
    out = []
    for mod in (tel, ref_tel):
        reg = mod.MetricsRegistry()
        c = reg.counter("serving_tokens_generated_total", unit="tok")
        c.inc(3)
        assert reg.counter("serving_tokens_generated_total") is c
        g = reg.gauge("serving_queue_depth")
        g.set(5.0)
        g.set(2.0)
        reg.histogram("serving_ttft_seconds").observe(0.012)
        reg.histogram("serving_decode_step_seconds").observe(0.1)
        reg.counter("serving_preempted_total").inc()
        with pytest.raises(TypeError):
            reg.gauge("serving_tokens_generated_total")
        assert "serving_queue_depth" in reg and reg.get("missing") is None
        out.append((reg.snapshot(), mod.serving_report_line(reg),
                    reg.names(), reg.value("missing", 7)))
    assert out[0] == out[1]
    json.dumps(out[0][0])


def _tracer_events(mod_tracing):
    t = [0.0]
    tr = mod_tracing.SpanTracer(capacity=9, clock=lambda: t[0])
    rs = mod_tracing.RequestStateTracker(tr)
    for rid in (1, 2):
        rs.transition(rid, "queued")
    t[0] = 1.0
    rs.transition(1, "prefilling", args={"slot": 0})
    with tr.span("engine", "decode_step", args={"step": 1}):
        t[0] = 1.5
    tr.counter("serving_queue_depth", 3)
    t[0] = 2.0
    rs.transition(1, "decoding")
    t[0] = 3.0
    rs.finish(1)
    rs.finish(2)
    for i in range(5):                       # past the capacity: dropped
        tr.instant("engine", f"e{i}")
    return tr, rs


def test_tracer_and_request_tracker_match_reference():
    """The same event tuples, the same drop count, the same open states and
    the same exported Chrome trace from the same calls."""
    (tr, rs), (rtr, rrs) = (_tracer_events(tracing),
                            _tracer_events(ref_tracing))
    assert tr.events == rtr.events and len(tr) == 9
    assert tr.n_dropped == rtr.n_dropped == 4
    assert rs.open_states == rrs.open_states == {}
    assert tracing.request_track(7) == ref_tracing.request_track(7)
    got = trace_export.build_trace(tr)
    assert got == ref_export.build_trace(rtr)
    assert trace_export.validate_chrome_trace(got) == []
    assert trace_export.validate_chrome_trace({"x": 1}) == \
        ref_export.validate_chrome_trace({"x": 1})


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(1)
    times = [0.0, 1.0] + list(0.01 + 0.001 * rng.random(30)) + [10.0, 0.02]
    out = []
    for mod in (monitor, ref_monitor):
        m = mod.StragglerMonitor(ewma_alpha=0.05)
        stats = [m.observe(float(dt), i) for i, dt in enumerate(times)]
        out.append(([(s.step, s.seconds, s.z, s.is_straggler)
                     for s in stats], m.ewma_seconds,
                    [a.step for a in m.alarms]))
    assert out[0] == out[1]
    assert out[0][2] == [32]                    # the 10 s step alarms


def test_kvcache_monitor_matches_reference():
    """Mixed stats (with and without a swap tier and chunked prefill, list
    stats per shard): the same registry snapshot and summary."""
    records = [
        {"pages_in_use": 4, "cold_pages_in_use": 1, "page_bytes": 100,
         "cache_bytes_paged": 500, "cache_bytes_raw_equiv": 600,
         "monolithic_bytes": 1000, "cold_bytes_ragged": 60,
         "pages_in_use_per_shard": [3, 1]},
        {"pages_in_use": 2, "swap_bytes_used": 7, "swap_out_bytes_total": 7,
         "swap_in_bytes_total": 0, "n_preempted": 1, "n_resumed": 0,
         "pages_in_use_per_shard": [1, 4], "n_prefill_chunks": 3,
         "prefill_chunk_tokens": 24, "n_interleaved_steps": 2,
         "prefilling_slots": 1, "prefix_shared_pages": 2}]
    out = []
    for mod, tmod in ((monitor, tel), (ref_monitor, ref_tel)):
        mon = mod.KVCacheMonitor(registry=tmod.MetricsRegistry())
        empty = mon.summary()
        for r in records:
            mon.record(r)
        out.append((empty, mon.summary(), mon.registry.snapshot(),
                    mon.peak_per_shard(), mon.n_samples))
    assert out[0] == out[1]
    assert out[0][1]["peak_swap_bytes"] == 7 and out[0][3] == [3, 4]
    assert monitor.KVCacheMonitor().summary() == {}


# --------------------------------------------------------------------------
# the engine with telemetry: tokens unchanged, the reference's counters
# --------------------------------------------------------------------------

# tests/test_serving.py:175's oversubscribed configuration and workload
_OVERSUB = dict(page_size=8, n_pages=5, compress_cold=True, n_cold_slots=1,
                swap_bytes=1 << 28)
_OVERSUB_WL = ([[i + 1] * (7 + 3 * (i % 3)) for i in range(6)],
               [14, 10, 16, 9, 12, 11], [0, 1, 0, 2, 1, 0])


def _oversub(Req):
    prompts, news, prios = _OVERSUB_WL
    return [Req(prompt=p, max_new_tokens=n, priority=pr, id=9_200 + i)
            for i, (p, n, pr) in enumerate(zip(prompts, news, prios))]


def _chat(Req):
    prefix = list(range(1, 17))
    return [Req(prompt=prefix + [40 + i, 50 + i][: 1 + i % 2],
                max_new_tokens=5, id=9_300 + i) for i in range(5)]


# name -> (workload, engine settings)
_WORKLOADS = {
    "oversubscribed-chunked": (_oversub, dict(max_batch=2, max_len=48,
                                              prefill_chunk=4, **_OVERSUB)),
    "chat-prefix-sharing": (_chat, dict(max_batch=3, max_len=64, page_size=8,
                                        prefill_chunk=8,
                                        prefix_sharing=True)),
}
_COUNTERS = ("serving_requests_submitted_total",
             "serving_requests_finished_total",
             "serving_tokens_generated_total", "prefix_hit_total",
             "prefix_miss_total", "prefix_match_tokens_total",
             "serving_preempted_total", "serving_resumed_total",
             "kvcache_evict_pages_total", "kvcache_fault_pages_total")


def _serve(Eng, Cfg, Req, params, cfg, make, kw, telemetry=None):
    reqs = make(Req)
    eng = Eng(params, cfg, config=Cfg(**kw, telemetry=telemetry),
              **({"device": "cpu"} if Eng is GenerationEngine else {}))
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("workload", list(_WORKLOADS))
def test_telemetry_on_off_tokens_and_reference_counters(raw_weights,
                                                        workload,
                                                        pallas_store):
    """Tokens are identical with telemetry fully on (registry + tracer)
    and off, equal the reference engine's, and the registry's counters
    (requests, tokens, prefix hits / misses / matched tokens, preemptions,
    evicted and faulted pages) equal the reference registry's."""
    cfg, ref_cfg, ref_params, params = raw_weights
    make, kw = _WORKLOADS[workload]
    bare, _ = _serve(GenerationEngine, EngineConfig, Request, params, cfg,
                     make, kw)
    t = tel.Telemetry()
    instr, eng = _serve(GenerationEngine, EngineConfig, Request, params,
                        cfg, make, kw, telemetry=t)
    rt = ref_tel.Telemetry()
    ref, _ = _serve(RefEngine, RefEngineConfig, RefRequest, ref_params,
                    ref_cfg, make, kw, telemetry=rt)
    assert instr == bare == ref
    reg, rreg = t.registry, rt.registry
    assert {n: reg.value(n) for n in _COUNTERS} == \
        {n: rreg.value(n) for n in _COUNTERS}
    assert reg.value("serving_tokens_generated_total") == \
        sum(map(len, bare))
    for n in ("serving_ttft_seconds", "serving_request_latency_seconds",
              "serving_queue_wait_seconds", "serving_decode_step_seconds",
              "serving_prefill_chunk_seconds"):
        assert reg.get(n).count == rreg.get(n).count, n
    assert reg.get("serving_ttft_seconds").min > 0
    assert reg.get("serving_decode_step_seconds").count == eng.steps
    # gauge peaks the registry keeps (levels sampled at the same points)
    for n in ("serving_queue_depth", "serving_active_slots",
              "kvstat_pages_in_use", "prefix_shared_pages"):
        assert (n in reg) == (n in rreg), n
        if n in reg:
            assert reg.get(n).peak == rreg.get(n).peak, n
    # no kernel is built on the CPU: the compile counters stay at 0
    assert reg.value("serving_decode_compile_total") == 0
    assert reg.value("serving_prefill_compile_total") == 0
    assert t.requests.open_states == {}
    assert tel.serving_report_line(reg)
    if workload.startswith("oversubscribed"):
        assert reg.value("serving_preempted_total") > 0
        assert reg.value("kvcache_fault_pages_total") > 0
    else:
        assert reg.value("prefix_hit_total") > 0


def test_oversubscribed_trace_export_round_trip(raw_weights, tmp_path):
    """An oversubscribed run's exported Chrome trace validates, round-trips
    through JSON, and carries the preempt / resume pair, the evict and
    fault spans and a row per request."""
    cfg, _, _, params = raw_weights
    t = tel.Telemetry()
    _, eng = _serve(GenerationEngine, EngineConfig, Request, params, cfg,
                    _oversub, dict(max_batch=2, max_len=48, **_OVERSUB),
                    telemetry=t)
    assert eng.scheduler.n_preempted > 0
    path = tmp_path / "trace.json"
    trace = trace_export.export_chrome_trace(t.tracer, str(path),
                                             t.registry)
    assert trace_export.validate_chrome_trace(trace) == []
    loaded = json.loads(path.read_text())
    assert trace_export.validate_chrome_trace(loaded) == []
    assert loaded == trace
    evs = loaded["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"preempted", "resume", "preempt", "evict", "fault",
            "decode_step", "finished"} <= names
    assert {"engine", "swap", "request"} <= \
        {e.get("cat") for e in evs if e["ph"] == "X"}
    assert {e["tid"] for e in evs if e["pid"] == 2 and e["ph"] != "M"} == \
        {9_200 + i for i in range(6)}
    assert {"serving_queue_depth", "kvcache_pages_in_use"} <= \
        {e["name"] for e in evs if e["ph"] == "C"}
    metrics = loaded["otherData"]["metrics"]
    assert metrics["serving_resumed_total"]["value"] > 0
    assert loaded["otherData"]["n_dropped_events"] == 0


def test_metrics_only_mode_keeps_no_event_buffer(raw_weights):
    cfg, _, _, params = raw_weights
    t = tel.Telemetry(trace=False)
    assert t.tracer is None and t.requests is None
    _serve(GenerationEngine, EngineConfig, Request, params, cfg, _chat,
           dict(max_batch=2, max_len=48), telemetry=t)
    assert t.registry.get("serving_ttft_seconds").count == 5


def test_torch_profiler_hook_writes_a_trace(raw_weights, tmp_path):
    """The hook captures engine steps 1-3 (a two-step window) on the CPU
    and writes a Chrome trace there."""
    cfg, _, _, params = raw_weights
    hook = tracing.TorchProfilerHook(str(tmp_path / "prof"), 1, 3)
    steps = []
    eng = GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=2, max_len=48), device="cpu")
    for r in _chat(Request):
        eng.submit(r)

    def on_step(i):
        steps.append((i, hook.active))
        hook.on_step(i)

    eng.run(on_step=on_step)
    hook.close()
    assert steps[:4] == [(0, False), (1, False), (2, True), (3, True)]
    assert hook.done and not hook.active
    trace = json.loads(open(hook.trace_path).read())
    assert trace["traceEvents"]


def test_serve_cli_prefix_sharing_with_trace(tmp_path, capsys):
    """``launch/serve.py`` on the CPU: a shared system prompt hits the
    prefix index, the report prints the reference's lines, and the trace
    file validates."""
    from repro_torch.launch import serve
    out = tmp_path / "trace.json"
    serve.main(["--smoke", "--device", "cpu", "--compress", "none",
                "--requests", "6", "--max-batch", "3", "--max-new", "4",
                "--max-len", "96", "--page-size", "8", "--prefill-chunk",
                "8", "--prefix-sharing", "--shared-prefix", "24",
                "--trace-out", str(out), "--metrics-interval", "5"])
    text = capsys.readouterr().out
    line = next(ln for ln in text.splitlines() if "prefix sharing:" in ln)
    assert int(line.split("prefix sharing: ")[1].split()[0]) > 0, line
    for frag in ("step 5: tok=", "ttft p50/p95/p99", "kv-cache (paged",
                 "0 CoW splits"):
        assert frag in text, frag
    assert trace_export.validate_chrome_trace(
        json.loads(out.read_text())) == []
