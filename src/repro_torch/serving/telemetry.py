"""Serving telemetry: zero-dependency metrics registry + facade (the
reference's ``serving/telemetry.py``; host Python, the same names and the
same numbers).

The metrics half of the telemetry subsystem (the span tracer lives in
``runtime.tracing``, the Chrome-trace exporter in ``runtime.trace_export``):

  * :class:`Counter` — monotone total (requests, tokens, compile events,
    swap pages).
  * :class:`Gauge` — last-write-wins level (queue depth, pages in use);
    also tracks the peak over its lifetime, which is what the serving
    summary reports.
  * :class:`Histogram` — fixed-bucket distribution with p50/p95/p99
    estimation (TTFT, request latency, decode-step seconds).  Buckets are
    fixed at construction, so ``observe`` is O(log n_buckets) with no
    allocation — cheap enough for the engine's step loop.
  * :class:`MetricsRegistry` — get-or-create keyed store of the above;
    ``snapshot()`` serializes everything to plain dicts (what
    ``trace_export`` embeds and ``launch/serve.py --metrics-interval``
    prints).
  * :class:`Telemetry` — the bundle the engine takes: one registry plus an
    optional :class:`runtime.tracing.SpanTracer` and its request-state
    tracker.

Every metric name emitted under ``src/`` must be documented in
``docs/OBSERVABILITY.md`` (``tools/check_metrics.py``), so the port emits
the reference's names only.  Telemetry never changes engine behaviour: it
is host-side observation, reads the host clock where the engine already
holds a result, and adds no device synchronisation.
"""
from __future__ import annotations

import math
from bisect import bisect_left

from ..runtime.tracing import RequestStateTracker, SpanTracer


class Metric:
    """Base: a named instrument with a unit and a one-line description."""

    kind = "metric"

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        self.name, self.unit, self.desc = name, unit, desc

    def describe(self) -> dict:
        return {"type": self.kind, "unit": self.unit, "desc": self.desc}


class Counter(Metric):
    """Monotonically increasing total."""

    kind = "counter"

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        super().__init__(name, unit, desc)
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def describe(self) -> dict:
        return {**super().describe(), "value": self.value}


class Gauge(Metric):
    """Last-write-wins level; remembers its lifetime peak."""

    kind = "gauge"

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        super().__init__(name, unit, desc)
        self.value = 0.0
        self.peak = float("-inf")
        self.n_sets = 0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v
        self.n_sets += 1

    def describe(self) -> dict:
        return {**super().describe(), "value": self.value,
                "peak": self.peak if self.n_sets else 0.0}


class Histogram(Metric):
    """Fixed-bucket histogram with interpolated percentile estimation.

    ``edges`` are ascending bucket upper bounds; observations land in
    ``(edges[i-1], edges[i]]`` (bucket 0 is everything ``<= edges[0]``,
    the overflow bucket everything above ``edges[-1]``).  Buckets never
    grow, so memory is bounded and ``observe`` allocates nothing.
    ``percentile`` interpolates linearly inside the winning bucket,
    clamping the outermost buckets to the observed min/max — accuracy is
    one bucket width, which the default geometric edges keep at ~20%
    relative error over nine decades of seconds."""

    kind = "histogram"

    def __init__(self, name: str, edges=None, unit: str = "s",
                 desc: str = ""):
        super().__init__(name, unit, desc)
        self.edges = list(edges) if edges is not None \
            else geometric_edges(1e-5, 60.0, factor=1.2)
        if sorted(self.edges) != self.edges or len(self.edges) < 1:
            raise ValueError(f"histogram {name}: edges must be ascending")
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """Interpolated ``q``-quantile (``q`` in [0, 1])."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = self.min if i == 0 else self.edges[i - 1]
                hi = self.max if i == len(self.edges) else self.edges[i]
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                return lo + (hi - lo) * max(target - cum, 0.0) / c
            cum += c
        return self.max

    def describe(self) -> dict:
        return {**super().describe(), "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.mean if self.count else None,
                "p50": self.percentile(0.50) if self.count else None,
                "p95": self.percentile(0.95) if self.count else None,
                "p99": self.percentile(0.99) if self.count else None}


def geometric_edges(lo: float, hi: float, factor: float = 1.2) -> list:
    """Geometric bucket edges from ``lo`` up to at least ``hi``."""
    if not (lo > 0 and hi > lo and factor > 1):
        raise ValueError((lo, hi, factor))
    edges, e = [], lo
    while e < hi * factor:
        edges.append(e)
        e *= factor
    return edges


def linear_edges(lo: float, hi: float, n: int) -> list:
    """``n`` equal-width bucket edges spanning [lo, hi]."""
    step = (hi - lo) / n
    return [lo + step * (i + 1) for i in range(n)]


class MetricsRegistry:
    """Get-or-create store of named metrics.

    A name is bound to one instrument kind for the registry's lifetime;
    re-requesting it returns the same object (so call sites never need
    to thread metric handles around), and requesting it as a different
    kind raises."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, unit: str = "", desc: str = "") -> Counter:
        return self._get(Counter, name, unit=unit, desc=desc)

    def gauge(self, name: str, unit: str = "", desc: str = "") -> Gauge:
        return self._get(Gauge, name, unit=unit, desc=desc)

    def histogram(self, name: str, edges=None, unit: str = "s",
                  desc: str = "") -> Histogram:
        return self._get(Histogram, name, edges=edges, unit=unit, desc=desc)

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list:
        return sorted(self._metrics)

    def value(self, name: str, default=0):
        """Scalar value of a counter/gauge (``default`` when absent)."""
        m = self._metrics.get(name)
        return default if m is None else m.value

    def snapshot(self) -> dict:
        """JSON-safe dump of every metric (sorted by name)."""
        return {n: self._metrics[n].describe() for n in self.names()}


class Telemetry:
    """The bundle the serving engine takes: registry + optional tracer.

    ``trace=False`` keeps only the metrics registry (counters/gauges/
    histograms still collect; no per-event buffer is kept at all) —
    the cheapest always-on configuration.  With tracing on, the span
    buffer is bounded by ``trace_capacity`` events; overflow increments
    a drop counter instead of growing (``SpanTracer``)."""

    def __init__(self, registry=None, tracer=None, *, trace: bool = True,
                 trace_capacity: int = 200_000):
        self.registry = registry if registry is not None else MetricsRegistry()
        if tracer is None and trace:
            tracer = SpanTracer(capacity=trace_capacity)
        self.tracer = tracer
        self.requests = (RequestStateTracker(tracer)
                         if tracer is not None else None)


def serving_report_line(registry: MetricsRegistry) -> str:
    """One-line periodic stats report for ``launch/serve.py
    --metrics-interval`` (and anything else that wants a heartbeat)."""
    parts = []
    toks = registry.value("serving_tokens_generated_total")
    parts.append(f"tok={int(toks)}")
    fin = registry.value("serving_requests_finished_total")
    sub = registry.value("serving_requests_submitted_total")
    parts.append(f"done={int(fin)}/{int(sub)}")
    parts.append(f"q={int(registry.value('serving_queue_depth'))}")
    parts.append(f"act={int(registry.value('serving_active_slots'))}")
    h = registry.get("serving_decode_step_seconds")
    if h is not None and h.count:
        parts.append(f"step p50={h.percentile(0.5) * 1e3:.1f}ms "
                     f"p99={h.percentile(0.99) * 1e3:.1f}ms")
    t = registry.get("serving_ttft_seconds")
    if t is not None and t.count:
        parts.append(f"ttft p50={t.percentile(0.5) * 1e3:.0f}ms "
                     f"p95={t.percentile(0.95) * 1e3:.0f}ms")
    if "kvstat_pages_in_use" in registry:
        parts.append(f"pages={int(registry.value('kvstat_pages_in_use'))}")
    if "kvcache_swap_bytes_used" in registry:
        parts.append(
            f"swap={int(registry.value('kvcache_swap_bytes_used'))}B")
    npre = registry.value("serving_preempted_total")
    if npre:
        parts.append(f"preempt={int(npre)}")
    return " ".join(parts)
