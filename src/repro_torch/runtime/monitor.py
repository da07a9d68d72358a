"""Step-time tracking, straggler detection, and KV-cache accounting (the
reference's ``runtime/monitor.py``).

Host-side instrumentation (wall clock), so it works the same on the CPU and
on the card.  :class:`StragglerMonitor` keeps a per-step wall-time EWMA and
a robust z-score (median / MAD window): a step slower than ``threshold``
MADs, and at least ``min_seconds``, raises an alarm with the step's stats.
The serving engine feeds it its decode-step times and surfaces alarms
through the telemetry registry (``serving_decode_straggler_total``; see
``docs/OBSERVABILITY.md``).  :class:`KVCacheMonitor` forwards the paged
cache's per-step stats into registry gauges and reduces them to the
serving report's summary.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field


@dataclass
class StepStats:
    step: int
    seconds: float
    z: float
    is_straggler: bool


@dataclass
class StragglerMonitor:
    window: int = 50
    threshold_mads: float = 6.0
    min_samples: int = 10
    # absolute floor: a robust z over a millisecond-scale MAD flags pure
    # scheduler jitter as a straggler (observed: 5-10 ms steps alarming at
    # z=7-13 and flooding the trainer's eager-checkpoint path) — a step
    # must also be at least this slow in absolute terms to alarm
    min_seconds: float = 0.05
    ewma_alpha: float = 0.05
    _times: deque = field(default_factory=lambda: deque(maxlen=200))
    # None = no sample yet; a legitimate 0.0-second first sample (clock
    # granularity, mocked clocks) must seed the EWMA, not be mistaken
    # for "uninitialized"
    _ewma: float | None = None
    alarms: list = field(default_factory=list)

    def observe(self, dt: float, step: int) -> StepStats:
        """Record an externally measured step duration (the serving
        engine times its decode step once and feeds both this and its
        latency histogram from the same measurement)."""
        window = list(self._times)[-self.window:]
        if len(window) >= self.min_samples:
            srt = sorted(window)
            med = srt[len(srt) // 2]
            mad = sorted(abs(x - med) for x in window)[len(window) // 2]
            z = (dt - med) / max(mad, 1e-6)
        else:
            z = 0.0
        is_straggler = (len(window) >= self.min_samples
                        and z > self.threshold_mads
                        and dt >= self.min_seconds)
        self._times.append(dt)
        self._ewma = (dt if self._ewma is None
                      else (1 - self.ewma_alpha) * self._ewma
                      + self.ewma_alpha * dt)
        stats = StepStats(step=step, seconds=dt, z=z,
                          is_straggler=is_straggler)
        if is_straggler:
            self.alarms.append(stats)
        return stats

    @property
    def ewma_seconds(self) -> float:
        return 0.0 if self._ewma is None else self._ewma


# --------------------------------------------------------------------------
# KV-cache accounting (serving)
# --------------------------------------------------------------------------

#: stats keys whose per-step values are lists (per batch shard) — kept as
#: element-wise peaks inside the monitor rather than registry gauges
_LIST_KEYS = ("pages_in_use_per_shard", "free_pages_per_shard",
              "swap_bytes_per_shard")

#: forwarded-gauge namespace: every scalar stats key ``k`` recorded by the
#: engine lands in the registry as gauge ``kvstat_<k>`` (enumerated in
#: docs/OBSERVABILITY.md)
STAT_PREFIX = "kvstat_"


class KVCacheMonitor:
    """Per-step KV-cache accounting as a thin consumer of the telemetry
    metrics registry.

    The engine records ``PagedKVCache.stats()`` (merged with the
    scheduler's counters) after every step; instead of keeping its own
    list-of-dicts trace, the monitor forwards every scalar stat into a
    registry gauge named ``kvstat_<key>`` (gauges track last value +
    lifetime peak), keeps element-wise peaks for the per-shard list
    stats, and tracks the one correlated pair the summary needs (cold
    bytes at the step holding the most cold data — a ratio of maxima
    taken at different steps would be fictional).

    ``summary()`` reduces that to the numbers the serving report
    prints: peak/mean paged bytes vs the monolithic ``(B, max_len)``
    cache, the cold-page compression ratio, swap traffic and preemption
    counts.  Every key is read with a default, so a monitor shared
    across mixed engines (some without a swap tier or chunked prefill)
    summarizes what it saw instead of raising ``KeyError``.

    Pass the engine's ``Telemetry.registry`` to publish into the shared
    registry; by default the monitor owns a private one."""

    def __init__(self, registry=None):
        if registry is None:
            from ..serving.telemetry import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self.n_samples = 0
        self._keys: set = set()             # scalar stat keys ever seen
        self._shard_peaks: dict = {}        # list-key -> per-shard peaks
        self._cold_peak = (0, 0)            # (raw-equiv bytes, ragged bytes)

    def record(self, stats: dict) -> None:
        self.n_samples += 1
        reg = self.registry
        for k, v in stats.items():
            if k in _LIST_KEYS or isinstance(v, (list, tuple)):
                peaks = self._shard_peaks.setdefault(k, [])
                for i, x in enumerate(v):
                    if i >= len(peaks):
                        peaks.append(x)
                    elif x > peaks[i]:
                        peaks[i] = x
            elif isinstance(v, (int, float)):
                self._keys.add(k)
                reg.gauge(STAT_PREFIX + k).set(v)
        # derived, correlated stats: total pages this step, and the cold
        # ratio at the step holding the most cold data
        total = (stats.get("pages_in_use", 0)
                 + stats.get("cold_pages_in_use", 0))
        reg.gauge(STAT_PREFIX + "pages_in_use_total").set(total)
        cold_raw = (stats.get("cold_pages_in_use", 0)
                    * stats.get("page_bytes", 0))
        if cold_raw > self._cold_peak[0]:
            self._cold_peak = (cold_raw, stats.get("cold_bytes_ragged", 0))

    # -- registry readers --------------------------------------------------

    def _peak(self, key: str, default=0):
        g = self.registry.get(STAT_PREFIX + key)
        return default if g is None or not g.n_sets else g.peak

    def _last(self, key: str, default=0):
        g = self.registry.get(STAT_PREFIX + key)
        return default if g is None or not g.n_sets else g.value

    def peak_per_shard(self, key: str = "pages_in_use_per_shard") -> list:
        """Element-wise peak of a per-shard list stat (empty when the
        engine never reported it)."""
        return list(self._shard_peaks.get(key, ()))

    @property
    def peak_paged_bytes(self) -> int:
        return self._peak("cache_bytes_paged")

    @property
    def peak_raw_equiv_bytes(self) -> int:
        return self._peak("cache_bytes_raw_equiv")

    def summary(self) -> dict:
        if not self.n_samples:
            return {}
        mono = self._last("monolithic_bytes")
        peak = self.peak_paged_bytes
        cold_raw, cold_ragged = self._cold_peak
        out = {
            "steps": self.n_samples,
            "monolithic_bytes": mono,
            "peak_paged_bytes": peak,
            "peak_raw_equiv_bytes": self.peak_raw_equiv_bytes,
            "peak_pages_in_use": self._peak("pages_in_use_total"),
            "paged_vs_monolithic": peak / max(mono, 1),
            "cold_compression_ratio": (cold_ragged / cold_raw
                                       if cold_raw else math.nan),
        }
        if "swap_bytes_used" in self._keys:     # swap tier attached
            out.update({
                "peak_swap_bytes": self._peak("swap_bytes_used"),
                "peak_swapped_pages": self._peak("swapped_pages"),
                "swap_out_bytes_total": self._last("swap_out_bytes_total"),
                "swap_in_bytes_total": self._last("swap_in_bytes_total"),
                "n_preempted": self._last("n_preempted"),
                "n_resumed": self._last("n_resumed"),
            })
        if "n_prefill_chunks" in self._keys:    # chunked prefill active
            out.update({
                "n_prefill_chunks": self._last("n_prefill_chunks"),
                "prefill_chunk_tokens": self._last("prefill_chunk_tokens"),
                "n_interleaved_steps": self._last("n_interleaved_steps"),
                "peak_prefilling_slots": self._peak("prefilling_slots"),
            })
        return out
