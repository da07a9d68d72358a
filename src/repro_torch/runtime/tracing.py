"""Per-request span tracing for the serving engine (host wall-clock; the
reference's ``runtime/tracing.py``, with a ``torch.profiler`` hook in place
of its ``jax.profiler`` one).

The tracing half of the telemetry subsystem (metrics live in
``serving.telemetry``; the Chrome-trace/Perfetto JSON exporter in
``runtime.trace_export``).  The engine records every lifecycle
transition it already performs — submit -> admitted -> prefilling (per
chunk) -> decoding -> preempted/resumed -> finished — as **state spans**
on a per-request track, plus **engine-phase spans** (prefill phase,
decode step, evict/fault a.k.a. host<->device swap, preempt/resume) on
the engine track, and per-step counter samples (queue depth, pages in
use) that render as counter tracks in Perfetto.

Design constraints (the tracer runs inside the serving step loop):

  * **bounded**: the event buffer is capped at ``capacity``; overflow
    bumps ``n_dropped`` instead of growing — a runaway run degrades to
    a truncated trace, never to unbounded host memory;
  * **cheap**: an event is one small tuple append; timestamps are raw
    ``perf_counter`` floats (exported to microseconds only at dump
    time); nothing is formatted or serialized until export.  There is
    no per-token work at all — events are per step / per transition.

Event tuples are ``(ph, cat, name, track, ts, dur, args)`` with ``ph``
one of ``"X"`` (complete span), ``"I"`` (instant), ``"C"`` (counter
sample; ``args`` is the numeric value).  ``track`` is a string:
``"engine"`` (engine-phase rows) or ``"req:<id>"`` (one row per
request).  ``runtime.trace_export`` maps tracks to Chrome-trace
pid/tid pairs.
"""
from __future__ import annotations

import os
import time
import warnings
from contextlib import contextmanager

ENGINE_TRACK = "engine"


def request_track(rid) -> str:
    return f"req:{rid}"


class SpanTracer:
    """Bounded host-side event buffer (see module docstring)."""

    def __init__(self, capacity: int = 200_000, clock=time.perf_counter):
        self._clock = clock
        self.capacity = capacity
        self.events: list[tuple] = []
        self.n_dropped = 0
        self.t0 = clock()

    def __len__(self) -> int:
        return len(self.events)

    def now(self) -> float:
        return self._clock()

    def _push(self, ev: tuple) -> None:
        if len(self.events) >= self.capacity:
            self.n_dropped += 1
            return
        self.events.append(ev)

    def complete(self, cat: str, name: str, track: str, t_start: float,
                 t_end: float | None = None, args: dict | None = None):
        """Record a finished span [t_start, t_end] (end defaults to now)."""
        if t_end is None:
            t_end = self._clock()
        self._push(("X", cat, name, track, t_start,
                    max(t_end - t_start, 0.0), args))

    def instant(self, cat: str, name: str, track: str = ENGINE_TRACK,
                args: dict | None = None):
        self._push(("I", cat, name, track, self._clock(), 0.0, args))

    def counter(self, name: str, value: float,
                track: str = ENGINE_TRACK):
        """One sample of a counter track (queue depth, pages in use)."""
        self._push(("C", "metric", name, track, self._clock(), 0.0,
                    float(value)))

    @contextmanager
    def span(self, cat: str, name: str, track: str = ENGINE_TRACK,
             args: dict | None = None):
        t0 = self._clock()
        try:
            yield
        finally:
            self.complete(cat, name, track, t0, args=args)


class RequestStateTracker:
    """Per-request lifecycle state machine -> non-overlapping state spans.

    Each request's track carries back-to-back spans named after its
    scheduler state (``queued`` / ``prefilling`` / ``decoding`` /
    ``preempted``): :meth:`transition` closes the open state span and
    opens the next, :meth:`finish` closes the last one and stamps an
    instant ``finished`` marker.  Invariants the telemetry tests pin:
    every submitted request's spans close by the time the engine drains
    (``open_states`` is empty), and spans on one track never overlap
    (they share single open-state bookkeeping by construction)."""

    CAT = "request"

    def __init__(self, tracer: SpanTracer):
        self.tracer = tracer
        self._open: dict = {}       # rid -> (state, t_since, args)

    def transition(self, rid, state: str, args: dict | None = None):
        now = self.tracer.now()
        prev = self._open.get(rid)
        if prev is not None:
            pstate, pt, pargs = prev
            self.tracer.complete(self.CAT, pstate, request_track(rid),
                                 pt, now, pargs)
        self._open[rid] = (state, now, args)

    def finish(self, rid, args: dict | None = None):
        prev = self._open.pop(rid, None)
        if prev is not None:
            pstate, pt, pargs = prev
            self.tracer.complete(self.CAT, pstate, request_track(rid),
                                 pt, args=pargs)
        self.tracer.instant(self.CAT, "finished", request_track(rid), args)

    @property
    def open_states(self) -> dict:
        """rid -> current state name (empty once the engine drains)."""
        return {rid: st for rid, (st, _, _) in self._open.items()}


class TorchProfilerHook:
    """Opt-in ``torch.profiler`` capture over an engine-step window (the
    reference's ``JaxProfilerHook``).

    Starts a ``torch.profiler.profile`` (host activity, and the card's when
    one is visible) at ``start_step`` and stops it at ``stop_step``, then
    writes its Chrome trace to ``<logdir>/torch_trace.json``, so a
    device-side profile (kernels, copies) lands beside the host-side span
    trace of the same steps (``launch/serve.py --torch-profile DIR
    --profile-steps A:B``).  A failure to start or stop is downgraded to a
    warning: profiling must never take down a serving run."""

    def __init__(self, logdir: str, start_step: int = 0,
                 stop_step: int | None = None):
        self.logdir = logdir
        self.start_step = start_step
        # default: a one-step capture window
        self.stop_step = (start_step + 1 if stop_step is None
                          else stop_step)
        self.active = False
        self.done = False
        self.trace_path = os.path.join(logdir, "torch_trace.json")
        self._prof = None

    def on_step(self, step: int) -> None:
        if not self.done and not self.active and step >= self.start_step:
            try:
                import torch
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
                self.active = True
            except Exception as e:                  # pragma: no cover
                warnings.warn(f"torch.profiler start failed: {e}")
                self.done = True
        elif self.active and step >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self.active:
            try:
                self._prof.__exit__(None, None, None)
                os.makedirs(self.logdir, exist_ok=True)
                self._prof.export_chrome_trace(self.trace_path)
            except Exception as e:                  # pragma: no cover
                warnings.warn(f"torch.profiler stop failed: {e}")
            self.active = False
            self._prof = None
        self.done = True
