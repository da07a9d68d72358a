"""Chrome-trace / Perfetto JSON export of a serving ``SpanTracer`` buffer
(the reference's ``runtime/trace_export.py``).

Writes the `Trace Event Format`_ consumed by ``chrome://tracing`` and
https://ui.perfetto.dev: one process row per track family —

  * pid 1 ``engine``: engine-phase spans (prefill phase / decode step /
    evict / fault / preempt / resume) on tid 0, plus the per-step
    counter tracks (queue depth, pages in use) as ``ph: "C"`` events;
  * pid 2 ``requests``: one thread row per request (tid = request id),
    carrying its back-to-back lifecycle state spans (queued ->
    prefilling -> decoding -> preempted -> ... -> finished), so a mixed
    oversubscribed run renders as a timeline of request rows above the
    engine-phase row.

Timestamps are exported in microseconds relative to the tracer's
``t0``.  The top-level object also embeds ``otherData`` with the
metrics-registry snapshot (when given) and the tracer's drop count, so
one file carries the whole observation.

.. _Trace Event Format: https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
from __future__ import annotations

import json

from .tracing import SpanTracer

_ENGINE_PID = 1
_REQUEST_PID = 2


def _track_ids(track: str, extra_tids: dict) -> tuple:
    """Map a tracer track name to a (pid, tid) pair."""
    if track.startswith("req:"):
        return _REQUEST_PID, int(track.split(":", 1)[1])
    if track == "engine":
        return _ENGINE_PID, 0
    tid = extra_tids.setdefault(track, len(extra_tids) + 1)
    return _ENGINE_PID, tid


def to_chrome_events(tracer: SpanTracer) -> list:
    """Tracer buffer -> list of Chrome trace-event dicts (with metadata)."""
    extra_tids: dict = {}
    seen: dict = {}                     # (pid, tid) -> track name
    events = []
    for ph, cat, name, track, ts, dur, args in tracer.events:
        pid, tid = _track_ids(track, extra_tids)
        seen.setdefault((pid, tid), track)
        ev = {"ph": ph, "cat": cat, "name": name, "pid": pid, "tid": tid,
              "ts": (ts - tracer.t0) * 1e6}
        if ph == "X":
            ev["dur"] = dur * 1e6
        if ph == "C":
            ev["args"] = {"value": args}
        elif args:
            ev["args"] = dict(args)
        events.append(ev)

    meta = [
        {"ph": "M", "pid": _ENGINE_PID, "tid": 0, "name": "process_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": _REQUEST_PID, "tid": 0, "name": "process_name",
         "args": {"name": "requests"}},
        {"ph": "M", "pid": _ENGINE_PID, "tid": 0, "name": "thread_name",
         "args": {"name": "engine phases"}},
    ]
    for (pid, tid), track in sorted(seen.items()):
        if pid == _REQUEST_PID:
            meta.append({"ph": "M", "pid": pid, "tid": tid,
                         "name": "thread_name",
                         "args": {"name": f"request {tid}"}})
        elif tid != 0:
            meta.append({"ph": "M", "pid": pid, "tid": tid,
                         "name": "thread_name", "args": {"name": track}})
    return meta + events


def build_trace(tracer: SpanTracer, registry=None) -> dict:
    """The full Chrome-trace JSON object (not yet serialized)."""
    other = {"n_dropped_events": tracer.n_dropped,
             "n_events": len(tracer.events)}
    if registry is not None:
        other["metrics"] = registry.snapshot()
    return {"traceEvents": to_chrome_events(tracer),
            "displayTimeUnit": "ms",
            "otherData": other}


def export_chrome_trace(tracer: SpanTracer, path: str,
                        registry=None) -> dict:
    """Write the trace JSON to ``path`` (open it in ui.perfetto.dev or
    ``chrome://tracing``); returns the written object."""
    trace = build_trace(tracer, registry)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


def validate_chrome_trace(obj: dict) -> list:
    """Schema sanity check -> list of error strings (empty = valid).

    Used by the telemetry tests' export round-trip and by anything that
    wants to assert a trace file is loadable before shipping it."""
    errors = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing top-level traceEvents"]
    for i, ev in enumerate(obj["traceEvents"]):
        for k in ("ph", "name", "pid", "tid"):
            if k not in ev:
                errors.append(f"event {i}: missing {k!r}")
        ph = ev.get("ph")
        if ph not in ("X", "I", "C", "M"):
            errors.append(f"event {i}: unknown ph {ph!r}")
        if ph != "M" and "ts" not in ev:
            errors.append(f"event {i}: missing ts")
        if ph == "X" and ev.get("dur", -1) < 0:
            errors.append(f"event {i}: X span without dur >= 0")
        if ph == "C" and "value" not in ev.get("args", {}):
            errors.append(f"event {i}: counter without args.value")
    return errors
