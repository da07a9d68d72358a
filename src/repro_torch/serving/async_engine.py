"""Async serving front end: admission decoupled from the engine step loop
(the reference's ``serving/async_engine.py`` over the port's engine).

``AsyncServingFrontend`` is the layer above one or more synchronous
``GenerationEngine`` replicas: callers ``submit()``
requests from asyncio coroutines and consume **per-request streaming
token iterators** (``TokenStream``), while a single driver coroutine
(``run()``, or explicit ``step()`` calls) pumps the replicas.  The
pieces:

* **bounded admission queue** — ``submit`` lands requests in a frontend
  queue of at most ``max_pending`` entries; between engine steps the
  driver drains it through the ``Router`` into replicas, stopping while
  the chosen replica's backlog exceeds ``max_replica_backlog`` (so the
  frontend queue, not the engine scheduler, absorbs bursts).
* **explicit shed policy** — a full queue either rejects the new
  request (``shed_policy="reject"``: ``FrontendOverloaded``) or sheds
  the lowest-priority queued request in its favour
  (``"drop-lowest"``; when the newcomer itself is lowest, it is the one
  shed — its stream terminates immediately with ``.shed`` set).  Every
  shed bumps ``frontend_shed_total``.
* **streaming** — tokens appear on a request's ``TokenStream`` as the
  engine emits them, ordered, with no buffering beyond the engine step
  that produced them.  The stream is **bit-identical to the synchronous
  engine**: the frontend only moves requests and copies
  ``Request.out_tokens`` deltas; sampling keys fold
  ``(rng_seed, request.id, position)`` only, so admission timing,
  replica choice, batching and preemption cannot change any token
  (asserted by the differential tests in
  ``tests/test_torch_async_serving.py``).
* **graceful drain** — ``drain()`` stops nothing but pumps until every
  accepted request finished; ``close()`` rejects new submissions
  (``FrontendClosed``) and optionally drains or sheds what is queued.

Determinism note: ``step()`` is a *tick* — admission, one engine step
per busy replica, stream flush.  Everything it decides (admission
order, placement, shedding) is a function of tick state, never of wall
clock, so a seeded arrival trace replayed tick-by-tick
(``launch/load_replay.py``) reproduces placements and sheds
exactly; wall clock only feeds the latency histograms.

Metrics (names in docs/OBSERVABILITY.md): ``frontend_requests_total``,
``frontend_shed_total``, ``frontend_completed_total``,
``frontend_stream_tokens_total``, ``frontend_queue_depth``,
``frontend_stream_ttft_seconds``.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque

from .engine import GenerationEngine, Request
from .router import Router

SHED_POLICIES = ("reject", "drop-lowest")

_DONE = object()
_SHED = object()


class FrontendOverloaded(RuntimeError):
    """Admission queue full under ``shed_policy="reject"``."""


class FrontendClosed(RuntimeError):
    """``submit`` after ``close()``."""


class TokenStream:
    """Async iterator over one request's output tokens, in order.

    ``async for tok in stream`` yields each token as the driver flushes
    it and ends when the request finishes (or was shed — check
    ``stream.shed``).  ``tokens`` accumulates every flushed token as it
    lands (consumed or not); ``collect()`` drains to completion and
    returns the full list."""

    def __init__(self, request: Request):
        self.request = request
        self.tokens: list[int] = []
        self.finished = False
        self.shed = False
        self._q: asyncio.Queue = asyncio.Queue()

    def _push(self, tok: int):
        self.tokens.append(tok)
        self._q.put_nowait(tok)

    def _finish(self):
        self.finished = True
        self._q.put_nowait(_DONE)

    def _mark_shed(self):
        self.shed = self.finished = True
        self._q.put_nowait(_SHED)

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        item = await self._q.get()
        if item is _DONE or item is _SHED:
            raise StopAsyncIteration
        return item

    async def collect(self) -> list[int]:
        async for _ in self:
            pass
        return self.tokens


class AsyncServingFrontend:
    """Asyncio front end over engine replicas (module docstring).

    ``replicas``: a ``Router``, one ``GenerationEngine``, or a list of
    engines (wrapped in a default least-loaded router).  For cross-
    replica bit-identity every replica must share one
    ``EngineConfig.rng_seed``.  ``max_replica_backlog`` defaults to
    twice the replica's ``max_batch`` — enough queued work to refill
    every slot at the next admission pass without hiding the queue from
    the shed policy."""

    def __init__(self, replicas, *, max_pending: int = 64,
                 max_replica_backlog: int | None = None,
                 shed_policy: str = "reject", telemetry=None):
        if isinstance(replicas, Router):
            router = replicas
        elif isinstance(replicas, GenerationEngine):
            router = Router([replicas], telemetry=telemetry)
        else:
            router = Router(replicas, telemetry=telemetry)
        if shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy={shed_policy!r} (must be one of "
                f"{SHED_POLICIES})")
        if max_pending < 1:
            raise ValueError(f"max_pending={max_pending} (must be >= 1)")
        self.router = router
        self.max_pending = max_pending
        self.max_replica_backlog = max_replica_backlog
        self.shed_policy = shed_policy
        self.tel = telemetry
        self.n_shed = 0
        self.n_completed = 0
        self._pending: deque[tuple[Request, TokenStream]] = deque()
        self._live: dict[int, tuple[Request, TokenStream, int]] = {}
        self._submit_t: dict[int, float] = {}
        self._closed = False
        self._wake = asyncio.Event()

    # -- admission ---------------------------------------------------------

    def _count_shed(self, stream: TokenStream):
        self.n_shed += 1
        stream._mark_shed()
        if self.tel is not None:
            self.tel.registry.counter("frontend_shed_total").inc()

    def submit_nowait(self, req: Request) -> TokenStream:
        """Enqueue ``req``; returns its stream.  A full queue raises
        ``FrontendOverloaded`` (``shed_policy="reject"``) or sheds the
        lowest-priority queued request — possibly ``req`` itself, whose
        returned stream is then already terminated with ``.shed``."""
        if self._closed:
            raise FrontendClosed("frontend is closed to new requests")
        stream = TokenStream(req)
        if self.tel is not None:
            self.tel.registry.counter("frontend_requests_total").inc()
        if len(self._pending) >= self.max_pending:
            if self.shed_policy == "reject":
                self.n_shed += 1
                if self.tel is not None:
                    self.tel.registry.counter("frontend_shed_total").inc()
                raise FrontendOverloaded(
                    f"admission queue full ({self.max_pending} pending)")
            # drop-lowest: shed the lowest-priority queued request,
            # latest arrival within the class — unless the newcomer
            # itself is lowest-or-equal, in which case shedding it keeps
            # already-accepted work untouched
            worst = min(range(len(self._pending)),
                        key=lambda i: (self._pending[i][0].priority, -i))
            victim_req, victim_stream = self._pending[worst]
            if victim_req.priority < req.priority:
                del self._pending[worst]
                self._count_shed(victim_stream)
            else:
                self._count_shed(stream)
                return stream
        self._pending.append((req, stream))
        self._submit_t[req.id] = time.perf_counter()
        self._note_depth()
        self._wake.set()
        return stream

    async def submit(self, req: Request) -> TokenStream:
        """Coroutine flavour of :meth:`submit_nowait` (the admission
        decision itself is synchronous and immediate)."""
        return self.submit_nowait(req)

    def _backlog_limit(self, idx: int) -> int:
        if self.max_replica_backlog is not None:
            return self.max_replica_backlog
        return 2 * self.router.replicas[idx].max_batch

    def _admit(self):
        """Drain the frontend queue through the router, head-of-line in
        arrival order, stopping while the placed replica's backlog is
        full (the frontend queue absorbs the burst instead)."""
        while self._pending:
            req, stream = self._pending[0]
            idx, reason = self.router.place(req)
            if self.router.load(idx) >= self._backlog_limit(idx):
                break
            self._pending.popleft()
            self.router.submit_to(idx, req, reason=reason)
            self._live[req.id] = (req, stream, 0)
        self._note_depth()

    # -- driving -----------------------------------------------------------

    async def step(self) -> bool:
        """One tick: admit queued requests, one engine step per busy
        replica, flush new tokens to their streams.  Returns whether any
        work remains (queued, admitted, or mid-flight)."""
        self._admit()
        for eng in self.router.replicas:
            if eng.load() > 0:
                eng.step()
            # cooperative yield between replica steps: consumers see
            # tokens while other replicas still compute
            await asyncio.sleep(0)
        self._flush()
        self.router.sample_load_gauges()
        return bool(self._pending or self._live) or self.router.total_load() > 0

    def _flush(self):
        """Copy each live request's ``out_tokens`` delta to its stream —
        the only coupling between engine state and consumers, which is
        why the streamed tokens are bit-identical to a synchronous
        ``run()`` of the same requests."""
        reg = self.tel.registry if self.tel is not None else None
        for rid, (req, stream, sent) in list(self._live.items()):
            new = req.out_tokens[sent:]
            if new:
                if sent == 0 and reg is not None:
                    t0 = self._submit_t.get(rid)
                    if t0 is not None:
                        reg.histogram(
                            "frontend_stream_ttft_seconds").observe(
                                time.perf_counter() - t0)
                for tok in new:
                    stream._push(tok)
                if reg is not None:
                    reg.counter("frontend_stream_tokens_total").inc(
                        len(new))
            if req.done:
                stream._finish()
                del self._live[rid]
                self._submit_t.pop(rid, None)
                self.n_completed += 1
                if reg is not None:
                    reg.counter("frontend_completed_total").inc()
            elif new:
                self._live[rid] = (req, stream, sent + len(new))

    def _note_depth(self):
        if self.tel is not None:
            self.tel.registry.gauge("frontend_queue_depth").set(
                len(self._pending))

    async def drain(self):
        """Pump until every accepted request has finished (admission
        stays open — requests submitted meanwhile are served too)."""
        while await self.step():
            pass

    async def run(self):
        """Driver loop for background use: pump while there is work,
        park on an event while idle, exit once closed and drained."""
        while True:
            busy = await self.step()
            if not busy:
                if self._closed:
                    return
                self._wake.clear()
                await self._wake.wait()

    async def close(self, *, drain: bool = True):
        """Stop admission; then either serve out the backlog
        (``drain=True``) or shed every queued request and finish only
        what replicas already own."""
        self._closed = True
        self._wake.set()
        if not drain:
            while self._pending:
                _, stream = self._pending.popleft()
                self._count_shed(stream)
            self._note_depth()
        await self.drain()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close(drain=exc[0] is None)
