"""Request routing over ``GenerationEngine`` replicas: the reference's
``serving/router.py`` over the port's engine.

The router is the placement policy of the async front end
(``serving.async_engine``): given a request, pick the replica that
serves it.  Placement is **deterministic** — a pure function of the
replicas' current load and prefix indices, with index order breaking
ties — so a seeded arrival trace always produces the same placement
sequence (asserted by ``tests/test_torch_async_serving.py``), and per-request
token streams stay bit-identical no matter which replica serves them
(sampling keys fold ``(rng_seed, request.id, position)`` only; every
replica must therefore be built from the same ``EngineConfig.rng_seed``
for the bit-identity guarantee to hold across placements).

Two signals, in order:

1. **prefix affinity** — with prefix sharing enabled, the replica whose
   ``PrefixIndex`` already holds the longest prefix of the prompt
   adopts its pages by reference instead of recomputing them
   (``GenerationEngine.prefix_match_tokens``); a hit beats any load
   imbalance because the work it saves (the matched prefill tokens) is
   the dominant admission cost.  Ties fall through to load.
2. **least loaded** — fewest owned requests
   (``GenerationEngine.load()``: occupied slots + scheduler backlog);
   ties break to the lowest replica index.

Metrics (registry names in docs/OBSERVABILITY.md):
``router_placements_total``, ``router_prefix_affinity_total`` and the
dynamic per-replica gauge namespace ``router_replica<i>_load``.
"""
from __future__ import annotations

from .engine import GenerationEngine, Request

POLICIES = ("least-loaded", "round-robin")


class Router:
    """Deterministic request placement over engine replicas.

    ``policy="least-loaded"`` (default) applies prefix affinity then
    least-loaded placement; ``"round-robin"`` ignores both signals and
    cycles the replicas (the control arm in the load-replay bench).
    ``placements`` records ``(request_id, replica_index, reason)`` per
    routed request — the determinism test's observable."""

    def __init__(self, replicas, *, policy: str = "least-loaded",
                 telemetry=None):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("Router needs at least one replica")
        if policy not in POLICIES:
            raise ValueError(f"policy={policy!r} (must be one of {POLICIES})")
        self.replicas = replicas
        self.policy = policy
        self.tel = telemetry
        self._rr = 0
        self.placements: list[tuple[int, int, str]] = []

    def __len__(self) -> int:
        return len(self.replicas)

    def load(self, idx: int) -> int:
        return self.replicas[idx].load()

    def total_load(self) -> int:
        return sum(eng.load() for eng in self.replicas)

    def place(self, req: Request) -> tuple[int, str]:
        """``(replica index, reason)`` for ``req`` — pure: reads load and
        prefix indices, changes nothing, so the front end may probe a
        placement and defer the submit under backpressure."""
        if self.policy == "round-robin":
            return self._rr % len(self.replicas), "round-robin"
        best, reason = 0, "least-loaded"
        matches = [eng.prefix_match_tokens(req.prompt)
                   for eng in self.replicas]
        top = max(matches)
        if top > 0:
            cands = [i for i, m in enumerate(matches) if m == top]
            reason = "prefix-affinity"
        else:
            cands = range(len(self.replicas))
        best = min(cands, key=lambda i: (self.replicas[i].load(), i))
        return best, reason

    def submit_to(self, idx: int, req: Request, *, reason: str = "direct"):
        """Hand ``req`` to replica ``idx`` and record the placement."""
        self.replicas[idx].submit(req)
        self._rr += 1
        self.placements.append((req.id, idx, reason))
        if self.tel is not None:
            reg = self.tel.registry
            reg.counter("router_placements_total").inc()
            if reason == "prefix-affinity":
                reg.counter("router_prefix_affinity_total").inc()

    def submit(self, req: Request) -> int:
        """Place and submit in one call; returns the replica index."""
        idx, reason = self.place(req)
        self.submit_to(idx, req, reason=reason)
        return idx

    def sample_load_gauges(self):
        """Publish per-replica load into the dynamic
        ``router_replica<i>_load`` gauge namespace (peak-tracked, like
        every registry gauge)."""
        if self.tel is None:
            return
        for i, eng in enumerate(self.replicas):
            self.tel.registry.gauge(f"router_replica{i}_load").set(
                eng.load())
