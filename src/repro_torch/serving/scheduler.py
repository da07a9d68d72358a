"""Preemptive request scheduler: priority admission over virtual capacity.

The reference's ``serving/scheduler.py`` on one device, with its
chunked-prefill pieces (the per-step prefill token budget, mid-prefill
preemption records) and without prefix sharing.  Over the monolithic cache
(``paged`` None) every slot holds a whole ``max_len`` row, so admission is
plain priority order and nothing is preempted.  With the swap tier (``kvcache/swap.py``) the page pool becomes a
cache over a larger *virtual* capacity — device pages + host swap — and
this module is the policy layer over it:

  * **priority classes** — ``Request.priority`` (higher runs first);
    FIFO within a class, so priority 0 everywhere gives plain FIFO
    admission.
  * **admission control against virtual capacity** — a request is queued,
    not rejected, while its pages are swappable; ``OutOfPages`` is raised
    only for requests that can *never* fit (their worst-case resident
    working set exceeds the pool — swap cannot help, because a slot's
    whole history must be device-resident to gather).
  * **whole-request preemption** — when a higher-priority request waits or
    an active slot cannot grow, the victim (lowest priority, then least
    recently scheduled) is swapped out wholesale: the engine evicts all
    its pages, detaches its host state into a :class:`Preempted` record,
    and requeues it at the *front* of its priority class.  Resume faults
    the pages back and re-splices the slot's timeline — bit-identical to
    a run that was never preempted, because page restore is lossless and
    greedy/fold-in sampling depends only on the request's own state.

The scheduler is pure host-side policy: it owns the queues and victim
choice; the engine owns execution (prefill, evict/fault, splicing).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class Preempted:
    """A swapped-out request awaiting resume: partially generated, or, with
    chunked prefill, partially prefilled (``prefill_pos`` is then the count
    of prompt tokens whose K/V is in the swapped pages, equal to
    ``host_len``; the next chunk resumes there, and ``last_tok`` is a
    placeholder that resume never feeds to a decode step)."""

    req: object                 # serving.engine.Request
    pages: list                 # all-negative swap sentinels (detach_slot)
    skip: set                   # incompressible-page indices (preserved)
    host_len: int               # next cache write position
    last_tok: int               # last sampled token (decode input on resume)
    state: dict = field(default_factory=dict)
    # ^ non-paged per-slot cache state (PagedKVCache.snapshot_slot_state)
    prefill_pos: int | None = None   # prompt tokens consumed (mid-prefill)
    draft_state: object = None
    # ^ the paired draft-cache row (speculative decoding), stashed on the
    #   host at preemption and reinstalled on resume

    @property
    def priority(self) -> int:
        return self.req.priority

    @property
    def prefill_tokens_left(self) -> int:
        """Prompt tokens still to prefill on resume (0 in decode phase)."""
        if self.prefill_pos is None:
            return 0
        return len(self.req.prompt) - self.prefill_pos


@dataclass
class Scheduler:
    """Queue + policy.  ``paged`` is the engine's ``PagedKVCache`` (None
    for the monolithic cache)."""

    paged: object = None
    preemption: bool = True
    chunk_tokens: int = 0      # engine's prefill chunk (0 = whole-prompt)
    _classes: dict = field(default_factory=dict)   # priority -> deque
    _clock: int = 0
    _last_used: dict = field(default_factory=dict)  # slot -> stamp
    n_preempted: int = 0
    n_resumed: int = 0

    # -- queue -------------------------------------------------------------

    def submit(self, req) -> None:
        self._classes.setdefault(req.priority, deque()).append(req)

    def requeue(self, state: Preempted) -> None:
        """Preempted work resumes before new work of its class."""
        self._classes.setdefault(state.priority, deque()).appendleft(state)

    @property
    def waiting(self) -> int:
        return sum(len(q) for q in self._classes.values())

    def _priorities(self):
        return sorted((p for p in self._classes if self._classes[p]),
                      reverse=True)

    def head(self):
        """Highest-priority *schedulable* waiting item (None when idle);
        requests that can never fit are passed over — they only surface
        in :func:`impossible` once the engine has drained."""
        for p in self._priorities():
            for item in self._classes[p]:
                if (self.paged is None or isinstance(item, Preempted)
                        or self._ever_fits(item)):
                    return item
        return None

    def impossible(self):
        """First queued request whose worst-case resident set can never
        fit the pool — the diagnostic for the engine's drained-queue
        ``OutOfPages`` (never raised while other work is in flight)."""
        if self.paged is None:
            return None
        for p in self._priorities():
            for item in self._classes[p]:
                if (not isinstance(item, Preempted)
                        and not self._ever_fits(item)):
                    return item
        return None

    # -- fit tests ---------------------------------------------------------

    def prefill_tokens(self, item) -> int:
        """Prompt tokens the item still needs prefilled once admitted: the
        unit of the chunked engine's per-step token budget (0 for a
        decode-phase resume)."""
        if isinstance(item, Preempted):
            return item.prefill_tokens_left
        return len(item.prompt)

    def admission_grant(self, req) -> int:
        """Pages a fresh request is granted at admission, for both the fit
        test here and the engine's allocation.  With chunked prefill and a
        live preemption path, the first chunk's pages (later chunks grow
        the slot, and pressure resolves by preemption); otherwise the
        whole-prompt grant, since a first-chunk grant with no way to evict
        could wedge a later chunk."""
        if self.chunk_tokens and self._can_preempt():
            return self.paged.pages_for_prefix(
                min(self.chunk_tokens, len(req.prompt)))
        return self.paged.pages_needed(len(req.prompt))

    def _need_now(self, item) -> int:
        """Raw pages the item needs resident to start on a slot."""
        if isinstance(item, Preempted):
            return len(item.pages)      # conservative: cold slots may help
        return self.admission_grant(item)

    def _fits(self, item) -> bool:
        """Admissible *now and for its whole lifetime*: the current need
        must fit the free list, and the worst-case working set the pool."""
        if self._need_now(item) > self.paged.free_pages:
            return False
        req = item.req if isinstance(item, Preempted) else item
        return self._ever_fits(req)

    def _ever_fits(self, req) -> bool:
        """Whether the request's worst-case resident set fits the pool at
        full capacity (raw pages only: cold space is shared and
        incompressible pages stay raw, so counting it could admit a
        request that later wedges mid-flight)."""
        worst = self.paged.pages_worst_case(len(req.prompt),
                                            req.max_new_tokens)
        return worst <= self.paged.shard_capacity()

    def pick(self, slot: int, prefill_budget: int | None = None):
        """Pop the best waiting item admissible on ``slot`` now, or None.

        Strict head-of-line within a priority class: only the class's
        first *schedulable* item (never-fitting requests are passed over)
        is considered, so an all-priority-0 workload is served in FIFO
        order and a large request cannot be starved by smaller ones behind
        it.  A blocked class head does let lower classes run.

        ``prefill_budget`` is the chunked engine's remaining prefill tokens
        this step: once spent (``<= 0``), items that still need prompt
        tokens prefilled are blocked, and only decode-phase resumes admit.
        A budget-blocked class head blocks its class like a page-blocked
        one."""
        if self.paged is None:
            for p in self._priorities():
                self.touch(slot)
                return self._classes[p].popleft()
            return None
        for p in self._priorities():
            q = self._classes[p]
            for i, item in enumerate(q):
                if (not isinstance(item, Preempted)
                        and not self._ever_fits(item)):
                    continue        # unschedulable: not head-of-line
                if (prefill_budget is not None and prefill_budget <= 0
                        and self.prefill_tokens(item) > 0):
                    break           # out of prefill budget this step
                if self._fits(item):
                    del q[i]
                    self.touch(slot)
                    return item
                break               # class head blocks in-class backfill
        return None

    # -- preemption policy -------------------------------------------------

    def touch(self, slot: int) -> None:
        """LRU stamp: called on admit/resume (victims are the least
        recently scheduled — every active slot decodes every step)."""
        self._clock += 1
        self._last_used[slot] = self._clock

    def _can_preempt(self) -> bool:
        """Preemption needs an attached swap store with headroom — a full
        store would make every eviction attempt fail (and roll back)."""
        if not self.preemption or self.paged is None \
                or self.paged.swap is None:
            return False
        store = self.paged.swap
        return (store.capacity_bytes is None
                or store.bytes_used < store.capacity_bytes)

    def admission_victim(self, slots, head):
        """A victim whose eviction provably lets ``head`` admit *now*.

        Strictly-lower-priority active slots only (preempting your own
        class livelocks), and only when the freed pages would then hold
        ``head``'s current page need — so every admission preemption is
        followed by head's admission in the same pass, never by
        preempt/resume flapping across steps.  Ties break
        lowest-priority-first, then least recently scheduled."""
        if not self._can_preempt():
            return None
        need = self._need_now(head)
        best = None
        for s, req in enumerate(slots):
            if req is None or req.priority >= head.priority:
                continue
            raw = self.paged.resident_raw_pages(s)
            if self.paged.free_pages + raw < need:
                continue            # would not unblock head: keep running
            cand = (req.priority, self._last_used.get(s, 0), s)
            best = cand if best is None else min(best, cand)
        return best[2] if best is not None else None

    def victim(self, slots, *, exclude=()):
        """Choose a page-pressure victim among active ``slots`` (a list of
        Request-or-None): lowest priority first, then least recently
        scheduled — any priority qualifies, because the slot under
        pressure cannot write at all until pages free up.  ``exclude``
        protects the slot under pressure."""
        if not self._can_preempt():
            return None
        cands = []
        for s, req in enumerate(slots):
            if req is None or s in exclude:
                continue
            if self.paged.resident_raw_pages(s) == 0:
                continue        # holds no raw pages: evicting it would
                                # cost swap traffic and relieve nothing
            cands.append((req.priority, self._last_used.get(s, 0), s))
        return min(cands)[2] if cands else None

    def counters(self) -> dict:
        return {"n_preempted": self.n_preempted,
                "n_resumed": self.n_resumed,
                "queue_depth": self.waiting}
