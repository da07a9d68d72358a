"""Request scheduler: priority classes over the paged cache's free pages.

The pure-Python policy layer of the reference's ``serving/scheduler.py``
for the part this slice serves: priority classes (``Request.priority``,
higher runs first; FIFO within a class) and admission of whole-prompt
requests against the page pool.  Requests whose worst-case working set
can never fit the pool are passed over and surface through
:func:`Scheduler.impossible` once the engine has drained.  Preemption
(victim choice, ``Preempted`` records) arrives with the swap tier.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class Scheduler:
    """Queue + policy.  ``paged`` is the engine's ``PagedKVCache``."""

    paged: object
    _classes: dict = field(default_factory=dict)   # priority -> deque

    # -- queue -------------------------------------------------------------

    def submit(self, req) -> None:
        self._classes.setdefault(req.priority, deque()).append(req)

    @property
    def waiting(self) -> int:
        return sum(len(q) for q in self._classes.values())

    def _priorities(self):
        return sorted((p for p in self._classes if self._classes[p]),
                      reverse=True)

    def impossible(self):
        """First queued request whose worst-case resident set can never
        fit the pool — the diagnostic for the engine's drained-queue
        ``OutOfPages``."""
        for p in self._priorities():
            for req in self._classes[p]:
                if not self._ever_fits(req):
                    return req
        return None

    # -- fit tests ---------------------------------------------------------

    def _fits(self, req) -> bool:
        """Admissible now and for its whole lifetime: the prompt's pages
        fit the free list and the worst-case working set fits the pool."""
        if self.paged.pages_needed(len(req.prompt)) > self.paged.free_pages:
            return False
        return self._ever_fits(req)

    def _ever_fits(self, req) -> bool:
        worst = self.paged.pages_worst_case(len(req.prompt),
                                            req.max_new_tokens)
        return worst <= self.paged.capacity()

    def pick(self):
        """Pop the best waiting request admissible now, or None.

        Strict head-of-line within a priority class (never-fitting
        requests are passed over): an all-priority-0 workload is served in
        FIFO order and a large request cannot be starved by smaller ones
        behind it.  A blocked class head does let lower classes run."""
        for p in self._priorities():
            q = self._classes[p]
            for i, req in enumerate(q):
                if not self._ever_fits(req):
                    continue        # unschedulable: not head-of-line
                if self._fits(req):
                    del q[i]
                    return req
                break               # class head blocks in-class backfill
        return None
