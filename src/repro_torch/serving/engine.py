"""Continuous-batching generation engine (the serving loop).

The paper's RQ2 regime: weight-streaming-bound batched decode.  The engine
keeps a fixed ``max_batch`` of slots over a paged KV cache and fills them
with requests continuously:

  * every slot has its own timeline (per-slot ``cur_len``) — a finished
    request's slot is reused by the next queued request without draining
    the batch;
  * a new request is prefilled whole as a single-row batch
    (``models.model.prefill``: the flash kernel) and its K/V is copied
    into freshly allocated pages (``PagedKVCache.admit``);
  * with ``prefill_chunk=C``, prompts are instead prefilled in C-token
    chunks (``models.model.prefill_chunk``) that write their K/V straight
    into the slot's pages, under a per-step prefill token budget
    (``prefill_budget``, default C): each step first spends at most about
    the budget on prefill (mid-prefill slots first, in admission order,
    then new work), then runs one batched decode step, so a long prompt no
    longer stalls every decoding request.  A mid-prefill slot rides the
    decode step as a masked row (its stray write lands at the next chunk's
    first position, which that chunk overwrites; its timeline is rolled
    back after the step) and can be preempted: ``Preempted.prefill_pos``
    records where its prefill resumes;
  * decode steps always run the full batch; inactive slots read and write
    the garbage page and their rows are never used;
  * with ``compress_cold``, every slot's full pages are entropy-coded into
    the cold pool after each step and decoded where the step uses them;
  * with a swap store (``swap_bytes``), page pressure preempts whole
    requests: the victim's pages go to the host losslessly, it is requeued
    at the front of its priority class and resumes bit-identically;
  * ``cache_mode="monolithic"`` keeps one contiguous ``max_len`` row a
    slot instead (``models.model.init_cache(per_slot=True)``): a prefill
    fragment is spliced into its row (:func:`splice_fragment`), and there
    is no preemption, swap or chunking;
  * with a draft model (``draft_cfg`` / ``draft_params``), each step is a
    speculative round (:meth:`GenerationEngine._spec_round`): the draft,
    whose cache is always monolithic, proposes ``spec_k`` tokens a slot,
    the target scores them in one verify forward
    (``models.model.verify_chunk``) and ``serving.spec.verify`` keeps an
    exact rejection-sampled prefix; the rejected suffix is rolled back in
    both caches.

Weights may be an ECF8-compressed tree (``core.store.compress_tree``):
every weight is decoded where it is used (the ECF8 decode kernel).
Sampling keys fold ``(rng_seed, request.id, position)`` only, so a
request's sampled stream does not depend on batching.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.store import torch_dtype
from ..device import resolve
from ..kvcache import OutOfPages, PagedKVCache, SwapExhausted, SwapStore
from ..models import model as M
from . import spec as SPEC
from .config import EngineConfig
from .sampler import greedy, key_generator, request_key, root_key, \
    sample_logits
from .scheduler import Preempted, Scheduler

_ids = itertools.count()


@dataclass
class Request:
    prompt: list
    max_new_tokens: int = 32
    temperature: float = 0.0
    priority: int = 0           # higher runs first; FIFO within a class
    id: int = field(default_factory=lambda: next(_ids))
    out_tokens: list = field(default_factory=list)
    done: bool = False


def _leaves(tree: dict, names=()):
    """(path names, tensor) of every leaf of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, names + (k,))
        else:
            yield names + (k,), v


def _at(tree: dict, names):
    for k in names:
        tree = tree[k]
    return tree


def _slot_view(leaf, names, slot: int):
    """``slot``'s row of a cache leaf: leaves under ``"units"`` are
    stacked over layers (batch at axis 1), others carry the batch at axis
    0, and ``cur_len`` is a (B,) vector indexed directly."""
    if "cur_len" in names:
        return leaf[slot]
    return leaf.narrow(1 if "units" in names else 0, slot, 1)


def splice_fragment(cache: dict, frag: dict, slot: int) -> dict:
    """Copy a single-request prefill fragment (``models.model.prefill``'s
    cache, batch 1) into row ``slot`` of the monolithic batched cache, in
    place (the reference's ``splice_fragment``).  ``frag`` has the same
    leaves with batch size 1 and a 0-d ``cur_len``."""
    for names, leaf in _leaves(cache):
        fr = _at(frag, names)
        if "cur_len" in names:
            leaf[slot] = fr
        else:
            _slot_view(leaf, names, slot).copy_(fr.to(leaf.dtype))
    return cache


class GenerationEngine:
    def __init__(self, params, cfg: ArchConfig,
                 config: EngineConfig | None = None, device="cuda"):
        """``params`` (and a draft's ``config.draft_params``) must already
        live on ``device`` (the card unless the caller asks for the CPU).
        ``config`` is resolved by ``EngineConfig.validate``: an incompatible
        feature request warns and falls back there."""
        config = config or EngineConfig()
        if (config.draft_params is None) != (config.draft_cfg is None):
            raise ValueError(
                "draft_params and draft_cfg must be provided together")
        config = self.config = config.validate(cfg)
        self.device = resolve(device)
        self.params, self.cfg = params, cfg
        self.max_batch = max_batch = config.max_batch
        self.max_len = config.max_len
        self.slots: list = [None] * max_batch   # Request or None
        self._inflight: list = []               # submitted, not yet returned
        self.cache_mode = config.cache_mode
        if self.cache_mode == "paged":
            self.paged = PagedKVCache(
                cfg, max_batch, config.max_len, dtype=torch_dtype(cfg.dtype),
                device=self.device, page_size=config.page_size,
                n_pages=config.n_pages, compress_cold=config.compress_cold,
                n_cold_slots=config.n_cold_slots)
            if config.swap_bytes:
                self.paged.attach_swap(SwapStore(
                    None if config.swap_bytes < 0 else config.swap_bytes))
            self.cache = self.paged.init_cache()
        else:
            self.paged = None
            self.cache = M.init_cache(cfg, max_batch, config.max_len,
                                      torch_dtype(cfg.dtype), self.device,
                                      per_slot=True)
        self.spec_on = config.draft_cfg is not None
        self.spec_k = config.spec_k
        if self.spec_on:
            self.draft_params = config.draft_params
            self.draft_cfg = config.draft_cfg
            # the paired draft cache, always monolithic: a small draft
            # needs no paging, and its rollback is a timeline reset
            # (_spec_round)
            self.draft_cache = M.init_cache(
                self.draft_cfg, max_batch, config.max_len,
                torch_dtype(self.draft_cfg.dtype), self.device,
                per_slot=True)
        self.n_spec_rounds = self.n_spec_drafted = self.n_spec_accepted = 0
        # verify windows whose rejected suffix was rolled back, and draft
        # rows reinstalled from a preemption's host stash
        self.n_spec_rollbacks = self.n_draft_restores = 0
        self.prefill_chunk = config.prefill_chunk
        self.prefill_budget = config.prefill_budget
        self.scheduler = Scheduler(paged=self.paged,
                                   preemption=config.preemption,
                                   chunk_tokens=config.prefill_chunk)
        self._prefill_pos: dict[int, int] = {}  # slot -> prompt tokens done
        self._prefill_order: list[int] = []     # admission order (FIFO)
        self._stalled_ids: set = set()          # self-preempted this step
        self.n_chunks = self.n_chunk_tokens = self.n_interleaved_steps = 0
        self.n_midprefill_preempted = 0
        self._host_len = [0] * max_batch        # next write position per slot
        self._last_tok = [0] * max_batch        # decode input per slot
        self.rng0 = root_key(config.rng_seed)
        self.steps = 0
        # host wall time of the two phases, each ending in a host read of
        # the sampled tokens or, for a chunked prefill phase, a device
        # synchronisation (so that each waits for its own device work)
        self.prefill_seconds = self.decode_seconds = 0.0

    def submit(self, req: Request):
        if not 0 < len(req.prompt) <= self.max_len:
            raise ValueError(f"request {req.id}: prompt of {len(req.prompt)}"
                             f" tokens does not fit max_len={self.max_len}")
        self.scheduler.submit(req)
        self._inflight.append(req)

    def _start(self, slot: int, req: Request):
        """Prefill a fresh request and copy its K/V into ``slot``'s pages."""
        t0 = time.perf_counter()
        toks = torch.tensor(req.prompt, dtype=torch.int64,
                            device=self.device)[None, :]
        logits, frag = M.prefill(self.params, self.cfg, toks,
                                 max_len=self.max_len)
        if self.paged is not None:
            self.cache = self.paged.admit(self.cache, slot, frag,
                                          len(req.prompt))
        else:
            self.cache = splice_fragment(self.cache, frag, slot)
        del frag
        if self.spec_on:
            # the draft consumes the prompt too (its logits are unused: the
            # first token is sampled from the target's prefill)
            _, dfrag = M.prefill(self.draft_params, self.draft_cfg, toks,
                                 max_len=self.max_len)
            self.draft_cache = splice_fragment(self.draft_cache, dfrag, slot)
        self._host_len[slot] = len(req.prompt)
        tok = self._sample_one(logits, req)
        req.out_tokens.append(tok)
        self._last_tok[slot] = tok
        self.slots[slot] = req
        self.prefill_seconds += time.perf_counter() - t0

    def _start_chunked(self, slot: int, req: Request):
        """Admit a request for chunked prefill: allocate its page grant
        (``Scheduler.admission_grant``, the count ``pick`` tested against)
        and enter the prefill phase; its chunks run under the step's token
        budget in :func:`_prefill_phase`."""
        grant = self.scheduler.admission_grant(req)
        self.cache = self.paged.admit_slot(self.cache, slot, grant)
        self._host_len[slot] = 0
        self._prefill_pos[slot] = 0
        self._prefill_order.append(slot)
        self.slots[slot] = req

    def _resume(self, slot: int, st: Preempted):
        """Re-splice a preempted request: reinstall its page list, fault
        every page back (lossless restore) and rebuild the slot timeline —
        the continuation is bit-identical to an unpreempted run.  A
        mid-prefill record re-enters the prefill phase at
        ``st.prefill_pos`` instead of rejoining the decode batch."""
        self.cache = self.paged.attach_slot(self.cache, slot, st.pages,
                                            st.skip)
        self.cache = self.paged.fault(self.cache, slot)
        if self.spec_on and st.draft_state is not None:
            self._draft_restore(slot, st.draft_state)
        self.cache["cur_len"][slot] = st.host_len
        self._host_len[slot] = st.host_len
        if st.prefill_pos is not None:
            self._prefill_pos[slot] = st.prefill_pos
            self._prefill_order.append(slot)
        else:
            self._last_tok[slot] = st.last_tok
        self.slots[slot] = st.req
        self.scheduler.n_resumed += 1

    def _preempt(self, slot: int) -> bool:
        """Swap out a whole active request and requeue it (front of its
        priority class).  Returns False — with the engine state intact —
        when the swap store cannot take the pages."""
        store = self.paged.swap
        traffic = (store.swap_out_bytes, store.swap_in_bytes,
                   store.n_swap_out, store.n_swap_in)
        try:
            self.cache = self.paged.evict(self.cache, slot)
        except SwapExhausted:
            # roll back any partially evicted pages (their device space
            # was just freed, so the fault cannot itself run dry), and
            # un-count the aborted attempt so the counters only report
            # swapping that actually happened
            self.cache = self.paged.fault(self.cache, slot)
            (store.swap_out_bytes, store.swap_in_bytes,
             store.n_swap_out, store.n_swap_in) = traffic
            return False
        state = self.paged.snapshot_slot_state(self.cache, slot)
        pages, skip = self.paged.detach_slot(slot)
        self.scheduler.requeue(Preempted(
            req=self.slots[slot], pages=pages, skip=skip,
            host_len=self._host_len[slot], last_tok=self._last_tok[slot],
            state=state, prefill_pos=self._prefill_pos.get(slot),
            draft_state=(self._draft_snapshot(slot) if self.spec_on
                         else None)))
        if slot in self._prefill_pos:       # preempted mid-prefill
            self.n_midprefill_preempted += 1
            del self._prefill_pos[slot]
            self._prefill_order.remove(slot)
        self.slots[slot] = None
        self.scheduler.n_preempted += 1
        return True

    def _admit(self, prefill_budget: int | None = None):
        """Fill free slots from the scheduler; preempt strictly-lower-
        priority work when the head of the queue is blocked on pages.
        ``prefill_budget``: the chunked prefill tokens left this step; once
        spent, only decode-phase resumes admit, and no victim is preempted
        for a request that could not be prefilled yet."""
        sched = self.scheduler
        spent = prefill_budget is not None and prefill_budget <= 0
        while True:
            progress = False
            for slot in range(self.max_batch):
                if self.slots[slot] is not None:
                    continue
                item = sched.pick(slot, prefill_budget)
                if item is None:
                    continue
                if isinstance(item, Preempted):
                    self._resume(slot, item)
                elif self.prefill_chunk:
                    self._start_chunked(slot, item)
                else:
                    self._start(slot, item)
                progress = True
            if progress:
                continue
            head = sched.head()
            if head is None:
                break
            if spent and sched.prefill_tokens(head) > 0:
                break
            victim = sched.admission_victim(self.slots, head)
            if victim is None or not self._preempt(victim):
                break
        if (sched.waiting and not spent and self.paged is not None
                and not any(s is not None for s in self.slots)):
            # every slot is free yet nothing could be admitted: no release
            # will ever refill the free list.  Raised only once the batch
            # has drained, so in-flight work always completes first.
            bad = sched.impossible()
            if bad is not None:
                raise OutOfPages(
                    f"request {bad.id} needs "
                    f"{self.paged.pages_worst_case(len(bad.prompt), bad.max_new_tokens)}"
                    f" resident pages; the pool holds "
                    f"{self.paged.shard_capacity()} (swap cannot hold a "
                    f"single slot's working set)")
            raise OutOfPages(
                f"queued work cannot be admitted with an empty batch "
                f"({self.paged.free_pages} pages free)")

    def _sample_one(self, logits, req: Request) -> int:
        """The next token of ``req`` from its logits (1, 1, V)."""
        if req.temperature <= 0:
            return int(greedy(logits)[0, 0])
        gen = key_generator(
            request_key(self.rng0, req.id, len(req.out_tokens)),
            logits.device)
        return int(sample_logits(logits, gen,
                                 temperature=req.temperature)[0, 0])

    def _finish(self, s: int, req: Request):
        """Retire a finished request: clear the slot, release its pages."""
        req.done = True
        self.slots[s] = None
        if self.paged is not None:
            self.cache = self.paged.release(self.cache, s)

    # -- speculative decoding ----------------------------------------------

    def _draft_snapshot(self, slot: int) -> list:
        """Host copies of ``slot``'s row of every draft-cache leaf: the
        paired draft row stashed in ``Preempted.draft_state`` when the
        target slot is preempted (preempting one preempts both)."""
        return [_slot_view(leaf, names, slot).to("cpu", copy=True)
                for names, leaf in _leaves(self.draft_cache)]

    def _draft_restore(self, slot: int, snap: list):
        """Inverse of :meth:`_draft_snapshot`, bit-exact."""
        for (names, leaf), fr in zip(_leaves(self.draft_cache), snap):
            if "cur_len" in names:
                leaf[slot] = fr.to(leaf.device)
            else:
                _slot_view(leaf, names, slot).copy_(fr)
        self.n_draft_restores += 1

    def _spec_round(self, active):
        """One speculative round for every decode-phase slot: ``k``
        batched draft steps (+1 that only advances the draft's state), one
        verify forward a slot appending ``k + 1`` tokens' K/V
        (``models.model.verify_chunk``), exact rejection sampling
        (``serving.spec.verify``), then the rejected suffix rolled back in
        the target's pages and timeline and in the draft's timeline.  Emits
        1 .. k + 1 tokens a slot: distribution-identical to target-only
        decoding, token-identical under greedy.

        Draft rollback.  ``snaps[j]`` is the draft's ``cur_len`` vector
        after ``j`` draft steps; a slot that emits ``j`` tokens goes back
        to ``snaps[j]`` (its new last token is the ``j``-th emission, which
        the draft consumes first in the next round).  The reference keeps
        the whole draft cache of each step, since its caches are immutable
        values; here they are written in place, and a copy of a full-width
        draft cache each draft step would swamp the round.  For the
        attention-only drafts served here the timeline alone is exact:
        every position at or past the restored ``cur_len`` is rewritten by
        the draft's next step there before any step reads it, and
        ``kv_len = cur_len + 1`` masks it until then.  A recurrent draft
        would need its per-slot state snapshotted instead."""
        k = self.spec_k
        t0 = time.perf_counter()
        # grow every slot's pages to cover its whole verify window before
        # drafting: pressure can preempt another active slot, and a
        # victim's draft row must be stashed in its round-start state
        windows = {}
        for s in active:
            if self.slots[s] is None:
                continue            # preempted by an earlier slot's ensure
            n_cache = self._host_len[s]
            k_eff = max(min(k, self.max_len - 1 - n_cache), 0)
            # speculation never preempts a neighbour just to draft deeper:
            # under pressure the window shrinks, and only the mandatory
            # single write (k_eff == 0, the target-only step's allocation)
            # applies preemption pressure
            while k_eff:
                try:
                    self.cache = self.paged.ensure(self.cache, s,
                                                   n_cache + k_eff)
                    break
                except OutOfPages:
                    k_eff -= 1
            if not k_eff:
                self._ensure_with_pressure(s)
            windows[s] = (n_cache, k_eff)
        active = [s for s in active if self.slots[s] is not None]
        if not active:
            return
        snaps = [self.draft_cache["cur_len"].clone()]
        q_rows = []                     # draft logits per proposal (B, 1, V)
        props = np.zeros((self.max_batch, k), np.int64)
        tok = torch.tensor(self._last_tok, dtype=torch.int64,
                           device=self.device)[:, None]
        for j in range(1, k + 2):
            logits, self.draft_cache = M.decode_step(
                self.draft_params, self.draft_cfg, tok, self.draft_cache)
            snaps.append(self.draft_cache["cur_len"].clone())
            if j > k:
                break                   # the last step only advances state
            q_rows.append(logits)
            nxt = greedy(logits)[:, 0].cpu().numpy().astype(np.int64)
            # sampled rows propose with the plain-decode rule and key
            for s in active:
                req = self.slots[s]
                if req.temperature > 0:
                    nxt[s] = SPEC.propose(
                        logits[s:s + 1], self.rng0, req.id,
                        len(req.out_tokens) + j - 1, req.temperature)
            props[:, j - 1] = nxt
            tok = torch.from_numpy(nxt).to(self.device)[:, None]
        for s in active:
            req = self.slots[s]
            n_cache, k_eff = windows[s]
            toks = torch.zeros((1, k + 1), dtype=torch.int64)
            toks[0, 0] = self._last_tok[s]
            toks[0, 1:1 + k_eff] = torch.from_numpy(props[s, :k_eff])
            logits, _ = M.verify_chunk(self.params, self.cfg,
                                       toks.to(self.device),
                                       self._step_cache(), s, k_eff + 1)
            p_log = logits[0, :k_eff + 1].float().cpu().numpy()
            q_log = (torch.stack([q_rows[j][s, 0] for j in range(k_eff)])
                     .float().cpu().numpy()
                     if k_eff and req.temperature > 0 else None)
            out, m = SPEC.verify(p_log, q_log, props[s, :k_eff].tolist(),
                                 rng0=self.rng0, req_id=req.id,
                                 pos0=len(req.out_tokens),
                                 temperature=req.temperature,
                                 device=self.device)
            # clip to the request's budget and the window (both >= 1: a
            # finished request never re-enters the active list)
            allow = min(req.max_new_tokens - len(req.out_tokens),
                        self.max_len - len(req.prompt)
                        - len(req.out_tokens))
            emit = out[:max(allow, 1)]
            new_len = n_cache + len(emit)
            self.cache = self.paged.rollback(self.cache, s, new_len)
            self._host_len[s] = new_len
            self.draft_cache["cur_len"][s] = snaps[len(emit)][s]
            req.out_tokens.extend(emit)
            self._last_tok[s] = emit[-1]
            self.n_spec_rounds += 1
            self.n_spec_drafted += k_eff
            self.n_spec_accepted += m
            self.n_spec_rollbacks += len(emit) < k_eff + 1
            if (len(req.out_tokens) >= req.max_new_tokens
                    or len(req.prompt) + len(req.out_tokens)
                    >= self.max_len):
                self._finish(s, req)
        self.decode_seconds += time.perf_counter() - t0

    def spec_counters(self) -> dict:
        """Speculative-decoding counters of the run so far."""
        return {"spec_rounds": self.n_spec_rounds,
                "spec_drafted": self.n_spec_drafted,
                "spec_accepted": self.n_spec_accepted,
                "spec_accept_rate": (self.n_spec_accepted
                                     / max(self.n_spec_drafted, 1))}

    # -- chunked prefill ---------------------------------------------------

    def _ensure_prefill(self, slot: int, pos: int) -> bool:
        """Grow ``slot``'s page list to cover a chunk write at ``pos``.  On
        pressure, preempt victims; as a last resort the prefilling request
        preempts itself (its chunks so far swap out losslessly and resume
        at the recorded position), at most once a step, after which it
        pauses holding its pages.  Returns False when the chunk must not
        run (self-preempted or paused)."""
        req = self.slots[slot]
        while True:
            try:
                self.cache = self.paged.ensure(self.cache, slot, pos)
                return True
            except OutOfPages:
                victim = self.scheduler.victim(self.slots, exclude=(slot,))
                if victim is not None and self._preempt(victim):
                    continue
                if (self.scheduler._can_preempt()
                        and req.id not in self._stalled_ids
                        and self._preempt(slot)):
                    self._stalled_ids.add(req.id)
                    return False
                if self.scheduler._can_preempt():
                    return False        # paused: retry next step
                raise

    def _advance_prefill(self, slot: int, allowance: int) -> int:
        """Run prefill chunks for ``slot`` until its prompt is done or about
        ``allowance`` tokens were spent (the last chunk may overshoot by at
        most ``chunk - 1``).  The final chunk's logits give the request's
        first token and move the slot to the decode phase.  Returns the
        tokens spent."""
        req = self.slots[slot]
        C = self.prefill_chunk
        spent = 0
        while (self.slots[slot] is req and slot in self._prefill_pos
               and spent < allowance):
            pos = self._prefill_pos[slot]
            part = req.prompt[pos:pos + C]
            n = len(part)
            if not self._ensure_prefill(slot, pos + n - 1):
                return spent                    # self-preempted: requeued
            toks = torch.tensor(list(part) + [0] * (C - n),
                                dtype=torch.int64, device=self.device)[None]
            logits, _ = M.prefill_chunk(self.params, self.cfg, toks,
                                        self._step_cache(), slot, n)
            self._prefill_pos[slot] = pos + n
            self._host_len[slot] = pos + n
            self.n_chunks += 1
            self.n_chunk_tokens += n
            spent += n
            if pos + n >= len(req.prompt):      # final chunk: first token
                tok = self._sample_one(logits, req)
                req.out_tokens.append(tok)
                self._last_tok[slot] = tok
                del self._prefill_pos[slot]
                self._prefill_order.remove(slot)
        return spent

    def _prefill_phase(self) -> int:
        """Spend up to ``prefill_budget`` prompt tokens on prefill work:
        mid-prefill slots drain first in admission order (an earlier prompt
        finishes before a later one starts), then new work admits against
        the remaining budget and runs its first chunks in the same step.
        Returns tokens spent."""
        budget = self.prefill_budget
        spent = 0
        t0 = time.perf_counter()
        self._stalled_ids.clear()
        while True:
            for slot in list(self._prefill_order):
                if spent >= budget:
                    break
                if self.slots[slot] is not None and slot in self._prefill_pos:
                    spent += self._advance_prefill(slot, budget - spent)
            before = len(self._prefill_order)
            had_free = any(s is None for s in self.slots)
            self._admit(prefill_budget=budget - spent)
            if len(self._prefill_order) == before or spent >= budget \
                    or not had_free:
                break
        if spent and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefill_seconds += time.perf_counter() - t0
        return spent

    # -- stepping ----------------------------------------------------------

    def _ensure_with_pressure(self, slot: int):
        """Grow ``slot``'s page list to cover this step's decode write; on
        page pressure, preempt victims until it fits."""
        while True:
            try:
                self.cache = self.paged.ensure(self.cache, slot,
                                               self._host_len[slot])
                return
            except OutOfPages:
                victim = self.scheduler.victim(self.slots, exclude=(slot,))
                if victim is None or not self._preempt(victim):
                    raise

    def _step_cache(self) -> dict:
        """The cache the decode step and the prefill chunk read: without
        the cold-pool leaves while no page is cold (decoding an empty pool
        would be waste)."""
        if (self.paged is None or not self.paged.compress
                or self.paged.has_cold):
            return self.cache
        pools = self.cache["units"]["pos0"]
        return {**self.cache, "units": {"pos0": {
            kn: pools[kn] for kn in ("k_pool", "v_pool")}}}

    def _decoding(self) -> list:
        """Slots in the decode phase (occupied, not mid-prefill)."""
        return [s for s in range(self.max_batch)
                if self.slots[s] is not None and s not in self._prefill_pos]

    def step(self) -> bool:
        """One engine step: admission and, in chunked mode, budgeted
        prefill work, then one batched decode step for the decode-phase
        slots.  Returns False when idle."""
        if self.prefill_chunk:
            prefill_spent = self._prefill_phase()
        else:
            self._admit()
            prefill_spent = 0
        active = self._decoding()
        if not active:
            # prefill in flight with nothing to decode, or idle
            return bool(self._prefill_pos) or self.scheduler.waiting > 0
        if self.paged is not None:
            for s in active:   # grow page lists to cover this step's write
                if self.slots[s] is not None:
                    self._ensure_with_pressure(s)
            active = self._decoding()
            # fault-before-gather: the decode step must never see a swapped
            # page of an active slot (normally a no-op: resume already
            # faults, and whole-request preemption only swaps vacated
            # slots)
            for s in active:
                if self.paged.has_swapped(s):
                    self.cache = self.paged.fault(self.cache, s)
        if self.spec_on:
            # a speculative round replaces the decode step (chunked prefill
            # is gated off, so no slot is mid-prefill here)
            self._spec_round(active)
            self.steps += 1
            self._compress_cold()
            return True
        t0 = time.perf_counter()
        last = torch.tensor(self._last_tok, dtype=torch.int64,
                            device=self.device)[:, None]
        logits, out = M.decode_step(self.params, self.cfg, last,
                                    self._step_cache())
        self.cache["cur_len"] = out["cur_len"]
        self.steps += 1
        if self._prefill_pos:
            # mid-prefill rows decoded as masked garbage: the batched step
            # advanced every timeline, so roll theirs back (their stray
            # write sits at the next chunk's first position, which that
            # chunk overwrites)
            idx = torch.tensor(sorted(self._prefill_pos), device=self.device)
            self.cache["cur_len"][idx] -= 1
        if prefill_spent:
            self.n_interleaved_steps += 1
        toks = greedy(logits)[:, 0].tolist()
        self.decode_seconds += time.perf_counter() - t0
        for s in active:
            req = self.slots[s]
            t = (toks[s] if req.temperature <= 0
                 else self._sample_one(logits[s:s + 1], req))
            req.out_tokens.append(t)
            self._last_tok[s] = t
            self._host_len[s] += 1
            if len(req.out_tokens) >= req.max_new_tokens or (
                    len(req.prompt) + len(req.out_tokens) >= self.max_len):
                self._finish(s, req)
        self._compress_cold()
        return True

    def _compress_cold(self):
        """Entropy-code every active slot's full pages into the cold pool
        (``compress_cold``), after a decode step or a speculative round."""
        if self.paged is not None and self.paged.compress:
            for s in range(self.max_batch):
                if self.slots[s] is not None:
                    self.cache = self.paged.compress_cold_pages(
                        self.cache, s, self._host_len[s])

    def run(self, max_steps: int = 10_000) -> list:
        """Drain the queue; returns every submitted request that finished
        (queued, admitted or preempted when ``run`` was called)."""
        for _ in range(max_steps):
            busy = self.step()
            if not busy and not any(s is not None for s in self.slots):
                break
        done = [r for r in self._inflight if r.done]
        self._inflight = [r for r in self._inflight if not r.done]
        return done
