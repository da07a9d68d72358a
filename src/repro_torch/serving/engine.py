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
    requests: the victim's pages go to the host losslessly (and the rings
    of its ``local`` layers and the states of its recurrent ones, which
    hold no pages, with them), it is
    requeued at the front of its priority class and resumes
    bit-identically;
  * ``cache_mode="monolithic"`` keeps one contiguous ``max_len`` row a
    slot instead (``models.model.init_cache(per_slot=True)``): a prefill
    fragment is spliced into its row (:func:`splice_fragment`), and there
    is no preemption, swap or chunking;
  * with ``prefix_sharing`` (chunked prefill only), admission matches the
    prompt against the cache's prefix index: the matched page-aligned
    blocks are adopted by reference (``PagedKVCache.admit_shared``, one
    physical copy however many requests hold them) and prefill starts at
    the match boundary; every finished chunk publishes its full prompt
    blocks (``register_prefix``), and a shared page is split before a
    write could land in it (``make_writable``);
  * with a draft model (``draft_cfg`` / ``draft_params``), each step is a
    speculative round (:meth:`GenerationEngine._spec_round`): the draft,
    whose cache is always monolithic, proposes ``spec_k`` tokens a slot,
    the target scores them in one verify forward
    (``models.model.verify_chunk``) and ``serving.spec.verify`` keeps an
    exact rejection-sampled prefix; the rejected suffix is rolled back in
    both caches (in the draft's, its rings and recurrent states too).

With ``telemetry`` (``serving.telemetry.Telemetry``) the engine publishes
the reference's metrics, request-lifecycle spans and engine-phase spans;
with ``kv_monitor`` (or telemetry) it records the cache's stats every step.
Both are host-side observation: they read the host clock where the engine
already holds a result, add no device synchronisation, and leave the
tokens unchanged.

Weights may be an ECF8-compressed tree (``core.store.compress_tree``):
every weight is decoded where it is used (the ECF8 decode kernel).
Sampling keys fold ``(rng_seed, request.id, position)`` only, so a
request's sampled stream does not depend on batching.

On a mesh (``config.mesh``, a ``("data", "model")`` DeviceMesh of ranks,
``launch/mesh.py``) every rank runs this engine on the same requests with
replicated weights, but for a mixture-of-experts stack's experts, which a
model axis splits (``runtime.sharding.expert_cut``: each rank holds its
model index's share and the MoE layers exchange rows over ``model``);
the checksums of the other leaves are compared over the mesh and of the
experts over the ranks sharing a model index at construction
(``collectives.check_replicated``, which also reports every rank's
resident bytes).  Every host decision is made from values all ranks
hold.  The paged cache's
pools and cold slots are split over the data axis (``PagedKVCache(
n_shards=..., shard=...)``: a slot's pages lie in its own batch shard,
whose ranks alone hold them); a decode step runs each data group's slots
on its ranks, which sample their own slots' tokens, and one all-gather a
step hands every rank all tokens (model rank 0 of each group is
authoritative).  A slot's whole-prompt prefill and its prefill chunks run
on its shard's ranks, the model ranks splitting a prefill's query rows,
and the first token is broadcast from the shard's first rank; so are an
encoded page's byte count and fit (``PagedKVCache.share``), which the
cold pool's and the swap tier's bookkeeping read.  The monolithic cache
(the recurrent stacks') is split over the data groups likewise when they
divide ``max_batch``: a rank holds its group's ``max_batch / n_shards``
rows, a slot's whole-prompt prefill runs on its group's ranks and is
spliced into its local row, the decode step runs the local rows and its
tokens are gathered as the split paged step's are; a model axis repeats
the monolithic work on every rank of a group (the reference does not
sequence-split a per-slot cache either).  A speculative draft's cache,
and the rings and recurrent states beside a split paged cache, are whole
on every rank.
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
from ..kernels import build
from ..kvcache import OutOfPages, PagedKVCache, SwapExhausted, SwapStore
from ..kvcache import paged as paged_kv
from ..models import model as M
from ..runtime import collectives
from ..runtime.monitor import KVCacheMonitor, StragglerMonitor
from ..runtime.sharding import batch_index
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
        self.mesh = mesh = config.mesh
        n_shards, self.n_model = config.n_shards(), config.n_model_shards()
        self.d_rank = batch_index(mesh)
        self.weights_checksum = self.resident_bytes = None
        if mesh is not None:
            got = collectives.check_replicated(params, mesh,
                                               n_experts=cfg.n_experts)
            self.weights_checksum = got["checksum"]
            # every rank's resident weight bytes: (experts, the rest)
            self.resident_bytes = list(zip(got["expert_bytes"],
                                           got["other_bytes"]))
        # the rows of this rank's decode step and whether the step's tokens
        # are gathered from the data groups (a cache split over them: the
        # paged one's slots, or a monolithic cache's rows where the groups
        # divide max_batch)
        paged_mesh = (mesh is not None and self.cache_mode == "paged"
                      and (n_shards > 1 or self.n_model > 1))
        mono_split = (mesh is not None and self.cache_mode != "paged"
                      and n_shards > 1 and max_batch % n_shards == 0)
        local = paged_mesh or mono_split
        b_loc = max_batch // n_shards if local else max_batch
        lo = self.d_rank * b_loc if local else 0
        self._rows = (lo, lo + b_loc)
        self._split = local and n_shards > 1
        self.gather_seconds = 0.0               # host s in token gathers
        if self.cache_mode == "paged":
            self.paged = PagedKVCache(
                cfg, max_batch, config.max_len, dtype=torch_dtype(cfg.dtype),
                device=self.device, page_size=config.page_size,
                n_pages=config.n_pages, compress_cold=config.compress_cold,
                n_cold_slots=config.n_cold_slots, n_shards=n_shards,
                shard=self.d_rank if mesh is not None else None,
                share=self._share if self._split else None)
            if config.swap_bytes:
                self.paged.attach_swap(SwapStore(
                    None if config.swap_bytes < 0 else config.swap_bytes,
                    n_shards=n_shards))
            self.cache = self.paged.init_cache()
        else:
            self.paged = None
            self.cache = M.init_cache(cfg, b_loc, config.max_len,
                                      torch_dtype(cfg.dtype), self.device,
                                      per_slot=True)
        self.spec_on = config.draft_cfg is not None
        self.spec_k = config.spec_k
        if self.spec_on:
            self.draft_params = config.draft_params
            self.draft_cfg = config.draft_cfg
            if mesh is not None:
                collectives.check_replicated(
                    self.draft_params, mesh, "draft weights",
                    n_experts=self.draft_cfg.n_experts)
            # the paired draft cache, always monolithic: a small draft
            # needs no paging, and its rollback is a timeline reset
            # (_spec_round)
            self.draft_cache = M.init_cache(
                self.draft_cfg, max_batch, config.max_len,
                torch_dtype(self.draft_cfg.dtype), self.device,
                per_slot=True)
            # the draft's ring length, when it has local layers: a step at
            # a position past it overwrote one still in the window
            self._draft_ring = (paged_kv.ring_len(self.draft_cfg,
                                                  config.max_len)
                                if "local" in self.draft_cfg.pattern
                                else float("inf"))
        self.n_spec_rounds = self.n_spec_drafted = self.n_spec_accepted = 0
        # verify windows whose rejected suffix was rolled back, draft rows
        # reinstalled from a preemption's host stash, rollbacks that undid
        # draft steps in rings or recurrent states, and those of them whose
        # undone ring slots held positions of the window (a wrapped ring)
        self.n_spec_rollbacks = self.n_draft_restores = 0
        self.n_draft_state_rollbacks = self.n_draft_ring_wraps = 0
        self.prefill_chunk = config.prefill_chunk
        self.prefill_budget = config.prefill_budget
        self.prefix_sharing = config.prefix_sharing
        if self.prefix_sharing:
            self.paged.enable_prefix_sharing()
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
        # telemetry is host-side observation only (None = off): request
        # lifecycle spans, engine-phase spans and the metrics registry
        self.kv_monitor = config.kv_monitor
        telemetry = self.tel = config.telemetry
        self._submit_t: dict = {}       # request id -> submit wall time
        self._straggler = None
        if telemetry is not None:
            self._straggler = StragglerMonitor()
            if self.kv_monitor is None:
                self.kv_monitor = KVCacheMonitor(
                    registry=telemetry.registry)
            self.scheduler.telemetry = telemetry
            if self.paged is not None:
                self.paged.telemetry = telemetry
                if self.paged.swap is not None:
                    self.paged.swap.attach_registry(telemetry.registry)
        # kernel builds and loads are process-wide: remember the count at
        # construction so compile events register only when *this* engine
        # triggers one
        self._compiles_seen = build.events()

    # -- telemetry ---------------------------------------------------------

    def _note_compiles(self, phase: str):
        """Publish kernel builds and loads since the last check as compile
        events of ``phase`` ('decode' or 'prefill'), the phase that just
        ran.  ``serving_decode_compile_total`` and
        ``serving_prefill_compile_total`` keep the reference's names, where
        they count jit traces; here they count the ``kernels.build``
        compilations and library loads that happen during this engine's
        life, as deltas from its construction, so a process whose kernels
        are already built and loaded reads 0, as a warm jit cache does."""
        tel = self.tel
        if tel is None:
            return
        n = build.events()
        if n <= self._compiles_seen:
            return
        if phase == "decode":
            tel.registry.counter("serving_decode_compile_total").inc(
                n - self._compiles_seen)
        else:
            tel.registry.counter("serving_prefill_compile_total").inc(
                n - self._compiles_seen)
        if tel.tracer is not None:
            tel.tracer.instant("engine", f"{phase}_compile",
                               args={"step": self.steps})
        self._compiles_seen = n

    def _sample_gauges(self):
        """Per-step level samples: queue depth and slot occupancy, as
        registry gauges (peak-tracking) and tracer counter tracks."""
        tel = self.tel
        if tel is None:
            return
        q = self.scheduler.waiting
        act = sum(1 for s in self.slots if s is not None)
        tel.registry.gauge("serving_queue_depth").set(q)
        tel.registry.gauge("serving_active_slots").set(act)
        if self.prefill_chunk:
            tel.registry.gauge("serving_prefilling_slots").set(
                len(self._prefill_pos))
        if self.prefix_sharing:
            tel.registry.gauge("prefix_shared_pages").set(
                self.paged.n_shared_pages())
        if tel.tracer is not None:
            tel.tracer.counter("serving_queue_depth", q)
            tel.tracer.counter("serving_active_slots", act)

    def _record_monitor(self):
        """The cache's stats (host bookkeeping, no tensor read), merged with
        the scheduler's and the chunked prefill's counters, into the
        KV-cache monitor and the tracer's counter tracks."""
        if self.kv_monitor is None or self.paged is None:
            return
        stats = self.paged.stats()
        stats.update(self.scheduler.counters())
        if self.prefill_chunk:
            stats.update({
                "n_prefill_chunks": self.n_chunks,
                "prefill_chunk_tokens": self.n_chunk_tokens,
                "n_interleaved_steps": self.n_interleaved_steps,
                "prefilling_slots": len(self._prefill_pos),
            })
        self.kv_monitor.record(stats)
        if self.tel is not None and self.tel.tracer is not None:
            tr = self.tel.tracer
            tr.counter("kvcache_pages_in_use",
                       stats.get("pages_in_use", 0))
            if "swap_bytes_used" in stats:
                tr.counter("kvcache_swap_bytes_used",
                           stats["swap_bytes_used"])

    # -- the mesh ----------------------------------------------------------

    def _src(self, shard: int) -> int:
        """Global rank of ``shard``'s model rank 0 (rank ``r`` sits at data
        ``r // n_model``, model ``r % n_model``)."""
        return shard * self.n_model

    def _share(self, obj, shard: int):
        """``obj`` as the first rank of ``shard`` holds it, on every rank
        (``PagedKVCache.share``)."""
        return collectives.broadcast_object(obj, self._src(shard))

    def _shard_of(self, slot: int) -> int:
        """The data group that holds ``slot``."""
        if self.paged is not None:
            return self.paged.shard_of_slot(slot)
        return slot // (self._rows[1] - self._rows[0])

    def _owns(self, slot: int) -> bool:
        """Whether this rank computes ``slot``'s prefill."""
        return not self._split or self._shard_of(slot) == self.d_rank

    def _first_token(self, slot: int, logits, req) -> int:
        """The token sampled from a prefill's last logits, as the slot's
        shard samples it, on every rank."""
        tok = self._sample_one(logits, req) if logits is not None else 0
        if self._split:
            tok = self._share([tok], self._shard_of(slot))[0]
        return tok

    def _gather_tokens(self, local: list) -> list:
        """Every data group's sampled tokens of its rows -> the whole
        batch's, as each group's model rank 0 sampled them."""
        t0 = time.perf_counter()
        got = collectives.gather_rows(
            torch.tensor(local, dtype=torch.int64), self.mesh)
        n_data = got.shape[0] // self.n_model
        toks = got[::self.n_model][:n_data].reshape(-1).tolist()
        self.gather_seconds += time.perf_counter() - t0
        return toks

    # -- scheduling --------------------------------------------------------

    def load(self) -> int:
        """Requests this engine currently owns: occupied slots plus the
        scheduler backlog (queued + preempted).  The router's
        least-loaded placement signal."""
        return (sum(1 for s in self.slots if s is not None)
                + self.scheduler.waiting)

    def prefix_match_tokens(self, prompt) -> int:
        """Longest index-resident prefix of ``prompt`` this engine could
        adopt by reference (0 without prefix sharing).  Advisory: reading
        the index allocates nothing."""
        if self.paged is None or self.paged.prefix is None:
            return 0
        return self.paged.match_prefix(list(prompt))

    def submit(self, req: Request):
        if not 0 < len(req.prompt) <= self.max_len:
            raise ValueError(f"request {req.id}: prompt of {len(req.prompt)}"
                             f" tokens does not fit max_len={self.max_len}")
        self.scheduler.submit(req)
        self._inflight.append(req)
        if self.tel is not None:
            self._submit_t[req.id] = time.perf_counter()
            self.tel.registry.counter(
                "serving_requests_submitted_total").inc()
            if self.tel.requests is not None:
                self.tel.requests.transition(req.id, "queued")

    def _start(self, slot: int, req: Request):
        """Prefill a fresh request and copy its K/V into ``slot``'s pages."""
        tel, t0 = self.tel, time.perf_counter()
        if tel is not None and tel.requests is not None:
            tel.requests.transition(req.id, "prefilling",
                                    args={"slot": slot})
        toks = torch.tensor(req.prompt, dtype=torch.int64,
                            device=self.device)[None, :]
        logits = frag = None
        if self._owns(slot):
            logits, frag = M.prefill(self.params, self.cfg, toks,
                                     max_len=self.max_len, mesh=self.mesh)
        if self.paged is not None:
            self.cache = self.paged.admit(self.cache, slot, frag,
                                          len(req.prompt))
        elif frag is not None:      # the slot's local row
            self.cache = splice_fragment(self.cache, frag,
                                         slot - self._rows[0])
        del frag
        if self.spec_on:
            # the draft consumes the prompt too (its logits are unused: the
            # first token is sampled from the target's prefill)
            _, dfrag = M.prefill(self.draft_params, self.draft_cfg, toks,
                                 max_len=self.max_len)
            self.draft_cache = splice_fragment(self.draft_cache, dfrag, slot)
        self._host_len[slot] = len(req.prompt)
        tok = self._first_token(slot, logits, req)
        req.out_tokens.append(tok)
        self._last_tok[slot] = tok
        self.slots[slot] = req
        now = time.perf_counter()
        self.prefill_seconds += now - t0
        if tel is not None:
            sub = self._submit_t.get(req.id)
            if sub is not None:
                tel.registry.histogram("serving_queue_wait_seconds").observe(
                    t0 - sub)
                tel.registry.histogram("serving_ttft_seconds").observe(
                    now - sub)
            tel.registry.counter("serving_tokens_generated_total").inc()
            if tel.tracer is not None:
                tel.tracer.complete("engine", "prefill", "engine", t0, now,
                                    args={"req": req.id,
                                          "tokens": len(req.prompt)})
            if tel.requests is not None:
                tel.requests.transition(req.id, "decoding")
            self._note_compiles("prefill")

    def _start_chunked(self, slot: int, req: Request):
        """Admit a request for chunked prefill: allocate its page grant
        (``Scheduler.admission_grant``, the count ``pick`` tested against)
        and enter the prefill phase; its chunks run under the step's token
        budget in :func:`_prefill_phase`.

        With prefix sharing, admission matches the prompt against the
        prefix index first: matched pages are adopted by reference
        (``admit_shared``) and prefill resumes at the match boundary, so
        the matched positions are never recomputed."""
        grant = self.scheduler.admission_grant(req)
        matched = 0
        if self.prefix_sharing:
            self.cache, matched = self.paged.admit_shared(
                self.cache, slot, req.prompt, grant)
        else:
            self.cache = self.paged.admit_slot(self.cache, slot, grant)
        self._host_len[slot] = matched
        self._prefill_pos[slot] = matched
        self._prefill_order.append(slot)
        self.slots[slot] = req
        tel = self.tel
        if tel is None:
            return
        if self.prefix_sharing:
            reg = tel.registry
            if matched:
                reg.counter("prefix_hit_total").inc()
                reg.counter("prefix_match_tokens_total").inc(matched)
            else:
                reg.counter("prefix_miss_total").inc()
        sub = self._submit_t.get(req.id)
        if sub is not None:
            tel.registry.histogram("serving_queue_wait_seconds").observe(
                time.perf_counter() - sub)
        if tel.requests is not None:
            tel.requests.transition(req.id, "prefilling",
                                    args={"slot": slot})

    def _resume(self, slot: int, st: Preempted):
        """Re-splice a preempted request: reinstall its page list, fault
        every page back (lossless restore), reinstall its non-paged
        per-slot state (the rings of ``local`` layers and the recurrent
        states, which the slot's requests in between overwrote) and rebuild
        the slot timeline — the
        continuation is bit-identical to an unpreempted run.  A
        mid-prefill record re-enters the prefill phase at
        ``st.prefill_pos`` instead of rejoining the decode batch."""
        tel, t0 = self.tel, time.perf_counter()
        origin = self.paged.swap_shard(st.pages)
        self.cache = self.paged.attach_slot(self.cache, slot, st.pages,
                                            st.skip)
        self.cache = self.paged.fault(self.cache, slot)
        if st.state:
            self.cache = self.paged.restore_slot_state(self.cache, slot,
                                                       st.state, origin)
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
        if tel is not None:
            now = time.perf_counter()
            tel.registry.counter("serving_resumed_total").inc()
            tel.registry.histogram("serving_resume_seconds").observe(
                now - t0)
            if tel.tracer is not None:
                tel.tracer.complete("engine", "resume", "engine", t0, now,
                                    args={"req": st.req.id, "slot": slot})
            if tel.requests is not None:
                tel.requests.transition(
                    st.req.id, ("prefilling" if st.prefill_pos is not None
                                else "decoding"),
                    args={"slot": slot, "resumed": True})

    def _preempt(self, slot: int) -> bool:
        """Swap out a whole active request and requeue it (front of its
        priority class).  Returns False — with the engine state intact —
        when the swap store cannot take the pages."""
        req = self.slots[slot]
        tel, t0 = self.tel, time.perf_counter()
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
            store.sync_registry()
            if tel is not None and tel.tracer is not None:
                tel.tracer.instant("engine", "preempt_aborted",
                                   args={"req": req.id, "slot": slot})
            return False
        state = self.paged.snapshot_slot_state(self.cache, slot)
        pages, skip = self.paged.detach_slot(slot)
        self.scheduler.requeue(Preempted(
            req=req, pages=pages, skip=skip,
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
        if tel is not None:
            now = time.perf_counter()
            tel.registry.counter("serving_preempted_total").inc()
            tel.registry.histogram("serving_preempt_seconds").observe(
                now - t0)
            if tel.tracer is not None:
                tel.tracer.complete("engine", "preempt", "engine", t0, now,
                                    args={"req": req.id, "slot": slot})
            if tel.requests is not None:
                tel.requests.transition(req.id, "preempted")
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
                pc = self.paged
                largest = max(map(pc.shard_capacity, range(pc.n_shards)))
                raise OutOfPages(
                    f"request {bad.id} needs "
                    f"{pc.pages_worst_case(len(bad.prompt), bad.max_new_tokens)}"
                    f" resident pages; largest shard holds {largest} (swap "
                    f"cannot hold a single slot's working set)")
            raise OutOfPages(
                f"queued work cannot be admitted with an empty batch (free "
                f"per shard: {self.paged.free_pages_per_shard})")

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
        """Retire a finished request: clear the slot, publish telemetry,
        release its pages."""
        req.done = True
        self.slots[s] = None
        tel = self.tel
        if tel is not None:
            tel.registry.counter("serving_requests_finished_total").inc()
            sub = self._submit_t.pop(req.id, None)
            if sub is not None:
                tel.registry.histogram(
                    "serving_request_latency_seconds").observe(
                        time.perf_counter() - sub)
            if tel.requests is not None:
                tel.requests.finish(req.id,
                                    args={"tokens": len(req.out_tokens)})
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
        draft cache each draft step would swamp the round.  A global
        layer's row needs the timeline alone: every position at or past
        the restored ``cur_len`` is rewritten by the draft's next step there
        before any step reads it, and ``kv_len = cur_len + 1`` masks it
        until then.  A ``local`` layer's ring does not: a step's write at
        ``cur_len % W`` replaced the position ``W`` back, which the next
        step still attends to; nor does a recurrent layer's state, which
        every step replaces.  So before each draft step the engine keeps
        copies of just what the step overwrites there
        (``models.model.step_overwrites``: the ring slot a layer, the whole
        small state of a recurrent layer), and a rejection puts the
        undone steps' copies back, newest first (``undo_step``).  For an
        attention-only draft the record is empty."""
        k, tel = self.spec_k, self.tel
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
        undo = []                       # what each draft step overwrote
        q_rows = []                     # draft logits per proposal (B, 1, V)
        props = np.zeros((self.max_batch, k), np.int64)
        tok = torch.tensor(self._last_tok, dtype=torch.int64,
                           device=self.device)[:, None]
        for j in range(1, k + 2):
            undo.append(M.step_overwrites(self.draft_cfg, self.draft_cache))
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
                                       self._step_cache(), s, k_eff + 1,
                                       mesh=self.mesh)
            if self._split:
                # the slot's shard verified; every rank rolls back alike
                if logits is None:
                    logits = torch.empty((1, k + 1, self.cfg.vocab_size),
                                         dtype=torch.float32)
                logits = collectives.broadcast_tensor(
                    logits.float(), self._src(self.paged.shard_of_slot(s)))
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
            if undo[0] and len(emit) <= k:
                # undo draft steps len(emit) + 1 .. k + 1, newest first
                for saved in undo[:len(emit) - 1:-1]:
                    M.undo_step(saved, s)
                self.n_draft_state_rollbacks += 1
                # the newest undone step wrote position n_cache + k
                self.n_draft_ring_wraps += n_cache + k >= self._draft_ring
            req.out_tokens.extend(emit)
            self._last_tok[s] = emit[-1]
            self.n_spec_rounds += 1
            self.n_spec_drafted += k_eff
            self.n_spec_accepted += m
            self.n_spec_rollbacks += len(emit) < k_eff + 1
            if tel is not None:
                tel.registry.counter("spec_drafted_total").inc(k_eff)
                tel.registry.counter("spec_accepted_total").inc(m)
                tel.registry.histogram("spec_accept_rate").observe(
                    m / k_eff if k_eff else 0.0)
                tel.registry.counter(
                    "serving_tokens_generated_total").inc(len(emit))
            if (len(req.out_tokens) >= req.max_new_tokens
                    or len(req.prompt) + len(req.out_tokens)
                    >= self.max_len):
                self._finish(s, req)
        now = time.perf_counter()
        self.decode_seconds += now - t0
        if tel is not None:
            tel.registry.histogram("serving_decode_step_seconds").observe(
                now - t0)
            if tel.tracer is not None:
                tel.tracer.complete("engine", "spec_round", "engine", t0,
                                    now, args={"step": self.steps,
                                               "active": len(active)})
            self._note_compiles("decode")

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
                victim = self.scheduler.victim(
                    self.slots, shard=self.paged.shard_of_slot(slot),
                    exclude=(slot,))
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
            if self.prefix_sharing:
                # copy-on-write safety: block-aligned matching makes the
                # chunk start at the match boundary, so this splits
                # nothing on the normal path; a shared page in the write
                # window is copied (every layer, K and V) before the chunk
                # writes in place
                self.cache = self.paged.make_writable(self.cache, slot,
                                                      pos, pos + n - 1)
            toks = torch.tensor(list(part) + [0] * (C - n),
                                dtype=torch.int64, device=self.device)[None]
            tc0 = time.perf_counter()
            logits, _ = M.prefill_chunk(self.params, self.cfg, toks,
                                        self._step_cache(), slot, n,
                                        mesh=self.mesh)
            self._prefill_pos[slot] = pos + n
            self._host_len[slot] = pos + n
            if self.prefix_sharing:
                # publish the newly completed prompt blocks, so concurrent
                # and later requests share them
                self.paged.register_prefix(slot, req.prompt, pos + n)
            self.n_chunks += 1
            self.n_chunk_tokens += n
            spent += n
            tel = self.tel
            if tel is not None:
                tel.registry.histogram(
                    "serving_prefill_chunk_seconds").observe(
                        time.perf_counter() - tc0)
            if pos + n >= len(req.prompt):      # final chunk: first token
                tok = self._first_token(slot, logits, req)
                req.out_tokens.append(tok)
                self._last_tok[slot] = tok
                del self._prefill_pos[slot]
                self._prefill_order.remove(slot)
                if tel is not None:
                    sub = self._submit_t.get(req.id)
                    if sub is not None:
                        tel.registry.histogram(
                            "serving_ttft_seconds").observe(
                                time.perf_counter() - sub)
                    tel.registry.counter(
                        "serving_tokens_generated_total").inc()
                    if tel.requests is not None:
                        tel.requests.transition(req.id, "decoding")
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
        if spent and self.tel is not None:
            if self.tel.tracer is not None:
                self.tel.tracer.complete("engine", "prefill_phase",
                                         "engine", t0,
                                         args={"tokens": spent})
            self._note_compiles("prefill")
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
                victim = self.scheduler.victim(
                    self.slots, shard=self.paged.shard_of_slot(slot),
                    exclude=(slot,))
                if victim is None or not self._preempt(victim):
                    raise

    def _step_cache(self) -> dict:
        """The cache the decode step and the prefill chunk read: without
        the cold-pool leaves while no page is cold (decoding an empty pool
        would be waste); every position's pools and rings stay."""
        if (self.paged is None or not self.paged.compress
                or self.paged.has_cold):
            return self.cache
        return paged_kv.without_cold(self.cache)

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
            if self._prefill_pos:
                self._record_monitor()
                self._sample_gauges()
                return True         # prefill in flight, nothing to decode
            return self.scheduler.waiting > 0
        if self.paged is not None:
            for s in active:   # grow page lists to cover this step's write
                if self.slots[s] is not None:
                    self._ensure_with_pressure(s)
                    if self.prefix_sharing:
                        # copy-on-write safety for the decode write (a
                        # no-op on the normal path: decode writes land past
                        # the prompt, and only full prompt blocks share)
                        self.cache = self.paged.make_writable(
                            self.cache, s, self._host_len[s],
                            self._host_len[s])
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
            self._record_monitor()
            self._sample_gauges()
            return True
        t0 = time.perf_counter()
        last = torch.tensor(self._last_tok, dtype=torch.int64,
                            device=self.device)[:, None]
        lo, hi = self._rows
        if self.paged is None:      # the monolithic cache's rows here
            last = last[lo:hi]
        logits, out = M.decode_step(
            self.params, self.cfg, last, self._step_cache(), mesh=self.mesh,
            rows="shard" if self._split else "all")
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
        # this rank's rows (every row off a split mesh); sampled rows draw
        # on the host's read of their logits
        toks = greedy(logits)[:, 0].tolist()
        for s in active:
            if lo <= s < hi and self.slots[s].temperature > 0:
                toks[s - lo] = self._sample_one(logits[s - lo:s - lo + 1],
                                                self.slots[s])
        if self._split:
            toks = self._gather_tokens(toks)
        now = time.perf_counter()
        self.decode_seconds += now - t0
        if self.tel is not None:
            self._observe_decode(t0, now, len(active))
        for s in active:
            req = self.slots[s]
            t = toks[s]
            req.out_tokens.append(t)
            self._last_tok[s] = t
            self._host_len[s] += 1
            if len(req.out_tokens) >= req.max_new_tokens or (
                    len(req.prompt) + len(req.out_tokens) >= self.max_len):
                self._finish(s, req)
        self._compress_cold()
        self._record_monitor()
        self._sample_gauges()
        return True

    def _observe_decode(self, t0: float, now: float, n_active: int):
        """Publish one decode step ``[t0, now]`` of ``n_active`` slots: one
        timing feeds the step histogram and the straggler monitor (the
        token read that ends the step waited for its device work)."""
        tel = self.tel
        dt = now - t0
        tel.registry.histogram("serving_decode_step_seconds").observe(dt)
        sstat = self._straggler.observe(dt, self.steps)
        tel.registry.gauge("serving_decode_step_ewma_seconds").set(
            self._straggler.ewma_seconds)
        if sstat.is_straggler:
            tel.registry.counter("serving_decode_straggler_total").inc()
            if tel.tracer is not None:
                tel.tracer.instant("engine", "decode_straggler",
                                   args={"step": self.steps, "z": sstat.z,
                                         "seconds": dt})
        if tel.tracer is not None:
            tel.tracer.complete("engine", "decode_step", "engine", t0, now,
                                args={"step": self.steps,
                                      "active": n_active})
        tel.registry.counter("serving_tokens_generated_total").inc(n_active)
        self._note_compiles("decode")

    def _compress_cold(self):
        """Entropy-code every active slot's full pages into the cold pool
        (``compress_cold``), after a decode step or a speculative round."""
        if self.paged is not None and self.paged.compress:
            for s in range(self.max_batch):
                if self.slots[s] is not None:
                    self.cache = self.paged.compress_cold_pages(
                        self.cache, s, self._host_len[s])

    def run(self, max_steps: int = 10_000, on_step=None) -> list:
        """Drain the queue; returns every submitted request that finished
        (queued, admitted or preempted when ``run`` was called).
        ``on_step(step_index)``, when given, is called after every engine
        step (``launch/serve.py`` hangs the periodic stats line and the
        profiler window off it)."""
        for i in range(max_steps):
            busy = self.step()
            if on_step is not None:
                on_step(i)
            if not busy and not any(s is not None for s in self.slots):
                break
        done = [r for r in self._inflight if r.done]
        self._inflight = [r for r in self._inflight if not r.done]
        return done
