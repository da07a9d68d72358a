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
  * decode steps always run the full batch; inactive slots read and write
    the garbage page and their rows are never used.

Weights may be an ECF8-compressed tree (``core.store.compress_tree``):
every weight is decoded where it is used (the ECF8 decode kernel).
Sampling keys fold ``(rng_seed, request.id, position)`` only, so a
request's sampled stream does not depend on batching.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import torch

from ..configs.base import ArchConfig
from ..core.store import torch_dtype
from ..device import resolve
from ..kvcache import OutOfPages, PagedKVCache
from ..models import model as M
from .config import EngineConfig
from .sampler import greedy, key_generator, request_key, root_key, \
    sample_logits
from .scheduler import Scheduler

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


class GenerationEngine:
    def __init__(self, params, cfg: ArchConfig,
                 config: EngineConfig | None = None, device="cuda"):
        """``params`` must already live on ``device`` (the card unless the
        caller asks for the CPU)."""
        config = (config or EngineConfig()).validate(cfg)
        M.check_supported(cfg)
        self.device = resolve(device)
        self.params, self.cfg = params, cfg
        self.max_batch = max_batch = config.max_batch
        self.max_len = config.max_len
        self.slots: list = [None] * max_batch   # Request or None
        self._inflight: list = []               # submitted, not yet returned
        self.paged = PagedKVCache(
            cfg, max_batch, config.max_len, dtype=torch_dtype(cfg.dtype),
            device=self.device, page_size=config.page_size,
            n_pages=config.n_pages)
        self.cache = self.paged.init_cache()
        self.scheduler = Scheduler(paged=self.paged)
        self._host_len = [0] * max_batch        # next write position per slot
        self._last_tok = [0] * max_batch        # decode input per slot
        self.rng0 = root_key(config.rng_seed)
        self.steps = 0
        # host wall time of the two phases, each ending in a host read of
        # the sampled tokens (which waits for the device work)
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
        self.cache = self.paged.admit(self.cache, slot, frag, len(req.prompt))
        self._host_len[slot] = len(req.prompt)
        tok = self._sample_one(logits, req)
        req.out_tokens.append(tok)
        self._last_tok[slot] = tok
        self.slots[slot] = req
        self.prefill_seconds += time.perf_counter() - t0

    def _admit(self):
        """Fill free slots from the scheduler."""
        for slot in range(self.max_batch):
            if self.slots[slot] is not None:
                continue
            req = self.scheduler.pick()
            if req is not None:
                self._start(slot, req)
        if self.scheduler.waiting and not any(
                s is not None for s in self.slots):
            # every slot is free yet nothing could be admitted: no release
            # will ever refill the free list
            bad = self.scheduler.impossible()
            raise OutOfPages(
                f"request {bad.id if bad else '?'} cannot be admitted: the "
                f"pool holds {self.paged.capacity()} pages")

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
        self.cache = self.paged.release(self.cache, s)

    def step(self) -> bool:
        """Admit what fits, then one batched decode step for the active
        slots.  Returns False when idle."""
        self._admit()
        active = [s for s in range(self.max_batch)
                  if self.slots[s] is not None]
        if not active:
            return self.scheduler.waiting > 0
        for s in active:   # grow page lists to cover this step's write
            self.cache = self.paged.ensure(self.cache, s, self._host_len[s])
        t0 = time.perf_counter()
        last = torch.tensor(self._last_tok, dtype=torch.int64,
                            device=self.device)[:, None]
        logits, self.cache = M.decode_step(self.params, self.cfg, last,
                                           self.cache)
        self.steps += 1
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
        return True

    def run(self, max_steps: int = 10_000) -> list:
        """Drain the queue; returns every submitted request that finished."""
        for _ in range(max_steps):
            busy = self.step()
            if not busy and not any(s is not None for s in self.slots):
                break
        done = [r for r in self._inflight if r.done]
        self._inflight = [r for r in self._inflight if not r.done]
        return done
