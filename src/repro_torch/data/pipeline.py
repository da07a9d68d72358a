"""Deterministic synthetic token pipeline: the reference's
``data/pipeline.py``, its numpy generator copied as it is.

Batch ``i`` is a pure function of ``(seed, i)``: any process can
(re)generate any batch, so a restart needs only the step counter from the
checkpoint.  The stream is a fixed-vocab LCG-mixed sequence with a
learnable structure (next token = f(previous tokens), with noise), so a
small model's loss falls.  :meth:`SyntheticLMData.batch_numpy` is
bit-identical to the reference's; :meth:`SyntheticLMData.batch` hands the
same int32 batch to torch on a device.  The reference's multi-host
``sharded_batch`` and ``make_global_array`` wait for the port's multi-GPU
slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structure of the synthetic language (see _gen_tokens)
    n_states: int = 97          # hidden markov-ish state count
    noise: float = 0.1          # probability of a uniform-random token


class SyntheticLMData:
    """Deterministic synthetic LM batches; batch i is a function of (seed, i).

    ``batch(i)`` -> dict(tokens (B, T) int32, labels (B, T) int32) where
    labels are next-token targets (tokens shifted left; last label wraps).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _gen_tokens(self, rows: np.ndarray) -> np.ndarray:
        """Generate the token matrix for *global* row ids ``rows``.

        Every row is a pure function of (seed, row id): the noise streams
        are drawn from a per-row SeedSequence, so any process generating
        any subset of rows produces identical tokens."""
        c = self.cfg
        T = c.seq_len + 1
        n = len(rows)
        noise = np.empty((n, T))
        rand_toks = np.empty((n, T), dtype=np.int64)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                np.random.SeedSequence([c.seed, int(r)]))
            noise[i] = rng.random(T)
            rand_toks[i] = rng.integers(0, c.vocab_size, size=T)
        is_noise = noise < c.noise
        # structured stream: token = state-projected value, state advances
        # by an LCG of (state, token); occasional uniform noise
        toks = np.empty((n, T), dtype=np.int64)
        s = (rows.astype(np.int64) * 2654435761) % c.n_states
        for t in range(T):
            tok = (s * 7919 + 13) % c.vocab_size
            tok = np.where(is_noise[:, t], rand_toks[:, t], tok)
            toks[:, t] = tok
            s = (s * 6364136223846793005 + tok + 1442695040888963407) \
                % c.n_states
        return toks.astype(np.int32)

    def batch_numpy(self, idx: int, rows: np.ndarray | None = None) -> dict:
        """Host-side batch for the given local row ids (default: all)."""
        c = self.cfg
        if rows is None:
            rows = np.arange(c.global_batch, dtype=np.int64)
        rows = np.asarray(rows) + np.int64(idx) * c.global_batch
        toks = self._gen_tokens(rows)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, idx: int, device="cuda") -> dict:
        """The batch as int32 tensors on ``device`` (the card by default)."""
        dev = resolve(device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in self.batch_numpy(idx).items()}
