"""Token samplers (pure functions over final-position logits).

Every random draw is keyed by a ``torch.Generator`` seeded from a fixed
mix of ``(seed, request id, position)`` — the reference's key discipline
(``jax.random.fold_in(fold_in(root, id), position)``), so a request's
sampled stream is a pure function of its own state, independent of
batching and scheduling.  The bits differ from JAX's: only the discipline
is shared.
"""
from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64 finaliser: a bijective 64-bit mix."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def greedy(logits):
    """logits (B, 1, V) -> (B, 1) int32."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def root_key(seed: int) -> int:
    """The engine's root key: everything downstream derives from it via
    :func:`request_key`."""
    return _mix64(seed & _M64)


def request_key(rng0: int, req_id: int, position: int) -> int:
    """The per-draw key: fold the request id, then the token position, into
    the root key (a 63-bit seed for :func:`key_generator`)."""
    return _mix64(_mix64(rng0 ^ (req_id & _M64)) ^ (position & _M64)) >> 1


def key_generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(key)


def filter_logits(x, *, top_k: int = 0, top_p: float = 0.0):
    """Mask logits ``x`` (B, V) float32 to the sampling support.

    top-k keeps the k largest entries; top-p keeps the smallest set whose
    softmax mass reaches ``top_p``.  Excluded entries become ``-inf``;
    included entries are returned **unchanged** (no renormalization)."""
    if top_k:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, -torch.inf, x)
    if top_p:
        srt = torch.sort(x, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        # smallest set with cumulative mass >= top_p
        cutoff_idx = torch.argmax((cum >= top_p).to(torch.uint8), dim=-1)
        cutoff = torch.gather(srt, -1, cutoff_idx[:, None])
        x = torch.where(x < cutoff, -torch.inf, x)
    return x


def sample_logits(logits, gen: torch.Generator, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0):
    """Temperature / top-k / top-p sampling.  logits (B, 1, V) -> (B, 1).

    ``temperature <= 0`` is exact greedy; otherwise a Gumbel-max draw
    (the construction of ``jax.random.categorical``) from ``gen``."""
    if temperature <= 0.0:
        return greedy(logits)
    x = filter_logits(logits[:, -1, :].float() / temperature, top_k=top_k,
                      top_p=top_p)
    u = torch.rand(x.shape, generator=gen, device=x.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(x + gumbel, dim=-1).to(torch.int32)[:, None]


def residual_probs(p, q):
    """The exact rejection-sampling residual ``max(0, p - q) / Z``.

    ``p`` / ``q`` are probability vectors (..., V): the target's and the
    draft's distributions at one position.  ``Z = sum(max(0, p - q))`` is
    the total rejection probability, so drawing from the residual after a
    rejection makes the next token's marginal exactly ``p``.  ``p == q``
    gives ``Z == 0``, where a rejection cannot happen; the function then
    returns ``p`` to stay total (the reference's convention)."""
    r = torch.clamp(p - q, min=0.0)
    z = r.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, r / torch.where(z > 0, z, torch.ones_like(z)),
                       p)
