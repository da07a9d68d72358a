"""Exact rejection sampling for speculative decoding.

A draft model proposes ``k`` tokens; the target scores all ``k + 1``
positions in one verify forward (``models.model.verify_chunk``), and this
module decides which proposals survive.  At each position, with target
distribution ``p`` and draft distribution ``q``, a proposal ``t ~ q`` is
accepted with probability ``min(1, p(t) / q(t))``; on rejection the token
is drawn again from the residual ``max(0, p - q) / Z``
(``sampler.residual_probs``).  The marginal is exactly ``p``, so
speculative decoding is distribution-identical to target-only decoding,
and token-identical under greedy, where acceptance is the argmax
comparison and every emitted token is an argmax of the target's logits.

Key discipline (the reference's): every draw at absolute token position
``pos`` is a function of ``(seed, request id, pos, tag)`` alone:

  * the draft proposal for ``pos`` uses the plain-decode rule and key
    (``sample_logits`` with ``request_key(rng0, req_id, pos)``), so a
    draft that agrees with the target reproduces the plain-decode stream;
  * the acceptance uniform folds in :data:`ACCEPT_DRAW`;
  * the residual draw folds in :data:`RESIDUAL_DRAW`;
  * the bonus token after a fully accepted window uses the plain-decode
    rule and key on the target's logits.

None of these depends on ``k``, on where ``pos`` falls in a verify
window, or on preemption.  The tags are folded into the port's
``request_key`` with its ``_mix64``: the bits differ from JAX's, the
discipline is the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from .sampler import _mix64, key_generator, request_key, residual_probs, \
    sample_logits

# fold-in tags separating the three draw streams of a position: the base
# key is the proposal / plain-decode draw
ACCEPT_DRAW = 1
RESIDUAL_DRAW = 2


def accept_key(rng0: int, req_id: int, position: int) -> int:
    """Key of the acceptance uniform at ``position``."""
    return _mix64(request_key(rng0, req_id, position) ^ ACCEPT_DRAW) >> 1


def residual_key(rng0: int, req_id: int, position: int) -> int:
    """Key of the residual draw at ``position``."""
    return _mix64(request_key(rng0, req_id, position) ^ RESIDUAL_DRAW) >> 1


def propose(q_logits, rng0: int, req_id: int, position: int,
            temperature: float) -> int:
    """One draft proposal from ``q_logits`` (1, 1, V) for absolute token
    ``position``: exactly the plain-decode rule and key (on the logits'
    device), so a draft that agrees with the target reproduces the
    plain-decode token stream."""
    if temperature <= 0:
        return int(torch.argmax(q_logits[0, -1]))
    gen = key_generator(request_key(rng0, req_id, position), q_logits.device)
    return int(sample_logits(q_logits, gen, temperature=temperature)[0, 0])


def verify(p_logits, q_logits, proposals, *, rng0: int, req_id: int,
           pos0: int, temperature: float, device="cuda"):
    """Exact rejection sampling over one verify window.

    Args:
      p_logits: (n + 1, V) target logits (array-like); row ``i`` scores the
        token at absolute position ``pos0 + i``.
      q_logits: (n, V) draft logits; row ``i`` is the distribution
        ``proposals[i]`` was drawn from.
      proposals: the n drafted tokens.
      rng0 / req_id: the engine's root key and the request id.
      pos0: absolute position of the first proposal.
      temperature: the request's; ``<= 0`` is the exact greedy path (numpy
        argmax comparisons, no randomness).
      device: where the draws run (the engine's: the bonus token then
        draws exactly as plain decode does there); the card unless the
        caller asks for the CPU.

    Returns ``(tokens, n_accepted)``: the accepted prefix of the proposals
    and one more token, the residual draw at the first rejection or the
    bonus token after a fully accepted window; ``len(tokens) ==
    n_accepted + 1``."""
    dev = resolve(device)
    n = len(proposals)
    p_logits = np.asarray(p_logits, np.float32)
    if temperature <= 0:
        out = []
        for i, t in enumerate(proposals):
            tgt = int(np.argmax(p_logits[i]))
            if int(t) != tgt:
                return out + [tgt], i
            out.append(int(t))
        return out + [int(np.argmax(p_logits[n]))], n

    p_log = torch.from_numpy(p_logits).to(dev)
    if n:
        p = torch.softmax(p_log / temperature, dim=-1)
        q = torch.softmax(torch.from_numpy(np.asarray(
            q_logits, np.float32).reshape(n, -1)).to(dev) / temperature,
            dim=-1)
        us = torch.stack([torch.rand(
            (), generator=key_generator(accept_key(rng0, req_id, pos0 + i),
                                        dev), device=dev)
            for i in range(n)])
        idx = torch.arange(n, device=dev)
        t = torch.as_tensor([int(x) for x in proposals], device=dev)
        # accept iff u < min(1, p(t) / q(t))  <=>  u * q(t) < p(t)
        ok = (us * q[idx, t] < p[idx, t]).tolist()
        m = ok.index(False) if False in ok else n
        if m < n:
            r = residual_probs(p[m], q[m])
            gen = key_generator(residual_key(rng0, req_id, pos0 + m), dev)
            tok = int(sample_logits(torch.log(r)[None, None], gen,
                                    temperature=1.0)[0, 0])
            return [int(x) for x in proposals[:m]] + [tok], m
    # fully accepted window: the bonus token draws from the target's last
    # row with the plain-decode rule and key
    gen = key_generator(request_key(rng0, req_id, pos0 + n), dev)
    bonus = int(sample_logits(p_log[n][None, None], gen,
                              temperature=temperature)[0, 0])
    return [int(x) for x in proposals] + [bonus], n
