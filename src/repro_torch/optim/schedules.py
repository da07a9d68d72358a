"""Learning-rate schedules (the reference's ``optim/schedules.py``): f32
functions of the step counter, as 0-d tensors on the counter's device."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _linear_warmup(step, warmup_steps: int, peak: float):
    """0 -> peak over ``warmup_steps`` (then flat)."""
    frac = torch.clamp(torch.as_tensor(step).to(F32) / max(warmup_steps, 1),
                       max=1.0)
    return peak * frac


def _cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                     floor: float = 0.0):
    """Linear warmup then cosine decay to ``floor`` at ``total_steps``."""
    step = torch.as_tensor(step).to(F32)
    warm = _linear_warmup(step, warmup_steps, peak)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


# Bound at the file's tail, as ``optim/adamw.py`` binds its functions: the
# reference's jitted train step reaches these names across files.
linear_warmup = _linear_warmup
cosine_schedule = _cosine_schedule
