"""Learning-rate schedules, pure functions of the step counter (port of
``repro.optim.schedule``).

Both return a float32 tensor on the step's device (the CPU for a Python
int), computed in float32 as the reference computes them, so a trainer
can evaluate them on a device-resident step count without a host sync.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _f32(step) -> Tensor:
    if isinstance(step, Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def linear_warmup(step, warmup_steps: int) -> Tensor:
    """min(1, (step + 1) / warmup_steps)."""
    s = _f32(step)
    return torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0, min_frac=0.1) -> Tensor:
    """Warmup → cosine decay to min_frac.  Returns a multiplier in (0, 1]."""
    s = _f32(step)
    warm = linear_warmup(s, warmup_steps)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_frac + (1.0 - min_frac) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * cos
