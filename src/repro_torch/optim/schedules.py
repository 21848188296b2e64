"""Learning-rate schedules (``repro.optim.schedules``), in float32 as the
reference computes them from a float32 step."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(step, *, base_lr, total_steps, min_frac=0.1):
    """base_lr (min_frac + (1 - min_frac) (1 + cos(pi frac)) / 2), frac =
    step / total_steps clipped to [0, 1]; a 0-dim float32 tensor on the
    step's device (the host for a number)."""
    frac = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return base_lr * (min_frac + (1.0 - min_frac) * cos)


def linear_warmup_cosine(step, *, base_lr, warmup_steps, total_steps,
                         min_frac=0.1):
    """Linear warm-up over ``warmup_steps``, then ``cosine_schedule`` over
    the remaining ``total_steps - warmup_steps``."""
    step = _f32(step)
    warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    decay = cosine_schedule(torch.clamp(step - warmup_steps, min=0.0),
                            base_lr=base_lr,
                            total_steps=max(total_steps - warmup_steps, 1),
                            min_frac=min_frac)
    return torch.where(step < warmup_steps, warm, decay)
