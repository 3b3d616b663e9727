"""LR schedules, pure functions of the step counter (counterpart of
``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup: int,
                       total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; an f32 tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
