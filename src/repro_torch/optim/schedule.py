"""LR schedules (the port of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak``; the schedule
    takes the step count (an int or a tensor) and returns a float32
    tensor on the step's device."""

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
