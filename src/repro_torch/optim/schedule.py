"""Learning-rate schedules (pure functions of the step counter; a copy of
``repro/optim/schedule.py``), computed in float32."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup then cosine decay to ``min_ratio * peak_lr``: a
    function of the step (an int or a tensor) giving a float32 0-d tensor
    on the step's device."""

    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * s / max(1, warmup_steps)
        t = torch.clamp(
            (s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (
            min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr
