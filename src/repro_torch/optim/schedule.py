"""LR schedules (port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to ``final_frac * base_lr`` at ``total``. The returned function takes
    a step (int or tensor) and gives an f32 tensor on its device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr
