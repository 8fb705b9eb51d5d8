"""Learning-rate schedules (pure functions of the int step), in f32 as the
JAX package computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                  * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def linear(step, *, peak: float, warmup: int, total: int) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return torch.where(step < warmup, warm, peak * (1 - t))


def constant(step, *, peak: float, **_) -> torch.Tensor:
    return torch.full((), peak, dtype=torch.float32)
