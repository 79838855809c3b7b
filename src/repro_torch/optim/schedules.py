"""Learning-rate schedules as step -> lr callables on int32 step tensors,
mirroring ``repro/optim/schedules.py`` (float32 arithmetic)."""
from __future__ import annotations

import math

import torch

__all__ = ["constant_schedule", "linear_warmup", "cosine_schedule", "warmup_cosine"]


def constant_schedule(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32, device=step.device)
    return fn


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = step.float()
        return lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = torch.clamp(step.float(), max=float(total_steps))
        cos = 0.5 * (1.0 + torch.cos(math.pi * s / max(total_steps, 1)))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        decay = final_frac + (1.0 - final_frac) * cos
        return lr * torch.where(s < warmup_steps, warm, decay)
    return fn
