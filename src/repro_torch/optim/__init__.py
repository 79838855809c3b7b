"""Optimizers and LR schedules of the port (elementwise torch, no optax)."""
from .optimizers import (
    AdamWState,
    OptState,
    SGDState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgd_momentum,
)
from .schedules import constant_schedule, cosine_schedule, linear_warmup, warmup_cosine

__all__ = [
    "AdamWState", "OptState", "SGDState", "adamw", "apply_updates",
    "clip_by_global_norm", "global_norm", "make_optimizer", "sgd_momentum",
    "constant_schedule", "cosine_schedule", "linear_warmup", "warmup_cosine",
]
