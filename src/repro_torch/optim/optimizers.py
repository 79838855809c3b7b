"""SGD+momentum (the paper's DSGD setting: lr 0.05, momentum 0.9, wd 1e-4)
and AdamW, as (init, update) pairs over parameter dicts, mirroring
``repro/optim/optimizers.py``.

Every function is elementwise, so it runs unchanged on one worker's
parameters or, under ``torch.func.vmap``, on the stacked (n, ...) leaves of
all workers at once. The state is float32 whatever the parameter dtype.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["SGDState", "AdamWState", "OptState", "sgd_momentum", "adamw",
           "apply_updates", "global_norm", "clip_by_global_norm", "make_optimizer"]


class SGDState(NamedTuple):
    momentum: dict  # pytree like params
    step: torch.Tensor


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor


OptState = SGDState | AdamWState


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads), g


def apply_updates(params, updates):
    """``p + u``, the float32 update cast to the parameter dtype first."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _lr_fn(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def sgd_momentum(lr: Callable | float, momentum: float = 0.9, weight_decay: float = 1e-4,
                 nesterov: bool = False):
    """Paper §VI-B hyper-parameters by default. Returns (init, update);
    ``update(grads, state, params) -> (updates, new_state)``."""
    lr_fn = _lr_fn(lr)

    def init(params) -> SGDState:
        return SGDState(tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                        _step0(params))

    def update(grads, state: SGDState, params):
        step = state.step + 1
        lr_t = lr_fn(step)

        def upd(g, m, p):
            g = g.float() + weight_decay * p.float()
            m_new = momentum * m + g
            d = (g + momentum * m_new) if nesterov else m_new
            return -lr_t * d, m_new

        flat = tree_map(upd, grads, state.momentum, params)
        is_pair = lambda t: isinstance(t, tuple)
        updates = tree_map(lambda t: t[0], flat, is_leaf=is_pair)
        m_new = tree_map(lambda t: t[1], flat, is_leaf=is_pair)
        return updates, SGDState(m_new, step)

    return init, update


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    lr_fn = _lr_fn(lr)

    def init(params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(tree_map(zeros, params), tree_map(zeros, params), _step0(params))

    def update(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(g, mu, nu, p):
            g = g.float()
            mu_new = b1 * mu + (1 - b1) * g
            nu_new = b2 * nu + (1 - b2) * torch.square(g)
            d = (mu_new / c1) / (torch.sqrt(nu_new / c2) + eps) + weight_decay * p.float()
            return -lr_t * d, mu_new, nu_new

        flat = tree_map(upd, grads, state.mu, state.nu, params)
        is_t = lambda t: isinstance(t, tuple)
        updates = tree_map(lambda t: t[0], flat, is_leaf=is_t)
        mu_new = tree_map(lambda t: t[1], flat, is_leaf=is_t)
        nu_new = tree_map(lambda t: t[2], flat, is_leaf=is_t)
        return updates, AdamWState(mu_new, nu_new, step)

    return init, update


def make_optimizer(name: str, lr, **kw):
    """Registry used by the launcher (--optimizer sgd|adamw)."""
    if name == "sgd":
        return sgd_momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise KeyError(f"unknown optimizer {name!r}")
