"""DSGD training steps (Lian et al. 2017, adapt-then-combine):

    x_i ← Σ_j W_ij · ( x_j − lr · ∇f_j(x_j) )

The single-device paths of ``repro/dsgd/trainer.py``: the n workers are
stacked on a leading (n,) axis of every leaf on one device.

  dsgd_train_step       gossip over the topology's W, by default through
                        the ``gossip_mix_batched`` kernel
  allreduce_train_step  centralized baseline (W = 11ᵀ/n, exact averaging)

Gradients of all workers come from one ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the worker axis, as the reference's
``jax.vmap(jax.value_and_grad)``: each op of the model runs once for all n
workers. The optimizer is vmapped the same way; the update, the gossip and
the metrics run under ``torch.no_grad()``.

The elastic runtime's step (:mod:`.elastic`) is this step with the fault
masks as arguments. ``make_matmul_gossip_train_step`` and
``make_sharded_train_step`` are multi-device work, not ported yet
(ROADMAP.md, Queue 1, item 7).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..core.graph import Topology, weight_matrix_from_weights
from ..device import resolve_device
from ..models import transformer
from ..optim import apply_updates
from .gossip import gossip_sim_tree, padded_neighbors

__all__ = ["DSGDState", "init_dsgd_state", "stack_workers", "dsgd_train_step",
           "allreduce_train_step"]


class DSGDState(NamedTuple):
    """Per-worker replicas stacked on a leading (n,) axis."""
    params: Any
    opt: Any
    step: torch.Tensor


def stack_workers(tree, n_workers: int):
    """n identical copies of every leaf, stacked on a new leading axis."""
    return tree_map(lambda x: x.unsqueeze(0).expand((n_workers,) + tuple(x.shape))
                    .contiguous(), tree)


def init_dsgd_state(seed: int | torch.Generator, cfg, n_workers: int, opt_init: Callable,
                    *, device: str | torch.device = "cuda") -> DSGDState:
    """All workers start from identical params (standard DSGD init: the
    consensus error starts at 0). The weights are drawn on the CPU from
    ``seed`` and then moved, so every device starts from the same ones."""
    dev = resolve_device(device)
    params = tree_map(lambda x: x.to(dev), transformer.init_params(seed, cfg))
    return DSGDState(stack_workers(params, n_workers),
                     stack_workers(opt_init(params), n_workers),
                     torch.zeros((), dtype=torch.int32, device=dev))


def _loss_fn(cfg, aux_weight: float = 0.01):
    def fn(params, batch):
        return transformer.train_loss(params, cfg, batch, aux_weight=aux_weight)
    return fn


def _consensus_error(params) -> torch.Tensor:
    """‖x − x̄‖_F over all stacked leaves (the paper's consensus metric)."""
    def leaf_err(x):
        return torch.sum(torch.square((x - x.mean(dim=0, keepdim=True)).float()))
    return torch.sqrt(sum(leaf_err(x) for x in tree_leaves(params)))


def _make_step(cfg, opt_update: Callable, mix: Callable):
    """The train step around ``mix(params, step)``, which gossips the
    updated parameters; ``step`` is the state's step count, a tensor on the
    device (the dynamic step selects its matching from it)."""
    grad_fn = torch.func.vmap(torch.func.grad_and_value(_loss_fn(cfg)))
    opt_fn = torch.func.vmap(opt_update)

    def step(state: DSGDState, batch):
        grads, losses = grad_fn(state.params, batch)
        with torch.no_grad():
            updates, opt = opt_fn(grads, state.opt, state.params)
            del grads
            params = mix(apply_updates(state.params, updates), state.step)
            metrics = {"loss": losses.mean(), "loss_max": losses.max(),
                       "consensus_err": _consensus_error(params)}
        return DSGDState(params, opt, state.step + 1), metrics

    return step


def dsgd_train_step(cfg, topo: Topology, opt_update: Callable, *, use_kernel: bool = True,
                    device: str | torch.device = "cuda"):
    """Returns ``step(state, batch) -> (state, metrics)``; batch leaves are
    (n, b, ...) on ``device``. The metrics stay on the device until read.
    The padded neighbour table is built once, here, and kept on the device."""
    dev = resolve_device(device)
    W = torch.tensor(weight_matrix_from_weights(topo.n, topo.edges, topo.g),
                     dtype=torch.float32, device=dev)
    nbr = padded_neighbors(W) if use_kernel else None
    return _make_step(cfg, opt_update,
                      lambda p, _: gossip_sim_tree(p, W, use_kernel=use_kernel, nbr=nbr))


def allreduce_train_step(cfg, n_workers: int, opt_update: Callable, *,
                         device: str | torch.device = "cuda"):
    """Centralized all-reduce baseline: exact parameter averaging each step,
    by the dense W matmul as in the reference."""
    W = torch.full((n_workers, n_workers), 1.0 / n_workers, dtype=torch.float32,
                   device=resolve_device(device))
    return _make_step(cfg, opt_update, lambda p, _: gossip_sim_tree(p, W, use_kernel=False))
