"""DSGD training steps (Lian et al. 2017, adapt-then-combine):

    x_i ← Σ_j W_ij · ( x_j − lr · ∇f_j(x_j) )

The paths of ``repro/dsgd/trainer.py``:

  dsgd_train_step          one device: the n workers stacked on a leading
                           (n,) axis of every leaf, gossip over the
                           topology's W, by default through the
                           ``gossip_mix_batched`` kernel
  allreduce_train_step     centralized baseline (W = 11ᵀ/n, exact averaging)
  make_sharded_train_step  one worker a rank of a ``torch.distributed``
                           process group: every leaf keeps a leading worker
                           axis of size 1, and the gossip is the schedule's
                           matching rounds as point-to-point sends
                           (``gossip_shard``), or a float32 all-reduce mean

Gradients come from one ``torch.func.vmap`` of ``torch.func.grad_and_value``
over the worker axis, as the reference's ``jax.vmap(jax.value_and_grad)``:
each op of the model runs once for all the workers a process holds (n
stacked, or 1 in a rank). The optimizer is vmapped the same way; the
update, the gossip and the metrics run under ``torch.no_grad()``.

The elastic runtime's step (:mod:`.elastic`) is this step with the fault
masks as arguments. ``make_matmul_gossip_train_step`` and
``make_tp_train_step`` need tensor parallelism inside a worker and are not
ported yet (ROADMAP.md, Queue 1, item 7c); they raise.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from ..core.graph import Topology, weight_matrix_from_weights
from ..device import resolve_device
from ..models import transformer
from ..optim import apply_updates
from .gossip import gossip_shard, gossip_sim_tree, padded_neighbors
from .schedule import GossipSchedule

__all__ = ["DSGDState", "init_dsgd_state", "stack_workers", "dsgd_train_step",
           "allreduce_train_step", "make_matmul_gossip_train_step", "make_sharded_train_step",
           "make_tp_train_step"]


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


def make_matmul_gossip_train_step(*args, **kwargs):
    """The reference's stacked step under pjit for pod-sized workers: not
    ported (it needs tensor parallelism inside a worker)."""
    raise NotImplementedError(
        "make_matmul_gossip_train_step is pjit/GSPMD work and is not ported yet "
        "(ROADMAP.md, Queue 1, item 7c)")


def make_tp_train_step(*args, **kwargs):
    """The reference's single-worker tensor-parallel step: not ported."""
    raise NotImplementedError(
        "make_tp_train_step is tensor-parallel pjit work and is not ported yet "
        "(ROADMAP.md, Queue 1, item 7c)")


# ---------------------------------------------------------------------------
# one worker a rank of a process group
# ---------------------------------------------------------------------------

def _gossip_group(mesh, gossip_axes=("data",)):
    """The process group hosting the workers of ``mesh`` along
    ``gossip_axes``: the default group, whose ranks the gossip dims must
    list in order, row-major as ``ppermute`` flattens a tuple of mesh axes.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``. A mesh dim
    outside ``gossip_axes`` larger than 1 would be tensor parallelism inside
    a worker, and gossip dims over a part of the world or out of rank order
    a sub-group: neither is ported, and both raise (ROADMAP.md, Queue 1,
    item 7c). Before it returns, every rank of the group meets in one
    barrier: the group's first point-to-point exchange, in which an idle
    rank posts nothing, then follows a collective of the whole group, as
    NCCL requires of ``batch_isend_irecv``.
    """
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in gossip_axes if a not in names]
    if missing or not gossip_axes:
        raise ValueError(f"gossip_axes {gossip_axes} are not dims of the mesh {names}")
    sizes = dict(zip(names, mesh.mesh.shape))
    tp = {a: sizes[a] for a in names if a not in gossip_axes and sizes[a] > 1}
    if tp:
        raise NotImplementedError(
            f"mesh dims {tp} outside gossip_axes {tuple(gossip_axes)} are tensor parallelism "
            "inside a worker, which is not ported yet (ROADMAP.md, Queue 1, item 7c)")
    order = [names.index(a) for a in gossip_axes]
    order += [d for d in range(len(names)) if d not in order]
    ranks = mesh.mesh.permute(order).reshape(-1).tolist()
    if ranks != list(range(len(ranks))) or len(ranks) != dist.get_world_size():
        raise NotImplementedError(
            f"gossip_axes {tuple(gossip_axes)} flatten the mesh to ranks {ranks}, not the whole "
            "default group in rank order: a gossip sub-group is not ported yet (ROADMAP.md, "
            "Queue 1, item 7c)")
    dist.barrier()
    return dist.group.WORLD


def _group_mean(value: torch.Tensor, weight, group) -> torch.Tensor:
    """``Σ value·weight / Σ weight`` over the ranks of ``group``, float32,
    in one all-reduce (with weight 1 the reference's ``pmean``); every rank
    gets the same bits."""
    w = torch.as_tensor(weight, dtype=torch.float32, device=value.device)
    t = torch.stack([value.float() * w, w])
    dist.all_reduce(t, group=group)
    return t[0] / t[1]


def _allreduce_mean(tree, group):
    """Every leaf replaced by its float32 mean over the ranks of ``group``
    (the reference's ``pmean`` in float32), cast back to its dtype: one
    all-reduce of all leaves packed in one float32 buffer."""
    leaves, spec = tree_flatten(tree)
    if not leaves:
        return tree
    buf = torch.cat([x.reshape(-1).float() for x in leaves])
    dist.all_reduce(buf, group=group)
    buf /= dist.get_world_size(group)
    out, off = [], 0
    for x in leaves:
        out.append(buf[off:off + x.numel()].view(x.shape).to(x.dtype, copy=True))
        off += x.numel()
    return tree_unflatten(out, spec)


_SYNCS = ("gossip", "allreduce", "none")


def make_sharded_train_step(cfg, sched: GossipSchedule, opt_update: Callable, mesh, *,
                            gossip_axes=("data",), sync: str = "gossip"):
    """The DSGD step of one worker a rank: ``step(state, batch) -> (state,
    {"loss": loss})``, called by every rank of the mesh together.

    Each rank holds its worker's state and batch with the reference's
    leading worker axis of size 1 on every leaf. ``gossip_axes``: the mesh
    dim(s) hosting the n workers (see :func:`_gossip_group`). ``sync``:
    ``"gossip"`` mixes the updated parameters over the schedule's matching
    rounds (:func:`~repro_torch.dsgd.gossip.gossip_shard`), ``"allreduce"``
    averages every leaf in float32 over the workers (the centralized
    baseline), ``"none"`` exchanges nothing. The loss is its mean over the
    workers, the same on every rank.
    """
    if sync not in _SYNCS:
        raise ValueError(f"sync={sync!r}; expected one of {_SYNCS}")
    group = _gossip_group(mesh, tuple(gossip_axes))
    grad_fn = torch.func.vmap(torch.func.grad_and_value(_loss_fn(cfg)))
    opt_fn = torch.func.vmap(opt_update)

    def step(state: DSGDState, batch):
        grads, losses = grad_fn(state.params, batch)
        with torch.no_grad():
            updates, opt = opt_fn(grads, state.opt, state.params)
            del grads
            params = apply_updates(state.params, updates)
            del updates
            if sync == "gossip":
                params = gossip_shard(params, sched, group)
            elif sync == "allreduce":
                params = _allreduce_mean(params, group)
            loss = _group_mean(losses[0], 1.0, group)
        return DSGDState(params, opt, state.step + 1), {"loss": loss}

    return step
