"""DSGD training steps (Lian et al. 2017, adapt-then-combine):

    x_i ← Σ_j W_ij · ( x_j − lr · ∇f_j(x_j) )

The paths of ``repro/dsgd/trainer.py``:

  dsgd_train_step          one device: the n workers stacked on a leading
                           (n,) axis of every leaf, gossip over the
                           topology's W, by default through the
                           ``gossip_mix_batched`` kernel
  allreduce_train_step     centralized baseline (W = 11ᵀ/n, exact averaging)
  make_sharded_train_step  one worker a rank of a ``torch.distributed``
                           process group, or a worker on a group of ranks
                           (tensor parallelism over the mesh dims outside
                           the gossip dims): every leaf keeps a leading
                           worker axis of size 1, and the gossip is the
                           schedule's matching rounds as point-to-point
                           sends (``gossip_shard``), or a float32
                           all-reduce mean
  make_tp_train_step       one worker, no gossip: tensor parallelism of its
                           DTensor leaves (the reference's pjit step)
  make_matmul_gossip_train_step
                           stacked pod-sized workers over the "pod" dim,
                           gossip the dense W product across it

Without tensor parallelism, gradients come from one ``torch.func.vmap``
of ``torch.func.grad_and_value`` over the worker axis, as the reference's
``jax.vmap(jax.value_and_grad)``: each op of the model runs once for all
the workers a process holds (n stacked, or 1 in a rank). The optimizer is
vmapped the same way; the update, the gossip and the metrics run under
``torch.no_grad()``. With it (DTensor leaves, :mod:`.tensor_parallel`),
``torch.func`` stays off the DTensors: a rank's workers run one at a time
through ``torch.autograd``, and the model's DTensor branches (the target
logit, for one, is the reference's masked sum over the sharded vocabulary)
take over where DTensor's own propagation does not serve.

The elastic runtime's step (:mod:`.elastic`) is this step with the fault
masks as arguments.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from ..core.graph import Topology, weight_matrix_from_weights
from ..device import resolve_device
from ..models import transformer
from ..optim import apply_updates
from .gossip import GossipAxis, gossip_shard, gossip_sim_tree, padded_neighbors
from .schedule import GossipSchedule
from .tensor_parallel import (full_value, is_dtensor, place, rewrap, sub_mesh, to_local_tree,
                              tp_region)

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


def _value_and_grad(loss_fn, params, batch):
    """(loss, gradients) of ``loss_fn(params, batch)`` by ``torch.autograd``
    over the parameter leaves, plain tensors or DTensors (``torch.func``
    transforms are kept off DTensors). A DTensor leaf's gradient is
    redistributed to its parameter's placements where DTensor's
    propagation left it otherwise (e.g. partial sums): an explicit
    redistribution, so the optimizer state keeps the parameters'
    layout."""
    leaves, spec = tree_flatten(params)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in leaves]
        loss = loss_fn(tree_unflatten(xs, spec), batch)
        grads = list(torch.autograd.grad(loss, xs))
    for k, (g, x) in enumerate(zip(grads, leaves)):
        if is_dtensor(g) and tuple(g.placements) != tuple(x.placements):
            grads[k] = g.redistribute(x.device_mesh, x.placements)
    return loss.detach(), tree_unflatten(grads, spec)


def _microbatch(x: torch.Tensor, k: int, size: int) -> torch.Tensor:
    """Rows ``[k·size, (k+1)·size)`` of a batch leaf, the reference's split
    (its reshape to (accum, b/accum)). A DTensor's slice is redistributed
    back to the batch's placements (a dim that no longer divides over a
    mesh dim is replicated there), so the microbatch keeps its data
    parallelism."""
    part = x[k * size:(k + 1) * size]
    if not is_dtensor(x):
        return part
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    want = [Replicate() if p.is_shard() and part.shape[p.dim] % mesh.size(i) else p
            for i, p in enumerate(x.placements)]
    return part.redistribute(mesh, want)


def _accum_value_and_grad(loss_fn, params, batch, accum_steps: int):
    """Gradient accumulation over ``accum_steps`` microbatches split on the
    batch dim: the loss and the gradient are the means of the
    microbatches', the gradients summed in float32 (peak activation memory
    shrinks ×accum_steps; the mean gradient is the same)."""
    if accum_steps <= 1:
        return _value_and_grad(loss_fn, params, batch)
    b = tree_leaves(batch)[0].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
    size = b // accum_steps
    loss_sum = 0.0
    grad_sum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for k in range(accum_steps):
        micro = tree_map(lambda x: _microbatch(x, k, size), batch)
        loss, grads = _value_and_grad(loss_fn, params, micro)
        del micro
        loss_sum = loss_sum + loss.float()
        grad_sum = tree_map(lambda a, g: a + g.float(), grad_sum, grads)
        del grads
    scale = 1.0 / accum_steps
    return loss_sum * scale, tree_map(lambda g: g * scale, grad_sum)


def _tp_context(tree):
    """:func:`~.tensor_parallel.tp_region` of the tree's mesh when its
    leaves are DTensors, else nothing."""
    first = next((x for x in tree_leaves(tree) if is_dtensor(x)), None)
    return contextlib.nullcontext() if first is None else tp_region(first.device_mesh)


def make_tp_train_step(cfg, opt_update: Callable, *, accum_steps: int = 1):
    """Single-worker step (no gossip): tensor-parallel training of one
    worker whose parameters and optimizer state are DTensors placed by
    ``launch.sharding.tree_param_specs`` (and its batch by
    ``batch_specs``); DTensor's propagation inserts the collectives, as
    GSPMD does under the reference's pjit. On plain tensors it is the same
    step on one device. ``step(state, batch) -> (state, {"loss"})``; the
    loss is a plain tensor, the same on every rank."""
    loss_fn = _loss_fn(cfg)

    def train_step(state: DSGDState, batch):
        with _tp_context(state.params):
            loss, grads = _accum_value_and_grad(loss_fn, state.params, batch, accum_steps)
            with torch.no_grad():
                updates, opt = opt_update(grads, state.opt, state.params)
                del grads
                params = apply_updates(state.params, updates)
                loss = full_value(loss)
        return DSGDState(params, opt, state.step + 1), {"loss": loss}

    return train_step


def _worker_layout(x):
    """(mesh dims of the worker axis, the other mesh dims, the worker
    placements dropped: the tensor dims' placements on the sub-mesh of the
    other dims) of a stacked DTensor leaf whose dim 0 is sharded over the
    gossip dims."""
    names = tuple(x.device_mesh.mesh_dim_names)
    lead = tuple(n for n, p in zip(names, x.placements) if p.is_shard(0))
    rest = tuple(n for n in names if n not in lead)
    return lead, rest, [_shift(p, -1) for n, p in zip(names, x.placements) if n in rest]


def _shift(p, by: int):
    """A placement with its tensor dim moved by ``by`` (a worker axis
    dropped or added in front)."""
    from torch.distributed.tensor import Shard

    if p.is_shard():
        if p.dim + by < 0:
            raise ValueError("the worker axis is sharded over a tensor-parallel dim")
        return Shard(p.dim + by)
    return p


def _unstack(tree, mine: list, sub):
    """The rank's workers ``mine`` of a stacked tree as a list of trees:
    DTensor leaves as DTensors on the worker sub-mesh ``sub``, plain leaves
    (a worker axis on one device) and per-worker scalars (replicated over
    the workers) as plain slices."""
    def one(x, j):
        if not is_dtensor(x):
            return x[mine[j]]
        local = x.to_local()
        if not any(p.is_shard(0) for p in x.placements):    # replicated over the workers
            return local[mine[j]]
        _, _, pl = _worker_layout(x)
        return rewrap(local[j], sub, pl)

    return [tree_map(lambda x: one(x, j), tree) for j in range(len(mine))]


def _gather_workers(local: torch.Tensor, axis: GossipAxis) -> torch.Tensor:
    """Every worker's rows of a stacked leaf, in worker order, from each
    rank's ``local`` rows (its workers), all-gathered over the gossip group."""
    parts = [torch.empty_like(local) for _ in axis.ranks]
    dist.all_gather(parts, local.contiguous(), group=axis.group)
    return torch.cat([parts[dist.get_group_rank(axis.group, r)] for r in axis.ranks])


def _restack(trees, like, axis):
    """Workers' trees stacked back on the worker axis with ``like``'s
    layout: a DTensor leaf's local shards stacked and rewrapped with its
    placements (a leaf replicated over the workers gathered over the gossip
    group ``axis`` first), plain leaves stacked."""
    def one(ref, *xs):
        if not is_dtensor(ref):
            return torch.stack(list(xs))
        local = torch.stack([x.to_local() if is_dtensor(x) else x for x in xs])
        if not any(p.is_shard(0) for p in ref.placements):
            local = _gather_workers(local, axis)
        return rewrap(local, ref.device_mesh, ref.placements)

    return tree_map(one, like, *trees)


def make_matmul_gossip_train_step(cfg, topo: Topology, opt_update: Callable, *,
                                  accum_steps: int = 1):
    """Stacked-worker DSGD step whose gossip is the dense W product over the
    worker axis (Eq. 1), for pod-sized workers: every leaf carries the (n,)
    worker axis, sharded over the gossip dim(s) ("pod"), its other dims by
    the 2-D tensor specs, as DTensors on the whole mesh. Each rank runs its
    local workers one at a time (no vmap over DTensors), each worker's
    leaves DTensors on the sub-mesh of the tensor dims; the gossip
    gathers the workers' local shards over the rank's gossip group (a
    collective across "pod") and mixes them by W in float32, as
    ``gossip_sim``. On plain stacked tensors it is the same step on one
    device. The loss is the mean over the n workers."""
    W = torch.tensor(weight_matrix_from_weights(topo.n, topo.edges, topo.g), dtype=torch.float32)
    loss_fn = _loss_fn(cfg)

    def train_step(state: DSGDState, batch):
        first = tree_leaves(state.params)[0]
        n = first.shape[0]
        if n != topo.n:
            raise ValueError(f"the state has {n} workers, the topology {topo.n}")
        if is_dtensor(first):
            mesh = first.device_mesh
            lead, rest, _ = _worker_layout(first)
            sub = sub_mesh(mesh, rest)
            axis = _gossip_axis(mesh, lead)
            n_local = first.to_local().shape[0]
            me = axis.ranks.index(dist.get_rank())
            mine = list(range(me * n_local, (me + 1) * n_local))
        else:
            axis = sub = None
            mine = list(range(n))
        params_w = _unstack(state.params, mine, sub)
        opt_w = _unstack(state.opt, mine, sub)
        batch_w = _unstack(batch, mine, sub)
        losses, new_p, new_o = [], [], []
        for p, o, b in zip(params_w, opt_w, batch_w):
            with _tp_context(p):
                loss, grads = _accum_value_and_grad(loss_fn, p, b, accum_steps)
                with torch.no_grad():
                    updates, o2 = opt_update(grads, o, p)
                    del grads
                    new_p.append(apply_updates(p, updates))
                    new_o.append(o2)
                    losses.append(full_value(loss).float())
        del params_w, opt_w, batch_w
        with torch.no_grad():
            local = _restack(new_p, state.params, axis)
            del new_p
            params = tree_map(lambda x: _mix_workers(x, W, mine, axis), local)
            opt = _restack(new_o, state.opt, axis)
            loss = torch.stack(losses).sum()
            if axis is not None:           # each worker's loss once: summed over the gossip group
                dist.all_reduce(loss, group=axis.group)
            loss = loss / n
        return DSGDState(params, opt, state.step + 1), {"loss": loss}

    return train_step


def _mix_workers(x: torch.Tensor, W: torch.Tensor, mine: list, axis) -> torch.Tensor:
    """Rows ``mine`` of W·X over the worker axis of a stacked leaf, as
    ``gossip_sim``: W rounded to the leaf's dtype, the products summed in
    float32, rounded once. A DTensor's local workers are mixed with every
    worker's local shard, all-gathered over the gossip group ``axis``."""
    local = x.to_local() if is_dtensor(x) else x
    X = local if axis is None else _gather_workers(local, axis)
    n = X.shape[0]
    Wm = W.to(device=local.device)[mine].to(local.dtype).float()
    out = (Wm @ X.reshape(n, -1).float()).to(local.dtype).reshape(local.shape)
    return rewrap(out, x.device_mesh, x.placements) if is_dtensor(x) else out


# ---------------------------------------------------------------------------
# one worker a rank of a process group
# ---------------------------------------------------------------------------

def _gossip_rank_groups(mesh, gossip_axes) -> tuple[list[list[int]], tuple[str, ...]]:
    """(the gossip groups: for each position on the other mesh dims, the
    global ranks of its workers in worker order; those other dims larger
    than 1, the tensor-parallel dims). The gossip dims flatten row-major in
    the order given, as ``ppermute`` flattens a tuple of axes. Pure: reads
    the mesh's rank grid only (a ``DeviceMesh`` or a stand-in with
    ``mesh_dim_names`` and ``mesh``)."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in gossip_axes if a not in names]
    if missing or not gossip_axes:
        raise ValueError(f"gossip_axes {tuple(gossip_axes)} are not dims of the mesh {names}")
    grid = torch.as_tensor(mesh.mesh)
    sizes = dict(zip(names, grid.shape))
    tp = tuple(a for a in names if a not in gossip_axes and sizes[a] > 1)
    order = [names.index(a) for a in gossip_axes]
    order += [d for d in range(len(names)) if d not in order]
    n = math.prod(sizes[a] for a in gossip_axes)
    cols = grid.permute(order).reshape(n, -1).T.tolist()
    return cols, tp


_SUBGROUPS: dict = {}


def _gossip_axis(mesh, gossip_axes) -> GossipAxis:
    """This rank's gossip group over ``mesh``'s ``gossip_axes``: the default
    group when the gossip dims flatten to it in rank order, one mesh dim's
    group (``mesh.get_group``) for one dim, else a group of its own, built
    once on every rank in the same order for all positions of the other
    dims (and kept: a later step over the same groups reuses them)."""
    cols, _ = _gossip_rank_groups(mesh, tuple(gossip_axes))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a rank-per-worker step needs a torch.distributed process group: "
                           "one rank a mesh position")
    world = dist.get_world_size()
    if sorted(r for c in cols for r in c) != list(range(world)):
        raise ValueError(f"the mesh's ranks {sorted(r for c in cols for r in c)} are not the "
                         f"default group's {world}: a mesh spans the whole default group")
    me = dist.get_rank()
    mine = next(c for c in cols if me in c)
    if mine == list(range(world)):
        return GossipAxis(dist.group.WORLD, tuple(mine))
    if len(gossip_axes) == 1 and hasattr(mesh, "get_group"):
        return GossipAxis(mesh.get_group(gossip_axes[0]), tuple(mine))
    key = tuple(tuple(sorted(c)) for c in cols)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = {members: dist.new_group(list(members)) for members in key}
    return GossipAxis(_SUBGROUPS[key][tuple(sorted(mine))], tuple(mine))


def _gossip_group(mesh, gossip_axes=("data",), n: int | None = None) -> GossipAxis:
    """The rank's gossip group (see :func:`_gossip_axis`), what the
    rank-per-worker steps gossip over. ``mesh`` is a
    ``torch.distributed.device_mesh.DeviceMesh`` spanning the default
    group; ``n``, where given, the schedule's workers, which the gossip dims
    must host. Before it returns, the ranks of the gossip group meet in one
    barrier: the group's first point-to-point exchange, in which an idle
    rank posts nothing, then follows a collective of the whole group, as
    NCCL requires of ``batch_isend_irecv``."""
    axis = _gossip_axis(mesh, tuple(gossip_axes))
    if n is not None and len(axis.ranks) != n:
        raise ValueError(f"the schedule has {n} workers but the gossip dims "
                         f"{tuple(gossip_axes)} host {len(axis.ranks)}")
    dist.barrier(group=axis.group)
    return axis


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


class _RankWorker:
    """One worker's tensor parallelism inside a rank-per-worker step: the
    worker's ranks form the sub-mesh of the tensor-parallel dims. Leaves
    arrive with the worker axis of size 1, plain (the worker's whole copy,
    the same on each of its ranks; placed by the specs of
    ``launch.sharding`` for a plan whose tensor dims are the mesh's
    non-gossip dims) or as DTensors on the sub-mesh; they leave as DTensors
    on the sub-mesh. Per-worker scalars (the optimizer's step) stay plain."""

    def __init__(self, mesh, gossip_axes, tp):
        from ..launch.sharding import DistPlan, axis_sizes

        self.sub = sub_mesh(mesh, tp)
        sizes = axis_sizes(mesh)
        self.plan = DistPlan(gossip_axes=tuple(gossip_axes),
                             tensor_axes=tuple(a for a in mesh.mesh_dim_names
                                               if a not in gossip_axes),
                             batch_axes=(), n_workers=math.prod(sizes[a] for a in gossip_axes))
        self.mesh = mesh

    def enter(self, tree, batch: bool = False):
        """(1, ...) leaves → the worker's leaves without the worker axis."""
        from ..launch.sharding import batch_specs, spec_leaves, tree_param_specs

        if batch:
            specs = batch_specs(None, self.plan, self.mesh,
                                {k: tuple(v.shape) for k, v in tree.items()}, stacked=True)
        else:
            specs = tree_param_specs(tree, self.plan, self.mesh, stacked=True)
        leaves, tdef = tree_flatten(tree)
        out = []
        for x, spec in zip(leaves, spec_leaves(specs, tree)):
            if is_dtensor(x):
                out.append(rewrap(x.to_local()[0], self.sub, [_shift(p, -1) for p in x.placements]))
            elif x.dim() <= 1:
                out.append(x[0])
            else:
                out.append(place(x[0], self.sub, tuple(spec[1:])))
        return tree_unflatten(out, tdef)

    @staticmethod
    def leave(tree):
        """The worker's leaves → (1, ...) leaves."""
        return tree_map(lambda x: rewrap(x.to_local().unsqueeze(0), x.device_mesh,
                                         [_shift(p, 1) for p in x.placements])
                        if is_dtensor(x) else x.unsqueeze(0), tree)


def _like(locals_, placed):
    """Local shards rewrapped with the placements of ``placed``'s leaves
    (plain leaves stay plain)."""
    return tree_map(lambda m, x: rewrap(m, x.device_mesh, x.placements) if is_dtensor(x) else m,
                    locals_, placed)


def _tp_rank_step(cfg, opt_update: Callable, mesh, gossip_axes, tp, mix: Callable):
    """The rank-per-worker step with tensor parallelism inside the worker:
    the worker's gradient, update and loss on DTensors over its sub-mesh,
    then ``mix(new params, old params, new opt, old opt, extra) -> (params,
    opt)``, every tree of local shards (the ranks of a gossip group hold
    the same shard position, so the exchange is shard for shard). Returns
    ``step(state, batch, *extra) -> (state, loss)``, the loss this
    worker's, a plain tensor."""
    worker = _RankWorker(mesh, gossip_axes, tp)
    loss_fn = _loss_fn(cfg)

    def step(state: DSGDState, batch, *extra):
        p1, o1 = worker.enter(state.params), worker.enter(state.opt)
        b1 = worker.enter(batch, batch=True)
        with tp_region(worker.sub):
            loss, grads = _value_and_grad(loss_fn, p1, b1)
            with torch.no_grad():
                updates, o2 = opt_update(grads, o1, p1)
                del grads
                p2 = apply_updates(p1, updates)
                del updates
                loss = full_value(loss)
        with torch.no_grad():
            params, opt = mix(to_local_tree(p2), to_local_tree(p1), to_local_tree(o2),
                              to_local_tree(o1), extra)
            params, opt = _like(params, p2), _like(opt, o2)
        return DSGDState(worker.leave(params), worker.leave(opt), state.step + 1), loss

    return step


def make_sharded_train_step(cfg, sched: GossipSchedule, opt_update: Callable, mesh, *,
                            gossip_axes=("data",), sync: str = "gossip"):
    """The DSGD step of one worker a rank, or of one worker on a group of
    ranks: ``step(state, batch) -> (state, {"loss": loss})``, called by
    every rank of the mesh together.

    ``mesh``: a ``DeviceMesh`` over the default group; ``gossip_axes``: its
    dim(s) hosting the n workers, flattened row-major in the order given.
    Every leaf keeps the reference's leading worker axis of size 1. With
    every other mesh dim of size 1, each rank holds its worker's whole
    state and batch; a dim outside ``gossip_axes`` larger than 1 is tensor
    parallelism inside the worker (the reference's automatic "model"
    axis): the worker's ranks hold its leaves as DTensors on their
    sub-mesh (plain leaves are placed at entry, see :class:`_RankWorker`),
    its gradient runs on them, and the gossip mixes the local shards over
    the rank's gossip group (:func:`_gossip_axis`). ``sync``: ``"gossip"``
    mixes the updated parameters over the schedule's matching rounds
    (:func:`~repro_torch.dsgd.gossip.gossip_shard`), ``"allreduce"``
    averages every leaf in float32 over the workers (the centralized
    baseline), ``"none"`` exchanges nothing. The loss is its mean over the
    workers, the same on every rank.
    """
    if sync not in _SYNCS:
        raise ValueError(f"sync={sync!r}; expected one of {_SYNCS}")
    _, tp = _gossip_rank_groups(mesh, tuple(gossip_axes))
    axis = _gossip_group(mesh, tuple(gossip_axes), sched.n)

    def sync_params(params):
        if sync == "gossip":
            return gossip_shard(params, sched, axis)
        if sync == "allreduce":
            return _allreduce_mean(params, axis.group)
        return params

    if tp:
        inner = _tp_rank_step(cfg, opt_update, mesh, tuple(gossip_axes), tp,
                              lambda p, _p_old, o, _o_old, _extra: (sync_params(p), o))

        def tp_step(state: DSGDState, batch):
            state, loss = inner(state, batch)
            return state, {"loss": _group_mean(loss, 1.0, axis.group)}

        return tp_step

    grad_fn = torch.func.vmap(torch.func.grad_and_value(_loss_fn(cfg)))
    opt_fn = torch.func.vmap(opt_update)

    def step(state: DSGDState, batch):
        grads, losses = grad_fn(state.params, batch)
        with torch.no_grad():
            updates, opt = opt_fn(grads, state.opt, state.params)
            del grads
            params = apply_updates(state.params, updates)
            del updates
            params = sync_params(params)
            loss = _group_mean(losses[0], 1.0, axis.group)
        return DSGDState(params, opt, state.step + 1), {"loss": loss}

    return step
