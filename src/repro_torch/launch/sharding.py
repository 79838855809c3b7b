"""Distribution plans and tensor specs for every (arch × shape × mesh), as
``repro/launch/sharding.py``.

Worker granularity (the paper's compute node) is chosen per architecture
from its memory footprint:

  standard     worker = one "data"-dim slice (its "model" ranks share the
               worker's tensors); the workers gossip over "data" (and
               "pod" on a multi-pod mesh).
  pod_worker   replica + optimizer state would not fit one slice → worker
               = a whole pod with 2-D ("data", "model") tensor sharding;
               gossip runs over "pod" only. A single-pod mesh then has one
               worker (tensor parallelism, no gossip).

Inference shapes never replicate per worker: params shard over the whole
mesh, batch and caches over the batch dims.

A spec is a tuple with one entry a tensor dim: a mesh-dim name, a tuple of
names (the dim split over several mesh dims, row-major), or None
(replicated), with trailing Nones dropped; it compares with the entries of
the reference's ``PartitionSpec``. :func:`placements` maps a spec onto a
``DeviceMesh`` as DTensor placements. Specs are assigned by rules on the
pytree key path (``torch.utils._pytree.keystr``, the reference's
``keystr`` form) and the dim sizes; a dim is sharded only where its size
divides by the mesh dim's.

The budgets are the card's memory: ``plan_for`` keeps a worker's replica
and optimizer state under ``BUDGET_SHARE`` of the memory of the cards of a
slice, read from ``torch.cuda.get_device_properties`` where a card is
present or given as ``hbm_bytes`` (without a card, ``hbm_bytes`` is
required).
"""
from __future__ import annotations

import functools
import math
import re
from dataclasses import dataclass

import torch
from torch.utils._pytree import (keystr, tree_flatten, tree_flatten_with_path, tree_leaves,
                                tree_map, tree_unflatten)

from ..configs import ModelConfig
from ..device import DeviceFault

__all__ = ["DistPlan", "plan_for", "param_specs", "tree_param_specs", "batch_specs",
           "cache_specs", "with_sharding", "params_bytes", "replica_budget_bytes",
           "axis_sizes", "placements", "spec_of", "spec_leaves", "BUDGET_SHARE"]

#: the share of a slice's memory a worker's replica and optimizer state
#: may take (the reference's 60 %)
BUDGET_SHARE = 0.6


@dataclass(frozen=True)
class DistPlan:
    gossip_axes: tuple[str, ...]   # mesh dims hosting gossip workers ((), = no DP)
    tensor_axes: tuple[str, ...]   # intra-worker model-sharding dims
    batch_axes: tuple[str, ...]    # inference batch dims
    n_workers: int
    # expert parallelism: the mesh dim owning the MoE expert dim
    expert_axis: str | None = None

    @property
    def gossip_spec_axis(self):
        if not self.gossip_axes:
            return None
        return self.gossip_axes if len(self.gossip_axes) > 1 else self.gossip_axes[0]


def axis_sizes(mesh) -> dict[str, int]:
    """{dim name: size} of a ``DeviceMesh``, or of a shape-only stand-in
    with ``axis_names`` and ``devices`` (an array of the mesh's shape)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@functools.lru_cache(maxsize=None)
def params_bytes(cfg: ModelConfig) -> int:
    """Replica size in its native dtype, from parameters built on the meta
    device (nothing is allocated)."""
    from ..models import transformer

    with torch.device("meta"):
        params = transformer.init_params(0, cfg)
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def _hbm_bytes(hbm_bytes: float | None) -> float:
    """One card's memory: ``hbm_bytes`` where given, else the current
    card's; without a card it must be given."""
    if hbm_bytes is not None:
        return float(hbm_bytes)
    if not torch.cuda.is_available():
        raise DeviceFault("plan_for reads the card's memory and torch.cuda.is_available() is "
                          "False; pass hbm_bytes (one device's memory in bytes)")
    return float(torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory)


def replica_budget_bytes(model: int = 1, hbm_bytes: float | None = None) -> float:
    """What a worker's replica and optimizer state may take on a slice of
    ``model`` cards: ``model · hbm · BUDGET_SHARE``."""
    return model * _hbm_bytes(hbm_bytes) * BUDGET_SHARE


def plan_for(cfg: ModelConfig, mesh, *, mode: str, tp_only: bool | None = None,
             expert_parallel: bool = False, hbm_bytes: float | None = None) -> DistPlan:
    """mode ∈ {"train", "prefill", "decode"}. Mesh dims: ("pod",)? + "data"
    + "model"; a mesh without a "pod" dim is single-pod.

    tp_only (inference): shard weights over "model" only, "data" carrying
    just the batch. None = auto: TP-only whenever the replica fits one
    "model" slice's budget, 2-D otherwise. ``hbm_bytes``: one device's
    memory (default: the card's)."""
    sizes = axis_sizes(mesh)
    multi_pod = "pod" in sizes and sizes["pod"] > 1
    pb = params_bytes(cfg)
    slice_budget = replica_budget_bytes(sizes.get("model", 1), hbm_bytes)
    if mode == "train":
        # per-worker footprint: replica (native dtype) + f32 momentum + f32 grads
        n_params = pb // (2 if cfg.dtype == "bfloat16" else 4)
        train_worker_bytes = pb + 2 * 4 * n_params
        if train_worker_bytes > slice_budget:
            return DistPlan(
                gossip_axes=("pod",) if multi_pod else (),
                tensor_axes=("data", "model"), batch_axes=("data",),
                n_workers=sizes.get("pod", 1) if multi_pod else 1,
                expert_axis="data" if (expert_parallel and cfg.num_experts) else None)
        gossip = ("pod", "data") if multi_pod else ("data",)
        return DistPlan(gossip_axes=gossip, tensor_axes=("model",), batch_axes=(),
                        n_workers=math.prod(sizes[a] for a in gossip))
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if tp_only is None:
        tp_only = pb <= slice_budget
    ep_axis = None
    if expert_parallel and cfg.num_experts and cfg.num_experts % sizes.get("model", 1) == 0:
        ep_axis = "model"
    return DistPlan(gossip_axes=(), tensor_axes=("model",) if tp_only else ("data", "model"),
                    batch_axes=batch_axes, n_workers=1, expert_axis=ep_axis)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_STACKED = re.compile(r"\['(layers|enc_layers)'\]")


def _leaf_spec(path: str, shape: tuple[int, ...], plan: DistPlan, sizes: dict[str, int],
               lead: tuple = ()) -> tuple:
    """Megatron-pattern sharding for the known matmul weights, largest-dim
    heuristic for the rest: w_gate/w_up column-parallel (the output d_ff
    dim), w_down row-parallel (its input d_ff dim), wq/wk/wv over their
    output heads, wo over its input heads; the layer axis of a stacked leaf
    is never sharded."""
    protect = 1 if _STACKED.search(path) else 0
    entries: list = list(lead) + [None] * len(shape)
    model_ax = plan.tensor_axes[-1]          # the intra-layer TP dim
    used: set[int] = set()

    def try_assign(d: int, ax: str) -> bool:
        if d in used or d < protect or shape[d] < 2 * sizes[ax] or shape[d] % sizes[ax]:
            return False
        entries[len(lead) + d] = ax
        used.add(d)
        return True

    moe_ep = plan.expert_axis and "moe" in path
    if re.search(r"\['(w_gate|w_up)'\]$", path):
        if moe_ep and len(shape) >= 3:
            entries[len(lead) + protect] = plan.expert_axis
            used.add(protect)
        if plan.expert_axis != model_ax or not moe_ep:
            try_assign(len(shape) - 1, model_ax)
    elif re.search(r"\['w_down'\]$", path):
        if moe_ep and len(shape) >= 3:
            entries[len(lead) + protect] = plan.expert_axis
            used.add(protect)
        if plan.expert_axis != model_ax or not moe_ep:
            try_assign(len(shape) - 2, model_ax)
    elif re.search(r"\['(wq|wk|wv)'\]$", path):
        try_assign(len(shape) - 1, model_ax)
    elif re.search(r"\['wo'\]$", path):
        try_assign(len(shape) - 2, model_ax)

    # fill the remaining tensor dims by size rank (2-D plans, untyped leaves)
    order = sorted(range(protect, len(shape)), key=lambda d: -shape[d])
    for ax in plan.tensor_axes:
        if any(entries[len(lead) + d] == ax for d in range(len(shape))):
            continue
        for d in order:
            if try_assign(d, ax):
                break
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_specs(cfg: ModelConfig, plan: DistPlan, mesh, *, stacked: bool = False):
    """Spec tree matching ``transformer.init_params(cfg)`` (shapes from the
    meta device)."""
    from ..models import transformer

    with torch.device("meta"):
        shapes = transformer.init_params(0, cfg)
    if stacked:
        shapes = tree_map(lambda x: x.new_empty((plan.n_workers,) + tuple(x.shape)), shapes)
    return tree_param_specs(shapes, plan, mesh, stacked=stacked)


def tree_param_specs(tree, plan: DistPlan, mesh, *, stacked: bool = False):
    """Specs for a params-shaped pytree (params, optimizer state, grads);
    ``stacked``: leaves carry a leading (n_workers,) axis over the gossip
    dims. Scalars (step counters) get ``()``."""
    sizes = axis_sizes(mesh)
    lead = (plan.gossip_spec_axis,) if stacked else ()
    pairs, spec = tree_flatten_with_path(tree)
    out = []
    for path, leaf in pairs:
        shape = tuple(leaf.shape)[1:] if stacked else tuple(leaf.shape)
        out.append(() if not shape else _leaf_spec(keystr(path), shape, plan, sizes, lead))
    return tree_unflatten(out, spec)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, plan: DistPlan, mesh, batch_shape: dict, *,
                stacked: bool = False):
    """Specs for {tokens, labels(, embeds)} dicts (stacked adds the worker
    axis 0)."""
    sizes = axis_sizes(mesh)
    lead = (plan.gossip_spec_axis,) if stacked else ()
    baxis = None
    if plan.batch_axes:
        b = batch_shape["tokens"][1 if stacked else 0]
        avail = tuple(a for a in plan.batch_axes if a not in plan.gossip_axes)
        total = math.prod(sizes[a] for a in avail) if avail else 0
        if avail and b % total == 0 and b >= total:
            baxis = avail if len(avail) > 1 else avail[0]
    return {k: (*lead, baxis) + (None,) * (len(shp) - len(lead) - 1)
            for k, shp in batch_shape.items()}


def cache_specs(cfg: ModelConfig, plan: DistPlan, mesh, caches, batch: int):
    """Specs for ``transformer.Caches``: batch over the batch dims (when
    divisible), KV sequence over "model", SSM head dims over "model"."""
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in plan.batch_axes) if plan.batch_axes else 1
    if plan.batch_axes and batch % total == 0 and batch >= total:
        baxis = plan.batch_axes if len(plan.batch_axes) > 1 else plan.batch_axes[0]
        seq_axes: tuple[str, ...] = ("model",)
    else:
        baxis = None
        # batch unshardable (long_500k B = 1): the sequence dim takes every dim
        seq_axes = tuple(a for a in ("data", "model") if a in sizes)
    seq_total = math.prod(sizes[a] for a in seq_axes)

    def assign(key: str, shape) -> tuple:
        spec: list = [None] * len(shape)
        if ".kv" in key or "shared_kv" in key or "cross_kv" in key:
            # (L_or_G, B, C, Hkv, hd)
            if len(shape) >= 2:
                spec[1] = baxis
            if len(shape) >= 3:
                C = shape[2]
                if C % seq_total == 0 and C >= seq_total:
                    spec[2] = seq_axes if len(seq_axes) > 1 else seq_axes[0]
        elif ".ssm" in key:
            # conv state (L, B, d_inner, k) or SSD state (L, B, H, dh, state)
            if len(shape) >= 2:
                spec[1] = baxis
            m = sizes.get("model", 1)
            for d in range(2, len(shape)):
                if shape[d] % m == 0 and shape[d] >= 2 * m:
                    spec[d] = "model"
                    break
        return tuple(spec)

    pairs, spec = tree_flatten_with_path(caches)
    return tree_unflatten([assign(keystr(p), tuple(x.shape)) for p, x in pairs], spec)


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim d names, ``Replicate()`` on the others. A
    tensor dim split over several mesh dims must name them in mesh order
    (row-major, as the reference's ``PartitionSpec``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits a dim over mesh dims out of mesh "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def with_sharding(mesh, tree, specs):
    """Abstract stand-ins of ``tree``'s leaves: meta tensors of each leaf's
    shape and dtype (nothing allocated), each carrying its spec on ``mesh``
    (:func:`spec_of`)."""
    def one(x, s):
        t = torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
        t.spec = s
        return t

    leaves, tdef = tree_flatten(tree)
    return tree_unflatten([one(x, s) for x, s in zip(leaves, spec_leaves(specs, tree))], tdef)


def spec_leaves(specs, like) -> list:
    """The specs of a spec tree (a tuple is a spec) in the leaf order of
    ``like``, the tree they describe."""
    out: list = []

    def walk(s, node):
        if isinstance(node, dict):
            for k in node:
                walk(s[k], node[k])
        elif isinstance(node, (list, tuple)) and not isinstance(node, torch.Tensor):
            for a, b in zip(s, node):
                walk(a, b)
        else:
            out.append(s)

    walk(specs, like)
    return out


def spec_of(abstract: torch.Tensor) -> tuple:
    """The spec an abstract leaf of :func:`with_sharding` carries."""
    return abstract.spec
