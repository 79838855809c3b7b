"""Step builders, as ``repro/launch/steps.py``: (arch × input shape ×
mesh) → (step function, abstract args), and the gossip topology for n
workers (``topology_for``).

``build_step`` for a train shape picks the plan of ``launch/sharding.py``
and one of three steps: the rank-per-worker schedule step
(``make_sharded_train_step``; the standard plan, gossip over "data", tensor
parallelism over "model" inside each worker), the dense W-matmul step
(``make_matmul_gossip_train_step``; pod-sized workers gossiping over
"pod"), or the single-worker tensor-parallel step (``make_tp_train_step``;
no gossip, or ``sync="none"``). Its ``args`` are abstract: meta tensors of
each input's shape and dtype, each carrying its spec (``sharding.spec_of``),
nothing allocated. Its ``fn``, like pjit with ``in_shardings``, places
plain tensors (every rank holding the same global value, e.g.
``init_dsgd_state(...)``'s output) by those specs at entry and takes
DTensors on the mesh as they are; it returns the state as DTensors on the
mesh. Serving shapes (prefill, decode) are ROADMAP.md Queue 1 item 7c′ and
raise.

Topology: BA-Topo by default, solved by the port's own ``solve_topology``
on the given device, with the classic baselines selectable. Solved BA
topologies are kept in memory and in a JSON file of their own
(``benchmarks/artifacts/topo_cache_torch.json``), never in the reference's
``topo_cache.json``, so a topology the JAX package solved never stands in
for one of the port's.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..configs import INPUT_SHAPES, ModelConfig, get_arch, shape_supported
from ..core import BATopoConfig, TopologyRequest, solve_topology
from ..core.graph import Topology
from ..core.topologies import make_baseline
from ..dsgd import (DSGDState, init_dsgd_state, make_matmul_gossip_train_step,
                    make_sharded_train_step, make_tp_train_step, schedule_from_topology)
from ..dsgd.tensor_parallel import is_dtensor, place_tree, rewrap, sub_mesh
from ..dsgd.trainer import _gossip_axis
from ..models import transformer
from ..optim import sgd_momentum
from .sharding import (DistPlan, axis_sizes, batch_specs, placements, plan_for,
                       spec_leaves, tree_param_specs, with_sharding)

__all__ = ["BuiltStep", "build_step", "input_specs", "topology_for", "TOPO_CACHE"]

TOPO_CACHE = Path(__file__).resolve().parents[3] / "benchmarks" / "artifacts" / "topo_cache_torch.json"

_MEM_CACHE: dict[tuple, Topology] = {}


def topology_for(n: int, kind: str = "ba", r: int | None = None, seed: int = 0,
                 node_bw: "list[float] | None" = None, *,
                 device: str | torch.device = "cuda",
                 cache_path: str | os.PathLike | None = None) -> Topology:
    """Gossip topology over n workers. kind ∈ {"ba", "ring", "exponential",
    "equistatic", "torus", "grid", "hypercube", "random"}; r defaults to 2n.
    ``node_bw`` (BA only): per-node GB/s — the solve runs the §VI-A2 node
    scenario. A BA topology missing from the cache (``cache_path``, default
    :data:`TOPO_CACHE`) is solved on ``device``."""
    r = r if r is not None else 2 * n
    bw_key = tuple(float(b) for b in node_bw) if node_bw is not None else None
    path = Path(cache_path) if cache_path is not None else TOPO_CACHE
    key = (n, kind, r, seed, bw_key, str(path))
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    if node_bw is not None and kind != "ba":
        raise ValueError("node_bw is a BA-Topo (ADMM) knob — baseline "
                         f"topologies ignore bandwidth (got kind={kind!r})")
    if node_bw is not None and len(node_bw) != n:
        raise ValueError(f"node_bw has {len(node_bw)} entries for n={n}")
    if n == 1:
        topo = Topology(1, [], np.zeros(0), name="singleton")
    elif n == 2:
        topo = Topology(2, [(0, 1)], np.array([0.5]), name="pair")
    elif kind == "ba":
        topo = _cached_ba_topology(n, r, seed, node_bw, device, path)
    elif kind == "random":
        topo = make_baseline(kind, n, r=r, seed=seed)
    else:
        topo = make_baseline(kind, n)
    _MEM_CACHE[key] = topo
    return topo


def _cached_ba_topology(n: int, r: int, seed: int, node_bw, device, path: Path) -> Topology:
    cache = {}
    if path.exists():
        with open(path) as f:
            cache = json.load(f)
    ck = f"n{n}_r{r}_s{seed}"
    if node_bw is not None:
        ck += "_bw" + ",".join(f"{b:g}" for b in node_bw)
    if ck in cache:
        d = cache[ck]
        return Topology(n, [tuple(e) for e in d["edges"]], np.asarray(d["g"]),
                        name=f"ba-topo(n={n},r={r})", meta=d.get("meta", {}))
    if node_bw is not None:
        req = TopologyRequest(n=n, r=r, scenario="node",
                              node_bandwidths=np.asarray(node_bw, float))
    else:
        req = TopologyRequest(n=n, r=r, scenario="homo")
    topo = solve_topology(req, cfg=BATopoConfig(seed=seed, device=str(device))).topology
    cache[ck] = {"edges": [list(e) for e in topo.edges],
                 "g": np.asarray(topo.g).tolist(),
                 "meta": {k: v for k, v in topo.meta.items()
                          if isinstance(v, (int, float, str, bool, list))}}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(cache, f)
    os.replace(tmp, path)
    return topo


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@dataclass
class BuiltStep:
    fn: Callable               # (args…) → outputs
    args: tuple                # abstract inputs: meta tensors carrying their specs
    plan: DistPlan
    mode: str                  # train | prefill | decode
    meta: dict


def _sharding_rules(plan: DistPlan, mesh, mode: str) -> dict:
    """The reference's logical → mesh-dim rules for its in-model hints
    (``models/partitioning.py``), recorded in ``meta``. The port's model
    takes no hints yet (ROADMAP.md Queue 1, item 7d): its MoE keeps one
    dispatch group, which is what the standard train plan's rules say
    (``moe_groups: 1``)."""
    sizes = axis_sizes(mesh)
    if mode == "train" and plan.gossip_axes and plan.gossip_axes != ("pod",):
        return {"moe_ff": "model", "embed": None, "moe_groups": 1, "moe_group": None}
    if mode == "train":  # pod-sized worker: per-worker batch shards over data
        if plan.expert_axis:
            return {"moe_ff": "model", "embed": None, "moe_groups": 1,
                    "moe_group": None, "moe_expert": plan.expert_axis}
        return {"moe_ff": "model", "embed": None,
                "moe_groups": sizes.get("data", 1), "moe_group": "data"}
    axes = plan.batch_axes or ("data",)
    groups = math.prod(sizes.get(a, 1) for a in axes)
    rules = {"moe_ff": "model", "embed": None, "moe_groups": groups,
             "moe_group": axes if len(axes) > 1 else axes[0]}
    if plan.expert_axis:
        rules.update(moe_impl="expert_parallel", moe_expert_axis=plan.expert_axis,
                     moe_groups=1, moe_group=None, moe_token_axes=axes)
    return rules


def _batch_shapes(cfg: ModelConfig, B: int, S: int) -> dict:
    shp = {"tokens": (B, S), "labels": (B, S)}
    if cfg.frontend_tokens:
        shp["embeds"] = (B, cfg.frontend_tokens, cfg.d_model)
    return shp


def _batch_structs(shapes: dict, lead: tuple = ()) -> dict:
    """Meta tensors of the batch's leaves (int32 tokens and labels, float32
    embeddings)."""
    dt = {"tokens": torch.int32, "labels": torch.int32, "embeds": torch.float32}
    return {k: torch.empty(lead + v, dtype=dt[k], device="meta") for k, v in shapes.items()}


def input_specs(arch: str, shape_name: str, mesh, *, mode: str | None = None, **kw) -> tuple:
    """The abstract inputs ``build_step`` returns."""
    return build_step(arch, shape_name, mesh, **kw).args


def build_step(arch: str, shape_name: str, mesh, *, sync: str = "gossip",
               topo_kind: str = "ba", topo_r: int | None = None,
               param_dtype: str | None = None, accum_steps: int = 1,
               tp_only: bool | None = None, expert_parallel: bool = False,
               hbm_bytes: float | None = None) -> BuiltStep:
    """(arch × input shape × mesh) → :class:`BuiltStep`. ``mesh``: a
    ``DeviceMesh`` over the default group (``launch/mesh.py``);
    ``hbm_bytes``: one device's memory for the plan (default: the card's,
    see ``sharding.plan_for``)."""
    cfg = get_arch(arch)
    if param_dtype:
        cfg = replace(cfg, dtype=param_dtype)
    shape = INPUT_SHAPES[shape_name]
    if not shape_supported(arch, shape_name):
        raise ValueError(f"{arch} × {shape_name} not in the supported matrix "
                         "(long_500k needs sub-quadratic attention)")
    if shape.kind != "train":
        raise NotImplementedError(
            f"build_step for a {shape.kind} shape ({shape_name}) serves over DTensor parameters "
            "and sharded caches, which is not ported yet (ROADMAP.md, Queue 1, item 7c′)")
    return _build_train(cfg, shape, mesh, sync=sync, topo_kind=topo_kind, topo_r=topo_r,
                        accum_steps=accum_steps, expert_parallel=expert_parallel,
                        hbm_bytes=hbm_bytes)


def _abstract_state(cfg, n: int | None, opt_init) -> DSGDState:
    """The train state's meta tensors: n stacked workers, or one unstacked
    (``n`` None)."""
    with torch.device("meta"):
        if n is not None:
            return init_dsgd_state(0, cfg, n, opt_init, device="meta")
        params = transformer.init_params(0, cfg)
        return DSGDState(params, opt_init(params), torch.zeros((), dtype=torch.int32))


def _build_train(cfg, shape, mesh, *, sync: str, topo_kind: str, topo_r: int | None,
                 accum_steps: int = 1, expert_parallel: bool = False,
                 hbm_bytes: float | None = None) -> BuiltStep:
    plan = plan_for(cfg, mesh, mode="train", expert_parallel=expert_parallel,
                    hbm_bytes=hbm_bytes)
    n = plan.n_workers
    per_b = max(shape.global_batch // max(n, 1), 1)
    if accum_steps == 1 and len(plan.tensor_axes) > 1:
        # a pod-sized worker sees the whole (or half the) global batch: auto
        # microbatch to ≤ 128k tokens a microbatch, as the reference
        while per_b % (accum_steps * 2) == 0 and \
                per_b * shape.seq_len // accum_steps > 131072:
            accum_steps *= 2
    opt_init, opt_update = sgd_momentum(0.05)
    bshapes = _batch_shapes(cfg, per_b, shape.seq_len)
    meta: dict = {"n_workers": n, "per_worker_batch": per_b, "sync": sync,
                  "accum_steps": accum_steps}
    device = mesh.device_type

    if plan.gossip_axes and sync != "none":
        topo = topology_for(n, kind=topo_kind, r=topo_r, device=device)
        if plan.gossip_axes == ("pod",):
            step = make_matmul_gossip_train_step(cfg, topo, opt_update, accum_steps=accum_steps)
            meta.update(topology=topo.name, gossip_impl="W-matmul")
            make_fn = _placed_fn
        else:
            sched = schedule_from_topology(topo)
            step = make_sharded_train_step(cfg, sched, opt_update, mesh,
                                           gossip_axes=plan.gossip_axes, sync=sync)
            meta.update(topology=topo.name, rounds=sched.rounds,
                        degree_max=int(sched.degrees.max()) if len(topo.edges) else 0,
                        gossip_impl="ppermute-schedule")
            make_fn = _rank_fn
        state_sh = _abstract_state(cfg, n, opt_init)
        stacked = True
        batch = _batch_structs(bshapes, lead=(n,))
    else:
        step = make_tp_train_step(cfg, opt_update, accum_steps=accum_steps)
        state_sh = _abstract_state(cfg, None, opt_init)
        stacked = False
        # a single worker sees the whole global batch
        bshapes = _batch_shapes(cfg, shape.global_batch // max(n, 1), shape.seq_len)
        batch = _batch_structs(bshapes, lead=(n,) if n > 1 else ())
        if n > 1:
            stacked = True
        make_fn = _placed_fn

    pspecs = tree_param_specs(state_sh.params, plan, mesh, stacked=stacked)
    ospecs = tree_param_specs(state_sh.opt, plan, mesh, stacked=stacked)
    state_specs = DSGDState(pspecs, ospecs, ())
    state = with_sharding(mesh, state_sh, state_specs)
    bsp = batch_specs(cfg, plan, mesh, {k: tuple(v.shape) for k, v in batch.items()},
                      stacked=stacked)
    batch_abs = with_sharding(mesh, batch, bsp)
    fn = make_fn(step, mesh, plan, state_specs, bsp)
    rules = _sharding_rules(plan, mesh, "train")
    return BuiltStep(fn=fn, args=(state, batch_abs), plan=plan, mode="train",
                     meta={**meta, "rules": rules})


def _placed_fn(step, mesh, plan, state_specs, batch_specs_):
    """The step on the whole mesh: plain leaves placed by their specs (the
    step counter stays plain), DTensors as they are."""
    def fn(state: DSGDState, batch):
        placed = DSGDState(place_tree(state.params, mesh, state_specs.params),
                           place_tree(state.opt, mesh, state_specs.opt), state.step)
        return step(placed, place_tree(batch, mesh, batch_specs_))

    return fn


def _rank_fn(step, mesh, plan, state_specs, batch_specs_):
    """The rank-per-worker step on the whole mesh's (n, ...) inputs: each
    rank hands the step its worker's slice (plain leaves sliced at the
    worker's index, DTensors as their local shards on the worker's
    sub-mesh) and gets back the stacked state as DTensors on the mesh,
    the worker axis over the gossip dims (a per-worker scalar, replicated
    by its spec, all-gathered over the gossip group)."""
    axis = _gossip_axis(mesh, plan.gossip_axes)
    w = axis.ranks.index(dist.get_rank())
    tp = tuple(a for a in mesh.mesh_dim_names if a not in plan.gossip_axes)
    sizes = axis_sizes(mesh)
    sub = sub_mesh(mesh, tp) if any(sizes[a] > 1 for a in tp) else None
    sub_dims = [list(mesh.mesh_dim_names).index(a) for a in tp]

    def to_rank(x):
        if not is_dtensor(x):
            return x[w:w + 1]
        local = x.to_local()
        if not any(p.is_shard(0) for p in x.placements):   # replicated over the workers
            local = local[w:w + 1]
        if sub is None or x.dim() <= 1:                     # per-worker scalars stay plain
            return local
        return rewrap(local, sub, [x.placements[d] for d in sub_dims])

    def from_rank(y, spec):
        local = y.to_local() if is_dtensor(y) else y
        if spec == ():                 # a per-worker scalar, replicated (n,) by its spec
            parts = [torch.empty_like(local) for _ in axis.ranks]
            dist.all_gather(parts, local.contiguous(), group=axis.group)
            local = torch.cat([parts[dist.get_group_rank(axis.group, r)] for r in axis.ranks])
        return rewrap(local, mesh, placements(spec, mesh))

    def tree_from_rank(tree, specs):
        leaves, tdef = tree_flatten(tree)
        return tree_unflatten([from_rank(y, s) for y, s in zip(leaves, spec_leaves(specs, tree))],
                              tdef)

    def fn(state: DSGDState, batch):
        from torch.utils._pytree import tree_map

        mine = DSGDState(tree_map(to_rank, state.params), tree_map(to_rank, state.opt),
                         state.step)
        out, metrics = step(mine, tree_map(to_rank, batch))
        return DSGDState(tree_from_rank(out.params, state_specs.params),
                         tree_from_rank(out.opt, state_specs.opt), out.step), metrics

    return fn
