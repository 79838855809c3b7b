"""Gossip topology for n workers, as ``repro/launch/steps.py`` ``topology_for``.

BA-Topo by default, solved by the port's own ``solve_topology`` on the
given device, with the classic baselines selectable. Solved BA topologies
are kept in memory and in a JSON file of their own
(``benchmarks/artifacts/topo_cache_torch.json``), never in the reference's
``topo_cache.json``, so a topology the JAX package solved never stands in
for one of the port's. The other step functions of the reference module
(meshes, shardings, abstract inputs) are not ported yet.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..core import BATopoConfig, TopologyRequest, solve_topology
from ..core.graph import Topology
from ..core.topologies import make_baseline

__all__ = ["topology_for", "TOPO_CACHE"]

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
