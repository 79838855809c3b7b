"""BA-Topo generation CLI of the port — the paper's optimizer as a
standalone tool, the CLI of ``repro/launch/topo.py`` plus ``--device``.

Solves on ``cuda`` unless ``--device cpu``; the report is the reference's
JSON (``t_iter_ms`` is the paper's Eq. 34 model of one iteration at the
topology's slowest edge, not a measured time).

  PYTHONPATH=src python -m repro_torch.launch.topo --n 16 --r 32            # Eq. 9
  PYTHONPATH=src python -m repro_torch.launch.topo --n 16 --r 32 \\
      --scenario node --bandwidths 9.76x8,3.25x8                          # §IV-B1
  PYTHONPATH=src python -m repro_torch.launch.topo --n 8 --r 12 --scenario intra
  PYTHONPATH=src python -m repro_torch.launch.topo --n 16 --r 48 --scenario bcube
  PYTHONPATH=src python -m repro_torch.launch.topo --n 32 --r 64 --scenario pods \\
      --pods 2 --device cpu
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..core import BATopoConfig, TopologyRequest, solve_topology
from ..core.bandwidth import homo_edge_bandwidth, min_edge_bandwidth, t_iter
from ..core.constraints import (bcube_constraints, intra_server_constraints,
                                pod_boundary_constraints)
from ..core.graph import weight_matrix_from_weights

__all__ = ["main", "parse_bandwidths"]


def parse_bandwidths(spec: str, n: int) -> np.ndarray:
    """'9.76x8,3.25x8' → [9.76]*8 + [3.25]*8."""
    vals: list[float] = []
    for part in spec.split(","):
        if "x" in part:
            v, k = part.split("x")
            vals.extend([float(v)] * int(k))
        else:
            vals.append(float(part))
    if len(vals) != n:
        raise ValueError(f"--bandwidths expands to {len(vals)} entries "
                         f"but --n is {n}: {spec!r}")
    return np.asarray(vals)


def main(argv=None) -> dict:
    """Solve once and print the report; returns the report with the edge
    list and the weights (what ``--out`` writes)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--r", type=int, required=True)
    ap.add_argument("--scenario", default="homo",
                    choices=["homo", "node", "intra", "bcube", "pods"])
    ap.add_argument("--bandwidths", default=None,
                    help="per-node GB/s for --scenario node, e.g. 9.76x8,3.25x8")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--cross-pod-cap", type=int, default=4,
                    help="max edges crossing each pod boundary")
    ap.add_argument("--sa-iters", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-ms", type=float, default=None,
                    help="anytime wall-clock budget; omit for the full "
                         "deterministic solve")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write topology json")
    args = ap.parse_args(argv)

    cfg = BATopoConfig(sa_iters=args.sa_iters, seed=args.seed, device=args.device)
    n = args.n
    if args.scenario == "homo":
        req = TopologyRequest(n=n, r=args.r, scenario="homo")
    elif args.scenario == "node":
        if not args.bandwidths:
            raise ValueError("--bandwidths is required for --scenario node "
                             "(e.g. --bandwidths 9.76x8,3.25x8)")
        b = parse_bandwidths(args.bandwidths, n)
        req = TopologyRequest(n=n, r=args.r, scenario="node",
                              node_bandwidths=b)
    elif args.scenario == "intra":
        cs = intra_server_constraints(n)
        req = TopologyRequest(n=n, r=args.r, scenario="constraint", cs=cs)
    elif args.scenario == "bcube":
        # BCube(p, 2) has p² servers; the reference passes n as p here,
        # which builds a 256-server BCube for --n 16 and fails validation
        p = int(round(n ** 0.5))
        if p * p != n:
            raise ValueError(f"--scenario bcube needs --n = p² (BCube(p, 2)), got {n}")
        cs = bcube_constraints(p, 2)
        req = TopologyRequest(n=n, r=args.r, scenario="constraint", cs=cs)
    else:  # pods
        cs = pod_boundary_constraints(n, args.pods, args.cross_pod_cap)
        req = TopologyRequest(n=n, r=args.r, scenario="constraint", cs=cs)
    res = solve_topology(req, cfg=cfg, budget_ms=args.budget_ms)
    topo = res.topology

    W = weight_matrix_from_weights(n, topo.edges, topo.g)
    bw = homo_edge_bandwidth(topo)
    report = {
        "name": topo.name,
        "n": n, "edges": len(topo.edges),
        "r_asym": topo.r_asym(),
        "quality_tier": res.quality_tier,
        "complete": res.complete,
        "max_degree": int(np.max(np.count_nonzero(W - np.diag(np.diag(W)), axis=1))),
        "b_min_GBs": min_edge_bandwidth(bw),
        "t_iter_ms": t_iter(min_edge_bandwidth(bw)),
        "meta": {k: v for k, v in topo.meta.items()
                 if isinstance(v, (str, int, float, bool))},
        "edge_list": [list(e) for e in topo.edges],
        "weights": np.asarray(topo.g).round(6).tolist(),
    }
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("edge_list", "weights")}, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
