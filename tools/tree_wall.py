"""Wall time of one workload of the port, for several source trees in turn
on one card.

    python3 tools/tree_wall.py --workload admm --tree build/parent --tree . --order 0110
    python3 tools/tree_wall.py --workload sim --tree build/parent --tree . --order 0110100101

Each ``--tree`` is the root of a checkout (its ``src/repro_torch`` is the
package timed); ``--order`` lists the trees to run by index, one process
each, so that ``0110`` runs parent, change, change, parent on the same
card. Each process builds its tree's kernels, warms up with one call of
the workload, then times ``--reps`` calls by the host clock, each ending
in a synchronise (or a host read). Workloads:

- ``admm`` (the default): 60 ADMM steps at n=64 (``main_n64``'s ADMM: n=64,
  r=128, the pipeline's default ``BATopoConfig().admm``, the warm start of
  ``chip_smoke.py``'s profile phase); it profiles one more solve for its
  device launches, host syncs and device busy time, and with
  ``--cprofile`` runs one solve under ``cProfile`` for its Python function
  calls and the functions that took the most host time under it;
- ``sim``: the §VI-B sim's training call, ``accuracy_curves`` in
  chip_smoke's main_sim configuration (n = 16, 30 epochs, batch 32, hidden
  128, bench_training_time's task) over nine topologies that need no solve
  (ring, grid, torus, exponential, U-EquiStatic M = 2, 3, random graphs of
  16, 24 and 32 edges); it reports the ``gossip_mix_batched`` launches of
  one call and the final accuracies (equal across trees where the gossip
  is bitwise equal).

Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
process, and a summary line; ``--json-out`` writes them all to a file.

It needs a card and imports only torch and numpy itself; each child
imports ``repro_torch`` from its own tree.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

N, R, STEPS = 64, 128, 60
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _python_calls(fn, top: int = 12) -> dict:
    """Python function calls of one ``fn()`` under cProfile, and the ``top``
    functions by their own time under it (the profiler's own cost
    included)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(fn)
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, nc, f"{Path(f).name}:{line}({name})")
                   for (f, line, name), (_, nc, tt, _, _) in stats.items()), reverse=True)
    return dict(calls=sum(nc for (_, nc, _, _, _) in stats.values()),
                top=[dict(fn=name, calls=nc, own_s=tt) for tt, nc, name in rows[:top]])


def child_admm(reps: int, cprofile: bool = False) -> dict:
    """Time and profile 60 ADMM steps with the ``repro_torch`` on sys.path."""
    import dataclasses
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import BATopoConfig, HomogeneousADMM
    from repro_torch.core.anneal import greedy_degree_graph
    from repro_torch.core.api import _pack_warm

    edges = greedy_degree_graph(N, np.full(N, 4), np.random.default_rng(0))
    g0, _, lam0 = _pack_warm(N, edges)
    cfg = dataclasses.replace(BATopoConfig().admm, max_iters=STEPS, device="cuda")
    solver = HomogeneousADMM(N, R, cfg)
    solver.solve(g0=g0, lam0=lam0)                      # builds the kernels, warms up
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(g0=g0, lam0=lam0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.solve(g0=g0, lam0=lam0)
        torch.cuda.synchronize()
    launches, syncs, busy_us = 0, 0, 0.0
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            launches += 1
            busy_us += ev.time_range.elapsed_us()
        elif ev.name in _SYNCS:
            syncs += 1
    out = dict(walls_s=walls, median_wall_s=sorted(walls)[len(walls) // 2],
               device_launches=launches, host_syncs=syncs, device_busy_s=busy_us / 1e6,
               lam_tilde=res.lam_tilde, cg_iters=res.cg_iters, iters=res.iters,
               residual=res.residual, support=int((res.g > 1e-6).sum()))
    if cprofile:
        out["python"] = _python_calls(lambda: (solver.solve(g0=g0, lam0=lam0),
                                               torch.cuda.synchronize()))
    return out


def child_sim(reps: int, cprofile: bool = False) -> dict:
    """Time ``accuracy_curves`` with the ``repro_torch`` on sys.path."""
    import time

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.topologies import make_baseline
    from repro_torch.data import class_balanced_partition, make_classification_data
    from repro_torch.dsgd.sim import DSGDSimConfig, accuracy_curves

    n = 16
    X, y = make_classification_data(num_classes=10, dim=64, samples_per_class=400, seed=0)
    Xte, yte = make_classification_data(num_classes=10, dim=64, samples_per_class=64, seed=0,
                                        noise_seed=10_001)
    data = (X, y, class_balanced_partition(y, n, seed=0), Xte, yte)
    topos = [make_baseline(k, n) for k in ("ring", "grid", "torus", "exponential")]
    topos += [make_baseline("equistatic", n, M=M) for M in (2, 3)]
    topos += [make_baseline("random", n, r=r, seed=0) for r in (16, 24, 32)]
    Ws = np.stack([t.W for t in topos]).astype(np.float32)
    cfg = DSGDSimConfig(epochs=30, batch=32, lr=0.05, momentum=0.9, hidden=128, seed=0)
    accuracy_curves(Ws, *data, cfg)                    # builds the kernels, warms up
    walls = []
    for _ in range(reps):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        accs, _ = accuracy_curves(Ws, *data, cfg)
        walls.append(time.perf_counter() - t0)
    return dict(walls_s=walls, median_wall_s=sorted(walls)[len(walls) // 2],
                gossip_launches=kernels.launch_counts()["gossip_mix_batched"],
                final_acc=accs[:, -1].tolist())


WORKLOADS = {"admm": child_admm, "sim": child_sim}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="admm")
    ap.add_argument("--tree", action="append", default=[],
                    help="root of a checkout to time (repeatable)")
    ap.add_argument("--order", default="",
                    help="tree indices to run in turn (default: each tree once)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--cprofile", action="store_true",
                    help="admm: also count each process's Python calls of one solve")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(WORKLOADS[args.workload](args.reps, args.cprofile)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tree_wall: needs an NVIDIA card", file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in (args.tree or ["."])]
    order = [int(c) for c in args.order] if args.order else list(range(len(trees)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for i in order:
        env = dict(os.environ, PYTHONPATH=str(trees[i] / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               "--workload", args.workload, "--reps", str(args.reps)]
                              + ["--cprofile"] * args.cprofile,
                              cwd=trees[i], env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"tree_wall: the run of {trees[i]} failed")
        run = dict(tree=str(trees[i]), index=i, **json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(run), flush=True)
        runs.append(run)
    summary = {str(i): sorted(r["median_wall_s"] for r in runs if r["index"] == i)
               for i in sorted(set(order))}
    print(json.dumps({"card": card, "workload": args.workload,
                      "median_wall_s_by_tree": summary}), flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps({"card": card, "workload": args.workload,
                                                   "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
