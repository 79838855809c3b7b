"""DSGD training launcher of the port (``repro/launch/train.py``).

n workers are stacked on one device; each step takes every worker's
gradient in one vmapped pass, applies the optimizer, and gossips over the
topology (BA-Topo by default, solved on the same device) through the
``gossip_mix_batched`` kernel. Runs on ``cuda`` unless ``--device cpu``.

``--elastic`` wraps the loop in the elastic runtime
(:mod:`repro_torch.dsgd.elastic`): chaos-spec faults (churn, packet loss,
stragglers, bandwidth drift) hit the real model's gossip loop, a watchdog
drops modeled stragglers from rounds, a drift detector re-optimizes the
topology mid-training on the same device, and checkpoints (``--ckpt-dir``)
carry the elastic state, so ``--resume`` after a SIGKILL reproduces the
uninterrupted loss curve bitwise. With no fault flags the elastic path is
bitwise the plain trainer.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --workers 4 --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --workers 8 --steps 10 --batch 4 --seq 256 --topo ba --r 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --workers 4 --steps 10 --elastic --drift-step 4 \\
      --churn-events 1 --ckpt-dir build/ck --device cpu [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --workers 4 --steps 6 --sync dynamic --device cpu

``--sync dynamic`` gossips over one matching of the topology a step,
cycling round-robin (:mod:`repro_torch.dsgd.dynamic`): step t mixes by
W_{t mod R}, the slot read on the device from the state's step count, so a
resumed run takes up the cycle where its checkpoint left it.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
from typing import Callable

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_arch, reduced_for_smoke
from ..core.bandwidth import PaperConstants, homo_edge_bandwidth, min_edge_bandwidth, t_iter
from ..data import DataConfig, bigram_table, lm_batch_numpy
from ..data.pipeline import TABLE_STATS
from ..device import resolve_device
from ..dsgd import (ElasticRuntime, ElasticSpec, allreduce_train_step, drift_profile,
                    dsgd_train_step, init_dsgd_state, make_chaos, no_chaos,
                    random_churn_windows, trainer)
from ..dsgd.dynamic import cycle_weight_matrices, round_robin_schedules
from ..dsgd.gossip import padded_neighbors
from ..models import param_count
from ..optim import make_optimizer, warmup_cosine
from .steps import topology_for

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--topo", default="ba",
                    choices=["ba", "ring", "exponential", "equistatic", "torus"])
    ap.add_argument("--r", type=int, default=None, help="edge budget (default 2n)")
    ap.add_argument("--node-bw", default=None,
                    help="comma-separated per-node GB/s — optimizes the BA "
                         "topology under the §VI-A2 node scenario")
    ap.add_argument("--topo-cache", default=None,
                    help="JSON file of solved BA topologies "
                         "(default benchmarks/artifacts/topo_cache_torch.json)")
    ap.add_argument("--sync", default="gossip", choices=["gossip", "allreduce", "dynamic"])
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction, default=True,
                    help="gossip through the gossip_mix_batched kernel (default); "
                         "--no-use-kernel takes the dense W matmul")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    # ---- the elastic runtime --------------------------------------------
    ap.add_argument("--elastic", action="store_true",
                    help="elastic runtime: fault tensors + watchdog + "
                         "mid-training re-optimization")
    ap.add_argument("--churn-events", type=int, default=0)
    ap.add_argument("--p-drop", type=float, default=0.0)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--straggler-mult", type=float, default=3.0)
    ap.add_argument("--drift-step", type=int, default=-1,
                    help="step at which the slow nodes' NICs collapse (−1 off)")
    ap.add_argument("--slow-nodes", type=int, default=2)
    ap.add_argument("--slow-bw", type=float, default=1.0)
    ap.add_argument("--bw0", type=float, default=PaperConstants().b_avail)
    ap.add_argument("--deadline-factor", type=float, default=3.0)
    ap.add_argument("--activation-lag", type=int, default=1)
    ap.add_argument("--no-reopt", action="store_true",
                    help="elastic without the DriftDetector→re-solve loop")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest restorable checkpoint in "
                         "--ckpt-dir (crash-safe: bitwise the uninterrupted run)")
    ap.add_argument("--kill-at-step", type=int, default=-1,
                    help="(testing) SIGKILL this process before running the "
                         "given step — simulates a crash mid-run")
    args = ap.parse_args(argv)
    if args.elastic and args.sync != "gossip":
        ap.error("--elastic requires --sync gossip (the elastic runtime IS the gossip loop)")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    return args


def _build_chaos(args, n: int):
    """The run's ChaosSpec from the fault flags (all-defaults → fault-free)."""
    faulty = (args.churn_events > 0 or args.p_drop > 0
              or args.straggler_prob > 0 or args.drift_step >= 0)
    if not faulty:
        return no_chaos(args.steps, n, bandwidth=args.bw0)
    bw = np.full((args.steps, n), args.bw0, np.float64)
    if args.drift_step >= 0:
        bw = drift_profile(args.steps, n, args.drift_step, args.bw0,
                           args.slow_nodes, args.slow_bw)
    churn = random_churn_windows(n, args.steps, args.churn_events,
                                 seed=args.seed) if args.churn_events else []
    return make_chaos(args.steps, n, seed=args.seed, churn=churn,
                      p_drop=args.p_drop, straggler_prob=args.straggler_prob,
                      straggler_mult=args.straggler_mult, bandwidth=bw)


def _dynamic_step(cfg, topo, opt_update: Callable, *, use_kernel: bool = True,
                  device: str | torch.device = "cuda"):
    """``--sync dynamic``: the train step that mixes by one matching of the
    topology a step, ``W_{step mod R}`` over the R round-robin matchings.
    Returns ``(step, R)``.

    With ``use_kernel`` every step mixes all leaves by one
    ``gossip_mix_batched`` launch a dtype over the padded neighbour table of
    its slot (deg ≤ 1: each W_c is a matching). The R tables are built once
    and stacked on the device, and the slot is selected there from
    ``state.step``: no host counter and no read of the step. The mix goes
    through ``trainer.gossip_sim_tree`` as the static step's does.
    ``use_kernel=False`` mixes by the dense ``gossip_sim`` with W_c, the
    reference's form."""
    dev = resolve_device(device)
    Wc = torch.tensor(np.stack(cycle_weight_matrices(round_robin_schedules(topo))),
                      dtype=torch.float32, device=dev)
    rounds = int(Wc.shape[0])
    if use_kernel:
        tables = [padded_neighbors(W) for W in Wc]
        nbr_idx = torch.stack([idx for idx, _ in tables])
        weights = torch.stack([w for _, w in tables])

    def mix(params, t):
        slot = torch.remainder(t, rounds).long().reshape(1)
        W = Wc.index_select(0, slot)[0]
        if not use_kernel:
            return trainer.gossip_sim_tree(params, W, use_kernel=False)
        nbr = (nbr_idx.index_select(0, slot)[0], weights.index_select(0, slot)[0])
        return trainer.gossip_sim_tree(params, W, nbr=nbr)

    return trainer._make_step(cfg, opt_update, mix), rounds


def main(argv=None, *, on_step: Callable | None = None) -> dict:
    """Run the training loop; returns what ``--json-out`` writes. ``on_step``
    (for callers in Python) is called as ``on_step(step, state, metrics)``
    after every step."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    n = args.workers

    lr = warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)
    opt_init, opt_update = make_optimizer(args.optimizer, lr)

    node_bw = [float(v) for v in args.node_bw.split(",")] if args.node_bw else None
    t0 = time.perf_counter()
    topo = topology_for(n, kind=args.topo, r=args.r, seed=args.seed, node_bw=node_bw,
                        device=dev, cache_path=args.topo_cache)
    topo_s = time.perf_counter() - t0
    runtime = es = step = rounds = None
    if args.elastic:
        chaos = _build_chaos(args, n)
        spec = ElasticSpec(chaos=chaos, deadline_factor=args.deadline_factor,
                           reopt=not args.no_reopt,
                           activation_lag_steps=args.activation_lag)
        runtime = ElasticRuntime(cfg, spec, topo, opt_update, use_kernel=args.use_kernel,
                                 device=dev)
        es = runtime.make_state(topo, seed=args.seed)
        faults = "faultless" if chaos.faultless else "chaotic"
        sync_desc = f"elastic[{topo.name}] {faults} r_asym={topo.r_asym():.3f}"
    elif args.sync == "allreduce":
        step = allreduce_train_step(cfg, n, opt_update, device=dev)
        sync_desc = "allreduce"
    elif args.sync == "dynamic":
        step, rounds = _dynamic_step(cfg, topo, opt_update, use_kernel=args.use_kernel,
                                     device=dev)
        sync_desc = f"dynamic[{topo.name}] rounds={rounds}"
    else:
        step = dsgd_train_step(cfg, topo, opt_update, use_kernel=args.use_kernel, device=dev)
        sync_desc = f"gossip[{topo.name}] r_asym={topo.r_asym():.3f}"

    # the paper's wall-clock model for this topology (Eq. 34/35)
    pc = PaperConstants()
    b_min = min_edge_bandwidth(homo_edge_bandwidth(topo)) if len(topo.edges) else pc.b_avail
    iter_time = t_iter(b_min, pc) / 1e3  # s

    state = init_dsgd_state(args.seed, cfg, n, opt_init, device=dev)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
                    seed=args.seed, frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)
    bigram_table(cfg.vocab_size, args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    start = 0
    if args.resume:
        restored, rstep, extras = mgr.restore(state, with_extra=True)
        if restored is not None:
            state, start = restored, int(rstep)
            if args.elastic and extras:
                es = runtime.from_extras(extras, name=topo.name)
            print(f"resumed from step {start} "
                  f"({'elastic state restored' if extras else 'pytree only'})", flush=True)
        else:
            print("no restorable checkpoint found — starting fresh", flush=True)

    def save(step_label: int) -> None:
        if mgr:
            mgr.save(state, step_label, extra=runtime.to_extras(es) if args.elastic else None)

    print(f"arch={cfg.name} workers={n} device={dev} sync={sync_desc} "
          f"modelled t_iter={iter_time * 1e3:.2f}ms (paper Eq. 34)", flush=True)
    history, step_ms, elastic_log = [], [], []
    begin = time.perf_counter()
    modeled_ms = 0.0
    for s in range(start, args.steps):
        if s == args.kill_at_step:
            os.kill(os.getpid(), signal.SIGKILL)     # crash, not cleanup
        t_step = time.perf_counter()
        data_step = es.data_step if args.elastic else s
        per = [lm_batch_numpy(dc, data_step, node=i) for i in range(n)]
        batch = {k: torch.from_numpy(np.stack([b[k] for b in per])).to(dev) for k in per[0]}
        if args.elastic:
            state, metrics, rep = runtime.round(state, es, batch)
            modeled_ms += rep.round_ms
            if rep.dropped.any() or rep.swapped or rep.reopt is not None:
                elastic_log.append({"step": s, "dropped": int(rep.dropped.sum()),
                                    "swapped": rep.swapped, "reopt": rep.reopt_reason,
                                    "attempts": rep.attempts})
        else:
            state, metrics = step(state, batch)
            modeled_ms += iter_time * 1e3
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        if on_step is not None:
            on_step(s, state, metrics)
        if s % args.log_every == 0 or s == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=s, wall_s=round(time.perf_counter() - begin, 1),
                     modelled_time_s=round(modeled_ms / 1e3, 4))
            history.append(m)
            print("  " + json.dumps(m), flush=True)
        if s and s % args.ckpt_every == 0:
            save(int(state.step))
    save(int(state.step) if args.steps > start else args.steps)
    out = {"config": vars(args), "arch": cfg.name, "device": str(dev),
           "param_count_per_worker": param_count(state.params) // n,
           "topology": topo.name, "edges": len(topo.edges),
           "r_asym": topo.r_asym() if len(topo.edges) else None,
           "topology_s": topo_s, "rounds": rounds,
           "bigram_table": TABLE_STATS.get((cfg.vocab_size, args.seed)),
           "step_ms": step_ms, "history": history}
    if args.elastic:
        out["elastic"] = {"events": es.events, "log": elastic_log, "reopts": es.reopts,
                          "adopted": es.adopted, "drops": es.drops,
                          "final_topology": es.topology.name}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json_out}")
    return out


if __name__ == "__main__":
    main()
