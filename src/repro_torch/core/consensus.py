"""Consensus-speed evaluation (§VI-A), in PyTorch.

Simulates x_{k+1} = W x_k and tracks the consensus error ‖x_k − x̄‖₂ per
iteration, then converts iterations to wall clock with the bandwidth model
(Eq. 34). The port of ``repro.core.consensus``.

The initial values are standard-Gaussian from a ``torch.Generator`` seeded
with ``seed`` (``jax.random`` streams cannot be reproduced); pass ``x0`` to
supply them, which is how the tests feed both packages the same values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .bandwidth import PaperConstants, t_iter
from .graph import Topology

__all__ = ["ConsensusTrace", "simulate_consensus", "simulate_consensus_batched",
           "time_to_error"]


@dataclass
class ConsensusTrace:
    errors: np.ndarray        # (iters+1,) consensus error per iteration
    t_iter_ms: float          # wall-clock per iteration (Eq. 34)
    times_ms: np.ndarray      # (iters+1,)
    topology: str


def _initial_values(n: int, dim: int, seed: int, x0, dev) -> torch.Tensor:
    if x0 is not None:
        return torch.as_tensor(np.asarray(x0, dtype=np.float64), device=dev)
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((n, dim), generator=gen, dtype=torch.float64).to(dev)


def _consensus_errors(Ws: torch.Tensor, x0: torch.Tensor, iters: int) -> np.ndarray:
    """Stacked Ws (T, n, n), shared x0 (n, dim) → errors (T, iters+1)."""
    T = int(Ws.shape[0])
    errs = torch.empty((T, iters + 1), dtype=torch.float64, device=Ws.device)
    errs[:, 0] = torch.linalg.norm(x0 - x0.mean(dim=0, keepdim=True))
    x = x0.expand(T, *x0.shape)
    for k in range(iters):
        x = Ws @ x
        errs[:, k + 1] = torch.linalg.norm(x - x.mean(dim=1, keepdim=True), dim=(1, 2))
    return errs.cpu().numpy()


def _traces(topos, errors, iters, b_mins, const) -> list[ConsensusTrace]:
    traces = []
    for k, topo in enumerate(topos):
        bm = None if b_mins is None else b_mins[k]
        ti = t_iter(bm, const) if bm is not None else float("nan")
        times = np.arange(iters + 1) * (ti if np.isfinite(ti) else 1.0)
        traces.append(ConsensusTrace(errors=errors[k], t_iter_ms=ti,
                                     times_ms=times, topology=topo.name))
    return traces


def simulate_consensus(
    topo: Topology,
    iters: int = 200,
    dim: int = 16,
    seed: int = 0,
    b_min: float | None = None,
    const: PaperConstants = PaperConstants(),
    device: str = "cuda",
    x0: np.ndarray | None = None,
) -> ConsensusTrace:
    """The consensus error trace of one topology: the one-topology call of
    :func:`simulate_consensus_batched`, from ``x0`` ((n, dim), default:
    standard-Gaussian from ``seed``); ``b_min`` turns iterations into wall
    clock by Eq. 34."""
    return simulate_consensus_batched([topo], iters, dim, seed, [b_min], const,
                                      device=device, x0=x0)[0]


def simulate_consensus_batched(
    topos: Sequence[Topology],
    iters: int = 200,
    dim: int = 16,
    seed: int = 0,
    b_mins: Sequence[float | None] | None = None,
    const: PaperConstants = PaperConstants(),
    device: str = "cuda",
    x0: np.ndarray | None = None,
) -> list[ConsensusTrace]:
    """Consensus error traces of a same-``n`` topology set, all topologies
    in one batched loop on ``device`` from shared initial values ``x0``
    ((n, dim), default: standard-Gaussian from ``seed``). ``b_mins`` turn
    iterations into wall clock by Eq. 34."""
    if not topos:
        return []
    n = topos[0].n
    if any(t.n != n for t in topos):
        raise ValueError("simulate_consensus_batched requires equal n "
                         f"(got {[t.n for t in topos]})")
    dev = resolve_device(device)
    Ws = torch.as_tensor(np.stack([np.asarray(t.W, dtype=np.float64) for t in topos]),
                         device=dev)
    errors = _consensus_errors(Ws, _initial_values(n, dim, seed, x0, dev), iters)
    return _traces(topos, errors, iters, b_mins, const)


def time_to_error(trace: ConsensusTrace, target: float = 1e-4) -> float:
    """First wall-clock time (ms) at which the consensus error ≤ target
    (relative to the initial error). inf if never reached."""
    rel = trace.errors / max(trace.errors[0], 1e-300)
    hit = np.nonzero(rel <= target)[0]
    if hit.size == 0:
        return float("inf")
    return float(trace.times_ms[hit[0]])
