"""Fault injection for the DSGD engines (the reference's ``repro/dsgd/chaos.py``).

``ChaosSpec`` packages four fault modes as precomputed per-step arrays, so
the engines of :mod:`repro_torch.dsgd.sim` read them as data:

  - ``alive      (T, n)``    node-alive masks — join/leave churn. A dead node
    freezes (no gradient step, no mixing) and rejoins at its last params.
  - ``link_up    (T, n, n)`` symmetric per-edge Bernoulli draws — packet
    loss; both endpoints fold the lost weight into their self-weight.
  - ``straggler  (T, n)``    per-node delay multipliers (≥ 1) for the Eq. 34
    step-time model, not the training math.
  - ``bandwidth  (T, n)``    the per-node bandwidth profile B(t), GB/s, for
    the time model, not the training math.

The constructors are numpy, seeded as the reference's, so a spec is
bit-identical to the reference's for the same arguments. Only ``alive`` and
``link_up`` go to the device. ``degrade_matrix`` runs on tensors; with no
faults it is an IEEE-exact identity.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ChaosSpec", "no_chaos", "make_chaos", "random_churn_windows",
           "drift_profile", "degrade_matrix"]


@dataclass(frozen=True)
class ChaosSpec:
    """Precomputed fault arrays for a ``steps``-iteration run on n nodes."""

    alive: np.ndarray       # (T, n) float32 ∈ {0, 1}
    link_up: np.ndarray     # (T, n, n) float32 ∈ {0, 1}, symmetric, diag 1
    straggler: np.ndarray   # (T, n) float64 ≥ 1 — step-time multipliers
    bandwidth: np.ndarray   # (T, n) float64 GB/s — B(t) per node
    meta: dict = field(default_factory=dict)

    @property
    def steps(self) -> int:
        return self.alive.shape[0]

    @property
    def n(self) -> int:
        return self.alive.shape[1]

    @property
    def faultless(self) -> bool:
        """True when alive is all ones and every link is up (stragglers and
        bandwidth drift stretch the modeled clock only)."""
        return bool(np.all(self.alive == 1.0) and np.all(self.link_up == 1.0))

    def device_leaves(self, device: str | torch.device = "cuda"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """``alive`` and ``link_up`` as float32 tensors on ``device``."""
        dev = resolve_device(device)
        return (torch.as_tensor(self.alive, dtype=torch.float32, device=dev),
                torch.as_tensor(self.link_up, dtype=torch.float32, device=dev))

    def validate(self) -> None:
        T, n = self.alive.shape
        if self.link_up.shape != (T, n, n):
            raise ValueError(f"link_up shape {self.link_up.shape} != {(T, n, n)}")
        if self.straggler.shape != (T, n) or self.bandwidth.shape != (T, n):
            raise ValueError("straggler/bandwidth must be (steps, n)")
        if not np.allclose(self.link_up, np.swapaxes(self.link_up, 1, 2)):
            raise ValueError("link_up must be symmetric per step "
                             "(an undirected edge drops for both endpoints)")
        if np.any(self.straggler < 1.0):
            raise ValueError("straggler multipliers must be ≥ 1")
        if np.any(self.bandwidth <= 0.0):
            raise ValueError("bandwidth profile must be positive")


def no_chaos(steps: int, n: int, bandwidth: float = 9.76) -> ChaosSpec:
    """The fault-free spec: the chaos engine under it is bit-equal to the
    cross engine."""
    return ChaosSpec(
        alive=np.ones((steps, n), np.float32),
        link_up=np.ones((steps, n, n), np.float32),
        straggler=np.ones((steps, n), np.float64),
        bandwidth=np.full((steps, n), float(bandwidth), np.float64),
        meta={"faultless": True},
    )


def drift_profile(steps: int, n: int, drift_step: int, bw0: np.ndarray,
                  slow_nodes: int, slow_bw: float) -> np.ndarray:
    """(T, n) bandwidth profile: ``bw0`` until ``drift_step``, then the
    first ``slow_nodes`` nodes collapse to ``slow_bw`` GB/s for good."""
    prof = np.broadcast_to(np.asarray(bw0, np.float64), (steps, n)).copy()
    prof[drift_step:, :slow_nodes] = slow_bw
    return prof


def random_churn_windows(n: int, steps: int, events: int, seed: int = 0,
                         min_alive: int = 2,
                         min_down: int | None = None) -> list[tuple[int, int, int]]:
    """Draw ``events`` reproducible (node, t_leave, t_rejoin) churn windows.

    Windows never overlap on the same node and never take the alive count
    below ``min_alive`` at any step. ``t_rejoin == steps`` means the node
    leaves for good."""
    rng = np.random.default_rng(seed)
    down = np.zeros((steps, n), np.int64)
    out: list[tuple[int, int, int]] = []
    lo = max(min_down or steps // 8, 1)
    for _ in range(events):
        for _attempt in range(64):
            node = int(rng.integers(n))
            t0 = int(rng.integers(0, max(steps - lo, 1)))
            t1 = min(int(t0 + rng.integers(lo, max(steps // 2, lo + 1))), steps)
            window = down[t0:t1]
            if window[:, node].any():
                continue                          # node already down here
            if (n - (window.sum(axis=1) + 1)).min() < min_alive:
                continue                          # would depopulate the net
            window[:, node] = 1
            out.append((node, t0, t1))
            break
    return out


def make_chaos(steps: int, n: int, seed: int = 0, *,
               churn: list[tuple[int, int, int]] | None = None,
               p_drop: float = 0.0,
               straggler_prob: float = 0.0,
               straggler_mult: float = 3.0,
               bandwidth: np.ndarray | float = 9.76) -> ChaosSpec:
    """Build a ChaosSpec from scenario knobs: explicit ``churn`` windows
    (node, t_leave, t_rejoin); a per-step per-edge link-drop probability
    ``p_drop`` (drawn on the upper triangle and mirrored); stragglers that
    run ``straggler_mult×`` slow with probability ``straggler_prob``; and a
    scalar, (n,) or (T, n) ``bandwidth`` profile."""
    rng = np.random.default_rng(seed)
    alive = np.ones((steps, n), np.float32)
    for node, t0, t1 in churn or ():
        if not (0 <= node < n and 0 <= t0 <= t1 <= steps):
            raise ValueError(f"churn window {(node, t0, t1)} out of range "
                             f"for steps={steps}, n={n}")
        alive[t0:t1, node] = 0.0

    link_up = np.ones((steps, n, n), np.float32)
    if p_drop > 0.0:
        iu, ju = np.triu_indices(n, k=1)
        drops = rng.random((steps, len(iu))) < p_drop
        link_up[:, iu, ju] = np.where(drops, 0.0, 1.0)
        link_up[:, ju, iu] = link_up[:, iu, ju]

    straggler = np.ones((steps, n), np.float64)
    if straggler_prob > 0.0:
        slow = rng.random((steps, n)) < straggler_prob
        straggler = np.where(slow, float(straggler_mult), 1.0)

    bw = np.asarray(bandwidth, np.float64)
    if bw.ndim == 0:
        bw = np.full((steps, n), float(bw))
    elif bw.ndim == 1:
        bw = np.broadcast_to(bw, (steps, n)).copy()
    elif bw.shape != (steps, n):
        raise ValueError(f"bandwidth profile shape {bw.shape} != {(steps, n)}")

    spec = ChaosSpec(alive=alive, link_up=link_up, straggler=straggler,
                     bandwidth=bw,
                     meta={"seed": seed, "p_drop": p_drop,
                           "churn": list(churn or ()),
                           "straggler_prob": straggler_prob})
    spec.validate()
    return spec


def degrade_matrix(W: torch.Tensor, alive: torch.Tensor,
                   link_up: torch.Tensor) -> torch.Tensor:
    """Renormalize a gossip matrix under node/link faults, on W's device.

    An off-diagonal entry survives iff both endpoints are alive and the link
    is up; every entry a row loses is folded into that row's self-weight, so
    alive rows stay row-stochastic. Dead rows and columns are zeroed (the
    engine restores dead nodes' frozen state after the mix). With no faults
    every operation is an IEEE-exact identity (multiplies by 1.0, a folded
    loss of exact 0.0). Broadcasts over leading batch axes.
    """
    dt = W.dtype
    n = W.shape[-1]
    alive = alive.to(dt)
    pair = alive[..., :, None] * alive[..., None, :] * link_up.to(dt)
    eye = torch.eye(n, dtype=dt, device=W.device)
    off = W * (1.0 - eye)
    kept = off * pair
    lost = (off - kept).sum(dim=-1)
    diag = (torch.diagonal(W, dim1=-2, dim2=-1) + lost) * alive
    return kept + eye * diag[..., :, None]
