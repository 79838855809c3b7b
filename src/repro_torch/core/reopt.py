"""Online topology re-optimization under drift (DESIGN.md §14), in the port.

The port of ``repro.core.reopt``. A :class:`DriftDetector` watches the
per-step bandwidth profile B(t) and the alive mask (numpy, e.g. the port's
``dsgd.chaos.ChaosSpec`` arrays) against a baseline and fires when either
moves past the :class:`DriftPolicy` thresholds. On a trigger,
:func:`reoptimize_topology` re-solves on ``cfg.device`` under the drifted
``ConstraintSet`` through the shared ``core.guard`` ladder:

  rung "warm"  a guarded ADMM warm-started from the incumbent support
               (``g0``/``z0``/``lam0`` packed as the cold pipeline packs its
               annealed warm starts),
  rung "cold"  ``solve_topology(engine="barrier")`` (SA warm starts,
               batched restarts, classic baselines), or the anytime engine
               under ``budget_ms``,
  fallback     keep the incumbent and report why.

``time_to_reopt_s`` is the host wall time of the call; it ends in host
reads of the solver's results, so it includes the card's time. A device
fault (``repro_torch.device.DEVICE_FAULTS``) leaves the call as that
exception; the incumbent is kept only for solver outcomes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .api import BATopoConfig, _pack_warm
from .constraints import ConstraintSet
from .graph import Topology
from .guard import GuardPolicy, attempt_admm, run_ladder

__all__ = ["DriftPolicy", "DriftDetector", "ReoptResult",
           "reoptimize_topology", "first_drift"]


@dataclass(frozen=True)
class DriftPolicy:
    """When is the world different enough to re-solve?

    ``bw_rel_threshold``: trigger when any node's bandwidth moved by more
    than this fraction of its baseline value (|B_i(t) − B_i(0)| / B_i(0)).
    ``churn_events``: trigger when at least this many nodes flipped
    alive/dead versus the baseline membership.
    ``cooldown_steps``: suppress re-triggers for this many steps after one
    fires — a re-solve in flight should not be pre-empted by the same drift.
    ``max_residual``: an ADMM re-solve whose final summed-squared primal
    residual exceeds this is declared non-convergent (fallback ladder).
    """

    bw_rel_threshold: float = 0.25
    churn_events: int = 1
    cooldown_steps: int = 0
    max_residual: float = 1.0


@dataclass
class DriftDetector:
    """Streaming comparison of (B(t), alive(t)) against a rebased baseline."""

    policy: DriftPolicy
    base_bandwidth: np.ndarray           # (n,)
    base_alive: np.ndarray               # (n,)
    last_trigger: int | None = None

    @classmethod
    def from_profile(cls, bandwidth0: np.ndarray, alive0: np.ndarray,
                     policy: DriftPolicy | None = None) -> "DriftDetector":
        return cls(policy or DriftPolicy(),
                   np.asarray(bandwidth0, np.float64).copy(),
                   np.asarray(alive0, np.float64).copy())

    def check(self, t: int, bandwidth_t: np.ndarray,
              alive_t: np.ndarray) -> str | None:
        """Reason string ("bandwidth" / "churn") if step ``t`` drifted past
        the thresholds, else None. Does not rebase — call :meth:`rebase`
        after a re-optimized topology is actually adopted."""
        if (self.last_trigger is not None
                and t - self.last_trigger < self.policy.cooldown_steps):
            return None
        flips = int(np.sum(np.asarray(alive_t) != self.base_alive))
        if flips >= self.policy.churn_events:
            self.last_trigger = t
            return "churn"
        rel = np.abs(np.asarray(bandwidth_t, np.float64) - self.base_bandwidth)
        rel = rel / np.maximum(self.base_bandwidth, 1e-12)
        if float(rel.max(initial=0.0)) > self.policy.bw_rel_threshold:
            self.last_trigger = t
            return "bandwidth"
        return None

    def rebase(self, bandwidth_t: np.ndarray, alive_t: np.ndarray) -> None:
        """Adopt the current world as the new baseline (after a reopt)."""
        self.base_bandwidth = np.asarray(bandwidth_t, np.float64).copy()
        self.base_alive = np.asarray(alive_t, np.float64).copy()

    def to_state(self) -> dict[str, np.ndarray]:
        """Named arrays capturing the detector's mutable state (baselines +
        cooldown clock) — the checkpoint extras payload of a crash-safe
        resume (DESIGN.md §16). ``last_trigger`` uses −1 for "never"."""
        return {
            "base_bandwidth": self.base_bandwidth.copy(),
            "base_alive": self.base_alive.copy(),
            "last_trigger": np.asarray(
                -1 if self.last_trigger is None else self.last_trigger,
                np.int64),
        }

    @classmethod
    def from_state(cls, state: dict[str, np.ndarray],
                   policy: DriftPolicy | None = None) -> "DriftDetector":
        """Inverse of :meth:`to_state` (the policy itself is static config,
        not state — pass the run's)."""
        det = cls(policy or DriftPolicy(),
                  np.asarray(state["base_bandwidth"], np.float64).copy(),
                  np.asarray(state["base_alive"], np.float64).copy())
        lt = int(state["last_trigger"])
        det.last_trigger = None if lt < 0 else lt
        return det


def first_drift(chaos, policy: DriftPolicy | None = None,
                start: int = 0) -> tuple[int, str] | None:
    """Walk a ChaosSpec's numpy (bandwidth, alive) arrays from ``start`` and
    return the first (step, reason) the detector fires at, or None."""
    det = DriftDetector.from_profile(chaos.bandwidth[start],
                                     chaos.alive[start], policy)
    for t in range(start + 1, chaos.steps):
        reason = det.check(t, chaos.bandwidth[t], chaos.alive[t])
        if reason is not None:
            return t, reason
    return None


@dataclass
class ReoptResult:
    """Outcome of one re-optimization attempt ladder."""

    topology: Topology
    reoptimized: bool                 # False ⇒ incumbent kept (see reason)
    attempts: int                     # solver attempts actually made
    fallback_reason: str | None       # set iff reoptimized is False
    time_to_reopt_s: float            # wall: trigger → adopted topology
    r_asym_before: float
    r_asym_after: float
    meta: dict = field(default_factory=dict)


def reoptimize_topology(
    incumbent: Topology,
    scenario: str = "homo",
    cs: ConstraintSet | None = None,
    node_bandwidths: np.ndarray | None = None,
    r: int | None = None,
    alive: np.ndarray | None = None,
    cfg: BATopoConfig | None = None,
    policy: DriftPolicy | None = None,
    budget_ms: float | None = None,
) -> ReoptResult:
    """Re-solve the topology under drifted constraints, warm-started from
    the incumbent; keep the incumbent on any failure.

    ``node_bandwidths`` is the *drifted* profile (node scenario — Algorithm 1
    re-allocates per-node capacities under it); ``cs`` the drifted
    ConstraintSet (constraint scenario). ``alive`` (optional, (n,) mask)
    prunes dead nodes' edges from the warm-start support only — the re-solve
    still covers all n nodes, because churned nodes rejoin at their frozen
    params and need edges waiting for them.

    ``budget_ms`` (opt-in) bounds the COLD rung with a budgeted anytime
    solve of whatever budget remains after the warm attempt — the elastic
    runtime passes its ``activation_lag_steps`` adoption window here so the
    re-solve fills exactly the time the fleet must wait anyway. The default
    (None) keeps the unbudgeted deterministic ladder: wall-clock budgets
    make the adopted support timing-dependent, which would break bit-exact
    crash/resume replay (DESIGN.md §16) — hence opt-in.

    The attempt ladder and the non-convergence test (``policy.max_residual``)
    are documented in the module docstring; ``time_to_reopt_s`` measures
    this call's wall time, i.e. how long training would run on the stale
    incumbent before the new graph exists. A device fault raised by a rung
    leaves this call as that exception.
    """
    t_start = time.perf_counter()
    cfg = cfg or BATopoConfig()
    policy = policy or DriftPolicy()
    n = incumbent.n
    r = int(r if r is not None else len(incumbent.edges))

    from .anytime import resolve_scenario

    cs, _, meta = resolve_scenario(n, r, scenario, cs, node_bandwidths,
                                   context="reopt")
    meta.pop("alloc_e", None)  # reopt meta stays (scenario, r[, b_unit])

    live_edges = incumbent.edges
    if alive is not None:
        a = np.asarray(alive)
        live_edges = [e for e in incumbent.edges if a[e[0]] > 0 and a[e[1]] > 0]
    if not live_edges:                      # a fully-dead incumbent support
        live_edges = incumbent.edges        # fall back to the full support

    r_before = incumbent.r_asym()

    # ---- shared guard ladder: warm → cold (keep-incumbent is OUR fallback)
    guard_policy = GuardPolicy(max_residual=policy.max_residual,
                               warm_retries=0)
    warm = _pack_warm(n, live_edges)

    def _cold():
        from .anytime import TopologyRequest, solve_topology

        req = TopologyRequest(n=n, r=r, scenario=scenario, cs=cs,
                              node_bandwidths=node_bandwidths)
        if budget_ms is None:
            cand = solve_topology(req, cfg=cfg, engine="barrier").topology
        else:
            remaining = budget_ms - (time.perf_counter() - t_start) * 1e3
            if remaining <= 0:
                return None                 # window spent — keep incumbent
            res = solve_topology(req, cfg=cfg, budget_ms=remaining)
            # an internal classic fallback on an expired budget is NOT an
            # upgrade over a live incumbent — treat it as "no candidate"
            if not res.complete and res.quality_tier == "classic":
                return None
            cand = res.topology
        return (cand if cand is not None
                and cand.meta.get("connected", True) else None)

    ladder = run_ladder([
        ("warm", lambda: attempt_admm(
            n, r, scenario, cs, cfg, warm,
            f"ba-topo(n={n},r={r},reopt-warm)", guard_policy)),
        ("cold", _cold),
    ])
    candidate = ladder.topology

    elapsed = time.perf_counter() - t_start
    if candidate is None:
        return ReoptResult(topology=incumbent, reoptimized=False,
                           attempts=ladder.attempts,
                           fallback_reason=ladder.reason or "no connected candidate",
                           time_to_reopt_s=elapsed,
                           r_asym_before=r_before, r_asym_after=r_before,
                           meta=meta)

    r_after = candidate.r_asym()
    candidate.meta.update(meta)
    candidate.meta["r_asym"] = r_after
    candidate.meta["time_to_reopt_s"] = elapsed
    return ReoptResult(topology=candidate, reoptimized=True,
                       attempts=ladder.attempts, fallback_reason=None,
                       time_to_reopt_s=elapsed,
                       r_asym_before=r_before, r_asym_after=r_after,
                       meta=meta)
