"""Solver guard layer: outcome classification, topology invariants and the
shared retry/fallback ladder (DESIGN.md §15), in the port.

The port of ``repro.core.guard``, one code path for every consumer — the
barrier pipeline's release validation, ``core.reopt``'s online re-solve and
the topology service:

  * :class:`SolveOutcome` — {converged, non_convergent, non_finite,
    disconnected_rounding}, the verdict on one ADMM attempt; ``non_finite``
    pairs with the engine's ``abort_nonfinite`` early stop.
  * :func:`check_invariants` / :func:`validate_topology` — the release
    checklist (finite W, symmetry, row-stochasticity, connectivity) and
    :class:`TopologyInvariantError`.
  * :func:`run_ladder` — rungs are (name, thunk) pairs tried in order; a
    rung may return a Topology (validated here), return None, or raise —
    :class:`SolveFailure` carries a classified outcome, anything else is
    recorded as an error.
  * :func:`attempt_admm` / :func:`jittered_warm_rungs` — one classified,
    rounded ADMM attempt from a warm start on ``cfg.device``, and the
    ρ-jittered retry rungs built from it.
  * :func:`classic_fallback` — the closed-form last resort.

Deviation from the reference, whose ladder never raises: ``run_ladder``
re-raises :data:`~repro_torch.device.DEVICE_FAULTS` (the port's
``DeviceFault`` and ``torch.AcceleratorError``). A kernel that does not
build or launch, or a card that is not there, is not a solver outcome, and
recording it would answer every request from the classic fallback.
``torch.OutOfMemoryError`` is an outcome of the request's size and is
recorded like any other error.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np
import torch

from ..device import DEVICE_FAULTS
from .constraints import ConstraintSet
from .graph import Topology, all_edges, is_connected

__all__ = [
    "SolveOutcome", "GuardPolicy", "SolveFailure", "TopologyInvariantError",
    "RungReport", "LadderResult", "run_ladder", "check_invariants",
    "validate_topology", "classify_result", "round_result", "attempt_admm",
    "jittered_warm_rungs", "classic_fallback",
]


class SolveOutcome(str, enum.Enum):
    """Structured verdict on one ADMM solve + rounding attempt."""

    CONVERGED = "converged"
    NON_CONVERGENT = "non_convergent"
    NON_FINITE = "non_finite"
    DISCONNECTED_ROUNDING = "disconnected_rounding"


@dataclass(frozen=True)
class GuardPolicy:
    """Knobs of the retry ladder.

    ``max_residual``: an ADMM attempt whose final summed-squared primal
    residual exceeds this is ``non_convergent`` (same meaning as
    ``reopt.DriftPolicy.max_residual``).
    ``warm_retries``: reseeded warm-start retries with jittered ρ after the
    first warm attempt fails (0 = straight to the next rung).
    ``rho_jitter``: multiplicative jitter span — retry k uses
    ρ·(1 + rho_jitter)^±k alternating up/down, a cheap deterministic sweep
    around the tuned penalty (a bad ρ is the common non-convergence cause).
    """

    max_residual: float = 1.0
    warm_retries: int = 1
    rho_jitter: float = 0.5


class SolveFailure(RuntimeError):
    """A classified solver failure — raised by rung thunks so the ladder
    records *why* (outcome) rather than just *that* the rung failed."""

    def __init__(self, outcome: SolveOutcome, detail: str = ""):
        super().__init__(f"{outcome.value}" + (f": {detail}" if detail else ""))
        self.outcome = outcome
        self.detail = detail


class TopologyInvariantError(ValueError):
    """No candidate topology passed the release checklist; ``invariant``
    names the (last) failed check, ``failures`` the full per-candidate
    breakdown."""

    def __init__(self, message: str, invariant: str,
                 failures: list[str] | None = None):
        super().__init__(message)
        self.invariant = invariant
        self.failures = failures or []


# =========================================================================
# Release invariants (the checklist every served topology must pass)
# =========================================================================

def check_invariants(topo: Topology, atol: float = 1e-8) -> str | None:
    """First violated release invariant of ``topo``, or None if all hold.

    Checks, in order: ``finite`` (every W entry), ``symmetric`` (W = Wᵀ —
    skipped for directed ``W_override`` baselines), ``row_stochastic``
    (W·1 = 1), ``connected`` (the selected edge set spans all n nodes).
    The order is the debugging order: a NaN W fails ``finite`` rather than
    cascading into meaningless symmetry/stochasticity failures.
    """
    W = np.asarray(topo.W)
    n = topo.n
    if W.shape != (n, n):
        return "shape"
    if not np.all(np.isfinite(W)):
        return "finite"
    directed = bool(topo.meta.get("directed")) or "W_override" in topo.meta
    if not directed and not np.allclose(W, W.T, atol=atol):
        return "symmetric"
    if not np.allclose(W.sum(axis=1), 1.0, atol=max(atol, 1e-6)):
        return "row_stochastic"
    if not directed and not is_connected(n, topo.edges):
        return "connected"
    return None


def validate_topology(topo: Topology, context: str = "",
                      atol: float = 1e-8) -> Topology:
    """Raise :class:`TopologyInvariantError` naming the failed invariant,
    else return ``topo`` unchanged (release-validation entry point)."""
    bad = check_invariants(topo, atol=atol)
    if bad is not None:
        raise TopologyInvariantError(
            f"topology {topo.name!r} violates the {bad!r} invariant"
            + (f" ({context})" if context else ""),
            invariant=bad, failures=[f"{topo.name}: {bad}"])
    return topo


# =========================================================================
# Outcome classification + rounding
# =========================================================================

def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def classify_result(res, max_residual: float = 1.0) -> SolveOutcome:
    """Classify a raw :class:`~repro_torch.core.engine.ADMMResult` (pre-rounding).

    ``non_finite`` — the residual or any returned iterate entry is NaN/Inf
    (the engine's early-abort leaves the poisoned residual in place exactly
    so this check sees it); ``non_convergent`` — finite but above
    ``max_residual``; else ``converged``. ``disconnected_rounding`` is
    assigned later, by :func:`round_result` callers, because it is a
    property of the rounded support, not of the solve. A field may be a
    tensor on the card: each is read once, to the host.
    """
    vals = [_host(res.residual), _host(res.g), _host(res.g_raw)]
    if res.z is not None:
        vals.append(_host(res.z))
    if not all(np.all(np.isfinite(v)) for v in vals):
        return SolveOutcome.NON_FINITE
    if float(vals[0]) > max_residual:
        return SolveOutcome.NON_CONVERGENT
    return SolveOutcome.CONVERGED


def round_result(n: int, r: int, res, cs: ConstraintSet | None, cfg,
                 name: str) -> Topology | None:
    """ADMM result → rounded, repaired, polished Topology (None if the
    repaired support is disconnected — the ``disconnected_rounding``
    signal). Shared by reopt and the service; the cold pipeline inlines the
    same sequence in its batched form (``api._finalize_batch``). The polish
    is the host one, as in the reference."""
    from .api import extract_support, repair_selection
    from .weights import metropolis_weights, polish_weights

    score = res.g + res.g_raw
    edge_ok = np.asarray(cs.edge_ok) if cs is not None else None
    sel = extract_support(n, score, r, cfg.support_tol, z=res.z,
                          edge_ok=edge_ok)
    sel = repair_selection(n, sel, score, cs)
    edges_full = all_edges(n)
    edges = [edges_full[ln] for ln in np.nonzero(sel)[0]]
    if not edges or not is_connected(n, edges):
        return None
    g = polish_weights(n, edges, metropolis_weights(n, edges),
                       iters=cfg.polish_iters)
    return Topology(n, edges, g, name=name,
                    meta={"connected": True, "admm_iters": res.iters,
                          "admm_residual": res.residual})


def attempt_admm(n: int, r: int, scenario: str, cs: ConstraintSet | None,
                 cfg, warm: tuple, name: str,
                 policy: GuardPolicy | None = None,
                 rho_scale: float = 1.0) -> Topology:
    """One guarded ADMM attempt: solve from the warm start on
    ``cfg.device``, classify, round.

    Returns the rounded topology on success; raises :class:`SolveFailure`
    with the classified outcome otherwise. ``rho_scale`` multiplies the
    configured penalty (the ρ-jitter retry hook); ``warm`` is the
    ``(g0, z0, lam0)`` triple of ``api._pack_warm``.
    """
    from .api import _make_solver

    policy = policy or GuardPolicy()
    g0, z0, lam0 = warm
    if rho_scale != 1.0:
        cfg = replace(cfg, admm=replace(cfg.admm, rho=cfg.admm.rho * rho_scale))
    solver = _make_solver(n, r, scenario, cs, cfg)
    if scenario == "homo":
        res = solver.solve(g0=g0, lam0=lam0)
    else:
        res = solver.solve(g0=g0, z0=z0, lam0=lam0)
    outcome = classify_result(res, policy.max_residual)
    if outcome is not SolveOutcome.CONVERGED:
        raise SolveFailure(outcome, f"residual={res.residual:.3g}")
    topo = round_result(n, r, res, cs, cfg, name)
    if topo is None:
        raise SolveFailure(SolveOutcome.DISCONNECTED_ROUNDING,
                           "rounded+repaired support is disconnected")
    return topo


def jittered_warm_rungs(n: int, r: int, scenario: str,
                        cs: ConstraintSet | None, cfg, warm: tuple,
                        name: str, policy: GuardPolicy) -> list[tuple]:
    """The warm rung plus ``policy.warm_retries`` reseeded ρ-jittered
    retries, as (rung_name, thunk) pairs for :func:`run_ladder`. Retry k
    alternates the penalty up/down by (1 + rho_jitter)^⌈k/2⌉."""
    rungs = [("warm", lambda: attempt_admm(n, r, scenario, cs, cfg, warm,
                                           name, policy))]
    for k in range(1, policy.warm_retries + 1):
        scale = (1.0 + policy.rho_jitter) ** (-(k + 1) // 2 if k % 2 else
                                              (k + 1) // 2)
        rungs.append((
            f"warm-retry{k}(rho×{scale:.3g})",
            lambda s=scale: attempt_admm(n, r, scenario, cs, cfg, warm,
                                         name, policy, rho_scale=s)))
    return rungs


# =========================================================================
# The ladder
# =========================================================================

@dataclass
class RungReport:
    """What one rung did: ``outcome`` is "ok", a SolveOutcome value, an
    ``invalid:<invariant>`` release-check failure, or ``error:<Type>``."""

    rung: str
    outcome: str
    detail: str = ""


@dataclass
class LadderResult:
    topology: Topology | None
    rung: str | None                       # winning rung name (None = all failed)
    attempts: int                          # rungs actually attempted
    reports: list[RungReport] = field(default_factory=list)

    @property
    def reason(self) -> str:
        """Human-readable trail of every non-ok rung (the structured
        ``fallback_reason`` / degradation reason consumers report)."""
        return "; ".join(f"{r.rung}: {r.outcome}"
                         + (f" ({r.detail})" if r.detail else "")
                         for r in self.reports if r.outcome != "ok")


def run_ladder(rungs: list[tuple[str, Callable[[], Topology | None]]],
               validate: bool = True, atol: float = 1e-8) -> LadderResult:
    """Try ``rungs`` in order until one returns a topology that passes the
    release checklist. Classified failures (:class:`SolveFailure`), None
    returns, other exceptions and invariant violations are recorded in
    ``reports`` and the ladder moves on; a device fault
    (:data:`~repro_torch.device.DEVICE_FAULTS`) is re-raised.
    ``LadderResult.topology`` is None iff every rung failed — the caller
    decides the terminal fallback (keep the incumbent, reject the request,
    …)."""
    reports: list[RungReport] = []
    for k, (name, thunk) in enumerate(rungs):
        try:
            topo = thunk()
        except SolveFailure as sf:
            reports.append(RungReport(name, sf.outcome.value, sf.detail))
            continue
        except DEVICE_FAULTS:
            raise
        except Exception as exc:  # noqa: BLE001 — any solver failure → next rung
            reports.append(RungReport(name, f"error:{type(exc).__name__}",
                                      str(exc)))
            continue
        if topo is None:
            reports.append(RungReport(name, "none", "rung produced no topology"))
            continue
        if validate:
            bad = check_invariants(topo, atol=atol)
            if bad is not None:
                reports.append(RungReport(name, f"invalid:{bad}"))
                continue
        reports.append(RungReport(name, "ok"))
        return LadderResult(topology=topo, rung=name, attempts=k + 1,
                            reports=reports)
    return LadderResult(topology=None, rung=None, attempts=len(rungs),
                        reports=reports)


# =========================================================================
# Classic-topology fallback (the ladder's closed-form last rung)
# =========================================================================

def classic_fallback(n: int, r: int, cs: ConstraintSet | None = None,
                     polish_iters: int = 0) -> Topology:
    """Best feasible classic topology (ring / torus / hypercube), or an
    unconditional ring when none fits the budget/constraints.

    The feasible classics come from ``api._classic_candidates`` (same
    candidates the cold pipeline competes against) with Metropolis weights
    (optionally polished); ties break on r_asym. The terminal ring ignores
    ``r``/``cs`` — a valid connected topology that overshoots the budget
    beats no topology at all — and records that in ``meta["violates"]``.
    """
    from .api import _classic_candidates
    from .topologies import make_baseline
    from .weights import metropolis_weights, polish_weights

    edges_full = all_edges(n)
    best: Topology | None = None
    best_val = np.inf
    for base_name, sel in _classic_candidates(n, r, cs):
        edges = [edges_full[ln] for ln in np.nonzero(sel)[0]]
        g = metropolis_weights(n, edges)
        if polish_iters > 0:
            g = polish_weights(n, edges, g, iters=polish_iters)
        cand = Topology(n, edges, g, name=f"classic-{base_name}(n={n})",
                        meta={"connected": True, "classic": base_name})
        val = cand.r_asym()
        if val < best_val:
            best, best_val = cand, val
    if best is not None:
        best.meta["r_asym"] = best_val
        return best
    ring = make_baseline("ring", n)
    topo = Topology(n, ring.edges, metropolis_weights(n, ring.edges),
                    name=f"classic-ring(n={n})",
                    meta={"connected": True, "classic": "ring"})
    violates = []
    if len(ring.edges) > r:
        violates.append(f"edge budget r={r}")
    if cs is not None:
        sel = np.zeros(len(edges_full), dtype=bool)
        from .graph import edge_index
        eidx = edge_index(n)
        for e in ring.edges:
            sel[eidx[tuple(sorted(e))]] = True
        if not cs.feasible(sel):
            violates.append("constraint set")
    if violates:
        topo.meta["violates"] = ", ".join(violates)
    topo.meta["r_asym"] = topo.r_asym()
    return topo
