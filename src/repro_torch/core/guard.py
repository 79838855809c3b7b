"""Solver guard layer: outcome classification, release invariants and the
classic fallback (DESIGN.md §15), in the port.

A copy of the host-side (numpy) half of ``repro.core.guard``, kept so that
the port never imports the JAX package:

  * :class:`SolveOutcome` — the structured verdict on one ADMM attempt;
  * :func:`check_invariants` / :func:`validate_topology` — the release
    checklist (finite W, symmetry, row-stochasticity, connectivity) and
    :class:`TopologyInvariantError`;
  * :func:`classify_result` — converged / non_convergent / non_finite;
  * :func:`classic_fallback` — the closed-form last resort.

The retry ladder (``attempt_admm``, ``jittered_warm_rungs``,
``run_ladder``, ``round_result``) is not ported yet (ROADMAP.md Queue 1
item 3).
"""
from __future__ import annotations

import enum

import numpy as np

from .constraints import ConstraintSet
from .graph import Topology, all_edges, is_connected

__all__ = [
    "SolveOutcome", "TopologyInvariantError", "check_invariants",
    "validate_topology", "classify_result", "classic_fallback",
]


class SolveOutcome(str, enum.Enum):
    """Structured verdict on one ADMM solve + rounding attempt."""

    CONVERGED = "converged"
    NON_CONVERGENT = "non_convergent"
    NON_FINITE = "non_finite"
    DISCONNECTED_ROUNDING = "disconnected_rounding"


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
# Outcome classification
# =========================================================================

def classify_result(res, max_residual: float = 1.0) -> SolveOutcome:
    """Classify a raw :class:`~repro_torch.core.engine.ADMMResult` (pre-rounding).

    ``non_finite`` — the residual or any returned iterate entry is NaN/Inf
    (the engine's early-abort leaves the poisoned residual in place exactly
    so this check sees it); ``non_convergent`` — finite but above
    ``max_residual``; else ``converged``. ``disconnected_rounding`` is
    assigned later, by the rounding step's callers, because it is a
    property of the rounded support, not of the solve.
    """
    vals = [np.asarray(res.residual), np.asarray(res.g), np.asarray(res.g_raw)]
    if res.z is not None:
        vals.append(np.asarray(res.z))
    if not all(np.all(np.isfinite(v)) for v in vals):
        return SolveOutcome.NON_FINITE
    if float(res.residual) > max_residual:
        return SolveOutcome.NON_CONVERGENT
    return SolveOutcome.CONVERGED


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
