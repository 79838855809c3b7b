"""Algorithm 1 — Bandwidth-Aware Edge-Capacity Allocation.

Given per-node available bandwidths b, a total edge budget r, and per-node
degree caps ē, determine per-node edge counts e that maximize the minimum
per-edge ("unit") bandwidth b_unit. Faithful to the paper's pseudocode
(Eqs. 12–14), including the final trim step (lines 6–8).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["AllocationResult", "allocate_edge_capacity", "is_graphical", "graphical_repair"]


def is_graphical(d: np.ndarray) -> bool:
    """Erdős–Gallai test: is d realizable as a simple undirected graph?"""
    d = np.sort(np.asarray(d, dtype=np.int64))[::-1]
    n = d.shape[0]
    if d.sum() % 2 == 1 or (n and d[0] > n - 1) or np.any(d < 0):
        return False
    pre = np.cumsum(d)
    for k in range(1, n + 1):
        rhs = k * (k - 1) + sum(min(int(di), k) for di in d[k:])
        if pre[k - 1] > rhs:
            return False
    return True


def graphical_repair(e: np.ndarray, e_bar: np.ndarray | None = None) -> np.ndarray:
    """Minimal repair of a degree sequence to a graphical one (Σ preserved when
    possible). Algorithm 1 maximizes bandwidth but does not guarantee
    realizability (e.g. [5,5,5,5,1,1,1,1] fails Erdős–Gallai); this moves one
    unit of degree at a time from the largest-degree node to the node with the
    most headroom until the sequence is graphical (beyond-paper robustness,
    DESIGN.md §6)."""
    e = np.asarray(e, dtype=np.int64).copy()
    n = e.shape[0]
    if e_bar is None:
        e_bar = np.full(n, n - 1, dtype=np.int64)
    for _ in range(int(e.sum()) + n):
        if is_graphical(e):
            return e
        hi = int(np.argmax(e))
        headroom = np.minimum(e_bar, n - 1) - e
        headroom[hi] = -1
        lo = int(np.argmax(headroom))
        if headroom[lo] > 0:
            e[hi] -= 1
            e[lo] += 1
        else:
            e[hi] -= 2  # keep parity, shrink the infeasible peak
            e[hi] = max(e[hi], 0)
    return e


@dataclass
class AllocationResult:
    b_unit: float
    e: np.ndarray  # per-node edge counts
    feasible: bool


def allocate_edge_capacity(
    b: np.ndarray,
    r: int,
    e_bar: np.ndarray | None = None,
    max_rounds: int = 10_000,
) -> AllocationResult:
    """Run Algorithm 1.

    Args:
        b: node bandwidths (b_1, …, b_n).
        r: total number of edges to allocate.
        e_bar: per-node caps ē (defaults to n−1 each).

    Returns:
        AllocationResult with unit bandwidth and per-node counts e summing to
        ≥ 2r before the trim, == 2r after (when feasible).
    """
    b = np.asarray(b, dtype=np.float64)
    n = b.shape[0]
    if e_bar is None:
        e_bar = np.full(n, n - 1, dtype=np.int64)
    e_bar = np.asarray(e_bar, dtype=np.int64)

    # Eq. (12): start from the weakest node's bandwidth as the unit.
    b_unit = float(b.min())
    e = np.minimum(np.floor(b / b_unit).astype(np.int64), e_bar)
    edge_count = int(e.sum()) // 2

    rounds = 0
    while edge_count < r and rounds < max_rounds:
        rounds += 1
        # Eq. (13): shrink the unit bandwidth just enough to admit one more
        # edge at the node where that is cheapest.
        b_unit_new = float(np.max(b / (e + 1)))
        if b_unit_new >= b_unit:
            # All nodes capped — cannot add more edges by shrinking b_unit.
            if np.all(e >= e_bar):
                break
            b_unit_new = np.nextafter(b_unit, 0.0)
        b_unit = b_unit_new
        e = np.minimum(np.floor(b / b_unit + 1e-12).astype(np.int64), e_bar)
        edge_count = int(e.sum()) // 2
        if np.all(e >= e_bar):
            edge_count = int(e.sum()) // 2
            break

    # Lines 6–8: trim the largest-degree nodes until Σe/2 == r.
    while int(e.sum()) // 2 > r:
        k = int(np.argmax(e))
        e[k] -= 1

    # Degree-sum parity / handshake feasibility guard: Σe must be even and
    # each node's count realizable (e_i ≤ Σ_{j≠i} min(e_j, 1)·… — we only
    # enforce the Erdős–Gallai-lite necessary checks used downstream).
    if int(e.sum()) % 2 == 1:
        k = int(np.argmax(e))
        e[k] -= 1

    feasible = int(e.sum()) // 2 >= min(r, int(e_bar.sum()) // 2) or int(e.sum()) // 2 == r
    return AllocationResult(b_unit=b_unit, e=e, feasible=bool(feasible))
