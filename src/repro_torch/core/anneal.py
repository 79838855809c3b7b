"""Simulated-annealing warm start (§VI): construct an initial topology with
small average shortest path length (ASPL), optionally honoring a per-node
degree sequence and a heterogeneous ConstraintSet.

The paper notes the ADMM problem is initialization-sensitive and warm-starts
from an SA-optimized low-ASPL graph [40, 41]. Moves are degree-preserving
2-swaps ({a,b},{c,d} → {a,c},{b,d}), so a feasible degree sequence stays
feasible; constraint feasibility (M z ≤/= e) is re-checked per move.
"""
from __future__ import annotations

import math

import numpy as np

from .constraints import ConstraintSet
from .graph import all_edges, aspl, edge_index, is_connected

__all__ = ["greedy_degree_graph", "anneal_topology"]


def greedy_degree_graph(
    n: int,
    deg_target: np.ndarray,
    rng: np.random.Generator,
    cs: ConstraintSet | None = None,
    tries: int = 256,
) -> list[tuple[int, int]]:
    """Havel–Hakimi-style randomized construction of a connected graph whose
    degree sequence matches ``deg_target`` and which satisfies ``cs`` if given.
    """
    eidx = edge_index(n)
    edges_full = all_edges(n)
    m = len(edges_full)
    ok = cs.edge_ok if cs is not None else np.ones(m, dtype=bool)

    for _ in range(tries):
        residual = np.asarray(deg_target, dtype=np.int64).copy()
        z = np.zeros(m, dtype=bool)
        usage = np.zeros(cs.q, dtype=np.int64) if cs is not None else None
        failed = False
        order = list(range(n))
        while residual.sum() > 0:
            rng.shuffle(order)
            i = max(order, key=lambda u: residual[u])
            if residual[i] <= 0:
                break
            # candidate partners: positive residual, edge admissible & unused
            cands = []
            for j in order:
                if j == i or residual[j] <= 0:
                    continue
                l = eidx[(min(i, j), max(i, j))]
                if z[l] or not ok[l]:
                    continue
                if cs is not None:
                    col = cs.M[:, l]
                    if np.any(usage + col > cs.e_cap):
                        continue
                cands.append((j, l))
            if not cands:
                failed = True
                break
            # prefer the highest-residual partner (classic Havel–Hakimi)
            cands.sort(key=lambda t: -residual[t[0]])
            take = cands[0] if rng.random() < 0.7 else cands[rng.integers(len(cands))]
            j, l = take
            z[l] = True
            residual[i] -= 1
            residual[j] -= 1
            if cs is not None:
                usage += cs.M[:, l]
        if failed:
            continue
        edges = [edges_full[l] for l in np.nonzero(z)[0]]
        if is_connected(n, edges):
            return edges
    raise RuntimeError(f"could not realize degree sequence {deg_target} under constraints")


def anneal_topology(
    n: int,
    edges0: list[tuple[int, int]],
    cs: ConstraintSet | None = None,
    iters: int = 2000,
    T0: float = 0.5,
    seed: int = 0,
) -> list[tuple[int, int]]:
    """SA over degree-preserving 2-swaps, minimizing ASPL. Returns best edges."""
    rng = np.random.default_rng(seed)
    eidx = edge_index(n)
    edges_full = all_edges(n)
    m = len(edges_full)
    ok = cs.edge_ok if cs is not None else np.ones(m, dtype=bool)

    cur = sorted(edges0)
    cur_set = set(cur)
    cur_cost = aspl(n, cur)
    best, best_cost = list(cur), cur_cost

    # Capacity usage M z is maintained incrementally per accepted move (like
    # ``repair_selection`` does with ``usage``) instead of rebuilding the
    # O(m) selection mask from scratch for every candidate move.
    usage = None
    if cs is not None:
        z = np.zeros(m, dtype=np.int64)
        for e in cur:
            z[eidx[e]] = 1
        usage = cs.M @ z

    for t in range(iters):
        if len(cur) < 2:
            break
        T = T0 * math.exp(-3.0 * t / max(iters, 1))
        a_i = rng.integers(len(cur))
        b_i = rng.integers(len(cur))
        if a_i == b_i:
            continue
        (a, b), (c, d) = cur[a_i], cur[b_i]
        # two rewiring options preserve degrees
        opts = [((a, c), (b, d)), ((a, d), (b, c))]
        rng.shuffle(opts)
        for (p1, p2) in opts:
            p1 = (min(p1), max(p1))
            p2 = (min(p2), max(p2))
            if p1[0] == p1[1] or p2[0] == p2[1]:
                continue
            if p1 in cur_set or p2 in cur_set or p1 == p2:
                continue
            if not (ok[eidx[p1]] and ok[eidx[p2]]):
                continue
            new_usage = None
            if cs is not None:
                new_usage = (usage - cs.M[:, eidx[(a, b)]] - cs.M[:, eidx[(c, d)]]
                             + cs.M[:, eidx[p1]] + cs.M[:, eidx[p2]])
                feasible = (np.all(new_usage == cs.e_cap) if cs.equality
                            else np.all(new_usage <= cs.e_cap))
                if not feasible:
                    continue
            new = [e for k, e in enumerate(cur) if k not in (a_i, b_i)] + [p1, p2]
            if not is_connected(n, new):
                continue
            new_cost = aspl(n, new)
            if new_cost <= cur_cost or rng.random() < math.exp(-(new_cost - cur_cost) / max(T, 1e-9)):
                cur = sorted(new)
                cur_set = set(cur)
                cur_cost = new_cost
                usage = new_usage
                if cur_cost < best_cost:
                    best, best_cost = list(cur), cur_cost
            break
    return sorted(best)
