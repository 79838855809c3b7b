"""Benchmark topologies from the paper's experiment section (§VI).

ring, 2D grid, 2D torus [17], hypercube [18], (static) exponential [16],
U-EquiStatic (EquiTopo) [19], and uniform-random graphs [20, 21].

Weight assignment for the undirected baselines follows the degree-based
convention the paper attributes to [17]: we use Metropolis–Hastings weights
(symmetric, doubly stochastic, nonnegative) unless a topology defines its own
canonical weights (exponential, hypercube, EquiTopo use uniform 1/(d+1)).
"""
from __future__ import annotations

import math

import numpy as np

from .graph import Topology, all_edges, r_asym
from .weights import metropolis_weights, uniform_neighbor_weights

__all__ = [
    "ring",
    "grid2d",
    "torus2d",
    "hypercube",
    "exponential",
    "u_equistatic",
    "random_graph",
    "BASELINES",
    "make_baseline",
]


def ring(n: int) -> Topology:
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges = [(min(a, b), max(a, b)) for a, b in edges]
    edges = sorted(set(edges))
    g = metropolis_weights(n, edges)
    return Topology(n, edges, g, name=f"ring(n={n})")


def _grid_edges(rows: int, cols: int, wrap: bool) -> list[tuple[int, int]]:
    def nid(r, c):
        return r * cols + c

    edges = set()
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.add((nid(r, c), nid(r, c + 1)))
            elif wrap and cols > 2:
                edges.add(tuple(sorted((nid(r, c), nid(r, 0)))))
            if r + 1 < rows:
                edges.add((nid(r, c), nid(r + 1, c)))
            elif wrap and rows > 2:
                edges.add(tuple(sorted((nid(r, c), nid(0, c)))))
    return sorted(edges)


def _factor_near_square(n: int) -> tuple[int, int]:
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def grid2d(n: int) -> Topology:
    rows, cols = _factor_near_square(n)
    edges = _grid_edges(rows, cols, wrap=False)
    g = metropolis_weights(n, edges)
    return Topology(n, edges, g, name=f"2d-grid(n={n},{rows}x{cols})")


def torus2d(n: int) -> Topology:
    rows, cols = _factor_near_square(n)
    edges = _grid_edges(rows, cols, wrap=True)
    g = metropolis_weights(n, edges)
    return Topology(n, edges, g, name=f"2d-torus(n={n},{rows}x{cols})")


def hypercube(n: int) -> Topology:
    k = int(round(math.log2(n)))
    if 2**k != n:
        raise ValueError(f"hypercube requires n to be a power of 2, got {n}")
    edges = sorted({(min(i, i ^ (1 << b)), max(i, i ^ (1 << b))) for i in range(n) for b in range(k)})
    g = uniform_neighbor_weights(n, edges)
    return Topology(n, edges, g, name=f"hypercube(n={n})")


def exponential(n: int) -> Topology:
    """Static exponential graph [16]: i → (i + 2^k) mod n, k = 0..⌈log2 n⌉−1.

    Directed but circulant, hence doubly stochastic with uniform weights
    1/(⌈log2 n⌉ + 1). W is stored as an override; ``edges`` hold the
    undirected support (used for degree/bandwidth accounting — the paper
    counts its degree sum as 2·n·⌈log2 n⌉ worth of directed links, i.e.
    out-degree = in-degree = ⌈log2 n⌉).
    """
    tau = max(1, math.ceil(math.log2(n)))
    hops = [2**k for k in range(tau)]
    W = np.zeros((n, n))
    coef = 1.0 / (tau + 1)
    W += np.eye(n) * coef
    for h in hops:
        for i in range(n):
            W[i, (i + h) % n] += coef
    edges = sorted({tuple(sorted((i, (i + h) % n))) for h in hops for i in range(n) if (i + h) % n != i})
    g = np.zeros(len(edges))
    t = Topology(n, edges, g, name=f"exponential(n={n})")
    t.meta["W_override"] = W
    t.meta["directed"] = True
    t.meta["out_degree"] = tau
    return t


def u_equistatic(n: int, M: int, seed: int = 0, trials: int = 64) -> Topology:
    """U-EquiStatic [19]: average of M symmetrized cyclic-shift basis graphs.

    W = (I + Σ_k (P^{s_k} + P^{−s_k})/2) / (M + 1) with distinct random shifts
    s_k ∈ {1,…,n−1}. Degree = 2M per node (or 2M−1 when a shift is n/2),
    edges ≈ n·M. EquiTopo samples shifts randomly; we draw ``trials`` samples
    and keep the best r_asym — same spirit, slightly stronger baseline.
    """
    rng = np.random.default_rng(seed)
    best: Topology | None = None
    best_r = np.inf
    for _ in range(trials):
        avail = list(range(1, n))
        shifts = list(rng.choice(avail, size=min(M, len(avail)), replace=False))
        W = np.eye(n)
        for s in shifts:
            P = np.zeros((n, n))
            for i in range(n):
                P[i, (i + s) % n] = 1.0
            W = W + (P + P.T) / 2.0
        W /= M + 1
        edges = sorted({tuple(sorted((i, (i + s) % n))) for s in shifts for i in range(n) if (i + s) % n != i})
        val = r_asym(W)
        if val < best_r:
            best_r = val
            t = Topology(n, edges, np.zeros(len(edges)), name=f"u-equistatic(n={n},M={M})")
            t.meta["W_override"] = W
            t.meta["shifts"] = shifts
            best = t
    assert best is not None
    return best


def random_graph(n: int, r: int, seed: int = 0) -> Topology:
    """Uniform random connected graph with r edges, Metropolis weights [20, 21]."""
    rng = np.random.default_rng(seed)
    cand = all_edges(n)
    for _ in range(512):
        sel = sorted(rng.choice(len(cand), size=r, replace=False).tolist())
        edges = [cand[k] for k in sel]
        from .graph import is_connected

        if is_connected(n, edges):
            g = metropolis_weights(n, edges)
            return Topology(n, edges, g, name=f"random(n={n},r={r})")
    raise RuntimeError(f"could not sample a connected random graph n={n}, r={r}")


BASELINES = ("ring", "grid", "torus", "hypercube", "exponential", "equistatic")


def make_baseline(kind: str, n: int, **kw) -> Topology:
    if kind == "ring":
        return ring(n)
    if kind == "grid":
        return grid2d(n)
    if kind == "torus":
        return torus2d(n)
    if kind == "hypercube":
        return hypercube(n)
    if kind == "exponential":
        return exponential(n)
    if kind == "equistatic":
        M = kw.pop("M", max(1, round(math.ceil(math.log2(n)) / 2)))
        return u_equistatic(n, M, **kw)
    if kind == "random":
        return random_graph(n, **kw)
    raise ValueError(f"unknown baseline topology: {kind}")
