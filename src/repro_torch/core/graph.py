"""Graph primitives for parameter-synchronization topologies.

Implements the notation of §III of the paper: undirected graphs G(N, E) with
edge-weight vector ``g``, incidence matrix ``A`` (Eq. 6), Laplacian
``L = A Diag(g) Aᵀ`` (Eq. 5), weight matrix ``W = I − L`` and the asymptotic
convergence factor ``r_asym(W) = max{|λ₂(W)|, |λₙ(W)|}`` (Eq. 3).

All constructors here are host-side (numpy); the ADMM solver consumes the
edge index arrays and runs in PyTorch. A copy of ``repro.core.graph``, kept
so that the port never imports the JAX package.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "all_edges",
    "edge_index",
    "incidence_matrix",
    "laplacian_from_weights",
    "weight_matrix_from_weights",
    "r_asym",
    "r_asym_fast",
    "FAST_SPECTRAL_MIN_N",
    "spectral_gap",
    "degrees",
    "adjacency",
    "aspl",
    "is_connected",
    "Topology",
]

# Above this node count, ``Topology.r_asym`` (and the polish objective check)
# use the Lanczos largest-magnitude path; below it, full ``eigvalsh`` is
# faster (LAPACK's constant is tiny at small n — measured crossover is
# between n=128 and n=256 on CPU). The Lanczos path falls back to the
# exact one whenever ARPACK does not certify convergence.
FAST_SPECTRAL_MIN_N = 192


def all_edges(n: int) -> list[tuple[int, int]]:
    """Every candidate undirected edge {i, j}, i < j. |E| = n(n−1)/2."""
    return list(itertools.combinations(range(n), 2))


def edge_index(n: int) -> dict[tuple[int, int], int]:
    """Map (i, j) with i < j to its column index in the incidence matrix."""
    return {e: l for l, e in enumerate(all_edges(n))}


def incidence_matrix(n: int, edges: list[tuple[int, int]] | None = None) -> np.ndarray:
    """Signed incidence matrix A ∈ R^{n×m} (Eq. 6).

    For undirected graphs the arbitrary orientation (i→j for i<j) yields the
    same Laplacian.
    """
    if edges is None:
        edges = all_edges(n)
    A = np.zeros((n, len(edges)))
    for l, (i, j) in enumerate(edges):
        A[i, l] = 1.0
        A[j, l] = -1.0
    return A


def laplacian_from_weights(n: int, edges: list[tuple[int, int]], g: np.ndarray) -> np.ndarray:
    """L = A Diag(g) Aᵀ (Eq. 5) without materializing A."""
    L = np.zeros((n, n))
    for l, (i, j) in enumerate(edges):
        w = g[l]
        L[i, i] += w
        L[j, j] += w
        L[i, j] -= w
        L[j, i] -= w
    return L


def weight_matrix_from_weights(n: int, edges: list[tuple[int, int]], g: np.ndarray) -> np.ndarray:
    """W = I − L. Symmetric & doubly stochastic by construction (§IV-A)."""
    return np.eye(n) - laplacian_from_weights(n, edges, g)


def _is_doubly_stochastic(W: np.ndarray, atol: float = 1e-9) -> bool:
    """Row sums == 1 (for symmetric W that implies column sums too)."""
    return bool(np.allclose(W.sum(axis=1), 1.0, atol=atol))


def r_asym(W: np.ndarray, symmetric: bool | None = None) -> float:
    """Asymptotic convergence factor (Eq. 3): spectral radius of W − 11ᵀ/n.

    Works for non-symmetric (e.g. directed exponential) matrices too.

    ``symmetric`` is a caller hint that skips the O(n²) ``W == Wᵀ`` scan
    (callers that build W from ``laplacian_from_weights`` know it is
    symmetric). For symmetric doubly stochastic W the all-ones eigenpair
    (eigenvalue 1) is deflated *implicitly*: the spectrum of W − 11ᵀ/n is
    spec(W) with one copy of that eigenvalue replaced by 0, so we drop it
    from ``eigvalsh(W)`` instead of materializing the dense rank-1 shift.
    """
    n = W.shape[0]
    if n <= 1:
        return 0.0
    if symmetric is None:
        symmetric = bool(np.allclose(W, W.T, atol=1e-12))
    if symmetric:
        if _is_doubly_stochastic(W):
            ev = np.linalg.eigvalsh(W)
            k = int(np.argmin(np.abs(ev - 1.0)))
            ev = np.delete(ev, k)
            # the deflated eigenvalue becomes 0, which never wins the max
            return float(np.max(np.abs(ev), initial=0.0))
        ev = np.linalg.eigvalsh(W - 1.0 / n)  # scalar broadcast, no ones((n,n))
        return float(np.max(np.abs(ev)))
    ev = np.linalg.eigvals(W - 1.0 / n)
    return float(np.max(np.abs(ev)))


def r_asym_fast(W: np.ndarray, symmetric: bool | None = None,
                tol: float = 1e-10) -> float:
    """``r_asym`` via a Lanczos largest-magnitude eigenpair of M = W − 11ᵀ/n.

    Matvec-only: M v = W v − (Σv)/n · 1 — the rank-1 deflation is never
    materialized (and W is applied as a sparse CSR operator: mixing
    matrices have O(r) nonzeros, so each matvec is O(n + r) instead of
    n²). r_asym(W) is *exactly* the largest-magnitude eigenvalue of M:
    for symmetric doubly stochastic W, spec(M) is spec(W) with the
    all-ones eigenvalue replaced by 0, and 0 never wins the magnitude
    max. One ``which='LM'`` Lanczos pair (ARPACK) therefore suffices —
    much cheaper than resolving both spectrum ends separately.

    Falls back to the exact ``eigvalsh`` path whenever W is not symmetric
    doubly stochastic or ARPACK fails to converge to ``tol`` — callers
    get r_asym-parity to ~``tol`` unconditionally.
    """
    n = W.shape[0]
    if n <= 3:
        return r_asym(W, symmetric)
    if symmetric is None:
        symmetric = bool(np.allclose(W, W.T, atol=1e-12))
    if not symmetric or not _is_doubly_stochastic(W):
        return r_asym(W, symmetric)
    try:
        import scipy.sparse as sp
        from scipy.sparse.linalg import ArpackError, LinearOperator, eigsh
    except ImportError:
        return r_asym(W, True)
    Ws = sp.csr_matrix(W)
    op = LinearOperator((n, n), matvec=lambda v: Ws @ v - v.sum() / n,
                        dtype=np.float64)
    try:
        ev = eigsh(op, k=1, which="LM", tol=tol, return_eigenvectors=False)
    except ArpackError:
        # non-convergence (incl. ArpackNoConvergence): exact parity oracle.
        # Deliberately narrow — any other exception is a real bug and raises.
        return r_asym(W, True)
    return float(abs(ev[0]))


def spectral_gap(W: np.ndarray) -> float:
    return 1.0 - r_asym(W)


def degrees(n: int, edges: list[tuple[int, int]]) -> np.ndarray:
    d = np.zeros(n, dtype=np.int64)
    for i, j in edges:
        d[i] += 1
        d[j] += 1
    return d


def adjacency(n: int, edges: list[tuple[int, int]]) -> np.ndarray:
    Adj = np.zeros((n, n), dtype=bool)
    for i, j in edges:
        Adj[i, j] = Adj[j, i] = True
    return Adj


def _bfs_dists(adj_lists: list[list[int]], src: int) -> np.ndarray:
    n = len(adj_lists)
    dist = np.full(n, -1, dtype=np.int64)
    dist[src] = 0
    frontier = [src]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in adj_lists[u]:
                if dist[v] < 0:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def _adj_lists(n: int, edges: list[tuple[int, int]]) -> list[list[int]]:
    al: list[list[int]] = [[] for _ in range(n)]
    for i, j in edges:
        al[i].append(j)
        al[j].append(i)
    return al


def aspl(n: int, edges: list[tuple[int, int]]) -> float:
    """Average shortest path length; +inf if disconnected.

    Used by the simulated-annealing warm start (§VI: small ASPL correlates
    with low communication delay [41]).
    """
    al = _adj_lists(n, edges)
    total = 0
    for s in range(n):
        dist = _bfs_dists(al, s)
        if np.any(dist < 0):
            return float("inf")
        total += int(dist.sum())
    return total / (n * (n - 1))


def is_connected(n: int, edges: list[tuple[int, int]]) -> bool:
    if n == 1:
        return True
    al = _adj_lists(n, edges)
    return bool(np.all(_bfs_dists(al, 0) >= 0))


@dataclass
class Topology:
    """A concrete parameter-synchronization topology: graph + weight matrix.

    ``edges`` lists the selected undirected edges; ``g`` their weights
    (aligned with ``edges``); ``W`` the full mixing matrix; ``name`` for
    reporting; ``directed_W`` may override W for directed baselines
    (exponential graph) — consensus simulation and r_asym use ``W``.
    """

    n: int
    edges: list[tuple[int, int]]
    g: np.ndarray
    name: str = "topology"
    meta: dict = field(default_factory=dict)

    @property
    def W(self) -> np.ndarray:
        if "W_override" in self.meta:
            return self.meta["W_override"]
        return weight_matrix_from_weights(self.n, self.edges, self.g)

    @property
    def r(self) -> int:
        return len(self.edges)

    @property
    def deg(self) -> np.ndarray:
        return degrees(self.n, self.edges)

    @property
    def max_degree(self) -> int:
        return int(self.deg.max()) if self.edges else 0

    def r_asym(self) -> float:
        W = self.W
        # W built from laplacian_from_weights is symmetric by construction;
        # a directed override (exponential graph) must take the general path.
        sym = None if "W_override" in self.meta else True
        if self.n >= FAST_SPECTRAL_MIN_N:
            return r_asym_fast(W, symmetric=sym)
        return r_asym(W, symmetric=sym)

    def validate(self, atol: float = 1e-8) -> None:
        W = self.W
        n = self.n
        assert W.shape == (n, n)
        ones = np.ones(n)
        np.testing.assert_allclose(W @ ones, ones, atol=atol)
        np.testing.assert_allclose(ones @ W, ones, atol=atol)
        assert is_connected(n, self.edges) or "W_override" in self.meta, "topology must be connected"
        assert r_asym(W) < 1.0 - 1e-9, "W must contract toward consensus"
