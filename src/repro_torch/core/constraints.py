"""Builders for the unified heterogeneous-bandwidth constraint (M, e) of Eq. (10).

Each scenario yields a ``ConstraintSet``:
  - ``M ∈ {0,1}^{q×|E|}`` maps logical edges to physical resources,
  - ``e_cap ∈ N^q`` per-resource edge capacities,
  - ``equality``: True → ``M z = e`` (node-level, where Algorithm 1 produced an
    exact degree allocation); False → ``M z ≤ e`` (link/port capacities),
  - ``edge_ok``: mask of logical edges that exist at all (e.g. BCube only
    allows one-hop pairs),
  - ``edge_bandwidth(sel)``: the per-edge available bandwidth given a selected
    edge set, used by the time model (§VI Eqs. 34–35).

Scenarios (§IV-B / §VI-A):
  1. node-level        — M = abs(A) (Eq. 16), e from Algorithm 1.
  2. intra-server tree — PIX/NODE/SYS tiers of a standard 8-GPU server
                         (Fig. 3), e = (1,1,1,1,4,4,16).
  3. BCube(p, k)       — per-port rows (Eq. 18–19), cap p−1 per port.
  4. pod-boundary      — our TPU adaptation: intra-pod ICI vs inter-pod DCI.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .graph import all_edges

__all__ = [
    "ConstraintSet",
    "node_level_constraints",
    "intra_server_constraints",
    "bcube_constraints",
    "pod_boundary_constraints",
    "INTRA_SERVER_CAPS",
]


@dataclass
class ConstraintSet:
    n: int
    M: np.ndarray  # (q, |E|) over the FULL candidate edge list all_edges(n)
    e_cap: np.ndarray  # (q,)
    equality: bool
    name: str
    edge_ok: np.ndarray  # (|E|,) bool — which logical edges are admissible
    resource_bw: np.ndarray  # (q,) bandwidth of each physical resource
    # maps a selected-edge boolean mask to per-edge available bandwidth:
    edge_bandwidth: Callable[[np.ndarray], np.ndarray] = field(repr=False, default=None)  # type: ignore

    @property
    def q(self) -> int:
        return self.M.shape[0]

    def feasible(self, z: np.ndarray) -> bool:
        """Check M z (= or ≤) e for a 0/1 selection vector z."""
        lhs = self.M @ z.astype(np.int64)
        if self.equality:
            return bool(np.all(lhs == self.e_cap))
        return bool(np.all(lhs <= self.e_cap))

    def usage(self, z: np.ndarray) -> np.ndarray:
        return self.M @ z.astype(np.int64)


def _endpoint_arrays(edges) -> tuple[np.ndarray, np.ndarray]:
    ei = np.fromiter((i for i, _ in edges), dtype=np.int64, count=len(edges))
    ej = np.fromiter((j for _, j in edges), dtype=np.int64, count=len(edges))
    return ei, ej


def node_level_constraints(n: int, e_per_node: np.ndarray, b: np.ndarray) -> ConstraintSet:
    """§IV-B1: q = n rows, M = abs(A) (Eq. 16), e from Algorithm 1."""
    edges = all_edges(n)
    m = len(edges)
    ei, ej = _endpoint_arrays(edges)
    M = np.zeros((n, m), dtype=np.int64)
    M[ei, np.arange(m)] = 1
    M[ej, np.arange(m)] = 1
    e_cap = np.asarray(e_per_node, dtype=np.int64)
    b = np.asarray(b, dtype=np.float64)

    def edge_bw(sel: np.ndarray) -> np.ndarray:
        deg = np.maximum(M @ sel.astype(np.int64), 1)
        out = np.minimum(b[ei] / deg[ei], b[ej] / deg[ej])
        return np.where(sel, out, np.inf)

    cs = ConstraintSet(
        n=n, M=M, e_cap=e_cap, equality=True, name="node-level",
        edge_ok=np.ones(m, dtype=bool), resource_bw=b,
    )
    cs.edge_bandwidth = edge_bw
    return cs


# (PIX1..4, NODE1, NODE2, SYS) caps from §VI-A3.
INTRA_SERVER_CAPS = np.array([1, 1, 1, 1, 4, 4, 16], dtype=np.int64)


def intra_server_constraints(
    n: int = 8,
    caps: np.ndarray = INTRA_SERVER_CAPS,
    b_pix: float = 4.88,
    b_node: float = 4.88,
    b_sys: float = 9.76,
) -> ConstraintSet:
    """§IV-B2 / §VI-A3: standard 8-GPU server tree (Fig. 3).

    GPU pairs {0,1},{2,3},{4,5},{6,7} sit under PIX switches 1..4; PIX1/2
    under NODE1 (socket 0), PIX3/4 under NODE2; sockets joined by SYS. A
    logical edge is *classified by the highest tier its path traverses*:
    intra-pair → PIXk, intra-socket cross-pair → NODEm, cross-socket → SYS.
    With e = (1,1,1,1,4,4,16) every class capacity equals the number of
    possible edges of that class, matching the paper's accounting (the
    exponential graph on n=8 maps exactly 10 edges onto SYS → min edge
    bandwidth 9.76/10 = 0.976 GB/s, reproducing §VI-A3).
    """
    if n != 8:
        raise ValueError("the paper's standard server architecture has 8 GPUs")
    edges = all_edges(n)
    m = len(edges)
    q = 7
    M = np.zeros((q, m), dtype=np.int64)

    def tier(i: int, j: int) -> int:
        if i // 2 == j // 2:
            return i // 2  # PIX row 0..3
        if i // 4 == j // 4:
            return 4 + i // 4  # NODE row 4..5
        return 6  # SYS

    edge_tier = np.array([tier(i, j) for i, j in edges], dtype=np.int64)
    M[edge_tier, np.arange(m)] = 1
    bw = np.array([b_pix] * 4 + [b_node] * 2 + [b_sys])

    def edge_bw(sel: np.ndarray) -> np.ndarray:
        load = np.maximum(M @ sel.astype(np.int64), 1)
        return np.where(sel, bw[edge_tier] / load[edge_tier], np.inf)

    cs = ConstraintSet(
        n=n, M=M, e_cap=np.asarray(caps, dtype=np.int64), equality=False,
        name="intra-server", edge_ok=np.ones(m, dtype=bool), resource_bw=bw,
    )
    cs.edge_bandwidth = edge_bw
    return cs


def bcube_constraints(p: int = 4, k: int = 2, layer_bw: tuple[float, ...] = (4.88, 9.76)) -> ConstraintSet:
    """§IV-B3 / §VI-A4: BCube(p, k) switch-port capacities.

    n = p^k servers, addressed by k base-p digits. Servers share a layer-l
    switch iff their addresses differ only in digit l; only such one-hop
    pairs are admissible logical edges. Each server has one port per layer;
    a layer-l edge consumes the layer-l port of both endpoints. Per-port
    capacity e_{s_l} = p − 1 (Fig. 5 discussion).
    """
    n = p**k
    edges = all_edges(n)
    m = len(edges)

    def digits(x: int) -> list[int]:
        return [(x // p**t) % p for t in range(k)]

    def shared_layer(i: int, j: int) -> int | None:
        di, dj = digits(i), digits(j)
        diff = [t for t in range(k) if di[t] != dj[t]]
        return diff[0] if len(diff) == 1 else None

    q = k * n  # port (layer l, server i) → row l*n + i
    M = np.zeros((q, m), dtype=np.int64)
    edge_ok = np.zeros(m, dtype=bool)
    edge_layer = np.full(m, -1, dtype=np.int64)
    for l, (i, j) in enumerate(edges):
        lay = shared_layer(i, j)
        if lay is None:
            continue
        edge_ok[l] = True
        edge_layer[l] = lay
        M[lay * n + i, l] = 1
        M[lay * n + j, l] = 1
    e_cap = np.full(q, p - 1, dtype=np.int64)
    bw = np.concatenate([np.full(n, layer_bw[lay]) for lay in range(k)])
    # an admissible layer-l edge {i, j} consumes ports l·n+i and l·n+j
    ei, ej = _endpoint_arrays(edges)
    lay0 = np.maximum(edge_layer, 0)  # sentinel −1 → row 0 (masked below)
    port_i = lay0 * n + ei
    port_j = lay0 * n + ej

    def edge_bw(sel: np.ndarray) -> np.ndarray:
        load = np.maximum(M @ sel.astype(np.int64), 1)
        out = np.minimum(bw[port_i] / load[port_i], bw[port_j] / load[port_j])
        return np.where(sel & edge_ok, out, np.inf)

    cs = ConstraintSet(
        n=n, M=M, e_cap=e_cap, equality=False, name=f"bcube(p={p},k={k})",
        edge_ok=edge_ok, resource_bw=bw,
    )
    cs.edge_bandwidth = edge_bw
    cs.edge_layer = edge_layer  # type: ignore[attr-defined]  # kept for tests
    return cs


def pod_boundary_constraints(
    n: int,
    pods: int = 2,
    ici_bw: float = 50.0,
    dci_bw: float = 25.0,
    ici_cap_per_node: int = 4,
    dci_cap_total: int = 8,
) -> ConstraintSet:
    """TPU adaptation (DESIGN.md §7): intra-pod ICI vs inter-pod DCI.

    Rows: one per node for intra-pod edge capacity (ICI ports), plus one
    aggregate row for edges crossing the pod boundary (DCI).
    """
    edges = all_edges(n)
    m = len(edges)
    per_pod = n // pods
    q = n + 1
    ei, ej = _endpoint_arrays(edges)
    intra = (ei // per_pod) == (ej // per_pod)
    M = np.zeros((q, m), dtype=np.int64)
    cols = np.arange(m)
    M[ei[intra], cols[intra]] = 1
    M[ej[intra], cols[intra]] = 1
    M[n, cols[~intra]] = 1
    e_cap = np.concatenate([np.full(n, ici_cap_per_node), [dci_cap_total]]).astype(np.int64)
    bw = np.concatenate([np.full(n, ici_bw), [dci_bw]])

    def edge_bw(sel: np.ndarray) -> np.ndarray:
        load = np.maximum(M @ sel.astype(np.int64), 1)
        out = np.where(
            intra,
            np.minimum(ici_bw / load[ei], ici_bw / load[ej]),
            dci_bw / load[n],
        )
        return np.where(sel, out, np.inf)

    cs = ConstraintSet(
        n=n, M=M, e_cap=e_cap, equality=False, name=f"pod-boundary(pods={pods})",
        edge_ok=np.ones(m, dtype=bool), resource_bw=bw,
    )
    cs.edge_bandwidth = edge_bw
    return cs
