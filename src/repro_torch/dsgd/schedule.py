"""Gossip schedule: W → matching rounds (numpy; a copy of the reference's).

The undirected edge set is greedily edge-colored into *matching rounds* —
in each round every worker exchanges with at most one neighbour — and a
node's mixing weight for the copy it receives in round c is looked up from
a per-round (n,) weight table, so the weighted accumulation

    acc = W_ii · x_i + Σ_rounds  w_round[i] · recv_round(x)_i

reproduces x ← W x exactly (an unmatched node receives nothing and has
w_round[i] = 0). In the reference each round is one ``ppermute`` across
devices; the port uses the schedules on one device, for the round-robin
cycles of :mod:`repro_torch.dsgd.dynamic` and the per-sync byte counts.
The matching order is deterministic for a given edge list, and equal to
the reference's, so the cycle tensors are bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.graph import Topology, weight_matrix_from_weights

__all__ = ["GossipSchedule", "edge_color", "schedule_from_topology",
           "reconstruct_weight_matrix", "bytes_per_sync"]


@dataclass(frozen=True)
class GossipSchedule:
    """Static gossip plan (hashable)."""
    n: int
    # one entry per round: tuple of (src, dst) pairs — a symmetric matching
    perms: tuple[tuple[tuple[int, int], ...], ...]
    # per round, per node: weight applied to the received copy (0 if idle)
    recv_weights: tuple[tuple[float, ...], ...]
    self_weights: tuple[float, ...]          # diag(W)
    name: str = "gossip"

    @property
    def rounds(self) -> int:
        return len(self.perms)

    @property
    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n, dtype=np.int64)
        for perm in self.perms:
            for s, _ in perm:
                d[s] += 1
        return d


def _greedy_color(n: int, edges: list[tuple[int, int]],
                  order: list[int]) -> dict[int, int]:
    node_colors: list[set[int]] = [set() for _ in range(n)]
    color_of: dict[int, int] = {}
    for ei in order:
        i, j = edges[ei]
        c = 0
        while c in node_colors[i] or c in node_colors[j]:
            c += 1
        color_of[ei] = c
        node_colors[i].add(c)
        node_colors[j].add(c)
    return color_of


def edge_color(n: int, edges: list[tuple[int, int]],
               trials: int = 16) -> list[list[tuple[int, int]]]:
    """Proper edge coloring → list of matchings (= gossip rounds).

    Each round costs one full collective-permute of the params shard, so the
    color count is the gossip critical path: Δ ≤ χ′ ≤ Δ+1 (Vizing). Greedy
    can use up to 2Δ−1; we take the best of several greedy orders (degree-sum
    first + random restarts), which empirically reaches Δ or Δ+1 on the
    BA-Topo/exponential graphs used here. Deterministic for a given edge
    list — the round-robin cycle tensor (dynamic.py) and the per-matching
    bandwidth model (benchmarks) rely on getting the SAME matching order.
    """
    m = len(edges)
    deg = np.zeros(n, dtype=np.int64)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    orders = [sorted(range(m),
                     key=lambda ei: -(deg[edges[ei][0]] + deg[edges[ei][1]]))]
    rng = np.random.default_rng(0)
    for _ in range(max(trials - 1, 0)):
        orders.append(list(rng.permutation(m)))
    best: dict[int, int] | None = None
    for order in orders:
        cand = _greedy_color(n, edges, order)
        if best is None or max(cand.values(), default=-1) < max(best.values(), default=-1):
            best = cand
        if best and len(edges) and max(best.values()) + 1 == deg.max():
            break  # Δ rounds — optimal
    ncolors = 1 + max(best.values()) if best else 0
    matchings: list[list[tuple[int, int]]] = [[] for _ in range(ncolors)]
    for ei, c in best.items():
        matchings[c].append(edges[ei])
    return matchings


def schedule_from_topology(topo: Topology) -> GossipSchedule:
    """Compile a Topology (graph + weights g) into a matching-round schedule."""
    n = topo.n
    W = weight_matrix_from_weights(n, topo.edges, topo.g)
    matchings = edge_color(n, list(topo.edges))
    perms, recv = [], []
    for matching in matchings:
        pairs: list[tuple[int, int]] = []
        w_round = np.zeros(n)
        for i, j in matching:
            pairs.extend([(i, j), (j, i)])
            w_round[j] = W[j, i]   # j receives x_i
            w_round[i] = W[i, j]
        perms.append(tuple(sorted(pairs)))
        recv.append(tuple(float(v) for v in w_round))
    return GossipSchedule(
        n=n,
        perms=tuple(perms),
        recv_weights=tuple(recv),
        self_weights=tuple(float(W[i, i]) for i in range(n)),
        name=f"gossip[{topo.name}]",
    )


def reconstruct_weight_matrix(sched: GossipSchedule) -> np.ndarray:
    """Invert the schedule back to W — the validation oracle for the
    decomposition (tests assert allclose against the source Topology's W)."""
    n = sched.n
    W = np.diag(np.asarray(sched.self_weights))
    for perm, wr in zip(sched.perms, sched.recv_weights):
        for s, d in perm:
            W[d, s] += wr[d]
    return W


def bytes_per_sync(sched: GossipSchedule, param_bytes: int) -> dict:
    """Collective traffic of one gossip sync (per the roofline's collective
    term). All-reduce reference: ring all-reduce moves 2·(n−1)/n·|params|."""
    deg = sched.degrees
    return {
        "per_worker_max": int(deg.max()) * param_bytes,
        "per_worker_mean": float(deg.mean()) * param_bytes,
        "total": int(deg.sum()) * param_bytes,
        "allreduce_per_worker": 2 * (sched.n - 1) / sched.n * param_bytes,
        "rounds": sched.rounds,
    }
