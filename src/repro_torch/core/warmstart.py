"""Simulated-annealing warm start (§VI) on the device, restarts batched.

The port of ``repro.core.warmstart``. State is the adjacency matrix plus a
fixed-size endpoint array per restart (a degree-preserving 2-swap never
changes the edge count), with the restart axis explicit: (B, n, n) and
(B, E, 2). ASPL and connectivity come together from the matmul-BFS of
:func:`_aspl_total`, whose every hop is the ``hop_bfs`` kernel on the card
(``sa_kernel``/``use_kernel`` True, the port's default; the reference's is
False) and its plain version on the CPU.

Randomness: ``jax.random`` streams cannot be reproduced, so each restart
draws its per-move randoms (a_i, b_i, flip, u) up front, as tensors of
length ``iters``, from a ``torch.Generator`` seeded with the restart's seed.
The temperature follows the total ``iters``, so the stream driver visits the
same (randoms, temperature) sequence as the one-shot driver and is bit-equal
to it at exhaustion. Like the reference (``warmstart.py:134-140``), a
disconnecting option A rejects the move instead of falling through to B.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.hop_bfs import ops as _hop_ops
from .constraints import ConstraintSet
from .graph import all_edges, edge_index

__all__ = ["aspl_matmul", "anneal_topology_batched", "anneal_topology_stream"]

#: BFS hops between two host reads of the "still growing" flag.
BFS_CHECK_EVERY = 2


def _packed_index(n: int, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Packed index of edge {i, j} in ``all_edges(n)`` order."""
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    return lo * n - (lo * (lo + 1)) // 2 + (hi - lo - 1)


def _hop(reach: torch.Tensor, adj: torch.Tensor, use_kernel: bool):
    if use_kernel:
        return _hop_ops.hop_step(reach, adj)
    return _hop_ops.hop_step_plain(reach, adj)


def _aspl_total(adj: torch.Tensor, use_kernel: bool):
    """All-sources BFS by reach expansion for (B, n, n) bool adjacency.
    Returns ``(total, connected)``: total = Σ_{s≠t} dist(s, t) as int64
    (exact) and connected a bool, both (B,). A restart stops expanding once
    its reach matrix is full or stops growing (frozen by ``torch.where``);
    the host reads whether any restart is still expanding every
    ``BFS_CHECK_EVERY`` hops."""
    B, n = int(adj.shape[0]), int(adj.shape[1])
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    reach = (eye | adj).contiguous()
    cnt = reach.sum(dim=(1, 2))
    total = cnt - n                    # distance-1 pairs count 1 each
    k = torch.ones(B, dtype=torch.int64, device=adj.device)
    grew = cnt > n
    hops = 0
    while True:
        active = (cnt < n * n) & grew & (k < n)
        if hops % BFS_CHECK_EVERY == 0 and not bool(active.any()):
            break
        new_reach, rows = _hop(reach, adj, use_kernel)
        new_cnt = rows.sum(dim=1, dtype=torch.int64)
        newly = new_cnt - cnt          # pairs first reached at distance k+1
        total = torch.where(active, total + (k + 1) * newly, total)
        reach = torch.where(active[:, None, None], new_reach, reach)
        cnt = torch.where(active, new_cnt, cnt)
        grew = torch.where(active, newly > 0, grew)
        k = torch.where(active, k + 1, k)
        hops += 1
    return total, cnt == n * n


def _aspl_cost(adj: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """SA move cost per restart: ASPL as float64, +inf if disconnected."""
    n = int(adj.shape[1])
    total, connected = _aspl_total(adj, use_kernel)
    return torch.where(connected, total.to(torch.float64) / (n * (n - 1)), math.inf)


def aspl_matmul(adj, use_kernel: bool = True, device: str = "cuda") -> float:
    """Average shortest path length of one boolean adjacency matrix; +inf if
    disconnected. Bit-identical to ``graph.aspl``: the hop total is an exact
    integer on the device and the one division happens on the host."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(adj, dtype=bool), device=dev)[None].contiguous()
    n = int(a.shape[1])
    total, connected = _aspl_total(a, use_kernel)
    if not bool(connected[0]):
        return float("inf")
    return int(total[0]) / (n * (n - 1))


class _SABatch:
    """Device tensors of one batched SA run: the carry and the per-move
    randoms, plus the constraint data the moves check."""

    def __init__(self, n, edges0, cs, iters, T0, seeds, use_kernel, dev):
        B, E = len(edges0), len(edges0[0])
        self.n, self.E, self.iters, self.T0 = n, E, iters, float(T0)
        self.use_kernel = use_kernel
        adj0 = np.zeros((B, n, n), dtype=bool)
        eps0 = np.zeros((B, E, 2), dtype=np.int64)
        for k, edges in enumerate(edges0):
            for l, (i, j) in enumerate(edges):
                i, j = (i, j) if i < j else (j, i)
                adj0[k, i, j] = adj0[k, j, i] = True
                eps0[k, l] = (i, j)
        m = len(all_edges(n))
        okm = np.zeros((n, n), dtype=bool)
        okm[np.triu_indices(n, 1)] = (np.ones(m, dtype=bool) if cs is None
                                      else np.asarray(cs.edge_ok, dtype=bool))
        okm |= okm.T
        self.has_cs = cs is not None
        if self.has_cs:
            M = np.asarray(cs.M, dtype=np.int64)
            eidx = edge_index(n)
            usage0 = np.zeros((B, cs.q), dtype=np.int64)
            for k, edges in enumerate(edges0):
                z = np.zeros(m, dtype=np.int64)
                for e in edges:
                    z[eidx[tuple(sorted(e))]] = 1
                usage0[k] = M @ z
            self.MT = torch.as_tensor(M.T.copy(), device=dev)          # (m, q)
            self.e_cap = torch.as_tensor(np.asarray(cs.e_cap, dtype=np.int64), device=dev)
            self.equality = bool(cs.equality)
        else:
            usage0 = np.zeros((B, 0), dtype=np.int64)
        self.okm = torch.as_tensor(okm, device=dev)
        self.adj = torch.as_tensor(adj0, device=dev)
        self.eps = torch.as_tensor(eps0, device=dev)
        self.usage = torch.as_tensor(usage0, device=dev)
        self.cur = _aspl_cost(self.adj, use_kernel)
        self.best_eps, self.best_cost = self.eps, self.cur
        # per-restart move randoms, drawn up front from the restart's seed
        draws = [self._draw(s) for s in seeds]
        self.ai, self.bi, self.flip, self.u = (
            torch.stack([d[f] for d in draws]).to(dev) for f in range(4))
        self.rows = torch.arange(B, device=dev)

    def _draw(self, seed):
        gen = torch.Generator().manual_seed(int(seed))
        T = self.iters
        return (torch.randint(0, self.E, (T,), generator=gen),
                torch.randint(0, self.E, (T,), generator=gen),
                torch.rand(T, generator=gen, dtype=torch.float64) < 0.5,
                torch.rand(T, generator=gen, dtype=torch.float64))

    def _cheap_valid(self, p1a, p1b, p2a, p2b):
        s1a, s1b = torch.minimum(p1a, p1b), torch.maximum(p1a, p1b)
        s2a, s2b = torch.minimum(p2a, p2b), torch.maximum(p2a, p2b)
        rows = self.rows
        ok = (p1a != p1b) & (p2a != p2b)                        # no self loops
        ok &= ~((s1a == s2a) & (s1b == s2b))                    # p1 != p2
        ok &= ~self.adj[rows, s1a, s1b] & ~self.adj[rows, s2a, s2b]  # not existing
        ok &= self.okm[s1a, s1b] & self.okm[s2a, s2b]           # admissible
        return ok, (s1a, s1b, s2a, s2b)

    def _usage_delta(self, a, b, c, d, s):
        n, MT = self.n, self.MT
        return (self.usage - MT[_packed_index(n, a, b)] - MT[_packed_index(n, c, d)]
                + MT[_packed_index(n, s[0], s[1])] + MT[_packed_index(n, s[2], s[3])])

    def move(self, t: int) -> None:
        """One SA step for every restart: propose a degree-preserving 2-swap,
        validate it with cheap checks, price it with one matmul-BFS, accept
        by Metropolis."""
        rows = self.rows
        a_i, b_i = self.ai[:, t], self.bi[:, t]
        a, b = self.eps[rows, a_i, 0], self.eps[rows, a_i, 1]
        c, d = self.eps[rows, b_i, 0], self.eps[rows, b_i, 1]
        T = self.T0 * math.exp(-3.0 * t / max(self.iters, 1))
        flip = self.flip[:, t]
        vA1, vA2 = torch.where(flip, d, c), torch.where(flip, c, d)
        okA, sA = self._cheap_valid(a, vA1, b, vA2)
        okB, sB = self._cheap_valid(a, vA2, b, vA1)
        if self.has_cs:
            uA = self._usage_delta(a, b, c, d, sA)
            uB = self._usage_delta(a, b, c, d, sB)
            if self.equality:
                okA &= (uA == self.e_cap).all(dim=1)
                okB &= (uB == self.e_cap).all(dim=1)
            else:
                okA &= (uA <= self.e_cap).all(dim=1)
                okB &= (uB <= self.e_cap).all(dim=1)
        use_A = okA
        valid = (okA | okB) & (a_i != b_i)
        s1a, s1b, s2a, s2b = (torch.where(use_A, xa, xb) for xa, xb in zip(sA, sB))

        adj2 = self.adj.clone()
        for (p, q), val in (((a, b), False), ((c, d), False),
                            ((s1a, s1b), True), ((s2a, s2b), True)):
            adj2[rows, p, q] = val
            adj2[rows, q, p] = val
        eps2 = self.eps.clone()
        eps2[rows, a_i, 0] = s1a
        eps2[rows, a_i, 1] = s1b
        eps2[rows, b_i, 0] = s2a
        eps2[rows, b_i, 1] = s2b

        # connectivity + ASPL in one BFS; disconnected → +inf → never accepted
        new = _aspl_cost(adj2, self.use_kernel)
        accept_p = torch.exp(-(new - self.cur) / max(T, 1e-9))
        accept = valid & ((new <= self.cur) | (self.u[:, t] < accept_p))
        self.adj = torch.where(accept[:, None, None], adj2, self.adj)
        self.eps = torch.where(accept[:, None, None], eps2, self.eps)
        if self.has_cs:
            self.usage = torch.where(accept[:, None], torch.where(use_A[:, None], uA, uB),
                                     self.usage)
        self.cur = torch.where(accept, new, self.cur)
        better = accept & (new < self.best_cost)
        self.best_eps = torch.where(better[:, None, None], eps2, self.best_eps)
        self.best_cost = torch.where(better, new, self.best_cost)

    def best_edges(self) -> list[list[tuple[int, int]]]:
        return [sorted((int(i), int(j)) for i, j in ep)
                for ep in self.best_eps.cpu().numpy()]


def _check_batch(edges0, seeds):
    B = len(edges0)
    if B == 0:
        raise ValueError("edges0 must hold at least one start graph")
    E = len(edges0[0])
    if any(len(e) != E for e in edges0):
        raise ValueError("edge counts must match in a batch")
    seeds = list(range(B)) if seeds is None else list(seeds)
    if len(seeds) != B:
        raise ValueError(f"{len(seeds)} seeds for {B} start graphs")
    return E, seeds


def anneal_topology_batched(
    n: int,
    edges0: list[list[tuple[int, int]]],
    cs: ConstraintSet | None = None,
    iters: int = 2000,
    T0: float = 0.5,
    seeds: list[int] | None = None,
    use_kernel: bool = True,
    device: str = "cuda",
) -> list[list[tuple[int, int]]]:
    """SA over degree-preserving 2-swaps for a batch of start graphs, all
    restarts advancing together on ``device``. Mirrors ``anneal_topology``'s
    objective and invariants (ASPL minimization, degree preservation,
    capacity feasibility, connectivity). Every start graph must have the
    same edge count."""
    E, seeds = _check_batch(edges0, seeds)
    if E < 2 or iters <= 0:  # no 2-swap is possible
        return [sorted(e) for e in edges0]
    sa = _SABatch(n, edges0, cs, int(iters), T0, seeds, bool(use_kernel),
                  resolve_device(device))
    for t in range(int(iters)):
        sa.move(t)
    return sa.best_edges()


def anneal_topology_stream(
    n: int,
    edges0: list[list[tuple[int, int]]],
    cs: ConstraintSet | None = None,
    iters: int = 2000,
    T0: float = 0.5,
    seeds: list[int] | None = None,
    use_kernel: bool = True,
    chunk: int | None = None,
    device: str = "cuda",
):
    """Generator form of :func:`anneal_topology_batched` for the anytime
    pipeline: yields ``(edge_lists, best_costs, t_done)`` after every chunk
    of moves. Exhausting it gives the one-shot driver's edge lists."""
    E, seeds = _check_batch(edges0, seeds)
    B = len(edges0)
    if E < 2 or iters <= 0:
        yield [sorted(e) for e in edges0], [float("inf")] * B, 0
        return
    iters = int(iters)
    chunk = max(1, -(-iters // 8)) if chunk is None else int(chunk)
    sa = _SABatch(n, edges0, cs, iters, T0, seeds, bool(use_kernel),
                  resolve_device(device))
    t = 0
    while t < iters:
        stop = min(t + chunk, iters)
        for tt in range(t, stop):
            sa.move(tt)
        t = stop
        yield sa.best_edges(), [float(c) for c in sa.best_cost.cpu().numpy()], t
