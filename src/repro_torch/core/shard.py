"""The ADMM engine over several processes, on ``torch.distributed``.

The port of ``repro.core.shard``. ``core.engine`` solves on one device;
this module runs the same ADMM step over the ranks of a process group
along two axes, selected by ``ADMMConfig.partition``:

  - ``"edges"``     — ONE instance, its edge-space leaves block-partitioned
    over the ranks. Each rank owns a contiguous window ``[first, first +
    count)`` of the packed edge vector (g, μ_g and the heterogeneous z/ν
    blocks, and the coupling multiplier v); the node-space (n, n) blocks
    (S, T, the Laplacian, the PSD projections) are replicated. Per CG
    matvec the only collective is one all-reduce of the window's additive
    Laplacian contribution (``edge_laplacian(g, n, first)``), with the
    capacity-row partials M z packed beside it when heterogeneous; the
    heterogeneous inner products all-reduce their v part. Aᵀ is local (the
    windowed ``edge_adjoint``). The cardinality and binary projections are a
    distributed top-k (local ``topk``, then an all-gather of the
    candidates), the Newton–Schulz PSD projection is row-partitioned with
    one all-gather a sign iteration.
  - ``"instances"`` — a batch of restarts or sweep elements split over the
    ranks: each rank runs the engine's batched driver on its contiguous
    slice, and the results are gathered, so every rank returns all of them.
  - ``"auto"``      — resolved by :func:`resolve_partition` from (n, batch,
    world size); one process resolves to ``"none"``.

The collectives map as ``lax.psum`` → ``dist.all_reduce(SUM)``,
``lax.all_gather`` → ``dist.all_gather_into_tensor``, ``lax.axis_index`` →
the rank, on the default group or ``group=``; any backend (NCCL with one
card a rank, gloo otherwise, or several ranks on one card). Without a
process group the world is one rank and no collective runs.

Padding invariant (edges), as in the reference: the packed edge dimension m
is padded to a multiple of the world size. Padded slots are inadmissible,
every projection zeroes them, Aᵀ writes 0 there, and every other update
keeps them 0, so they add exactly 0 to every reduction: the sharded
iterates match the single-device ones up to the reassociation of the
cross-rank sums.

Stopping: every rank leaves the CG and chunk loops at the same iteration,
or the next collective deadlocks. The chunk loop stops on the all-reduced
residual, which every rank holds bitwise; the CG loop reads "any row still
active" where the single-device CG reads it (every ``CG_CHECK_EVERY``
iterations), all-reduced by MAX.

Deviations from the reference:
  - ``edge_kernel=True`` (the port's default) runs the windowed CUDA
    kernels, which the reference refuses (its Pallas pair needs the whole
    edge list); on the CPU the wrappers take the plain window forms, and
    ``edge_kernel=False`` takes them on the card too.
  - At entry the replicated problem data and the start state are broadcast
    from rank 0, so ranks that ran the pipeline's host code separately
    still solve one problem from one state.
  - The merge of the sharded state is the reference's ``_merge_state``
    without its placement fault (``ShardingTypeError`` under jax 0.9).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.edge_laplacian import ops as _el_ops
from . import engine
from .engine import ADMMConfig, ADMMResult, ADMMState, ProblemSpec
from .linalg import pcg_solve

__all__ = [
    "EDGE_PARTITION_MIN_N", "resolve_partition",
    "solve_spec_sharded", "solve_batched_spec_sharded",
    "solve_sweep_spec_sharded",
]

# Below this node count the per-matvec all-reduce of the (n, n) Laplacian
# costs more than the O(m) edge work it parallelizes; instance parallelism
# (when a batch exists) or the single-device path wins. 512 is the
# reference's threshold, measured off the card (XLA:CPU, DESIGN.md §13) and
# not yet on the H100 (PERF.md, Open questions), as NS_MIN_N in engine.py.
EDGE_PARTITION_MIN_N = 512

_PARTITIONS = ("none", "edges", "instances", "auto")

# ``all_gather_into_tensor`` under the name that newer releases give it
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _world(group=None) -> tuple[int, int]:
    """(rank, world size) of ``group`` (default: the default group), or
    (0, 1) when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def resolve_partition(partition: str, n: int, batch: int | None = None,
                      ndev: int | None = None) -> str:
    """Resolve ``ADMMConfig.partition`` to a concrete layout.

    ``auto`` prefers instance parallelism whenever the batch can fill the
    ranks (restarts and sweep elements need no collective per iteration),
    falls back to edge partitioning for single large instances, and
    degenerates to the single-device path otherwise. ``ndev`` defaults to
    the world size of the default process group, 1 when none is
    initialized.
    """
    if partition not in _PARTITIONS:
        raise ValueError(f"unknown partition {partition!r}; expected one of "
                         f"{_PARTITIONS}")
    if partition != "auto":
        return partition
    ndev = _world()[1] if ndev is None else ndev
    if ndev <= 1:
        return "none"
    if batch is not None and batch >= ndev:
        return "instances"
    if n >= EDGE_PARTITION_MIN_N:
        return "edges"
    return "none"


def _check_world(ndev: int | None, group) -> None:
    size = _world(group)[1]
    if ndev is not None and ndev != size:
        raise ValueError(f"ndev={ndev}, but the process group has {size} rank(s): the port "
                         "shards over the ranks of its group")


class _Comm:
    """The collectives of one group. A process without a process group runs
    none; a group of one rank runs them all (the route they take is the
    backend's, even with nothing to exchange)."""

    def __init__(self, group=None):
        self.group = group
        self.rank, self.size = _world(group)
        self.live = dist.is_available() and dist.is_initialized()

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        if self.live:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size,) + t.shape, rank-major: one all-gather of the flattened
        tensor into a flat buffer (the layout every backend takes)."""
        if not self.live:
            return t[None]
        flat = t.reshape(-1).contiguous()
        out = flat.new_empty(self.size * flat.shape[0])
        _ALL_GATHER(out, flat, group=self.group)
        return out.view((self.size,) + tuple(t.shape))

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of the group's rank 0's ``t`` on every rank (bool tensors
        travel as uint8)."""
        if not self.live:
            return t
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        u = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous().clone()
        dist.broadcast(u, src=src, group=self.group)
        return u.bool() if t.dtype == torch.bool else u


# ---------------------------------------------------------------------------
# Edge-partitioned solver
# ---------------------------------------------------------------------------

class SState(NamedTuple):
    """Sharded ADMM iterate of one rank. The blocks of ``engine.ADMMState``
    with the x-vector split into its partitioned g-part and replicated λ̃:
    ``X = (g, λ̃, S, y, T[, z, ν, s])``; the constraint multipliers ``lam =
    (P, Q, w[, u, v])`` with only the v-leaf partitioned."""

    X: tuple
    Y: tuple
    D: tuple
    lam: tuple
    res: torch.Tensor
    cg: torch.Tensor


def _pad1(a: torch.Tensor, size: int, fill=0) -> torch.Tensor:
    """Pad axis 0 of ``a`` to ``size`` with a constant."""
    pad = size - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                    device=a.device)])


def _broadcast_spec(comm: _Comm, spec: ProblemSpec) -> ProblemSpec:
    """The spec with rank 0's problem data (budget, penalty, admissible
    edges, capacity rows, Jacobi diagonal) on every rank."""
    if not comm.live:
        return spec
    kw = {k: comm.broadcast(getattr(spec, k)) for k in ("r", "rho", "edge_ok")}
    for k in ("M", "e_cap", "jd"):
        if getattr(spec, k) is not None:
            kw[k] = comm.broadcast(getattr(spec, k))
    return spec.replace(**kw)


class _EdgeShard:
    """One rank's window of the packed edge list and its share of the data
    (the reference's ``_edge_repl_data`` and the closures of its runner)."""

    def __init__(self, spec: ProblemSpec, comm: _Comm, r_cap: int):
        n, m, size, rank = spec.n, spec.m, comm.size, comm.rank
        self.spec, self.comm = spec, comm
        self.n, self.m = n, m
        self.m_loc = m_loc = -(-m // size)
        self.m_pad = size * m_loc
        self.offset = rank * m_loc
        self.first = min(self.offset, m)
        self.count = max(0, min(m_loc, m - self.offset))
        self.k_cap = max(1, min(m_loc, r_cap + 1))
        self.rows_loc = -(-n // size)
        self.hetero = spec.hetero
        self.dt, self.dev = spec.B0.dtype, spec.B0.device
        sl = slice(self.offset, self.offset + m_loc)
        self.ok = _pad1(spec.edge_ok, self.m_pad, False)[sl]
        self.lidx = spec.lidx
        nn = n * n
        self.K_rep = 2 * nn + n + (spec.q if spec.hetero else 0)
        if spec.hetero:
            self.Mt = _pad1(spec.M.T.contiguous(), self.m_pad)[sl]          # (m_loc, q)
            self.M = self.Mt.T.contiguous()                                  # (q, m_loc)
        self.jd = None
        if spec.jd is not None:
            jd = spec.jd[:self.K_rep]
            if spec.hetero:
                # padded slots divide a zero residual: any nonzero diagonal works
                jd = torch.cat([jd, _pad1(spec.jd[self.K_rep:], self.m_pad, 1.0)[sl]])
            self.jd = jd

    # ---- state split and merge (the reference's _split_state/_merge_state) ----

    def split(self, st: ADMMState) -> SState:
        m, sl = self.m, slice(self.offset, self.offset + self.m_loc)

        def part(t):
            return _pad1(t, self.m_pad)[sl]

        def xsplit(t):
            x = t[0]
            base = (part(x[:m]), x[m], t[1], t[2], t[3])
            if self.hetero:
                base += (part(t[4]), part(t[5]), t[6])
            return base

        lam = tuple(st.lam[:3])
        if self.hetero:
            lam += (st.lam[3], part(st.lam[4]))
        return SState(X=xsplit(st.X), Y=xsplit(st.Y), D=xsplit(st.D), lam=lam,
                      res=st.res, cg=st.cg)

    def merge(self, sst: SState) -> ADMMState:
        m = self.m

        def whole(t):
            return self.comm.all_gather(t).reshape(-1)[:m]

        def xjoin(t):
            x = torch.cat([whole(t[0]), t[1].reshape(1)])
            base = (x, t[2], t[3], t[4])
            if self.hetero:
                base += (whole(t[5]), whole(t[6]), t[7])
            return base

        lam = tuple(sst.lam[:3])
        if self.hetero:
            lam += (sst.lam[3], whole(sst.lam[4]))
        return ADMMState(X=xjoin(sst.X), Y=xjoin(sst.Y), D=xjoin(sst.D), lam=lam,
                         res=sst.res, cg=sst.cg)

    # ---- the constraint operator (engine.A_op / AT_op, window form) ----------

    def window_L(self, g: torch.Tensor) -> torch.Tensor:
        """This window's additive contribution to L(g)."""
        if self.spec.edge_kernel:
            return _el_ops.edge_laplacian(g[:self.count], self.n, self.first)
        return _el_ops.edge_laplacian_window_plain(g, self.lidx, self.offset)

    def A(self, X: tuple) -> torch.Tensor:
        """The local flat constraint-space vector ``[vec(L − λ̃I + S); vec(L
        + λ̃I + T); diag L + y (; M z (+ s); g − z + ν)]``, the last block
        this rank's window: one all-reduce of the window Laplacian (and M z)."""
        spec, n = self.spec, self.n
        g, lamt, S, y, T = X[:5]
        Lw = self.window_L(g)
        if self.hetero:
            buf = self.comm.all_reduce(torch.cat([Lw.reshape(-1), X[5] @ self.Mt]))
            L, zM = buf[:n * n].view(n, n), buf[n * n:]
        else:
            L = self.comm.all_reduce(Lw)
        lam_I = lamt * spec.I
        blocks = [(L - lam_I + S).flatten(), (L + lam_I + T).flatten(),
                  torch.diagonal(L) + y]
        if self.hetero:
            z, nu, s = X[5], X[6], X[7]
            blocks += [zM if spec.equality else zM + s, g - z + nu]
        return torch.cat(blocks)

    def split_lam(self, flat: torch.Tensor) -> tuple:
        n = self.n
        sizes = (n * n, n * n, n) + ((self.spec.q, self.m_loc) if self.hetero else ())
        parts = torch.split(flat, sizes)
        return (parts[0].view(n, n), parts[1].view(n, n)) + tuple(parts[2:])

    def AT(self, lamv: torch.Tensor) -> tuple:
        """Adjoint of :meth:`A`, local: the windowed ``edge_adjoint`` gives
        the window's x entries and the replicated −tr P + tr Q."""
        blocks = self.split_lam(lamv)
        P, Q, w = blocks[:3]
        v = blocks[4] if self.hetero else None
        vw = None if v is None else v[:self.count]
        if self.spec.edge_kernel:
            x = _el_ops.edge_adjoint(P, Q, w, vw, self.first, self.count)
        else:
            x = _el_ops.edge_adjoint_plain(P, Q, w, vw, self.first, self.count)
        xg = _pad1(x[:self.count], self.m_loc)
        xl = x[self.count]
        if not self.hetero:
            return (xg, xl, P, w, Q)
        u = blocks[3]
        z_adj = u @ self.M - v
        s_adj = torch.zeros_like(u) if self.spec.equality else u
        return (xg, xl, P, w, Q, z_adj, v, s_adj)

    def b(self) -> torch.Tensor:
        spec = self.spec
        blocks = [(-spec.B0).reshape(-1), (2.0 * spec.I).reshape(-1),
                  torch.ones(self.n, dtype=self.dt, device=self.dev)]
        if self.hetero:
            blocks += [spec.e_cap, torch.zeros(self.m_loc, dtype=self.dt, device=self.dev)]
        return torch.cat(blocks)

    def dot(self, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        """⟨a, b⟩ in float64 over the whole constraint space. Homogeneous
        vectors are replicated: the local dot, the single-device one. A
        heterogeneous one all-reduces its v part, rank 0 adding the
        replicated part, so that every rank holds the same bits."""
        a = a.to(torch.float64)
        b = a if b is None else b.to(torch.float64)
        if not self.hetero or self.comm.size == 1:
            return torch.dot(a, b)
        k = self.K_rep
        part = torch.dot(a[k:], b[k:])
        if self.comm.rank == 0:
            part = part + torch.dot(a[:k], b[:k])
        return self.comm.all_reduce(part)

    def any_active(self, active: torch.Tensor) -> bool:
        flag = active.any().to(torch.int32).reshape(1)
        return bool(self.comm.all_reduce(flag, dist.ReduceOp.MAX))

    # ---- projections (engine Eq. 24/25/30, distributed) ----------------------

    def proj_card(self, v: torch.Tensor) -> torch.Tensor:
        """Top-r nonnegative entries over the whole list: each rank's top
        ``k_cap`` candidates hold the global (r+1)-th largest, so the
        threshold is the single-device one exactly."""
        v = torch.where(self.ok, torch.clamp_min(v, 0.0), 0.0)
        top = torch.topk(v, self.k_cap).values
        desc = -torch.sort(-self.comm.all_gather(top).reshape(-1)).values
        r = self.spec.r
        idx = torch.clamp(torch.clamp_max(r, self.m - 1), 0, desc.shape[0] - 1).reshape(1)
        thresh = torch.where(r >= self.m, -1.0, torch.gather(desc, 0, idx)[0])
        keep = v > torch.clamp_min(thresh, 0.0)
        return torch.where(keep, v, 0.0)

    def proj_binary(self, v: torch.Tensor) -> torch.Tensor:
        """Largest r entries → 1 by a stable argsort of the gathered vector:
        rank-major order is the global packed order (padding last), so each
        rank is bitwise the single-device one."""
        vm = torch.where(self.ok, v + 0.0, -math.inf)
        allv = self.comm.all_gather(vm).reshape(-1)
        order = torch.argsort(-allv, stable=True)
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(allv.shape[0], device=allv.device))
        rank_loc = rank[self.offset:self.offset + self.m_loc]
        return (rank_loc < self.spec.r).to(self.dt)

    def proj_psd_ns(self, S: torch.Tensor, T: torch.Tensor) -> tuple:
        """Row-partitioned Newton–Schulz of the pair (S₁ ≼ 0, T₁ ≽ 0): rank
        d owns rows [d·rows_loc, (d+1)·rows_loc) of both iterates; one
        all-gather a sign iteration rebuilds the full matrices its rows
        multiply against. Same left association (X_loc @ X) @ X as the
        engine's X @ X @ X."""
        n, rows, comm = self.n, self.rows_loc, self.comm
        M = torch.stack([S, T])
        Msym = (M + M.transpose(-1, -2)) / 2.0
        nrm = torch.sqrt(torch.sum(Msym * Msym, dim=(-2, -1), keepdim=True)) + 1e-30
        Y0 = Msym / nrm
        r0 = comm.rank * rows
        Xl = Y0[:, r0:r0 + rows]
        if Xl.shape[1] < rows:
            Xl = torch.cat([Xl, Xl.new_zeros(2, rows - Xl.shape[1], n)], dim=1)

        def whole(Xl_):
            return comm.all_gather(Xl_).transpose(0, 1).reshape(2, -1, n)[:, :n]

        for _ in range(self.spec.psd_iters):
            Xf = whole(Xl)
            Xl = 1.5 * Xl - 0.5 * ((Xl @ Xf) @ Xf)
        absM = nrm * (whole(Xl) @ Y0)
        absM = (absM + absM.transpose(-1, -2)) / 2.0
        return (Msym[0] - absM[0]) / 2.0, (Msym[1] + absM[1]) / 2.0

    def project(self, U: tuple) -> tuple:
        spec = self.spec
        g1 = self.proj_card(U[0])
        lam1 = torch.clamp_min(U[1], 0.0)
        if spec.psd_backend == "newton_schulz":
            S1, T1 = self.proj_psd_ns(U[2], U[4])
        else:
            Msym = torch.stack([U[2], U[4]])
            Msym = (Msym + Msym.transpose(-1, -2)) / 2.0
            S1, T1 = engine._eigh_clip(Msym, (False, True)).unbind(0)
        y1 = torch.clamp_min(U[3], 0.0)
        if not self.hetero:
            return (g1, lam1, S1, y1, T1)
        z1 = self.proj_binary(U[5])
        nu1 = torch.clamp_min(U[6], 0.0)
        s1 = torch.zeros_like(U[7]) if spec.equality else torch.clamp_min(U[7], 0.0)
        return (g1, lam1, S1, y1, T1, z1, nu1, s1)

    # ---- one ADMM iteration ---------------------------------------------------

    def step(self, st: SState) -> SState:
        spec, rho = self.spec, self.spec.rho
        U = tuple(x + d / rho for x, d in zip(st.X, st.D))
        Y = self.project(U)
        V = [y1 - d / rho for y1, d in zip(Y, st.D)]
        V[1] = V[1] - (-1.0) / rho          # c has a single −1 at the λ̃ slot
        if self.hetero and spec.equality:
            V[7] = torch.zeros_like(V[7])
        lam0 = torch.cat([blk.reshape(-1) for blk in st.lam])
        Xn, lam, cg_it = pcg_solve(self.A, self.AT, tuple(V), self.b(), lam0, jd=self.jd,
                                   tol=engine._cg_tolerance(spec, st.res),
                                   maxiter=spec.cg_maxiter, dot=self.dot,
                                   any_active=self.any_active)
        if self.hetero and spec.equality:
            Xn = Xn[:7] + (torch.zeros_like(Xn[7]),)
        D = tuple(d + rho * (xn - y1) for d, xn, y1 in zip(st.D, Xn, Y))
        part = torch.zeros((), dtype=torch.float64, device=self.dev)
        rep = torch.zeros((), dtype=torch.float64, device=self.dev)
        for i, (xn, y1) in enumerate(zip(Xn, Y)):
            ssq = torch.sum((xn - y1).to(torch.float64) ** 2)
            if i in ((0, 5, 6) if self.hetero else (0,)):
                part = part + ssq
            else:
                rep = rep + ssq
        # rank 0 adds the replicated leaves, so the all-reduced residual,
        # which takes every stop decision, is the same bits on every rank
        res = self.comm.all_reduce(part + rep if self.comm.rank == 0 else part)
        return SState(X=Xn, Y=Y, D=D, lam=self.split_lam(lam), res=res, cg=st.cg + cg_it)


def solve_spec_sharded(spec: ProblemSpec, state0: ADMMState, cfg: ADMMConfig,
                       ndev: int | None = None, r_cap: int | None = None,
                       group=None) -> ADMMResult:
    """Edge-partitioned solve of ONE instance over the ranks of ``group``
    (default: the default group; one rank without a process group).

    Drop-in for ``engine.solve_spec``, called by every rank with the same
    arguments; every rank returns the same result. ``r_cap`` bounds the
    budget ``spec.r`` for the distributed top-k (default the spec's own r;
    pass the sweep maximum when budgets vary). ``ndev``, when given, must be
    the group's size. Rank 0's problem data and start state are broadcast
    first.
    """
    if cfg.solver != "schur_cg":
        raise ValueError("partition='edges' supports solver='schur_cg' only "
                         f"(got {cfg.solver!r})")
    _check_world(ndev, group)
    comm = _Comm(group)
    spec = _broadcast_spec(comm, spec)
    state0 = state0.map(comm.broadcast)
    r_cap = int(spec.r) if r_cap is None else int(r_cap)
    sh = _EdgeShard(spec, comm, r_cap)
    st = sh.split(state0)
    chunk = min(cfg.check_every, cfg.max_iters)
    n_chunks = -(-cfg.max_iters // chunk)
    its, res, history = 0, math.inf, []
    for c in range(n_chunks):
        clen = chunk if c < n_chunks - 1 else cfg.max_iters - chunk * (n_chunks - 1)
        for _ in range(clen):
            st = sh.step(st)
        done = st.res < cfg.eps
        if cfg.abort_nonfinite:
            done = done | ~torch.isfinite(st.res)
        res, lam, done_h = torch.stack([st.res, st.X[1].to(torch.float64),
                                        done.to(torch.float64)]).tolist()
        its += clen
        history.append((its, res, lam))
        if cfg.verbose:
            tag = "admm-het-sh" if spec.hetero else "admm-homo-sh"
            print(f"[{tag}] it={its} res={res:.3e} lam~={lam:.4f}")
        if done_h:
            break
    return engine._result_from(spec, sh.merge(st), its, res, history)


# ---------------------------------------------------------------------------
# Instance-partitioned drivers (restarts and sweeps as data parallelism)
# ---------------------------------------------------------------------------

def _pad_batch(t: torch.Tensor, B_pad: int) -> torch.Tensor:
    """Pad the leading batch axis by repeating element 0 (dropped on the way
    out) so that the batch divides the world size."""
    reps = B_pad - t.shape[0]
    if reps == 0:
        return t
    return torch.cat([t, t[:1].expand((reps,) + tuple(t.shape[1:]))])


def _instances(B: int, ndev, group) -> tuple[_Comm, slice, int]:
    _check_world(ndev, group)
    comm = _Comm(group)
    per = -(-B // comm.size)
    return comm, slice(comm.rank * per, (comm.rank + 1) * per), per * comm.size


def _gather_results(comm: _Comm, local: list, B: int) -> list[ADMMResult]:
    if comm.size == 1:
        return local[:B]
    out: list = [None] * comm.size
    dist.all_gather_object(out, local, group=comm.group)
    return [res for part in out for res in part][:B]


def solve_batched_spec_sharded(spec: ProblemSpec, states: ADMMState, cfg: ADMMConfig,
                               ndev: int | None = None, group=None) -> list[ADMMResult]:
    """``engine.solve_batched_spec`` with the restart batch split over the
    ranks: each rank advances its contiguous slice of restarts with no
    collective per iteration; every rank returns all B results."""
    B = int(states.X[0].shape[0])
    comm, sl, B_pad = _instances(B, ndev, group)
    states = states.map(lambda t: _pad_batch(comm.broadcast(t), B_pad)[sl])
    return _gather_results(comm, engine.solve_batched_spec(spec, states, cfg), B)


def solve_sweep_spec_sharded(spec: ProblemSpec, rs, states: ADMMState, cfg: ADMMConfig,
                             rhos=None, ndev: int | None = None,
                             group=None) -> list[ADMMResult]:
    """``engine.solve_sweep_spec`` with the sweep elements split over the
    ranks (r and ρ are data, so the padded elements re-solve element 0 and
    are dropped from the result list)."""
    dev = spec.I.device
    rs = torch.as_tensor(np.asarray(rs), dtype=torch.int64, device=dev)
    rhos = (spec.rho.expand(rs.shape) if rhos is None
            else torch.as_tensor(np.asarray(rhos), dtype=spec.B0.dtype, device=dev))
    B = int(rs.shape[0])
    comm, sl, B_pad = _instances(B, ndev, group)
    states = states.map(lambda t: _pad_batch(comm.broadcast(t), B_pad)[sl])
    rs, rhos = (_pad_batch(comm.broadcast(t), B_pad)[sl].cpu().numpy() for t in (rs, rhos))
    return _gather_results(comm, engine.solve_sweep_spec(spec, rs, states, cfg, rhos=rhos), B)
