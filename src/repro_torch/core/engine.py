"""ADMM solver engine (Algorithm 2, §V) in PyTorch.

The port of ``repro.core.engine``: one ``step(spec, state)`` serves the
homogeneous problem (Eq. 20) and the heterogeneous Mixed-Integer SDP
(Eq. 28). The problem data is a :class:`ProblemSpec` dataclass of tensors
and the iterate an :class:`ADMMState` dataclass of tensors; ``solve_spec``
drives chunks of ``check_every`` steps with one host sync per chunk, like
the reference's scan driver.

Variable layout (homogeneous, Eq. 20):
  X = (x, S, y, T)     with x = [g; λ̃] ∈ R^{m+1}
  Y = (x₁, S₁, y₁, T₁)
  duals D = (μ, Λ, σ, Γ)
Constraints C_X (Eq. 23):
  L(g) − λ̃I + S = −B₀,   L(g) + λ̃I + T = 2I,   diag(L(g)) + y = 1
Heterogeneous appends (z, ν, s) with M z (+ s) = e and g − z + ν = 0.

Constraint-space vectors (the CG unknown λ, the right-hand side b, A X)
are one flat tensor ``[vec P; vec Q; w (; u; v)]`` — see ``linalg``.

Deviation from the reference: ``ADMMConfig.edge_kernel`` defaults to True,
so on the card L(g), A_op's dense blocks, AT_op's x-part and the CG matvec
A·Aᵀλ (``schur_matvec``) run through the CUDA kernels of
``kernels/edge_laplacian``, one launch each; on the CPU each wrapper runs
its plain version, the reference's composition. ``False`` is kept as the
caller's explicit choice of the plain form.

Batches: where the reference writes ``step`` for one instance and vmaps
it, the port's ``step`` and the functions under it take tensors with a
leading instance axis B on every block of the state (the flat
constraint-space vectors (B, K)), or one iterate without it; ``spec.r``
and ``spec.rho`` are 0-dim or (B,) (a sweep's budgets and penalties), and
the rest of the spec is shared.
The drivers run every solve as a batch: ``solve_batched_spec`` (restarts),
``solve_sweep_spec`` (budgets) and ``solve_spec`` (B = 1). Each chunk makes
one host read for the whole batch; an instance that is done (converged, or
non-finite with ``abort_nonfinite``) is frozen on every leaf by
``torch.where``, the select the reference's ``lax.cond`` lowers to under
``vmap``.

Precision: the loop runs in the spec dtype; the squared primal residual
and the CG inner products are float64 whatever it is (the reference's
convention). ``r`` is an int64 tensor.

X-step backends (``step``'s ``backend``, ``ADMMConfig.solver``): the
default ``schur_cg`` (CG on the Schur complement, ``linalg.pcg_solve``),
``kkt_bicgstab`` (matrix-free Bi-CGSTAB on the KKT system: on the card two
``edge_laplacian_blocks`` and two ``edge_adjoint`` launches an iteration,
no ``edge_schur_matvec``) and the paper's ``kkt_bicgstab_ilu``
(``make_ilu_step``: scipy's ILU-preconditioned Bi-CGSTAB on the host, the
homogeneous problem in float64 only). ``solve_python`` is the reference's
per-iteration driver: one step and one host read of the residual an
iteration; it carries the ILU step.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.edge_laplacian import ops as _el_ops
from .graph import all_edges
from .linalg import ILUKKTSolver, kkt_bicgstab_solve, pcg_solve

__all__ = [
    "ADMMConfig", "ADMMResult", "ADMMState", "ProblemSpec",
    "make_homo_spec", "make_hetero_spec", "init_state", "step",
    "solve_spec", "solve_batched_spec", "solve_sweep_spec", "solve_python", "build_sparse_A",
    "make_ilu_step", "check_solver", "proj_psd", "proj_psd_ns",
    "proj_card_nonneg", "proj_binary_topr", "jacobi_diag", "resolve_psd_backend",
    "A_op", "AT_op", "schur_matvec", "b_rhs", "lam_sizes", "split_lam",
]

# Inexact-ADMM CG tolerance schedule (DESIGN.md §9): relative tolerance
# η·√(previous squared primal residual), clipped to [cg_tol, cap].
INEXACT_ETA = 1e-2
INEXACT_CAP = 1e-3
# Relative CG tolerances below ~machine-ε are unreachable in fp32.
FP32_TOL_FLOOR = 1e-6

# eigh ↔ Newton–Schulz crossover for ``psd_backend="auto"``. The cpu entry
# is the reference's measurement (XLA:CPU, DESIGN.md §13). The cuda entry
# is NOT measured on the H100: it copies the reference's unmeasured
# "default" of 256 until a later slice measures it (PERF.md, Open questions).
NS_MIN_N = {"cpu": None, "cuda": 256, "default": 256}


def resolve_psd_backend(psd_backend: str, n: int, platform: str = "cuda") -> str:
    """Resolve ``psd_backend="auto"`` to a concrete backend for size n on
    ``platform`` (a torch device type)."""
    if psd_backend != "auto":
        return psd_backend
    thr = NS_MIN_N.get(platform, NS_MIN_N["default"])
    return "newton_schulz" if (thr is not None and n >= thr) else "eigh"


@dataclass
class ADMMConfig:
    rho: float = 5.0
    alpha: float = 2.0
    max_iters: int = 1500
    eps: float = 1e-7
    solver: str = "schur_cg"   # schur_cg | kkt_bicgstab | kkt_bicgstab_ilu (host, homo, fp64)
    driver: str = "scan"       # scan (chunked) | python (per-iteration host loop)
    cg_tol: float = 1e-11
    cg_maxiter: int = 3000
    check_every: int = 10
    verbose: bool = False
    precond: str = "none"      # jacobi | none
    cg_inexact: bool = False
    psd_backend: str = "eigh"  # eigh | newton_schulz | auto
    psd_iters: int = 30
    dtype: str = "float64"     # float64 | float32 (fp32 loop, fp64 residuals)
    # Deviation from the reference (which defaults to False): the CUDA pair
    # is the default; False selects the plain PyTorch form explicitly.
    edge_kernel: bool = True
    partition: str = "none"    # none | edges | instances | auto (core.shard)
    abort_nonfinite: bool = True
    device: str = "cuda"


@dataclass
class ADMMResult:
    g: np.ndarray
    g_raw: np.ndarray
    lam_tilde: float
    z: np.ndarray | None
    iters: int
    residual: float
    history: list = field(default_factory=list)
    cg_iters: int = 0


@dataclass(frozen=True)
class ProblemSpec:
    """One topology MI-SDP instance as tensors on one device."""

    n: int
    m: int
    q: int
    hetero: bool
    equality: bool
    cg_tol: float
    cg_maxiter: int
    r: torch.Tensor            # int64, 0-dim or (B,) — cardinality budget
    rho: torch.Tensor          # spec dtype, 0-dim or (B,)
    edge_ok: torch.Tensor      # (m,) bool
    c: torch.Tensor            # (m+1,) objective: minimize −λ̃
    ei: torch.Tensor           # (m,) int64 endpoints, i < j
    ej: torch.Tensor
    B0: torch.Tensor           # (n, n) Lemma-1 shift α·11ᵀ/n
    I: torch.Tensor            # (n, n)
    M: torch.Tensor | None     # (q, m) capacity rows (hetero only)
    e_cap: torch.Tensor | None  # (q,)
    jd: torch.Tensor | None = None    # flat diag(A Aᵀ) (Jacobi precond)
    lidx: torch.Tensor | None = None  # (n, n) int64 packed edge index
    dtype: str = "float64"
    psd_backend: str = "eigh"
    psd_iters: int = 30
    cg_inexact: bool = False
    edge_kernel: bool = True

    def replace(self, **kw) -> "ProblemSpec":
        return dataclasses.replace(self, **kw)



@dataclass
class ADMMState:
    """ADMM iterates, one per instance of the leading batch axis (or one
    without it). Block tuples hold 4 tensors (homo: x, S, y, T) or 7
    (hetero: + z, ν, s); ``lam`` holds the constraint-space blocks
    (P, Q, w (, u, v)) of the X-step warm start."""

    X: tuple
    Y: tuple
    D: tuple
    lam: tuple
    res: torch.Tensor   # previous squared primal residual, float64 (B,)
    cg: torch.Tensor    # cumulative X-step CG iterations, int32 (B,)

    def map(self, fn) -> "ADMMState":
        """The state with ``fn`` applied to every leaf."""
        return ADMMState(*(tuple(fn(t) for t in blk) for blk in (self.X, self.Y, self.D,
                                                                 self.lam)),
                         res=fn(self.res), cg=fn(self.cg))


def jacobi_diag(n: int, ei, ej, dtype, M=None, equality: bool = True) -> tuple:
    """Analytic diag(A Aᵀ) of the constraint operator as blocks
    (dP, dP, dw (, du, dv)) — see the reference's ``engine.jacobi_diag``."""
    dev = ei.device
    one = torch.ones(ei.shape[0], dtype=dtype, device=dev)
    deg = torch.zeros(n, dtype=dtype, device=dev).index_add_(0, ei, one).index_add_(0, ej, one)
    C = torch.zeros((n, n), dtype=dtype, device=dev)
    C.index_put_((ei, ej), one, accumulate=True)
    C.index_put_((ej, ei), one, accumulate=True)
    dP = C + 1.0
    dP.diagonal().add_(deg + 1.0)
    dw = deg + 1.0
    if M is None:
        return (dP, dP, dw)
    Mj = torch.as_tensor(M, dtype=dtype, device=dev)
    du = torch.sum(Mj * Mj, dim=1) + (0.0 if equality else 1.0)
    du = torch.clamp_min(du, 1e-12)  # guard all-zero rows
    dv = torch.full((ei.shape[0],), 3.0, dtype=dtype, device=dev)
    return (dP, dP, dw, du, dv)


def _validate_cfg(cfg: ADMMConfig) -> None:
    if cfg.precond not in ("jacobi", "none"):
        raise ValueError(f"unknown precond {cfg.precond!r}; expected 'jacobi' or 'none'")
    if cfg.psd_backend not in ("eigh", "newton_schulz", "auto"):
        raise ValueError(f"unknown psd_backend {cfg.psd_backend!r}; "
                         "expected 'eigh', 'newton_schulz' or 'auto'")
    if cfg.dtype not in ("float64", "float32"):
        raise ValueError(f"unknown dtype {cfg.dtype!r}; expected 'float64' or 'float32'")
    if cfg.partition not in ("none", "edges", "instances", "auto"):
        raise ValueError(f"unknown partition {cfg.partition!r}; expected "
                         "'none', 'edges', 'instances' or 'auto'")


def resolve_partition(partition: str, n: int, batch: int | None = None,
                      ndev: int | None = None) -> str:
    """``core.shard.resolve_partition``: ``"auto"`` resolves by the world
    size of the default process group, to ``"none"`` on one process."""
    from .shard import resolve_partition as resolve

    return resolve(partition, n, batch, ndev)


def _make_spec(n: int, r: int, cfg: ADMMConfig, edge_ok, M=None, e_cap=None,
               equality: bool = True) -> ProblemSpec:
    _validate_cfg(cfg)
    dev = resolve_device(cfg.device)
    dt = getattr(torch, cfg.dtype)
    ei, ej = _el_ops.edge_endpoints(n, str(dev))
    m = int(ei.shape[0])
    ok = (torch.ones(m, dtype=torch.bool, device=dev) if edge_ok is None
          else torch.as_tensor(np.asarray(edge_ok, dtype=bool), device=dev))
    n_ok = m if edge_ok is None else int(np.asarray(edge_ok, dtype=bool).sum())
    r_eff = min(int(r), n_ok)
    c = torch.zeros(m + 1, dtype=dt, device=dev)
    c[m] = -1.0
    hetero = M is not None
    Mt = torch.as_tensor(np.asarray(M), dtype=dt, device=dev) if hetero else None
    jd = None
    if cfg.precond == "jacobi":
        jd = torch.cat([b.reshape(-1) for b in jacobi_diag(
            n, ei, ej, dt, M=Mt, equality=equality)])
    return ProblemSpec(
        n=n, m=m, q=int(M.shape[0]) if hetero else 0, hetero=hetero,
        equality=equality if hetero else True,
        cg_tol=cfg.cg_tol, cg_maxiter=cfg.cg_maxiter,
        r=torch.tensor(r_eff, dtype=torch.int64, device=dev),
        rho=torch.tensor(cfg.rho, dtype=dt, device=dev),
        edge_ok=ok, c=c, ei=ei, ej=ej,
        B0=cfg.alpha * torch.ones((n, n), dtype=dt, device=dev) / n,
        I=torch.eye(n, dtype=dt, device=dev),
        M=Mt,
        e_cap=(torch.as_tensor(np.asarray(e_cap), dtype=dt, device=dev)
               if hetero else None),
        jd=jd, lidx=_el_ops.packed_edge_index(n, str(dev)),
        dtype=cfg.dtype,
        psd_backend=resolve_psd_backend(cfg.psd_backend, n, platform=dev.type),
        psd_iters=cfg.psd_iters, cg_inexact=cfg.cg_inexact,
        edge_kernel=cfg.edge_kernel)


def make_homo_spec(n: int, r: int, cfg: ADMMConfig,
                   edge_ok: np.ndarray | None = None) -> ProblemSpec:
    return _make_spec(n, r, cfg, edge_ok)


def make_hetero_spec(n: int, r: int, M: np.ndarray, e_cap: np.ndarray,
                     cfg: ADMMConfig, equality: bool = True,
                     edge_ok: np.ndarray | None = None) -> ProblemSpec:
    m = n * (n - 1) // 2
    if M.shape[1] != m:
        raise ValueError(f"M must cover all {m} candidate edges, got {M.shape}")
    return _make_spec(n, r, cfg, edge_ok, M=M, e_cap=e_cap, equality=equality)


# =========================================================================
# Projections (Eq. 24/25/30) — r is an int64 tensor, 0-dim or one per row
# =========================================================================

def _eigh_clip(Msym: torch.Tensor, nonneg) -> torch.Tensor:
    """(U·clip(ev))·Uᵀ of symmetric matrices with leading batch axes. The
    eigenvalues are clipped to ≥ 0 when ``nonneg`` is True, to ≤ 0 when it
    is False; a tuple of flags gives one per matrix of the last leading
    axis (axis −3 of ``Msym``).

    ``torch.linalg.eigh`` raises on a non-finite input where the reference's
    ``jnp.linalg.eigh`` returns NaN, and a NaN has to reach the residual so
    that ``abort_nonfinite`` sees it. A non-finite matrix is therefore
    decomposed as zeros and its projection returned as NaN — without a host
    sync."""
    bad = ~torch.isfinite(Msym).all(dim=-1).all(dim=-1)
    ev, U = torch.linalg.eigh(torch.where(bad[..., None, None], 0.0, Msym))

    def clip(e, up):
        return torch.clamp_min(e, 0.0) if up else torch.clamp_max(e, 0.0)

    if isinstance(nonneg, tuple):
        ev = torch.stack([clip(e, up) for e, up in zip(ev.unbind(-2), nonneg)], dim=-2)
    else:
        ev = clip(ev, nonneg)
    out = (U * ev.unsqueeze(-2)) @ U.transpose(-1, -2)
    return torch.where(bad[..., None, None], math.nan, out)


def proj_psd(M: torch.Tensor, sign: float) -> torch.Tensor:
    """Eq. 25: eigenvalue clipping. sign=+1 → PSD (T₁ ≽ 0), −1 → NSD (S₁ ≼ 0).
    ``M`` may carry leading batch axes."""
    return _eigh_clip((M + M.transpose(-1, -2)) / 2.0, sign > 0)


def proj_psd_ns(M: torch.Tensor, sign: float, iters: int = 30) -> torch.Tensor:
    """Matmul-only PSD/NSD projection via the Newton–Schulz polar iteration
    X ← (3X − X³)/2 from X₀ = M/‖M‖_F; P_±(M) = (M ± |M|)/2."""
    Msym = (M + M.transpose(-1, -2)) / 2.0
    nrm = torch.sqrt(torch.sum(Msym * Msym, dim=(-2, -1), keepdim=True)) + 1e-30
    Y = Msym / nrm
    X = Y
    for _ in range(iters):
        X = 1.5 * X - 0.5 * (X @ X @ X)
    absM = nrm * (X @ Y)
    absM = (absM + absM.transpose(-1, -2)) / 2.0
    return (Msym + absM) / 2.0 if sign > 0 else (Msym - absM) / 2.0


def proj_card_nonneg(v: torch.Tensor, r: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Project each row of ``v`` (..., m) onto {g ≥ 0, Card(g) ≤ r} ∩
    {g_l = 0 for inadmissible l}: keep the largest r nonnegative entries.
    ``r`` is 0-dim or one budget per row; each row's threshold is read at
    its own index min(r, m−1) by a gather, so ``r`` stays a tensor (no
    host sync)."""
    v = torch.where(ok, torch.clamp_min(v, 0.0), 0.0)
    m = v.shape[-1]
    r = r.expand(v.shape[:-1]).unsqueeze(-1)
    desc = -torch.sort(-v, dim=-1).values
    thresh = torch.where(r >= m, -1.0, torch.gather(desc, -1, torch.clamp_max(r, m - 1)))
    keep = v > torch.clamp_min(thresh, 0.0)
    return torch.where(keep, v, 0.0)


def proj_binary_topr(v: torch.Tensor, r: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Heterogeneous z₁ projection of each row of ``v`` (..., m): largest r
    entries → 1, others → 0, ``r`` 0-dim or one per row. Ties break to the
    lowest index (stable sort); ``+ 0.0`` folds −0.0 into +0.0 so
    signed-zero ties are index-ordered too."""
    v = torch.where(ok, v + 0.0, -math.inf)
    order = torch.argsort(-v, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(v.shape[-1], device=v.device).expand_as(order))
    return (rank < r[..., None]).to(v.dtype)


# =========================================================================
# Matrix-free constraint operator A, its adjoint, and the RHS b
# =========================================================================

def _L_of_g(spec: ProblemSpec, g: torch.Tensor) -> torch.Tensor:
    """Laplacian of the packed edge-weight vector: the CUDA kernel when
    ``spec.edge_kernel`` (its wrapper runs the plain form for a CPU
    tensor), else the plain ``lidx`` gather."""
    if spec.edge_kernel:
        return _el_ops.edge_laplacian(g, spec.n)
    return _el_ops.edge_laplacian_plain(g, spec.lidx)


def lam_sizes(spec: ProblemSpec) -> tuple[int, ...]:
    """Lengths of the constraint-space blocks (P, Q, w (, u, v))."""
    n = spec.n
    base = (n * n, n * n, n)
    return base + (spec.q, spec.m) if spec.hetero else base


def split_lam(spec: ProblemSpec, flat: torch.Tensor) -> tuple:
    """Views of a flat constraint-space vector (..., K) as its blocks."""
    nn = flat.shape[:-1] + (spec.n, spec.n)
    parts = torch.split(flat, lam_sizes(spec), dim=-1)
    return (parts[0].view(nn), parts[1].view(nn)) + tuple(parts[2:])


def A_op(spec: ProblemSpec, X) -> torch.Tensor:
    """Constraint operator (Eq. 23, plus Eq. 29 rows when heterogeneous),
    as one flat constraint-space tensor (..., K), the leading axes X's.
    With ``spec.edge_kernel`` on a CUDA tensor the three dense blocks of the
    whole batch come from one ``edge_laplacian_blocks`` launch and the
    heterogeneous rows are written into slices of the same output
    (bit-equal to the composition below)."""
    x, S, y, T = X[:4]
    g, lam = x[..., :-1], x[..., -1]
    if spec.edge_kernel and g.device.type == "cuda":
        n = spec.n
        out = torch.empty(x.shape[:-1] + (sum(lam_sizes(spec)),), dtype=g.dtype,
                          device=g.device)
        _el_ops.edge_laplacian_blocks(g, lam, S, T, y, out)
        if spec.hetero:
            _hetero_rows(spec, out, g, X[4], X[5], X[6])
        return out
    L = _L_of_g(spec, g)
    lam_I = lam[..., None, None] * spec.I
    blocks = [(L - lam_I + S).flatten(-2), (L + lam_I + T).flatten(-2),
              torch.diagonal(L, dim1=-2, dim2=-1) + y]
    if spec.hetero:
        z, nu, s = X[4], X[5], X[6]
        r4 = z @ spec.M.T
        if not spec.equality:
            r4 = r4 + s
        blocks += [r4, g - z + nu]
    return torch.cat(blocks, dim=-1)


def _hetero_rows(spec: ProblemSpec, out: torch.Tensor, g, z, nu, s) -> None:
    """Write A_op's heterogeneous rows ``M·z (+ s)`` and ``g − z + ν`` into
    their slices of ``out`` (..., K), each by one product or op for the
    batch (the same torch ops as the composition in :func:`A_op`)."""
    o, q, m = 2 * spec.n * spec.n + spec.n, spec.q, spec.m
    rows = out.view(-1, out.shape[-1])
    r4 = torch.matmul(z.reshape(-1, m), spec.M.T, out=rows[:, o:o + q])
    if not spec.equality:
        r4.add_(s.reshape(-1, q))
    torch.sub(g.reshape(-1, m), z.reshape(-1, m), out=rows[:, o + q:]).add_(nu.reshape(-1, m))


def AT_op(spec: ProblemSpec, lamv: torch.Tensor) -> tuple:
    """Adjoint of :func:`A_op`: flat constraint-space tensor (..., K) →
    X-space. The x-part ``[quadform(P + Q) + (w_i + w_j) (+ v), −tr P +
    tr Q]`` is one ``edge_adjoint`` launch for the batch with
    ``spec.edge_kernel`` on a CUDA tensor; the P, w and Q blocks are views
    of ``lamv``."""
    blocks = split_lam(spec, lamv)
    P, Q, w = blocks[:3]
    v = blocks[4] if spec.hetero else None
    adjoint = _el_ops.edge_adjoint if spec.edge_kernel else _el_ops.edge_adjoint_plain
    x_adj = adjoint(P, Q, w, v)
    if not spec.hetero:
        return (x_adj, P, w, Q)
    u = blocks[3]
    z_adj = u @ spec.M - v
    s_adj = torch.zeros_like(u) if spec.equality else u
    return (x_adj, P, w, Q, z_adj, v, s_adj)


def schur_matvec(spec: ProblemSpec, lamv: torch.Tensor) -> torch.Tensor:
    """The CG matvec A·Aᵀλ = ``A_op(AT_op(λ))`` of each row of ``lamv``
    (..., K). With ``spec.edge_kernel`` the three dense blocks of the whole
    batch come from one ``edge_schur_matvec`` launch (on a CUDA tensor; its
    plain version, the composition, on the CPU); the heterogeneous rows
    ``M·z + s`` and ``g − z + ν`` of the adjoint (z = Mᵀu − v, s = u or 0,
    ν = v, g the adjoint's edge part, which the kernel writes beside) go to
    slices of the same output by the torch ops of :func:`A_op`."""
    if not spec.edge_kernel:
        return A_op(spec, AT_op(spec, lamv))
    blocks = split_lam(spec, lamv)
    P, Q, w = blocks[:3]
    out = torch.empty_like(lamv)
    if not spec.hetero:
        return _el_ops.edge_schur_matvec(P, Q, w, out)
    u, v = blocks[3], blocks[4]
    x_adj = lamv.new_empty(lamv.shape[:-1] + (spec.m + 1,))
    _el_ops.edge_schur_matvec(P, Q, w, out, v=v, x_adj=x_adj)
    _hetero_rows(spec, out, x_adj[..., :-1], u @ spec.M - v, v, u)
    return out


def b_rhs(spec: ProblemSpec) -> torch.Tensor:
    """Right-hand side b of A X = b, flat (K,), shared by every instance."""
    blocks = [(-spec.B0).reshape(-1), (2.0 * spec.I).reshape(-1),
              torch.ones(spec.n, dtype=spec.B0.dtype, device=spec.B0.device)]
    if spec.hetero:
        blocks += [spec.e_cap, torch.zeros(spec.m, dtype=spec.B0.dtype,
                                           device=spec.B0.device)]
    return torch.cat(blocks)


# =========================================================================
# The unified ADMM step (Alg. 2 lines 5–8 / 12–15)
# =========================================================================

def _per_row(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim or per-instance tensor (``spec.rho``, a flag) shaped to
    broadcast against the block ``like``."""
    if t.dim() == 0:
        return t
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def _project_blocks(spec: ProblemSpec, U: tuple) -> tuple:
    """Y-update (Eq. 24 / Eq. 30): per-block Euclidean projections, each
    instance at its own budget. The two PSD projections (S₁ ≼ 0, T₁ ≽ 0)
    of every instance share one batched eigh."""
    m = spec.m
    x1 = torch.cat([proj_card_nonneg(U[0][..., :m], spec.r, spec.edge_ok),
                    torch.clamp_min(U[0][..., m:], 0.0)], dim=-1)
    if spec.psd_backend == "newton_schulz":
        S1 = proj_psd_ns(U[1], -1.0, spec.psd_iters)
        T1 = proj_psd_ns(U[3], +1.0, spec.psd_iters)
    else:
        Msym = torch.stack([U[1], U[3]], dim=-3)
        Msym = (Msym + Msym.transpose(-1, -2)) / 2.0
        S1, T1 = _eigh_clip(Msym, (False, True)).unbind(-3)    # S₁ ≼ 0, T₁ ≽ 0
    y1 = torch.clamp_min(U[2], 0.0)
    if not spec.hetero:
        return (x1, S1, y1, T1)
    z1 = proj_binary_topr(U[4], spec.r, spec.edge_ok)
    nu1 = torch.clamp_min(U[5], 0.0)
    s1 = torch.zeros_like(U[6]) if spec.equality else torch.clamp_min(U[6], 0.0)
    return (x1, S1, y1, T1, z1, nu1, s1)


def _xstep_target(spec: ProblemSpec, Y: tuple, D: tuple) -> tuple:
    """V = Y − (D + c·e₀)/ρ for the X-update (Eq. 27 / 31)."""
    V = [y1 - d / _per_row(spec.rho, d) for y1, d in zip(Y, D)]
    V[0] = V[0] - spec.c / _per_row(spec.rho, V[0])
    if spec.hetero and spec.equality:
        V[6] = torch.zeros_like(V[6])
    return tuple(V)


def _cg_tolerance(spec: ProblemSpec, prev_res: torch.Tensor):
    """Per-iteration relative CG tolerance: ``cg_tol`` floored at what the
    spec dtype resolves, or in inexact mode η·√(previous residual) clipped
    to [floored cg_tol, cap] per instance (the first iteration, res = ∞,
    starts at cap)."""
    floor = FP32_TOL_FLOOR if spec.dtype == "float32" else 0.0
    tol0 = max(spec.cg_tol, floor)
    if not spec.cg_inexact:
        return tol0
    cap = max(INEXACT_CAP, tol0)
    return torch.clamp(INEXACT_ETA * torch.sqrt(prev_res), tol0, cap)


def step(spec: ProblemSpec, state: ADMMState, backend: str = "schur_cg"):
    """One ADMM iteration of every instance: Y-projection, X-step KKT solve
    by ``backend`` (``schur_cg``: CG on the Schur complement;
    ``kkt_bicgstab``: Bi-CGSTAB on the KKT system, which leaves
    ``state.cg`` as it is, as the reference does), dual update. Returns
    ``(new_state, squared primal residual)``, the residual float64, one
    per instance."""
    lead = state.X[0].dim() - 1
    U = tuple(x + d / _per_row(spec.rho, d) for x, d in zip(state.X, state.D))
    Y = _project_blocks(spec, U)
    V = _xstep_target(spec, Y, state.D)
    lam0 = torch.cat([blk.flatten(lead) for blk in state.lam], dim=-1)
    tol = _cg_tolerance(spec, state.res)
    if backend == "schur_cg":
        Xn, lam, cg_it = pcg_solve(partial(A_op, spec), partial(AT_op, spec), V,
                                   b_rhs(spec), lam0, jd=spec.jd, tol=tol,
                                   maxiter=spec.cg_maxiter,
                                   matvec=partial(schur_matvec, spec))
    elif backend == "kkt_bicgstab":
        Xn, lam = kkt_bicgstab_solve(partial(A_op, spec), partial(AT_op, spec), V,
                                     b_rhs(spec), state.X, lam0, tol=tol,
                                     maxiter=spec.cg_maxiter)
        cg_it = 0
    else:
        raise ValueError(f"unknown device backend {backend!r}")
    if spec.hetero and spec.equality:
        Xn = Xn[:6] + (torch.zeros_like(Xn[6]),)
    D = tuple(d + _per_row(spec.rho, d) * (xn - y1) for d, xn, y1 in zip(state.D, Xn, Y))
    res = None
    for xn, y1 in zip(Xn, Y):
        part = torch.sum((xn - y1).to(torch.float64) ** 2, dim=tuple(range(lead, xn.dim())))
        res = part if res is None else res + part
    return ADMMState(X=Xn, Y=Y, D=D, lam=split_lam(spec, lam), res=res,
                     cg=state.cg + cg_it), res


def init_state(spec: ProblemSpec, g, lam0, z=None) -> ADMMState:
    """Initial iterates from warm starts: ``g`` (B, m), ``lam0`` (B,) and
    ``z`` (B, m) give a batch of B; ``g`` (m,) with a scalar ``lam0`` one
    iterate without the batch axis."""
    n, m = spec.n, spec.m
    dt, dev = getattr(torch, spec.dtype), spec.I.device
    g = torch.as_tensor(g, dtype=dt, device=dev)
    lam0 = torch.as_tensor(lam0, dtype=dt, device=dev)
    lead = tuple(g.shape[:-1])
    x = torch.cat([g, lam0[..., None]], dim=-1)
    L = _L_of_g(spec, g)
    lam_I = lam0[..., None, None] * spec.I
    S = -(L - lam_I + spec.B0)
    T = 2 * spec.I - (L + lam_I)
    y = 1.0 - torch.diagonal(L, dim1=-2, dim2=-1)
    res0 = torch.full(lead, math.inf, dtype=torch.float64, device=dev)
    cg0 = torch.zeros(lead, dtype=torch.int32, device=dev)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    if not spec.hetero:
        X = (x, S, y, T)
        D = (zeros(m + 1), zeros(n, n), zeros(n), zeros(n, n))
        lam = (zeros(n, n), zeros(n, n), zeros(n))
        return ADMMState(X=X, Y=X, D=D, lam=lam, res=res0, cg=cg0)
    q = spec.q
    z = (g > 0).to(dt) if z is None else torch.as_tensor(z, dtype=dt, device=dev)
    nu = z - g
    s = zeros(q) if spec.equality else torch.clamp_min(spec.e_cap - z @ spec.M.T, 0.0)
    X = (x, S, y, T, z, nu, s)
    D = (zeros(m + 1), zeros(n, n), zeros(n), zeros(n, n), zeros(m), zeros(m), zeros(q))
    lam = (zeros(n, n), zeros(n, n), zeros(n), zeros(q), zeros(m))
    return ADMMState(X=X, Y=X, D=D, lam=lam, res=res0, cg=cg0)


# =========================================================================
# Drivers
# =========================================================================

SOLVERS = ("schur_cg", "kkt_bicgstab", "kkt_bicgstab_ilu")


def check_solver(cfg: ADMMConfig) -> None:
    """Raise ``ValueError`` for an unknown driver or X-step backend."""
    if cfg.driver not in ("scan", "python"):
        raise ValueError(f"unknown driver {cfg.driver!r}; expected 'scan' or 'python'")
    if cfg.solver not in SOLVERS:
        raise ValueError(f"unknown solver {cfg.solver!r}; expected one of {SOLVERS}")


def _select(done: torch.Tensor, old: ADMMState, new: ADMMState) -> ADMMState:
    """``old`` where ``done`` (one flag per instance), ``new`` elsewhere,
    on every leaf."""
    def sel(a, b):
        return torch.where(_per_row(done, a), a, b)

    return ADMMState(*(tuple(sel(a, b) for a, b in zip(fa, fb))
                       for fa, fb in zip((old.X, old.Y, old.D, old.lam),
                                         (new.X, new.Y, new.D, new.lam))),
                     res=sel(old.res, new.res), cg=sel(old.cg, new.cg))


def _run_batch(spec: ProblemSpec, state: ADMMState, cfg: ADMMConfig) -> list[ADMMResult]:
    """The chunked driver over a batch (every leaf of ``state`` carries the
    instance axis B): chunks of ``check_every`` steps (the last shortened so
    that at most ``max_iters`` steps run), all instances in each step, and
    one host read of (residual, λ̃, done) for the whole batch per chunk. An
    instance is done after the chunk whose residual is below ``eps`` or,
    with ``abort_nonfinite``, not finite; from then on every leaf of it,
    its residual and its count are frozen, and its history (one (it, res,
    λ̃) entry per chunk it ran) stops. The loop ends when every instance is
    done or ``max_iters`` steps have run. Every step runs ``cfg.solver``, a
    device backend; ``cfg.driver`` is not read (a batch always runs this
    driver, as the reference's vmapped scan does)."""
    check_solver(cfg)
    B = int(state.X[0].shape[0])
    dev = state.X[0].device
    chunk = min(cfg.check_every, cfg.max_iters)
    n_chunks = -(-cfg.max_iters // chunk)
    its, ress = [0] * B, [math.inf] * B
    histories: list[list] = [[] for _ in range(B)]
    done_host = [False] * B
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for c in range(n_chunks):
        clen = chunk if c < n_chunks - 1 else cfg.max_iters - chunk * (n_chunks - 1)
        new = state
        for _ in range(clen):
            new, _ = step(spec, new, cfg.solver)
        state = _select(done, state, new) if any(done_host) else new
        now = state.res < cfg.eps
        if cfg.abort_nonfinite:
            now |= ~torch.isfinite(state.res)
        done = done | now
        res_l, lam_l, done_l = torch.stack(
            [state.res, state.X[0][:, -1].to(torch.float64), done.to(torch.float64)]).tolist()
        for b in range(B):
            if done_host[b]:
                continue
            its[b] += clen
            ress[b] = res_l[b]
            histories[b].append((its[b], res_l[b], lam_l[b]))
            if cfg.verbose:
                tag = "admm-het" if spec.hetero else "admm-homo"
                pre = f"[{tag}{'' if B == 1 else f' {b}'}]"
                print(f"{pre} it={its[b]} res={res_l[b]:.3e} lam~={lam_l[b]:.4f}")
        done_host = [bool(d) for d in done_l]
        if all(done_host):
            break
    m = spec.m
    x, x1 = state.X[0].cpu().numpy(), state.Y[0].cpu().numpy()
    z = state.Y[4].cpu().numpy() if spec.hetero else None
    cg = state.cg.tolist()
    return [ADMMResult(g=x1[b, :m], g_raw=x[b, :m], lam_tilde=float(x1[b, m]),
                       z=None if z is None else z[b], iters=its[b], residual=float(ress[b]),
                       history=histories[b], cg_iters=int(cg[b])) for b in range(B)]


def solve_spec(spec: ProblemSpec, state0: ADMMState, cfg: ADMMConfig) -> ADMMResult:
    """One solve from ``state0`` (an iterate without the batch axis): the
    batch driver of :func:`solve_batched_spec` at B = 1."""
    return _run_batch(spec, state0.map(lambda t: t[None]), cfg)[0]


def solve_batched_spec(spec: ProblemSpec, states: ADMMState,
                       cfg: ADMMConfig) -> list[ADMMResult]:
    """Batched restarts: ``states`` has the instance axis on every leaf;
    every step and every host read serves the whole batch. One result per
    instance."""
    return _run_batch(spec, states, cfg)


def solve_sweep_spec(spec: ProblemSpec, rs, states: ADMMState, cfg: ADMMConfig,
                     rhos=None) -> list[ADMMResult]:
    """Sweep over problem axes: instance k solves the problem with budget
    ``rs[k]`` (and penalty ``rhos[k]``, default ``spec.rho``) from warm
    start k of ``states``, all in one batch on ``spec``'s shape (one n)."""
    dev = spec.I.device
    rs_t = torch.as_tensor(np.asarray(rs), dtype=torch.int64, device=dev)
    rhos_t = (spec.rho.expand(rs_t.shape) if rhos is None
              else torch.as_tensor(np.asarray(rhos), dtype=getattr(torch, spec.dtype),
                                   device=dev))
    return _run_batch(spec.replace(r=rs_t, rho=rhos_t), states, cfg)


def _result_from(spec: ProblemSpec, state: ADMMState, iters: int, residual: float,
                 history: list) -> ADMMResult:
    """The result of one solve from its final iterate (no batch axis)."""
    m = spec.m
    x, x1 = state.X[0].cpu().numpy(), state.Y[0].cpu().numpy()
    return ADMMResult(g=x1[:m], g_raw=x[:m], lam_tilde=float(x1[m]),
                      z=state.Y[4].cpu().numpy() if spec.hetero else None, iters=iters,
                      residual=float(residual), history=history, cg_iters=int(state.cg))


def solve_python(spec: ProblemSpec, state0: ADMMState, cfg: ADMMConfig, step_fn=None,
                 reuse_jit: bool = True) -> ADMMResult:
    """The reference's per-iteration host driver: one step and one host
    read of the residual an iteration, from ``state0`` (an iterate without
    the batch axis). History (it, res, λ̃) at ``it == 1`` and every
    ``check_every``; it stops below ``eps`` or, with ``abort_nonfinite``, on
    a non-finite residual. ``step_fn`` (``state → (state, res)``, default
    :func:`step` with ``cfg.solver``) carries the host-side ILU step.
    ``reuse_jit`` is accepted for the reference's signature and means
    nothing here: eager PyTorch compiles nothing per solve."""
    del reuse_jit
    check_solver(cfg)
    if step_fn is None:
        step_fn = partial(step, spec, backend=cfg.solver)
    state, history, res = state0, [], math.inf
    it = 0
    for it in range(1, cfg.max_iters + 1):
        state, res_t = step_fn(state)
        if it % cfg.check_every == 0 or it == 1:
            res, lam = torch.stack([res_t, state.X[0][-1].to(torch.float64)]).tolist()
            history.append((it, res, lam))
            if cfg.verbose:
                tag = "admm-het" if spec.hetero else "admm-homo"
                print(f"[{tag}] it={it} res={res:.3e} lam~={lam:.4f}")
        else:
            res = float(res_t)
        if res < cfg.eps:
            break
        if cfg.abort_nonfinite and not math.isfinite(res):
            break  # a poisoned state never recovers (core.guard classifies it)
    return _result_from(spec, state, it, res, history)


# =========================================================================
# The host-side ILU backend (the paper's §V-C) — homogeneous problem
# =========================================================================

def build_sparse_A(n: int, m: int, edges):
    """The homogeneous constraint operator A (Nc × Nx) as a scipy CSC
    matrix for the ILU-preconditioned KKT backend; the matrix blocks are
    vectorized column-major, as in the reference."""
    import scipy.sparse as sp

    rows, cols, vals = [], [], []

    def vecidx(i, j):  # column-major vec
        return i + j * n

    # B̃⁻ / B̃⁺ blocks (n² rows each) acting on x = [g; λ̃]
    for l, (i, j) in enumerate(edges):
        for (a, b2, v) in ((i, i, 1.0), (j, j, 1.0), (i, j, -1.0), (j, i, -1.0)):
            rows.append(vecidx(a, b2))
            cols.append(l)
            vals.append(v)
            rows.append(n * n + vecidx(a, b2))
            cols.append(l)
            vals.append(v)
    for i in range(n):
        rows.append(vecidx(i, i))
        cols.append(m)
        vals.append(-1.0)
        rows.append(n * n + vecidx(i, i))
        cols.append(m)
        vals.append(1.0)
    # the D block: the rows of diag(L)
    for l, (i, j) in enumerate(edges):
        rows.append(2 * n * n + i)
        cols.append(l)
        vals.append(1.0)
        rows.append(2 * n * n + j)
        cols.append(l)
        vals.append(1.0)
    Nx = m + 1 + n * n + n + n * n
    Nc = 2 * n * n + n
    Ax = sp.csr_matrix(sp.coo_matrix((vals, (rows, cols)), shape=(Nc, m + 1)))
    nn = n * n
    A = sp.bmat([
        [Ax[:nn, :], sp.eye(nn), sp.coo_matrix((nn, n)), sp.coo_matrix((nn, nn))],
        [Ax[nn:2 * nn, :], sp.coo_matrix((nn, nn)), sp.coo_matrix((nn, n)), sp.eye(nn)],
        [Ax[2 * nn:, :], sp.coo_matrix((n, nn)), sp.eye(n), sp.coo_matrix((n, nn))],
    ], format="csc")
    assert A.shape == (Nc, Nx)
    return A


def _pack_homo(X: tuple) -> torch.Tensor:
    """(x, S, y, T) as one flat vector, S and T column-major, on X's device."""
    x, S, y, T = X
    return torch.cat([x, S.t().reshape(-1), y, T.t().reshape(-1)])


def _unpack_homo(n: int, m: int, v: torch.Tensor) -> tuple:
    """Inverse of :func:`_pack_homo`."""
    x, S, y, T = torch.split(v, (m + 1, n * n, n, n * n))
    return (x, S.view(n, n).t().contiguous(), y, T.view(n, n).t().contiguous())


def make_ilu_step(spec: ProblemSpec, ilu: ILUKKTSolver | None = None):
    """The host-side ILU step behind the ``(state) → (state, res)``
    interface of :func:`step`, for an iterate without the batch axis. The
    Y-projection and the X-step target run on the spec's device; the
    packed target V makes one copy to the host for scipy's solve and the
    solution one copy back. Homogeneous problem in float64 only. The
    solver (``step.ilu``) counts its direct-solve fallbacks."""
    if spec.hetero:
        raise ValueError("the ILU backend supports the homogeneous problem only")
    if spec.dtype != "float64":
        raise ValueError("the scipy-ILU backend requires dtype='float64'")
    if ilu is None:
        ilu = ILUKKTSolver(build_sparse_A(spec.n, spec.m, all_edges(spec.n)))
    n, m = spec.n, spec.m
    ones = torch.ones(n, dtype=spec.B0.dtype, device=spec.B0.device)
    bp = torch.cat([(-spec.B0).t().reshape(-1), (2.0 * spec.I).t().reshape(-1),
                    ones]).cpu().numpy()
    rho = spec.rho

    def step_ilu(state: ADMMState):
        U = tuple(x + d / rho for x, d in zip(state.X, state.D))
        Y = _project_blocks(spec, U)
        V = _xstep_target(spec, Y, state.D)
        Xv, _ = ilu.solve(_pack_homo(V).cpu().numpy(), bp, tol=spec.cg_tol)
        Xn = _unpack_homo(n, m, torch.tensor(Xv, device=spec.I.device))
        D = tuple(d + rho * (xn - y1) for d, xn, y1 in zip(state.D, Xn, Y))
        res = sum(torch.sum((xn - y1).to(torch.float64) ** 2) for xn, y1 in zip(Xn, Y))
        return ADMMState(X=Xn, Y=Y, D=D, lam=state.lam, res=res, cg=state.cg), res

    step_ilu.ilu = ilu
    return step_ilu
