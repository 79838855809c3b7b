"""Linear-system backends for the ADMM X-step (§V-C), in PyTorch.

The X-step solves the KKT system (Eq. 27 / 31):

    [[I, Aᵀ], [A, 0]] [X; λ] = [V; b]        ⇔    X = V − Aᵀλ,  (A Aᵀ) λ = A V − b

Backends, as in ``repro.core.linalg``:
  - ``pcg_solve`` (default): matrix-free preconditioned CG on the SPD
    Schur complement A Aᵀ, with float64 inner products whatever the
    operands' dtype (the reference's ``_tdot``) and a relative tolerance
    that may be a tensor (the inexact-ADMM schedule);
  - ``schur_cg_solve``: the same CG without a preconditioner, returning
    ``(X, λ)`` (the reference's wrapper over ``jax.scipy``'s ``cg``);
  - ``kkt_bicgstab_solve``: matrix-free Bi-CGSTAB on the indefinite KKT
    system, step for step ``jax.scipy.sparse.linalg.bicgstab``;
  - ``ILUKKTSolver``: the paper's §V-C solver, the sparse KKT matrix
    assembled once with an ILU preconditioner for scipy's Bi-CGSTAB, on the
    host (a copy of the reference's).

Constraint-space vectors (λ, b, A V) are ONE flat tensor here, where the
reference keeps a tuple of blocks: an inner product, an axpy or a freeze is
then one launch instead of one per block. A leading instance axis (the
batched ADMM's) makes them (B, K): every scalar of the iteration (α, ⟨r, z⟩,
‖r‖², the tolerance, the count) is then one per instance, and each
instance freezes on its own, as the reference's ``while_loop`` does under
``vmap``.

The reference stops its ``lax.while_loop`` on ‖r‖² ≤ tol²‖b‖²; testing that
in eager PyTorch costs one host sync per iteration. This loop instead
freezes a converged iterate with ``torch.where`` (the semantics of a
vmapped ``while_loop``) and reads whether any instance is still active
once every ``CG_CHECK_EVERY`` iterations, one read for the whole batch, so
each returned iterate and count equal exact stopping with
``CG_CHECK_EVERY``× fewer syncs.

``kkt_bicgstab_solve`` keeps its whole (X, λ) iterate as one flat tensor
(lead + (Nx + K,)), X's blocks as views of it, so each of its dots and
axpys is one launch; its stopping test runs on the device the same way.
Its dots are taken in the operands' dtype, as ``jax.scipy``'s are (float32
under the pipeline's default spec; see ``kkt_bicgstab_solve``).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

__all__ = ["pcg_solve", "schur_cg_solve", "kkt_bicgstab_solve", "ILUKKTSolver",
           "CG_CHECK_EVERY"]

#: CG iterations between two host reads of the convergence flag.
CG_CHECK_EVERY = 8


def _tdot(a: torch.Tensor, b: torch.Tensor | None = None,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Inner product ⟨a, b⟩ (⟨a, a⟩ when ``b`` is None) of a vector (K,), or
    of each row of a batch (B, K) as a (B, 1) column, accumulated in float64
    (stable fp32-mode CG).

    One row (a vector, or a batch of one) takes ``torch.dot``, the single
    solves' order from the start (the exact-mode CG stops at the float64
    floor of its residual, where another order moves the count); its 0-dim
    result broadcasts as the column would. A batch on the card is one
    ``bmm`` of (B, 1, K) by (B, K, 1): one launch, as ``torch.dot`` is. A
    batch on the CPU, where a launch costs nothing, takes the product and a
    row sum: with the CPU ``bmm`` the heterogeneous BCube(4, 2) batch of
    ``tests/test_torch_batched.py`` took 5,356 CG iterations against the
    JAX package's 5,295 (1.15 %, over the test's 1 %), with the row sum
    within it. ``dtype`` is the accumulation dtype (Bi-CGSTAB passes the
    operands' own)."""
    a = a.to(dtype)
    b = a if b is None else b.to(dtype)
    if a.dim() == 1:
        return torch.dot(a, b)
    if a.shape[0] == 1:
        return torch.dot(a.view(-1), b.view(-1))
    if a.is_cuda:
        return torch.bmm(a.unsqueeze(1), b.unsqueeze(2))[:, 0]
    return (a * b).sum(-1, keepdim=True)


def _axpy(alpha: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + alpha·y with the float64 scalar (or column, one per row) cast to
    x's dtype first (no float64 upcast of a float32 vector)."""
    return x + alpha.to(x.dtype) * y


def pcg_solve(
    A_op: Callable,
    AT_op: Callable,
    V: tuple,
    b: torch.Tensor,
    lam0: torch.Tensor,
    jd: torch.Tensor | None = None,
    tol=1e-10,
    maxiter: int = 2000,
    matvec: Callable | None = None,
    dot: Callable | None = None,
    any_active: Callable | None = None,
):
    """Solve X = V − Aᵀλ with (A Aᵀ)λ = A V − b via preconditioned CG.

    ``A_op`` maps an X-space tuple to a flat constraint-space tensor
    (K,) or (B, K) (one row per instance) and ``AT_op`` back. ``matvec``
    maps a flat constraint-space tensor to A Aᵀ of it (default
    ``A_op(AT_op(·))``; the engine passes its one-launch form). ``jd``:
    flat diag(A Aᵀ) for Jacobi preconditioning, or None. ``tol`` is a
    relative residual tolerance (a float or a float64 tensor, one per
    instance). Each instance stops when ‖r‖ ≤ tol·‖rhs‖ or after
    ``maxiter`` iterations. ``dot`` (default the float64 ``_tdot``) and
    ``any_active`` (the host read of "some instance still iterates" from
    the device flags, default a local read) are the edge-partitioned
    solver's hooks: its dots span the ranks, and every rank has to leave
    the loop at the same iteration.

    Returns ``(X, λ, iters)`` with ``iters`` int32, one per instance.
    """
    if matvec is None:
        def matvec(lam):
            return A_op(AT_op(lam))

    def precond(r):
        return r if jd is None else r / jd

    if dot is None:
        dot = _tdot
    if any_active is None:
        def any_active(active):
            return bool(active if active.numel() == 1 else active.any())

    rhs = A_op(V) - b
    bb = dot(rhs)
    r = rhs - matvec(lam0)
    z = precond(r)
    rz = dot(r, z)
    rr = dot(r)
    lead = lam0.shape[:-1]
    tol = torch.as_tensor(tol, dtype=torch.float64, device=bb.device)
    tol2bb = tol.reshape(tol.shape + (1,) * (tol.dim() > 0)) ** 2 * bb
    x, p = lam0, z
    # the scalars are (B, 1) columns (0-dim for one row), so they broadcast
    # against the (B, K) vectors as they are
    k = torch.zeros(lead + (1,), dtype=torch.int32, device=bb.device)
    it = 0
    while True:
        active = (rr > tol2bb) & (k < maxiter)
        if it % CG_CHECK_EVERY == 0 and not any_active(active):
            break
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x_n = _axpy(alpha, x, p)
        r_n = _axpy(-alpha, r, Ap)
        z_n = precond(r_n)
        rz_n = dot(r_n, z_n)
        p_n = _axpy(rz_n / rz, z_n, p)  # p ← z + beta·p
        rr_n = dot(r_n)
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        z = r if jd is None else torch.where(active, z_n, z)
        p = torch.where(active, p_n, p)
        rr = torch.where(active, rr_n, rr)
        rz = torch.where(active, rz_n, rz)
        k = k + active.to(torch.int32)
        it += 1
    X = tuple(v - a for v, a in zip(V, AT_op(x)))
    return X, x, k.reshape(lead)


def schur_cg_solve(A_op: Callable, AT_op: Callable, V: tuple, b: torch.Tensor,
                   lam0: torch.Tensor, tol=1e-10, maxiter: int = 2000):
    """Solve X = V − Aᵀλ with (A Aᵀ)λ = A V − b by CG without a
    preconditioner. Returns ``(X, λ)``: :func:`pcg_solve` with ``jd=None``,
    whose iteration is ``jax.scipy``'s ``cg`` (the same stopping rule
    ‖r‖² ≤ tol²‖rhs‖², its dots in float64)."""
    X, lam, _ = pcg_solve(A_op, AT_op, V, b, lam0, tol=tol, maxiter=maxiter)
    return X, lam


def kkt_bicgstab_solve(A_op: Callable, AT_op: Callable, V: tuple, b: torch.Tensor,
                       X0: tuple, lam0: torch.Tensor, tol=1e-10, maxiter: int = 4000):
    """Matrix-free Bi-CGSTAB on [[I, Aᵀ], [A, 0]] [X; λ] = [V; b].

    ``jax.scipy.sparse.linalg.bicgstab`` (jax 0.9.0, ``_bicgstab_solve``)
    step for step: without a preconditioner, the recurrences for ρ, α, ω
    and β, the early exit when ‖s‖² < atol2, the stop codes k = −10 on
    ρ = 0 and k = −11 on ω = 0 or α = 0, and atol2 = max(tol²·‖b‖², 0)
    with the norms over the whole (X, λ) pair. Its dots are taken in the
    operands' dtype, as JAX's ``_vdot_real_tree`` takes them.

    ``V`` and ``X0`` are X-space tuples, ``b`` and ``lam0`` flat
    constraint-space tensors; a leading instance axis (B, ...) on ``V``,
    ``X0`` and ``lam0`` gives one solve per instance (``b`` is shared or
    (B, K)): every scalar is then one per instance and each instance stops
    on its own, the semantics of JAX's ``while_loop`` under ``vmap``.
    ``tol`` is a float or a float64 tensor, one per instance. The flag
    "any instance still iterating" is read once every ``CG_CHECK_EVERY``
    iterations. Each matvec is ``(X + AT_op(λ), A_op(X))``: two of each
    operator an iteration.

    Returns ``(X, λ)``.
    """
    lead = tuple(lam0.shape[:-1])
    nl = len(lead)
    shapes = [tuple(x.shape[nl:]) for x in X0]
    sizes = [math.prod(s) for s in shapes]
    nx = sum(sizes)

    def pack(X, lam):
        return torch.cat([x.reshape(lead + (-1,)) for x in X] + [lam], dim=-1)

    def unpack_x(z):
        parts = torch.split(z[..., :nx], sizes, dim=-1)
        return tuple(p.view(lead + s) for p, s in zip(parts, shapes))

    def matvec(z):
        X = unpack_x(z)
        top = [x + a for x, a in zip(X, AT_op(z[..., nx:]))]
        return pack(top, A_op(X))

    rhs = pack(V, b.expand(lead + tuple(b.shape[-1:])))
    dt = rhs.dtype

    def dot(a, c):          # in dt, so every scalar below is in dt too
        return _tdot(a, c, dtype=dt)

    bs = dot(rhs, rhs)
    if isinstance(tol, torch.Tensor):      # float64, one per instance
        tol2 = tol.to(torch.float64).reshape(tol.shape + (1,) * (tol.dim() > 0)) ** 2
    else:
        tol2 = torch.tensor(tol * tol, dtype=dt, device=bs.device)
    atol2 = torch.clamp_min(tol2 * bs, 0.0)
    x = pack(X0, lam0)
    r = rhs - matvec(x)
    rhat = r
    one = torch.ones_like(bs)
    alpha, omega, rho = one, one, one
    p = q = r
    rs = dot(r, r)
    k = torch.zeros(bs.shape, dtype=torch.int32, device=bs.device)
    it = 0
    while True:
        active = (rs > atol2) & (k < maxiter) & (k >= 0)
        if it % CG_CHECK_EVERY == 0 and not bool(active if active.numel() == 1
                                                  else active.any()):
            break
        rho_n = dot(rhat, r)
        beta = rho_n / rho * alpha / omega
        p_n = r + beta * (p - omega * q)
        q_n = matvec(p_n)
        alpha_n = rho_n / dot(rhat, q_n)
        s = r - alpha_n * q_n
        exit_early = dot(s, s) < atol2
        t = matvec(s)
        omega_n = dot(t, s) / dot(t, t)
        a_p = alpha_n * p_n
        x_n = torch.where(exit_early, x + a_p, x + (a_p + omega_n * s))
        r_n = torch.where(exit_early, s, s - omega_n * t)
        k_n = torch.where((omega_n == 0) | (alpha_n == 0), -11, k + 1)
        k_n = torch.where(rho_n == 0, -10, k_n).to(torch.int32)
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        alpha = torch.where(active, alpha_n, alpha)
        omega = torch.where(active, omega_n, omega)
        rho = torch.where(active, rho_n, rho)
        p = torch.where(active, p_n, p)
        q = torch.where(active, q_n, q)
        k = torch.where(active, k_n, k)
        rs = dot(r, r)
        it += 1
    return unpack_x(x), x[..., nx:]


class ILUKKTSolver:
    """The paper's §V-C backend, on the host: the sparse KKT matrix
    assembled once, ILU-preconditioned Bi-CGSTAB per ADMM iteration
    (Algorithm 2 lines 3/6 and 12/15). A copy of the reference's, scipy
    alike. ``A_sparse``: a scipy.sparse matrix of the constraint operator A
    (Nc × Nx). When Bi-CGSTAB does not converge, ``solve`` falls back to a
    direct ``spsolve``, as the reference does; ``fallbacks`` counts them."""

    def __init__(self, A_sparse, drop_tol: float = 1e-4, fill_factor: float = 10.0):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        self.sp = sp
        self.spla = spla
        A = sp.csc_matrix(A_sparse)
        Nc, Nx = A.shape
        self.Nx, self.Nc = Nx, Nc
        KKT = sp.bmat([[sp.eye(Nx), A.T], [A, None]], format="csc")
        self.KKT = KKT
        # ILU of the (indefinite) KKT matrix — §V-C: computed once, reused.
        self.ilu = spla.spilu(KKT, drop_tol=drop_tol, fill_factor=fill_factor)
        self.M = spla.LinearOperator(KKT.shape, self.ilu.solve)
        self._last = np.zeros(Nx + Nc)
        self.fallbacks = 0

    def solve(self, V: np.ndarray, b: np.ndarray, tol: float = 1e-10, maxiter: int = 2000):
        rhs = np.concatenate([V, b])
        sol, info = self.spla.bicgstab(
            self.KKT, rhs, x0=self._last, rtol=tol, atol=0.0, maxiter=maxiter, M=self.M
        )
        if info != 0:  # fall back to a direct solve — keeps ADMM robust
            sol = self.spla.spsolve(self.KKT, rhs)
            self.fallbacks += 1
        self._last = sol
        return sol[: self.Nx], sol[self.Nx:]
