"""Linear-system backend for the ADMM X-step (§V-C), in PyTorch.

The X-step solves the KKT system (Eq. 27 / 31):

    [[I, Aᵀ], [A, 0]] [X; λ] = [V; b]        ⇔    X = V − Aᵀλ,  (A Aᵀ) λ = A V − b

``pcg_solve`` is the port of ``repro.core.linalg.pcg_solve``: matrix-free
preconditioned CG on the SPD Schur complement A Aᵀ, with float64 inner
products whatever the operands' dtype (the reference's ``_tdot``) and a
relative tolerance that may be a tensor (the inexact-ADMM schedule).

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

The ``kkt_bicgstab`` and scipy-ILU backends are not ported yet (ROADMAP.md
Queue 1 item 2).
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pcg_solve", "CG_CHECK_EVERY"]

#: CG iterations between two host reads of the convergence flag.
CG_CHECK_EVERY = 8


def _tdot(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
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
    within it."""
    a = a.to(torch.float64)
    b = a if b is None else b.to(torch.float64)
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
):
    """Solve X = V − Aᵀλ with (A Aᵀ)λ = A V − b via preconditioned CG.

    ``A_op`` maps an X-space tuple to a flat constraint-space tensor
    (K,) or (B, K) (one row per instance) and ``AT_op`` back. ``matvec``
    maps a flat constraint-space tensor to A Aᵀ of it (default
    ``A_op(AT_op(·))``; the engine passes its one-launch form). ``jd``:
    flat diag(A Aᵀ) for Jacobi preconditioning, or None. ``tol`` is a
    relative residual tolerance (a float or a float64 tensor, one per
    instance). Each instance stops when ‖r‖ ≤ tol·‖rhs‖ or after
    ``maxiter`` iterations.

    Returns ``(X, λ, iters)`` with ``iters`` int32, one per instance.
    """
    if matvec is None:
        def matvec(lam):
            return A_op(AT_op(lam))

    def precond(r):
        return r if jd is None else r / jd

    rhs = A_op(V) - b
    bb = _tdot(rhs)
    r = rhs - matvec(lam0)
    z = precond(r)
    rz = _tdot(r, z)
    rr = _tdot(r)
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
        if it % CG_CHECK_EVERY == 0 and not bool(active if active.numel() == 1
                                                  else active.any()):
            break
        Ap = matvec(p)
        alpha = rz / _tdot(p, Ap)
        x_n = _axpy(alpha, x, p)
        r_n = _axpy(-alpha, r, Ap)
        z_n = precond(r_n)
        rz_n = _tdot(r_n, z_n)
        p_n = _axpy(rz_n / rz, z_n, p)  # p ← z + beta·p
        rr_n = _tdot(r_n)
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
