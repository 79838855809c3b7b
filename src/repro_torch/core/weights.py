"""Edge-weight assignment schemes for a *fixed* graph support.

- ``metropolis_weights``: the degree-based convention [17] the paper uses for
  intuition-designed baselines.
- ``uniform_neighbor_weights``: W_ij = 1/(d_max+1)-style uniform mixing.
- ``best_constant_weights``: Xiao–Boyd best constant edge weight
  α* = 2/(λ₁(L₁)+λ_{n−1}(L₁)) for unweighted Laplacian L₁ [22].
- ``polish_weights``: projected-subgradient minimization of the *convex*
  objective max(λ_max(L)−1, 1−λ₂(L)) over g ≥ 0 for fixed support — recovers
  the Xiao–Boyd SDP optimum without an SDP solver (beyond-paper; used both to
  polish ADMM output and to give baselines their optimal weights when we want
  a harder comparison).
- ``polish_weights_batched``: the same projected-subgradient loop for every
  candidate support of a solve at once, on the device, in PyTorch.

The numpy functions are copies of ``repro.core.weights``, kept so that the
port never imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .graph import degrees, laplacian_from_weights

__all__ = [
    "metropolis_weights",
    "uniform_neighbor_weights",
    "best_constant_weights",
    "polish_weights",
    "polish_weights_batched",
    "asym_factor_from_g",
]


def metropolis_weights(n: int, edges: list[tuple[int, int]]) -> np.ndarray:
    d = degrees(n, edges)
    return np.array([1.0 / (1.0 + max(d[i], d[j])) for i, j in edges])


def uniform_neighbor_weights(n: int, edges: list[tuple[int, int]]) -> np.ndarray:
    d = degrees(n, edges)
    dmax = int(d.max()) if len(edges) else 0
    return np.full(len(edges), 1.0 / (dmax + 1.0))


def _unweighted_laplacian_eigs(n: int, edges: list[tuple[int, int]]) -> np.ndarray:
    L1 = laplacian_from_weights(n, edges, np.ones(len(edges)))
    return np.linalg.eigvalsh(L1)


def best_constant_weights(n: int, edges: list[tuple[int, int]]) -> np.ndarray:
    ev = _unweighted_laplacian_eigs(n, edges)
    lam_max, lam_2 = ev[-1], ev[1]
    alpha = 2.0 / (lam_max + lam_2)
    return np.full(len(edges), alpha)


def asym_factor_from_g(n: int, edges: list[tuple[int, int]], g: np.ndarray,
                       fast: bool | None = None) -> float:
    """max(λ_max(L)−1, 1−λ₂(L)) — identically r_asym(I−L): both equal
    max_{i≥2} |1 − λ_i(L)| (the extremes of L bound the magnitude max, and
    λ₂ > 1 forces λ_max > 1). Above ``FAST_SPECTRAL_MIN_N`` (or with
    ``fast=True``) the Lanczos largest-magnitude path is used; the
    ``eigvalsh`` path is the exact oracle."""
    from .graph import FAST_SPECTRAL_MIN_N, r_asym_fast

    if fast is None:
        fast = n >= FAST_SPECTRAL_MIN_N
    L = laplacian_from_weights(n, edges, g)
    if fast:
        return r_asym_fast(np.eye(n) - L, symmetric=True)
    ev = np.linalg.eigvalsh(L)
    return float(max(ev[-1] - 1.0, 1.0 - ev[1]))


def polish_weights(
    n: int,
    edges: list[tuple[int, int]],
    g0: np.ndarray | None = None,
    iters: int = 400,
    enforce_diag: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """Projected subgradient descent on f(g) = max(λ_max(L(g))−1, 1−λ₂(L(g))).

    f is convex in g (max of a convex max-eigenvalue term and a concave-negated
    second-smallest-eigenvalue term). Subgradients come from eigenvector outer
    products: ∂λ(L)/∂g_l = (u_i − u_j)² for edge l = {i, j} and eigvec u.
    Projection: g ≥ 0, optionally diag(L) ≤ 1 (scale down if violated) so the
    resulting W = I − L stays entrywise-nonnegative, matching Eq. (9).
    """
    m = len(edges)
    if m == 0:
        return np.zeros(0)
    if g0 is None:
        g0 = best_constant_weights(n, edges)
    g = np.asarray(g0, dtype=np.float64).copy()
    ei = np.array([i for i, _ in edges])
    ej = np.array([j for _, j in edges])

    def project(g: np.ndarray) -> np.ndarray:
        g = np.maximum(g, 0.0)
        if enforce_diag:
            # diag(L)_i = sum of incident weights; scale all down if any exceeds 1
            diag = np.zeros(n)
            np.add.at(diag, ei, g)
            np.add.at(diag, ej, g)
            mx = diag.max() if n else 0.0
            if mx > 1.0:
                g = g / mx
        return g

    g = project(g)
    best_g, best_f = g.copy(), asym_factor_from_g(n, edges, g)
    step0 = 0.05
    for t in range(iters):
        L = laplacian_from_weights(n, edges, g)
        evals, evecs = np.linalg.eigh(L)
        f_max = evals[-1] - 1.0
        f_gap = 1.0 - evals[1]
        if f_max >= f_gap:
            u = evecs[:, -1]
            sub = (u[ei] - u[ej]) ** 2  # ∂(λ_max − 1)
        else:
            u = evecs[:, 1]
            sub = -((u[ei] - u[ej]) ** 2)  # ∂(1 − λ₂)
        f = max(f_max, f_gap)
        if f < best_f:
            best_f, best_g = f, g.copy()
        step = step0 / np.sqrt(1.0 + t)
        nrm = np.linalg.norm(sub)
        if nrm < 1e-14:
            break
        g = project(g - step * sub / nrm)
    return best_g


# =========================================================================
# Device polish: the same projected-subgradient loop for every candidate
# support of a solve, batched on the device (DESIGN.md §10)
# =========================================================================

def _polish_project(g, inc, mask, enforce_diag):
    """g ≥ 0 on real edges (padding pinned to 0); optionally scale each
    candidate down so that diag(L) ≤ 1. ``inc`` is the (B, E, n) 0/1
    edge-node incidence, so diag(L) = g·inc is a deterministic product."""
    g = torch.where(mask, torch.clamp_min(g, 0.0), 0.0)
    if enforce_diag:
        diag = torch.bmm(g.unsqueeze(1), inc).squeeze(1)
        mx = diag.amax(dim=1, keepdim=True)
        g = torch.where(mx > 1.0, g / mx, g)
    return g


def polish_weights_batched(
    n: int,
    edge_lists: list[list[tuple[int, int]]],
    g0s: list[np.ndarray] | None = None,
    iters: int = 400,
    enforce_diag: bool = True,
    dtype: str = "float32",
    device: str = "cuda",
) -> list[np.ndarray]:
    """``polish_weights`` for every candidate support at once on ``device``.

    Candidates are padded to a common edge count with masked zero-weight
    dummy edges (edge (0, 0), weight pinned to 0, subgradient masked). The
    loop and its batched ``eigh`` run in ``dtype`` (float32 by default);
    the objective bookkeeping (best-f comparisons) is float64, as in the
    reference. A candidate whose subgradient vanishes is frozen by
    ``torch.where``, which is the reference's ``done`` flag. L(g) and
    diag(L) are built without atomics, so a run is deterministic.
    """
    B = len(edge_lists)
    if B == 0:
        return []
    if g0s is None:
        g0s = [best_constant_weights(n, e) for e in edge_lists]
    Emax = max(len(e) for e in edge_lists)
    if Emax == 0:
        return [np.zeros(0) for _ in edge_lists]
    dev = resolve_device(device)
    dt = getattr(torch, dtype)
    ei = np.zeros((B, Emax), dtype=np.int64)
    ej = np.zeros((B, Emax), dtype=np.int64)
    mask = np.zeros((B, Emax), dtype=bool)
    g0p = np.zeros((B, Emax), dtype=np.float64)
    for k, (edges, g0) in enumerate(zip(edge_lists, g0s)):
        E = len(edges)
        if E:
            ei[k, :E] = [i for i, _ in edges]
            ej[k, :E] = [j for _, j in edges]
            mask[k, :E] = True
            g0p[k, :E] = np.asarray(g0, dtype=np.float64)
    inc = np.zeros((B, Emax, n))
    b_idx, e_idx = np.nonzero(mask)
    inc[b_idx, e_idx, ei[b_idx, e_idx]] = 1.0
    inc[b_idx, e_idx, ej[b_idx, e_idx]] = 1.0
    inc = torch.as_tensor(inc, dtype=dt, device=dev)
    # flat positions of (i, j) and (j, i) in the (B, n, n) Laplacian stack;
    # padding edges write their pinned 0 to (0, 0)
    base = (np.arange(B, dtype=np.int64) * n * n)[:, None]
    f_ij = torch.as_tensor((base + ei * n + ej).reshape(-1), device=dev)
    f_ji = torch.as_tensor((base + ej * n + ei).reshape(-1), device=dev)
    ei_t = torch.as_tensor(ei, device=dev)
    ej_t = torch.as_tensor(ej, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    g = _polish_project(torch.as_tensor(g0p, device=dev).to(dt), inc, mask_t,
                        enforce_diag)
    best_g = g
    best_f = torch.full((B,), float("inf"), dtype=torch.float64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = 0.05 / torch.sqrt(1.0 + torch.arange(iters, dtype=dt, device=dev))
    for t in range(int(iters)):
        gf = g.reshape(-1)
        G = torch.zeros(B * n * n, dtype=dt, device=dev)
        G.index_put_((f_ij,), gf)
        G.index_put_((f_ji,), gf)
        G = G.view(B, n, n)
        L = torch.diag_embed(G.sum(dim=-1)) - G
        evals, evecs = torch.linalg.eigh(L)
        f_max = evals[:, -1] - 1.0
        f_gap = 1.0 - evals[:, 1]
        use_max = f_max >= f_gap
        u = torch.where(use_max[:, None], evecs[:, :, -1], evecs[:, :, 1])
        diff = torch.gather(u, 1, ei_t) - torch.gather(u, 1, ej_t)
        sub = diff ** 2 * torch.where(use_max, 1.0, -1.0).to(dt)[:, None]
        sub = torch.where(mask_t, sub, 0.0)
        f = torch.maximum(f_max, f_gap).to(torch.float64)
        improved = ~done & (f < best_f)
        best_f = torch.where(improved, f, best_f)
        best_g = torch.where(improved[:, None], g, best_g)
        nrm = torch.sqrt(torch.sum(sub * sub, dim=1, keepdim=True))
        done = done | (nrm[:, 0] < 1e-14)
        g_new = _polish_project(g - steps[t] * sub / torch.clamp_min(nrm, 1e-30),
                                inc, mask_t, enforce_diag)
        g = torch.where(done[:, None], g, g_new)
    best = best_g.to(torch.float64).cpu().numpy()
    return [best[k, : len(edge_lists[k])] for k in range(B)]
