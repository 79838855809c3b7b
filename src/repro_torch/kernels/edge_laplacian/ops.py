"""The ADMM constraint-operator pair: L(g) and the per-edge quadratic form.

Each function has a CUDA kernel (``csrc/edge_laplacian.cu``) and a plain
PyTorch version beside it. The wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises. Each
wrapper counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import build as _build

__all__ = ["edge_laplacian", "edge_quadform", "edge_laplacian_plain",
           "edge_quadform_plain", "packed_edge_index"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_SIGNATURES = {
    **{f"edge_laplacian_{s}": [_P, _P, ctypes.c_int, _P] for s in ("f32", "f64")},
    **{f"edge_quadform_{s}": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
       for s in ("f32", "f64")},
}


@functools.lru_cache(maxsize=16)
def packed_edge_index(n: int, device: str = "cpu") -> torch.Tensor:
    """(n, n) int64 map from (a, b) to the packed index of edge {a, b} in
    ``all_edges(n)`` order; the diagonal maps to the sentinel m (a zero slot
    appended to the weight vector). Callers must not write to it."""
    m = n * (n - 1) // 2
    lidx = np.full((n, n), m, dtype=np.int64)
    iu = np.triu_indices(n, 1)
    lidx[iu] = np.arange(m, dtype=np.int64)
    lidx.T[iu] = np.arange(m, dtype=np.int64)
    return torch.from_numpy(lidx).to(device)


def edge_laplacian_plain(g: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """L = Diag(G·1) − G with G gathered from g through the packed index
    map (the ``lidx`` form of the reference's ``engine._L_of_g``)."""
    g_ext = torch.cat([g, g.new_zeros(1)])
    G = g_ext[lidx]
    return torch.diag(G.sum(dim=1)) - G


def edge_quadform_plain(P: torch.Tensor, ei: torch.Tensor,
                        ej: torch.Tensor) -> torch.Tensor:
    """⟨∂L/∂g_l, P⟩ = P_ii + P_jj − P_ij − P_ji per edge l = {i, j}."""
    return P[ei, ei] + P[ej, ej] - P[ei, ej] - P[ej, ei]


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, "
                         f"not {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what} lies on {t.device}, but the current CUDA "
                         f"device is cuda:{torch.cuda.current_device()}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def edge_laplacian(g: torch.Tensor, n: int) -> torch.Tensor:
    """Laplacian L(g) (n, n) of the complete candidate-edge list.

    ``g``: (m,) edge weights in ``all_edges(n)`` order, m = n(n−1)/2 — the
    kernel derives the packed index analytically, so the edge list must be
    the complete lexicographic one. float32 or float64.
    """
    m = n * (n - 1) // 2
    if g.dim() != 1 or g.shape[0] != m:
        raise ValueError(f"edge_laplacian needs the complete edge list: "
                         f"g has shape {tuple(g.shape)}, n={n} needs ({m},)")
    if g.device.type == "cpu":
        return edge_laplacian_plain(g, packed_edge_index(n, "cpu"))
    _check_cuda(g, "g")
    if g.dtype not in _SUFFIX:
        raise TypeError(f"edge_laplacian takes float32 or float64, not {g.dtype}")
    L = torch.empty((n, n), dtype=g.dtype, device=g.device)
    lib = _build.load("edge_laplacian", _SIGNATURES)
    fn = getattr(lib, f"edge_laplacian_{_SUFFIX[g.dtype]}")
    _raise_on(fn(g.data_ptr(), L.data_ptr(), n,
                 torch.cuda.current_stream().cuda_stream), "edge_laplacian")
    edge_laplacian.launches += 1
    return L


edge_laplacian.launches = 0


def edge_quadform(P: torch.Tensor, ei: torch.Tensor,
                  ej: torch.Tensor) -> torch.Tensor:
    """Per-edge quadratic forms ⟨∂L/∂g_l, P⟩ = P_ii + P_jj − P_ij − P_ji.

    ``P``: (n, n) float32 or float64; ``ei``/``ej``: (m,) int64 endpoints
    in [0, n) (any edge list). Returns (m,) in edge order, bit-equal to
    :func:`edge_quadform_plain`.
    """
    if P.dim() != 2 or P.shape[0] != P.shape[1]:
        raise ValueError(f"P must be square, got shape {tuple(P.shape)}")
    if ei.dim() != 1 or ei.shape != ej.shape:
        raise ValueError(f"ei/ej must be equal-length vectors, got "
                         f"{tuple(ei.shape)} and {tuple(ej.shape)}")
    if P.device.type == "cpu":
        return edge_quadform_plain(P, ei, ej)
    for t, what in ((P, "P"), (ei, "ei"), (ej, "ej")):
        _check_cuda(t, what)
    if P.dtype not in _SUFFIX:
        raise TypeError(f"edge_quadform takes float32 or float64 P, not {P.dtype}")
    if ei.dtype != torch.int64 or ej.dtype != torch.int64:
        raise TypeError(f"ei/ej must be int64, not {ei.dtype}/{ej.dtype}")
    m, n = int(ei.shape[0]), int(P.shape[0])
    out = torch.empty(m, dtype=P.dtype, device=P.device)
    lib = _build.load("edge_laplacian", _SIGNATURES)
    fn = getattr(lib, f"edge_quadform_{_SUFFIX[P.dtype]}")
    _raise_on(fn(P.data_ptr(), ei.data_ptr(), ej.data_ptr(), out.data_ptr(),
                 m, n, torch.cuda.current_stream().cuda_stream), "edge_quadform")
    edge_quadform.launches += 1
    return out


edge_quadform.launches = 0
