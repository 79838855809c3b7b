"""The ADMM constraint-operator pair: L(g) and the per-edge quadratic form,
and a second form of L(g) that writes A_op's three dense blocks at once.

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

from .. import launch_util as _lu

__all__ = ["edge_laplacian", "edge_quadform", "edge_laplacian_blocks", "edge_laplacian_plain",
           "edge_quadform_plain", "edge_laplacian_blocks_plain", "packed_edge_index"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_SIGNATURES = {
    **{f"edge_laplacian_{s}": [_P, _P, ctypes.c_int, _P] for s in ("f32", "f64")},
    **{f"edge_quadform_{s}": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
       for s in ("f32", "f64")},
    **{f"edge_laplacian_blocks_{s}": [_P] * 6 + [ctypes.c_int, _P] for s in ("f32", "f64")},
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


def edge_laplacian_blocks_plain(g: torch.Tensor, lam: torch.Tensor, S: torch.Tensor,
                                T: torch.Tensor, y: torch.Tensor,
                                out: torch.Tensor) -> torch.Tensor:
    """A_op's dense blocks by the composition the engine's plain route
    takes: ``out[:n²] = L − λ·I + S``, ``out[n²:2n²] = L + λ·I + T``,
    ``out[2n²:2n²+n] = diag(L) + y`` (row-major), with L from
    :func:`edge_laplacian_plain`. Returns ``out``."""
    n = S.shape[0]
    nn = n * n
    L = edge_laplacian_plain(g, packed_edge_index(n, str(g.device)))
    I = torch.eye(n, dtype=g.dtype, device=g.device)
    out[:nn] = (L - lam * I + S).reshape(-1)
    out[nn:2 * nn] = (L + lam * I + T).reshape(-1)
    out[2 * nn:2 * nn + n] = torch.diagonal(L) + y
    return out


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
    lib = _lu.library("edge_laplacian", _SIGNATURES)
    fn = getattr(lib, f"edge_laplacian_{_SUFFIX[g.dtype]}")
    _raise_on(fn(g.data_ptr(), L.data_ptr(), n, _lu.raw_stream(g.device.index)),
              "edge_laplacian")
    edge_laplacian.launches += 1
    return L


edge_laplacian.launches = 0


def edge_laplacian_blocks(g: torch.Tensor, lam: torch.Tensor, S: torch.Tensor,
                          T: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A_op's three dense blocks from L(g), written into the flat
    constraint-space vector ``out`` in one launch: ``out[:n²] = L − λI +
    S``, ``out[n²:2n²] = L + λI + T``, ``out[2n²:2n²+n] = diag(L) + y``.

    ``g``: (m,) in ``all_edges(n)`` order (the complete edge list, as
    :func:`edge_laplacian`); ``lam``: a 0-dim tensor, read on the device;
    ``S``, ``T``: (n, n); ``y``: (n,); ``out``: 1-D with at least 2n² + n
    entries (the rest is left as it is). One dtype, float32 or float64,
    every tensor contiguous. Bit-equal to :func:`edge_laplacian` followed by
    the torch ops of :func:`edge_laplacian_blocks_plain`. Returns ``out``.
    """
    n = int(S.shape[0]) if S.dim() == 2 else -1
    m = n * (n - 1) // 2
    if (S.dim() != 2 or tuple(S.shape) != (n, n) or tuple(T.shape) != (n, n)
            or tuple(y.shape) != (n,) or tuple(g.shape) != (m,) or lam.dim() != 0
            or out.dim() != 1 or out.shape[0] < 2 * n * n + n):
        raise ValueError(f"edge_laplacian_blocks needs g (m,), lam (), S and T (n, n), y (n,) "
                         f"and out (≥ 2n²+n,); got g {tuple(g.shape)}, lam {tuple(lam.shape)}, "
                         f"S {tuple(S.shape)}, T {tuple(T.shape)}, y {tuple(y.shape)}, "
                         f"out {tuple(out.shape)}")
    tensors = (("g", g), ("lam", lam), ("S", S), ("T", T), ("y", y), ("out", out))
    if any(t.dtype != g.dtype for _, t in tensors):
        raise TypeError("edge_laplacian_blocks: g, lam, S, T, y and out must share one dtype, "
                        f"got {[str(t.dtype) for _, t in tensors]}")
    if all(t.device.type == "cpu" for _, t in tensors):
        return edge_laplacian_blocks_plain(g, lam, S, T, y, out)
    for what, t in tensors:
        _check_cuda(t, what)
    if g.dtype not in _SUFFIX:
        raise TypeError(f"edge_laplacian_blocks takes float32 or float64, not {g.dtype}")
    lib = _lu.library("edge_laplacian", _SIGNATURES)
    fn = getattr(lib, f"edge_laplacian_blocks_{_SUFFIX[g.dtype]}")
    _raise_on(fn(g.data_ptr(), lam.data_ptr(), S.data_ptr(), T.data_ptr(), y.data_ptr(),
                 out.data_ptr(), n, _lu.raw_stream(g.device.index)), "edge_laplacian_blocks")
    edge_laplacian_blocks.launches += 1
    return out


edge_laplacian_blocks.launches = 0


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
    lib = _lu.library("edge_laplacian", _SIGNATURES)
    fn = getattr(lib, f"edge_quadform_{_SUFFIX[P.dtype]}")
    _raise_on(fn(P.data_ptr(), ei.data_ptr(), ej.data_ptr(), out.data_ptr(),
                 m, n, _lu.raw_stream(P.device.index)), "edge_quadform")
    edge_quadform.launches += 1
    return out


edge_quadform.launches = 0
