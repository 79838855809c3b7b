"""The ADMM constraint-operator pair: L(g) and the per-edge quadratic form,
and their forms on the ADMM path: A_op's three dense blocks from L(g), the
adjoint AT_op's x-part, and the CG matvec A·Aᵀλ's dense blocks, each in one
launch.

Each function has a CUDA kernel (``csrc/edge_laplacian.cu``) and a plain
PyTorch version beside it. The wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises. Each
wrapper counts its launches in its ``launches`` attribute.

Every form but ``edge_quadform`` also takes one leading batch axis (the
batched ADMM's instances) and serves the whole batch in one launch; each
instance of it is bitwise the unbatched call on that instance.

``edge_laplacian`` and ``edge_adjoint`` also take a window ``first`` (and
``count``) of the lexicographic edge list: one rank's contiguous share in
the edge-partitioned ADMM (``core/shard.py``). The complete list is the
window ``first = 0, count = m``, and a call without a window is that call.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...device import DeviceFault
from .. import launch_util as _lu

__all__ = ["edge_laplacian", "edge_quadform", "edge_laplacian_blocks", "edge_adjoint",
           "edge_schur_matvec", "edge_laplacian_plain", "edge_laplacian_window_plain",
           "edge_quadform_plain",
           "edge_laplacian_blocks_plain", "edge_adjoint_plain", "edge_schur_matvec_plain",
           "packed_edge_index", "edge_endpoints"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_S = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    **{f"edge_laplacian_{s}": [_P, _S, _P, _S, _I, _I, _S, _S, _P] for s in ("f32", "f64")},
    **{f"edge_quadform_{s}": [_P, _P, _P, _P, _S, _I, _P] for s in ("f32", "f64")},
    **{f"edge_laplacian_blocks_{s}": [_P, _S] * 6 + [_I, _I, _P] for s in ("f32", "f64")},
    **{f"edge_adjoint_{s}": [_P, _S] * 5 + [_I, _I, _S, _S, _P] for s in ("f32", "f64")},
    **{f"edge_schur_matvec_{s}": [_P, _S] * 6 + [_I, _I, _P] for s in ("f32", "f64")},
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


@functools.lru_cache(maxsize=16)
def edge_endpoints(n: int, device: str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Endpoints (i, j), i < j, of ``all_edges(n)`` (lexicographic) as
    int64. Callers must not write to them."""
    iu = np.triu_indices(n, 1)
    return (torch.from_numpy(iu[0].astype(np.int64)).to(device),
            torch.from_numpy(iu[1].astype(np.int64)).to(device))


# The plain versions take any leading axes (the batched ADMM's instance
# axis) by broadcasting; each instance of a batched call is bitwise the
# unbatched call on that instance.

def edge_laplacian_plain(g: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """L = Diag(G·1) − G with G gathered from g (..., m) through the packed
    index map (the ``lidx`` form of the reference's ``engine._L_of_g``)."""
    g_ext = torch.cat([g, g.new_zeros(g.shape[:-1] + (1,))], dim=-1)
    G = g_ext[..., lidx]
    return torch.diag_embed(G.sum(dim=-1)) - G


def edge_laplacian_window_plain(g: torch.Tensor, lidx: torch.Tensor,
                                first: int) -> torch.Tensor:
    """The additive contribution to L of the packed window ``[first, first
    + g.shape[-1])`` whose weights ``g`` holds (padded slots included, as
    the sharded layer hands them over): the reference's
    ``edge_laplacian_window`` (``repro/kernels/edge_laplacian/ref.py``).
    Out-of-window entries gather the appended zero slot; each row sums in
    index order (a cumulative sum), the order XLA's CPU reduction takes on
    the short rows the parity tests hold it at, so that the result is
    bitwise the reference's there in float64. Any leading axes."""
    m_loc = g.shape[-1]
    idx = lidx - first
    valid = (idx >= 0) & (idx < m_loc)
    g_ext = torch.cat([g, g.new_zeros(g.shape[:-1] + (1,))], dim=-1)
    G = g_ext[..., torch.where(valid, idx, m_loc)]
    return torch.diag_embed(G.cumsum(-1)[..., -1]) - G


def edge_laplacian_blocks_plain(g: torch.Tensor, lam: torch.Tensor, S: torch.Tensor,
                                T: torch.Tensor, y: torch.Tensor,
                                out: torch.Tensor) -> torch.Tensor:
    """A_op's dense blocks by the composition the engine's plain route
    takes: ``out[..., :n²] = L − λ·I + S``, ``out[..., n²:2n²] = L + λ·I +
    T``, ``out[..., 2n²:2n²+n] = diag(L) + y`` (row-major), with L from
    :func:`edge_laplacian_plain`. Returns ``out``."""
    n = S.shape[-1]
    nn = n * n
    L = edge_laplacian_plain(g, packed_edge_index(n, str(g.device)))
    lam_I = lam[..., None, None] * torch.eye(n, dtype=g.dtype, device=g.device)
    out[..., :nn] = (L - lam_I + S).flatten(-2)
    out[..., nn:2 * nn] = (L + lam_I + T).flatten(-2)
    out[..., 2 * nn:2 * nn + n] = torch.diagonal(L, dim1=-2, dim2=-1) + y
    return out


def edge_quadform_plain(P: torch.Tensor, ei: torch.Tensor,
                        ej: torch.Tensor) -> torch.Tensor:
    """⟨∂L/∂g_l, P⟩ = P_ii + P_jj − P_ij − P_ji per edge l = {i, j}."""
    return P[..., ei, ei] + P[..., ej, ej] - P[..., ei, ej] - P[..., ej, ei]


def edge_adjoint_plain(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor,
                       v: torch.Tensor | None = None, first: int = 0,
                       count: int | None = None) -> torch.Tensor:
    """AT_op's x-part by the engine's composition: ``[quadform(P + Q) + (w_i
    + w_j) (+ v), −tr P + tr Q]``, (..., m + 1), over ``all_edges(n)``; with
    ``count``, over the window ``[first, first + count)`` of it, (..., count
    + 1), ``v`` then the window's (..., count)."""
    ei, ej = edge_endpoints(P.shape[-1], str(P.device))
    if count is not None:
        ei, ej = ei[first:first + count], ej[first:first + count]
    xg = edge_quadform_plain(P + Q, ei, ej) + (w[..., ei] + w[..., ej])
    if v is not None:
        xg = xg + v
    return torch.cat([xg, (-_trace(P) + _trace(Q))[..., None]], dim=-1)


def _trace(P: torch.Tensor) -> torch.Tensor:
    """tr P over any leading axes, bitwise ``torch.trace`` of each matrix on
    the CPU: the last entry of the diagonal's cumulative sum accumulates in
    the same order and type (a plain ``sum`` pairs its terms otherwise)."""
    return torch.diagonal(P, dim1=-2, dim2=-1).cumsum(-1)[..., -1]


def edge_schur_matvec_plain(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor,
                            out: torch.Tensor, v: torch.Tensor | None = None,
                            x_adj: torch.Tensor | None = None) -> torch.Tensor:
    """A·Aᵀλ's dense blocks by the composition: :func:`edge_adjoint_plain`
    fed to :func:`edge_laplacian_blocks_plain` with S = P, T = Q, y = w.
    Writes the adjoint into ``x_adj`` when given. Returns ``out``."""
    x = edge_adjoint_plain(P, Q, w, v)
    edge_laplacian_blocks_plain(x[..., :-1], x[..., -1], P, Q, w, out)
    if x_adj is not None:
        x_adj.copy_(x)
    return out


def _check_cuda(t: torch.Tensor, what: str, current: int | None = None,
                batched: bool = False) -> None:
    """Device checks of a kernel operand (``current``: the current CUDA
    device, looked up when None), and its layout: contiguous, or with a
    leading instance axis (``batched``) contiguous within each instance,
    the instances at any stride."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, "
                         f"not {t.device}")
    current = torch.cuda.current_device() if current is None else current
    if t.device.index != current:
        raise ValueError(f"{what} lies on {t.device}, but the current CUDA "
                         f"device is cuda:{current}")
    if t.is_contiguous():
        return
    if not batched:
        raise ValueError(f"{what} must be contiguous")
    if t.shape[0] > 0 and not t[0].is_contiguous():
        raise ValueError(f"{what} must be contiguous within each instance")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise DeviceFault(f"{what} kernel launch failed with CUDA error {err}")


def _batch_of(what: str, lead: tuple) -> int:
    """The instance count of a leading shape: () is one instance, (B,) B."""
    if len(lead) > 1:
        raise ValueError(f"{what} takes at most one leading batch axis, got {lead}")
    return int(lead[0]) if lead else 1


def _launch(what: str, dtype: torch.dtype, operands: tuple, n: int, lead: tuple,
            window: tuple = ()) -> None:
    """Launch ``what`` on ``(name, tensor or None)`` operands, each passed
    as its pointer and instance stride, after the device and layout checks;
    a ``None`` operand is a null pointer. ``window`` is ``(first, count)``
    for the two forms that take one."""
    batched = len(lead) == 1
    current = torch.cuda.current_device()
    args = []
    for name, t in operands:
        if t is None:
            args += [None, 0]
            continue
        _check_cuda(t, name, current, batched)
        args += [t.data_ptr(), t.stride(0) if batched else 0]
    if dtype not in _SUFFIX:
        raise TypeError(f"{what} takes float32 or float64, not {dtype}")
    lib = _lu.library("edge_laplacian", _SIGNATURES)
    fn = getattr(lib, f"{what}_{_SUFFIX[dtype]}")
    device = next(t for _, t in operands if t is not None).device
    _raise_on(fn(*args, n, _batch_of(what, lead), *window, _lu.raw_stream(device.index)), what)


def edge_laplacian(g: torch.Tensor, n: int, first: int | None = None) -> torch.Tensor:
    """Laplacian L(g) (n, n) of the complete candidate-edge list, or
    (B, n, n) for a batch; with ``first``, the additive contribution of the
    window ``[first, first + count)`` of it, count = ``g.shape[-1]``.

    ``g``: (m,) or (B, m) edge weights in ``all_edges(n)`` order, m =
    n(n−1)/2 — the kernel derives the packed index analytically, so the
    edge list must be the complete lexicographic one, or a window of it
    ((count,) or (B, count), first + count ≤ m; every edge outside it
    counts as weight 0). float32 or float64. One launch for the batch. The
    window ``first = 0`` over the whole list is the call without a window.
    On the CPU a window takes :func:`edge_laplacian_window_plain`.
    """
    m = n * (n - 1) // 2
    if first is None:
        if g.dim() not in (1, 2) or g.shape[-1] != m:
            raise ValueError(f"edge_laplacian needs the complete edge list: "
                             f"g has shape {tuple(g.shape)}, n={n} needs ({m},) or (B, {m})")
        first = 0
    count = int(g.shape[-1])
    if g.dim() not in (1, 2) or first < 0 or first + count > m:
        raise ValueError(f"edge_laplacian: the window [{first}, {first + count}) of g "
                         f"{tuple(g.shape)} does not lie in the {m} edges of n={n}")
    if g.device.type == "cpu":
        if first == 0 and count == m:
            return edge_laplacian_plain(g, packed_edge_index(n, "cpu"))
        return edge_laplacian_window_plain(g, packed_edge_index(n, "cpu"), first)
    lead = tuple(g.shape[:-1])
    if g.dtype not in _SUFFIX:
        raise TypeError(f"edge_laplacian takes float32 or float64, not {g.dtype}")
    L = torch.empty(lead + (n, n), dtype=g.dtype, device=g.device)
    _launch("edge_laplacian", g.dtype, (("g", g), ("L", L)), n, lead, (first, count))
    edge_laplacian.launches += 1
    return L


edge_laplacian.launches = 0


def edge_laplacian_blocks(g: torch.Tensor, lam: torch.Tensor, S: torch.Tensor,
                          T: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A_op's three dense blocks from L(g), written into the flat
    constraint-space vector ``out`` in one launch: ``out[..., :n²] = L − λI
    + S``, ``out[..., n²:2n²] = L + λI + T``, ``out[..., 2n²:2n²+n] =
    diag(L) + y``.

    ``g``: (m,) in ``all_edges(n)`` order (the complete edge list, as
    :func:`edge_laplacian`); ``lam``: a 0-dim tensor, read on the device;
    ``S``, ``T``: (n, n); ``y``: (n,); ``out``: 1-D with at least 2n² + n
    entries (the rest is left as it is). A batch puts one leading axis B
    before every shape (λ (B,)), each instance contiguous, the instances
    at any stride (views of one constraint-space matrix), one launch for
    all. One dtype, float32 or float64. Bit-equal to :func:`edge_laplacian`
    followed by the torch ops of :func:`edge_laplacian_blocks_plain`.
    Returns ``out``.
    """
    lead = tuple(S.shape[:-2]) if S.dim() >= 2 else ()
    n = int(S.shape[-1]) if S.dim() >= 2 else -1
    m = n * (n - 1) // 2
    if (S.dim() not in (2, 3) or tuple(S.shape) != lead + (n, n)
            or tuple(T.shape) != lead + (n, n) or tuple(y.shape) != lead + (n,)
            or tuple(g.shape) != lead + (m,) or tuple(lam.shape) != lead
            or out.dim() != len(lead) + 1 or tuple(out.shape[:-1]) != lead
            or out.shape[-1] < 2 * n * n + n):
        raise ValueError(f"edge_laplacian_blocks needs g (m,), lam (), S and T (n, n), y (n,) "
                         f"and out (≥ 2n²+n,), each with the same leading batch axis or none; "
                         f"got g {tuple(g.shape)}, lam {tuple(lam.shape)}, "
                         f"S {tuple(S.shape)}, T {tuple(T.shape)}, y {tuple(y.shape)}, "
                         f"out {tuple(out.shape)}")
    tensors = (("g", g), ("lam", lam), ("S", S), ("T", T), ("y", y), ("out", out))
    if any(t.dtype != g.dtype for _, t in tensors):
        raise TypeError("edge_laplacian_blocks: g, lam, S, T, y and out must share one dtype, "
                        f"got {[str(t.dtype) for _, t in tensors]}")
    if all(t.device.type == "cpu" for _, t in tensors):
        return edge_laplacian_blocks_plain(g, lam, S, T, y, out)
    _launch("edge_laplacian_blocks", g.dtype, tensors, n, lead)
    edge_laplacian_blocks.launches += 1
    return out


edge_laplacian_blocks.launches = 0


def _check_adjoint_operands(what: str, P, Q, w, v, extra: tuple, count: int | None = None) -> tuple:
    """Shape and dtype checks shared by the two adjoint forms (``count``: a
    window's length, v's then); returns (n, m, the leading shape, the named
    tensors)."""
    lead = tuple(P.shape[:-2]) if P.dim() >= 2 else ()
    n = int(P.shape[-1]) if P.dim() >= 2 else -1
    m = n * (n - 1) // 2
    mv = m if count is None else count
    if (P.dim() not in (2, 3) or tuple(P.shape) != lead + (n, n)
            or tuple(Q.shape) != lead + (n, n) or tuple(w.shape) != lead + (n,)
            or (v is not None and tuple(v.shape) != lead + (mv,))):
        raise ValueError(f"{what} needs P and Q (n, n), w (n,) and v (m,) or None, each with "
                         f"the same leading batch axis or none; got "
                         f"P {tuple(P.shape)}, Q {tuple(Q.shape)}, w {tuple(w.shape)}, "
                         f"v {None if v is None else tuple(v.shape)}")
    tensors = (("P", P), ("Q", Q), ("w", w)) + ((("v", v),) if v is not None else ()) + extra
    if any(t.dtype != P.dtype for _, t in tensors):
        raise TypeError(f"{what}: every tensor must share one dtype, "
                        f"got {[str(t.dtype) for _, t in tensors]}")
    return n, m, lead, tensors


def edge_adjoint(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor,
                 v: torch.Tensor | None = None, first: int | None = None,
                 count: int | None = None) -> torch.Tensor:
    """AT_op's x-part in one launch: ``[quadform(P + Q)_l + (w_i + w_j)
    (+ v_l), −tr P + tr Q]``, (m + 1,), over ``all_edges(n)``; with
    ``first`` and ``count``, over the window ``[first, first + count)`` of
    it, (count + 1,), ``v`` then the window's (count,).

    ``P``, ``Q``: (n, n) (the λ blocks, views of the flat constraint-space
    vector); ``w``: (n,); ``v``: (m,) or None (heterogeneous specs). A
    batch puts one leading axis B before every shape (the output (B, m +
    1)), each instance contiguous, the instances at any stride; one launch
    for all. One dtype, float32 or float64. The edge entries are bit-equal
    to :func:`edge_adjoint_plain` on the same device; the last entry comes
    from a fixed-order sum of the diagonals, within 2n·u·(Σ|P_ii| +
    Σ|Q_ii|) of the plain version's. The window ``first = 0, count = m`` is
    the call without one.
    """
    if (first is None) != (count is None):
        raise ValueError("edge_adjoint takes a window as both first and count, or neither")
    n, m, lead, tensors = _check_adjoint_operands("edge_adjoint", P, Q, w, v, (), count)
    if first is None:
        first, count = 0, m
    if first < 0 or count < 0 or first + count > m:
        raise ValueError(f"edge_adjoint: the window [{first}, {first + count}) does not lie "
                         f"in the {m} edges of n={n}")
    if all(t.device.type == "cpu" for _, t in tensors):
        return edge_adjoint_plain(P, Q, w, v, first, None if count == m else count)
    x = torch.empty(lead + (count + 1,), dtype=P.dtype, device=P.device)
    _launch("edge_adjoint", P.dtype, (("P", P), ("Q", Q), ("w", w), ("v", v), ("x", x)),
            n, lead, (first, count))
    edge_adjoint.launches += 1
    return x


edge_adjoint.launches = 0


def edge_schur_matvec(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                      v: torch.Tensor | None = None,
                      x_adj: torch.Tensor | None = None) -> torch.Tensor:
    """The CG matvec's dense blocks in one launch: with (xg, xl) the
    adjoint of :func:`edge_adjoint`, ``out[..., :n²] = L(xg) − xl·I + P``,
    ``out[..., n²:2n²] = L(xg) + xl·I + Q``, ``out[..., 2n²:2n²+n] = diag
    L(xg) + w`` (the rest of ``out`` is left as it is). ``x_adj`` ((m + 1,)
    or None) receives the adjoint too.

    Operands as :func:`edge_adjoint`, a batch included; ``out``: 1-D with
    at least 2n² + n entries (with the batch axis before), overlapping no
    input. Bit-equal to :func:`edge_laplacian_blocks` fed
    :func:`edge_adjoint`'s output. Returns ``out``.
    """
    extra = (("out", out),) + ((("x_adj", x_adj),) if x_adj is not None else ())
    n, m, lead, tensors = _check_adjoint_operands("edge_schur_matvec", P, Q, w, v, extra)
    if (out.dim() != len(lead) + 1 or tuple(out.shape[:-1]) != lead
            or out.shape[-1] < 2 * n * n + n
            or (x_adj is not None and tuple(x_adj.shape) != lead + (m + 1,))):
        raise ValueError(f"edge_schur_matvec needs out (≥ 2n²+n,) and x_adj (m+1,) or None, "
                         f"with P's leading batch axis; got out {tuple(out.shape)}, "
                         f"x_adj {None if x_adj is None else tuple(x_adj.shape)}")
    if all(t.device.type == "cpu" for _, t in tensors):
        return edge_schur_matvec_plain(P, Q, w, out, v, x_adj)
    _launch("edge_schur_matvec", P.dtype, (("P", P), ("Q", Q), ("w", w), ("v", v),
                                           ("out", out), ("x_adj", x_adj)), n, lead)
    edge_schur_matvec.launches += 1
    return out


edge_schur_matvec.launches = 0


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
