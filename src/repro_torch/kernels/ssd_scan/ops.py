"""The Mamba-2 SSD intra-chunk dual form (the quadratic half of the chunked
scan).

The CUDA kernel is ``csrc/ssd_scan.cu``; the plain PyTorch version of the
reference's ``ref.py`` sits beside it. The wrapper takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises. It counts its launches in ``ssd_intra_chunk.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build as _build

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_plain", "ssd_intra_chunk_bound", "kernel_plan"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "ssd_intra_chunk": [_P] * 7 + [_I] * 6 + [_LL] * 15 + [_I] * 7 + [_P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMEM_MAX = 232_448            # bytes of shared memory a Hopper block may use
_HEADS_PER_Y_BLOCK = 8
_HEADS_PER_STATE_BLOCK = 4


def ssd_intra_chunk_plain(xc, dtc, la, Bc, Cc):
    """``ref.ssd_intra_chunk``, all in float32. xc (B, nc, Q, H, P); dtc, la
    (B, nc, Q, H); Bc, Cc (B, nc, Q, N). Returns (y_intra (B, nc, Q, H, P),
    chunk_states (B, nc, H, P, N))."""
    Q = xc.shape[2]
    xf, dtf, laf = xc.float(), dtc.float(), la.float()
    Bf, Cf = Bc.float(), Cc.float()
    Ldec = torch.exp(laf[:, :, :, None, :] - laf[:, :, None, :, :])   # (B,nc,Qt,Qs,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xc.device))
    Ldec = torch.where(causal[None, None, :, :, None], Ldec, 0.0)
    CB = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    y_intra = torch.einsum("bcts,bctsh,bcsh,bcshp->bcthp", CB, Ldec, dtf, xf)
    decay_out = torch.exp(laf[:, :, -1:, :] - laf)                    # (B,nc,Q,H)
    chunk_states = torch.einsum("bcsh,bcsh,bcsn,bcshp->bchpn", decay_out, dtf, Bf, xf)
    return y_intra, chunk_states


def ssd_intra_chunk_bound(xc, dtc, la, Bc, Cc):
    """First-order float32 error bounds per output element:
    2⁻²⁴·(N + Q + 8)·Σ|terms| for y_intra and 2⁻²⁴·(Q + 8)·Σ|terms| for
    the chunk states, where Σ|terms| is the plain version of |x|, |B|, |C|
    (dt and the decays are non-negative). G sums N products, y and the
    states Q; the decay and dt factors add a few units of 2⁻²⁴ more. Two
    float32 versions that take the sums in other orders agree within it."""
    Q, N = xc.shape[2], Bc.shape[3]
    y, st = ssd_intra_chunk_plain(xc.float().abs(), dtc, la, Bc.float().abs(),
                                  Cc.float().abs())
    return (N + Q + 8) * 2.0 ** -24 * y, (Q + 8) * 2.0 ** -24 * st


def _round4(v: int) -> int:
    return (v + 3) & ~3


def kernel_plan(Q: int, H: int, P: int, N: int) -> dict:
    """Tile sizes and shared memory of one launch: the largest row tile TT
    (a multiple of 4, at most 64) whose G, M and x fit in a block's shared
    memory, the G slice NK over N staged in the M/x space, and the state
    slice SK over s. Raises ``ValueError`` where no tile fits."""
    SP, P4, N4 = _round4(Q), _round4(P), _round4(N)
    for TT in (64, 32, 16, 8, 4):
        if TT > SP:
            continue
        y_floats = 2 * TT * SP + SP * P4 + 2 * SP
        floats = max(y_floats, min(Q, 64) * (P4 + N4 + 1))
        if 4 * floats <= _SMEM_MAX:
            break
    else:
        raise ValueError(f"ssd_intra_chunk: Q={Q}, P={P}, N={N} do not fit a block's "
                         "shared memory")
    return dict(TT=TT, HG=_HEADS_PER_Y_BLOCK, HS=_HEADS_PER_STATE_BLOCK,
                NK=max(1, min(N, (TT * SP + SP * P4) // (TT + SP))),
                SK=max(1, min(Q, floats // (P4 + N4 + 1))), smem_bytes=4 * floats)


def _inner_contiguous(t: torch.Tensor) -> bool:
    """Dimensions 3 onward laid out densely (dimensions 0 to 2 may stride)."""
    expect = 1
    for d in range(t.dim() - 1, 2, -1):
        if t.shape[d] != 1 and t.stride(d) != expect:
            return False
        expect *= t.shape[d]
    return True


def ssd_intra_chunk(xc, dtc, la, Bc, Cc):
    """The intra-chunk outputs of every (batch, chunk) and head.

    ``xc``: (B, nc, Q, H, P); ``Bc``, ``Cc``: (B, nc, Q, N), of one dtype
    (float32, bfloat16 or float16); ``dtc``, ``la``: (B, nc, Q, H) float32
    (post-softplus dt and the cumulative log-decay). Dimensions 0, 1 and 2
    may have any strides (a chunk of a column slice of the conv output is
    taken as it lies); the others must be dense. Returns (y_intra (B, nc, Q, H, P),
    chunk_states (B, nc, H, P, N)), both float32.
    """
    if xc.dim() != 5 or dtc.dim() != 4 or Bc.dim() != 4:
        raise ValueError(f"xc must be (B, nc, Q, H, P), dtc and la (B, nc, Q, H), Bc and Cc "
                         f"(B, nc, Q, N); got {tuple(xc.shape)}, {tuple(dtc.shape)}, "
                         f"{tuple(Bc.shape)}")
    Bsz, nc, Q, H, P = (int(s) for s in xc.shape)
    N = int(Bc.shape[3])
    if (tuple(dtc.shape) != (Bsz, nc, Q, H) or tuple(la.shape) != (Bsz, nc, Q, H)
            or tuple(Bc.shape) != (Bsz, nc, Q, N) or tuple(Cc.shape) != (Bsz, nc, Q, N)):
        raise ValueError(f"shapes do not fit xc {tuple(xc.shape)}: dtc {tuple(dtc.shape)}, "
                         f"la {tuple(la.shape)}, Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}")
    if xc.dtype not in _DTYPES or Bc.dtype != xc.dtype or Cc.dtype != xc.dtype:
        raise TypeError(f"xc, Bc and Cc must share one dtype, float32, bfloat16 or float16, "
                        f"not {xc.dtype}/{Bc.dtype}/{Cc.dtype}")
    if dtc.dtype != torch.float32 or la.dtype != torch.float32:
        raise TypeError(f"dtc and la must be float32, not {dtc.dtype}/{la.dtype}")
    if xc.device.type == "cpu":
        return ssd_intra_chunk_plain(xc, dtc, la, Bc, Cc)
    for what, t in (("xc", xc), ("dtc", dtc), ("la", la), ("Bc", Bc), ("Cc", Cc)):
        if t.device.type != "cuda":
            raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{what} lies on {t.device}, but the current CUDA device "
                             f"is cuda:{torch.cuda.current_device()}")
        if not _inner_contiguous(t):
            raise ValueError(f"{what} must be dense past its first three dimensions")
    y = torch.empty((Bsz, nc, Q, H, P), dtype=torch.float32, device=xc.device)
    st = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32, device=xc.device)
    if y.numel() == 0 or st.numel() == 0:
        return y.zero_(), st.zero_()
    if Bsz * nc > 2 ** 31 - 1:
        raise ValueError(f"ssd_intra_chunk takes B·nc < 2³¹, got {Bsz * nc}")
    plan = kernel_plan(Q, H, P, N)
    lib = _build.load("ssd_scan", _SIGNATURES)
    err = lib.ssd_intra_chunk(
        xc.data_ptr(), dtc.data_ptr(), la.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        y.data_ptr(), st.data_ptr(), Bsz, nc, Q, H, P, N,
        *xc.stride()[:3], *dtc.stride()[:3], *la.stride()[:3], *Bc.stride()[:3],
        *Cc.stride()[:3],
        plan["TT"], plan["HG"], plan["HS"], plan["SK"], plan["NK"], plan["smem_bytes"],
        _DTYPES[xc.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed with CUDA error {err}")
    ssd_intra_chunk.launches += 1
    return y, st


ssd_intra_chunk.launches = 0
