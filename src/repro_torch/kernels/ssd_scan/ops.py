"""The Mamba-2 SSD intra-chunk dual form (the quadratic half of the chunked
scan).

The CUDA kernels are in ``csrc/ssd_scan.cu``; the plain PyTorch version of
the reference's ``ref.py`` sits beside them. Two routes, by the dtype of x,
B and C (:func:`kernel_plan` names it): bfloat16 takes the tensor cores
(``mma.sync`` bf16 → float32, float32 operands split into three bf16
terms, :func:`bf16_terms`), float32 and float16 the CUDA cores (float32
FMA). The wrapper takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches its route's kernel or raises. It counts its
launches in ``ssd_intra_chunk.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import launch_util as _lu

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_plain", "ssd_intra_chunk_bound", "kernel_plan",
           "kernel_blocks", "bf16_terms"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "ssd_intra_chunk": [_P] * 7 + [_I] * 6 + [_LL] * 15 + [_I] * 7 + [_P],
    "ssd_intra_chunk_tc": [_P] * 7 + [_I] * 6 + [_LL] * 15 + [_I] * 3 + [_P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMEM_MAX = 232_448            # bytes of shared memory a Hopper block may use
_HEADS_PER_Y_BLOCK = 8
_HEADS_PER_STATE_BLOCK = 4
_SM_SMEM = 233_472             # shared memory of one SM (228 KB) ...
_BLOCK_RESERVED = 1_024        # ... of which the runtime keeps 1 KB a block
# the tensor-core route's fixed tiles (csrc/ssd_scan.cu TC_*)
_TC_TILE = 64                  # rows t of a y block, and the s tile
_TC_HG = 2                     # heads of a y block
_TC_PC = 64                    # columns of P a y block takes
_TC_NC = 128                   # columns of N a state block takes
_TC_TERMS = 3                  # bf16 terms a float32 operand is split into


def ssd_intra_chunk_plain(xc, dtc, la, Bc, Cc):
    """``ref.ssd_intra_chunk``, all in float32. xc (B, nc, Q, H, P); dtc, la
    (B, nc, Q, H); Bc, Cc (B, nc, Q, N). Returns (y_intra (B, nc, Q, H, P),
    chunk_states (B, nc, H, P, N)). The mask M = G·L·dt (B, nc, Q, Q, H) is
    formed first and each output is one batched product, so no
    intermediate is larger than M (a four-operand einsum may contract into
    (B, nc, Q, Q, H, P) floats: 43 GB at zamba2's prefill)."""
    Q = xc.shape[2]
    xf, dtf, laf = xc.float(), dtc.float(), la.float()
    Bf, Cf = Bc.float(), Cc.float()
    Ldec = torch.exp(laf[:, :, :, None, :] - laf[:, :, None, :, :])   # (B,nc,Qt,Qs,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xc.device))
    Ldec = torch.where(causal[None, None, :, :, None], Ldec, 0.0)
    CB = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    M = CB[..., None] * Ldec * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", M, xf)
    decay_out = torch.exp(laf[:, :, -1:, :] - laf)                    # (B,nc,Q,H)
    xw = xf * (decay_out * dtf)[..., None]                            # (B,nc,Q,H,P)
    chunk_states = torch.einsum("bcshp,bcsn->bchpn", xw, Bf)
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


def bf16_terms(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core route's split of a float32 operand into three
    bfloat16 terms: hi = rn(v), mid = rn(v − hi), lo = rn(v − hi − mid).
    Each difference is exact in float32, and the three add back to v
    exactly (8 + 8 + 8 significant bits cover float32's 24) wherever lo is
    a normal bfloat16."""
    v = v.float()
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _round16(v: int) -> int:
    return (v + 15) & ~15


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocks_per_sm(smem_bytes: int) -> int:
    return _SM_SMEM // (smem_bytes + _BLOCK_RESERVED)


def _tc_smem_bytes(Q: int, P: int, N: int, stages: int) -> int:
    """``tc_smem_bytes`` of csrc/ssd_scan.cu: a y block's C tile, its
    stages of (B's s tile, x's s tile for each of its heads), la/dt, G's
    exchange and the column factors; a state block's stages of (x's s tile
    per head, B's s tile) and w. Rows are padded by 8 bf16 (an odd number
    of 16-byte units: ldmatrix without bank conflicts)."""
    s_pad = _cdiv(Q, _TC_TILE) * _TC_TILE
    ld_n, ld_p = _round16(N) + 8, min(_TC_PC, _round16(P)) + 8
    y = 2 * (_TC_TILE * ld_n + stages * (_TC_TILE * ld_n + _TC_HG * _TC_TILE * ld_p)) \
        + 4 * 2 * _TC_HG * s_pad + 16 * 4 * 8 * 32 + 4 * _TC_HG * _TC_TILE
    ld_x, ld_b = _round16(P) + 8, min(_TC_NC, _round16(N)) + 8
    state = 2 * stages * (_TC_HG * _TC_TILE * ld_x + _TC_TILE * ld_b) + 4 * _TC_HG * s_pad
    return max(y, state)


def kernel_plan(Q: int, H: int, P: int, N: int, dtype=torch.float32) -> dict:
    """Route, tiles, stages and shared memory of one launch.

    bfloat16 takes the tensor-core route (``route="tensor_core"``): y
    blocks of 64 rows t × 2 heads × 64 columns of P, state blocks of a
    pair of heads × 128 columns of N, s in tiles of 64; two cp.async
    stages where two blocks still fit an SM's shared memory, else one.
    float32 and float16 take the CUDA-core route (``route="cuda_core"``):
    the largest row tile TT (a multiple of 4, at most 64) whose G, M and x
    fit in a block's shared memory, the G slice NK over N staged in the M/x
    space, and the state slice SK over s. Raises ``ValueError`` where no
    tile fits. Cached; each call returns a fresh dict."""
    return dict(_plan(Q, H, P, N, dtype))


@functools.lru_cache(maxsize=64)
def _plan(Q: int, H: int, P: int, N: int, dtype) -> dict:
    if dtype == torch.bfloat16:
        for stages in (2, 1):
            smem = _tc_smem_bytes(Q, P, N, stages)
            if _blocks_per_sm(smem) >= 2:
                break
        if smem > _SMEM_MAX:
            raise ValueError(f"ssd_intra_chunk: Q={Q}, P={P}, N={N} do not fit a block's "
                             "shared memory")
        n_tiles, n_hg = _cdiv(Q, _TC_TILE), _cdiv(H, _TC_HG)
        n_pc, n_nch = _cdiv(P, _TC_PC), _cdiv(N, _TC_NC)
        return dict(route="tensor_core", terms=_TC_TERMS, tile=_TC_TILE, HG=_TC_HG,
                    PC=_TC_PC, NC=_TC_NC, n_tiles=n_tiles, n_hg=n_hg, n_pc=n_pc,
                    n_nch=n_nch, n_state=n_hg * n_nch, n_y=n_tiles * n_hg * n_pc,
                    stages=stages, threads=256, smem_bytes=smem,
                    blocks_per_sm=_blocks_per_sm(smem))
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
    return dict(route="cuda_core", TT=TT, HG=_HEADS_PER_Y_BLOCK, HS=_HEADS_PER_STATE_BLOCK,
                NK=max(1, min(N, (TT * SP + SP * P4) // (TT + SP))),
                SK=max(1, min(Q, floats // (P4 + N4 + 1))), n_tiles=_cdiv(Q, TT),
                n_hg=_cdiv(H, _HEADS_PER_Y_BLOCK), n_state=_cdiv(H, _HEADS_PER_STATE_BLOCK),
                threads=256, smem_bytes=4 * floats, blocks_per_sm=_blocks_per_sm(4 * floats))


def kernel_blocks(plan: dict, Q: int, H: int, P: int, N: int) -> list[dict]:
    """What each block of one (batch, chunk) computes, decoded from its
    index along the grid's y axis as the kernel decodes it: ``kind`` "y"
    with its rows ``t``, columns ``s`` (every s ≤ t of those rows), heads
    ``h`` and columns ``p`` of P; ``kind`` "state" with heads ``h``,
    columns ``p`` and ``n``. Ranges are half-open (start, stop)."""
    out = []
    if plan["route"] == "tensor_core":
        T, HG, PC, NC = plan["tile"], plan["HG"], plan["PC"], plan["NC"]
        for role in range(plan["n_state"]):
            h0, n0 = role // plan["n_nch"] * HG, (role % plan["n_nch"]) * NC
            out.append(dict(kind="state", h=(h0, min(H, h0 + HG)), p=(0, P),
                            n=(n0, min(N, n0 + NC))))
        per_tile = plan["n_hg"] * plan["n_pc"]
        for role in range(plan["n_y"]):
            tile = plan["n_tiles"] - 1 - role // per_tile
            hg, pc = (role % per_tile) // plan["n_pc"], role % plan["n_pc"]
            t0 = tile * T
            out.append(dict(kind="y", t=(t0, min(Q, t0 + T)), s=(0, min(Q, t0 + T)),
                            h=(hg * HG, min(H, hg * HG + HG)), p=(pc * PC, min(P, pc * PC + PC))))
        return out
    TT, HG, HS = plan["TT"], plan["HG"], plan["HS"]
    for role in range(plan["n_tiles"] * plan["n_hg"]):
        tile, hg = role // plan["n_hg"], role % plan["n_hg"]
        t0 = tile * TT
        out.append(dict(kind="y", t=(t0, min(Q, t0 + TT)), s=(0, min(Q, t0 + TT)),
                        h=(hg * HG, min(H, hg * HG + HG)), p=(0, P)))
    for role in range(plan["n_state"]):
        out.append(dict(kind="state", h=(role * HS, min(H, role * HS + HS)), p=(0, P), n=(0, N)))
    return out


def _inner_contiguous(t: torch.Tensor) -> bool:
    """Dimensions 3 onward laid out densely (dimensions 0 to 2 may stride)."""
    expect = 1
    for d in range(t.dim() - 1, 2, -1):
        if t.shape[d] != 1 and t.stride(d) != expect:
            return False
        expect *= t.shape[d]
    return True


def _vec_ok(xc, Bc, Cc, P: int, N: int) -> bool:
    """Whether the tensor-core kernel may bring x, B and C in by 16-byte
    copies: every base address 16-byte aligned, every stride of dimensions
    0–2 and P and N multiples of 8 elements."""
    return (P % 8 == 0 and N % 8 == 0
            and all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
                    for t in (xc, Bc, Cc)))


def ssd_intra_chunk(xc, dtc, la, Bc, Cc):
    """The intra-chunk outputs of every (batch, chunk) and head.

    ``xc``: (B, nc, Q, H, P); ``Bc``, ``Cc``: (B, nc, Q, N), of one dtype
    (float32, bfloat16 or float16); ``dtc``, ``la``: (B, nc, Q, H) float32
    (post-softplus dt and the cumulative log-decay). Dimensions 0, 1 and 2
    may have any strides (a chunk of a column slice of the conv output is
    taken as it lies); the others must be dense. Returns (y_intra (B, nc, Q, H, P),
    chunk_states (B, nc, H, P, N)), both float32. One launch covers every
    chunk; bfloat16 takes the tensor-core route, float32 and float16 the
    CUDA-core route (:func:`kernel_plan`).
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
    plan = kernel_plan(Q, H, P, N, xc.dtype)
    lib = _lu.library("ssd_scan", _SIGNATURES)
    strides = (*xc.stride()[:3], *dtc.stride()[:3], *la.stride()[:3], *Bc.stride()[:3],
               *Cc.stride()[:3])
    head = (xc.data_ptr(), dtc.data_ptr(), la.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            y.data_ptr(), st.data_ptr(), Bsz, nc, Q, H, P, N, *strides)
    stream = _lu.raw_stream(xc.device.index)
    if plan["route"] == "tensor_core":
        err = lib.ssd_intra_chunk_tc(*head, plan["stages"], int(_vec_ok(xc, Bc, Cc, P, N)),
                                     plan["smem_bytes"], stream)
    else:
        err = lib.ssd_intra_chunk(*head, plan["TT"], plan["HG"], plan["HS"], plan["SK"],
                                  plan["NK"], plan["smem_bytes"], _DTYPES[xc.dtype], stream)
    if err != 0:
        _lu.raise_launch_error("ssd_intra_chunk", err, xc.device.index)
    ssd_intra_chunk.launches += 1
    return y, st


ssd_intra_chunk.launches = 0
