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

The wrapper is a ``torch.autograd.Function``, so the trainer's
``torch.func.vmap(torch.func.grad_and_value(...))`` runs through it. Its
backward, :func:`ssd_intra_chunk_backward`, is torch ops that recompute the
mask from the saved inputs (the mask itself is not saved). Its ``vmap``
rule folds the workers' axis into B, so one launch serves all workers.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import launch_util as _lu

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_plain", "ssd_intra_chunk_backward",
           "ssd_intra_chunk_bound", "kernel_plan", "kernel_blocks", "bf16_terms"]

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


def _compute_dtype(xc) -> torch.dtype:
    """float32, or float64 for float64 inputs (on the CPU only)."""
    return torch.promote_types(xc.dtype, torch.float32)


def _decay(laf, causal):
    """L[t, s] = exp(la_t − la_s) for s ≤ t, else 0: the exponent is masked
    before ``exp``, since la_t − la_s for s > t may overflow to inf, whose
    gradient through a masked ``where`` would be 0·inf = NaN."""
    diff = laf[:, :, :, None, :] - laf[:, :, None, :, :]               # (B,nc,Qt,Qs,H)
    return torch.exp(torch.where(causal[None, None, :, :, None], diff, -torch.inf))


def ssd_intra_chunk_plain(xc, dtc, la, Bc, Cc):
    """``ref.ssd_intra_chunk``, all in float32 (float64 for float64
    inputs). xc (B, nc, Q, H, P); dtc, la (B, nc, Q, H); Bc, Cc (B, nc, Q,
    N). Returns (y_intra (B, nc, Q, H, P), chunk_states (B, nc, H, P, N)).
    The mask M = G·L·dt (B, nc, Q, Q, H) is formed first and each output is
    one batched product, so no intermediate is larger than M (a
    four-operand einsum may contract into (B, nc, Q, Q, H, P) floats: 43 GB
    at zamba2's prefill)."""
    Q = xc.shape[2]
    ft = _compute_dtype(xc)
    xf, dtf, laf, Bf, Cf = (t.to(ft) for t in (xc, dtc, la, Bc, Cc))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xc.device))
    Ldec = _decay(laf, causal)
    CB = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    M = CB[..., None] * Ldec * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", M, xf)
    decay_out = torch.exp(laf[:, :, -1:, :] - laf)                    # (B,nc,Q,H)
    xw = xf * (decay_out * dtf)[..., None]                            # (B,nc,Q,H,P)
    chunk_states = torch.einsum("bcshp,bcsn->bchpn", xw, Bf)
    return y_intra, chunk_states


def ssd_intra_chunk_backward(xc, dtc, la, Bc, Cc, gy, gst):
    """The gradients of (y_intra, chunk_states) with respect to (xc, dtc,
    la, Bc, Cc), given their cotangents ``gy`` (B, nc, Q, H, P) and ``gst``
    (B, nc, H, P, N), in torch ops, in the inputs' dtypes. Per (batch,
    chunk), with G = C·Bᵀ, L[t,s] = exp(la_t − la_s) (s ≤ t), M = G·L·dt,
    w_s = exp(la_last − la_s)·dt_s:

      y[t]  = Σ_s M[t,s]·x[s]         st = Σ_s w_s·x[s] ⊗ B[s]
      dM    = gy·xᵀ (over P)          R = dM·M
      dx[s] = Σ_t M[t,s]·gy[t] + w_s·(gst·B[s])
      dG    = Σ_h dM·L·dt             dC = dG·B, dB = dGᵀ·C + Σ_hp (w·x)·gst
      ddt_s = Σ_t dM·G·L + dw_s·exp(la_last − la_s),  dw_s = Σ_p x[s]·(gst·B[s])
      dla_t = Σ_s R[t,s] − Σ_s' R[s',t] − dw_t·w_t, and dla_last += Σ_s dw_s·w_s

    la enters through L and through the state's decay, dt through M and w,
    B through both outputs. M is recomputed from the inputs, in float32
    (float64 for float64 inputs)."""
    Q = xc.shape[2]
    ft = _compute_dtype(xc)
    xf, dtf, laf, Bf, Cf, gy, gst = (t.to(ft) for t in (xc, dtc, la, Bc, Cc, gy, gst))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xc.device))
    L = _decay(laf, causal)                                           # (B,nc,t,s,H)
    G = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    GL = G[..., None] * L
    M = GL * dtf[:, :, None, :, :]
    dM = torch.einsum("bcthp,bcshp->bctsh", gy, xf)
    gx = torch.einsum("bctsh,bcthp->bcshp", M, gy)
    R = dM * M
    gla = R.sum(dim=3) - R.sum(dim=2)
    gdt = (dM * GL).sum(dim=2)
    del GL, R
    dG = (dM * L * dtf[:, :, None, :, :]).sum(dim=-1)                 # (B,nc,t,s)
    del dM, L, M
    gC = torch.einsum("bcts,bcsn->bctn", dG, Bf)
    gB = torch.einsum("bcts,bctn->bcsn", dG, Cf)
    decay_out = torch.exp(laf[:, :, -1:, :] - laf)                    # (B,nc,Q,H)
    w = decay_out * dtf
    gB_st = torch.einsum("bchpn,bcsn->bcshp", gst, Bf)                # gst·B[s]
    gx = gx + w[..., None] * gB_st
    dw = (xf * gB_st).sum(dim=-1)                                     # (B,nc,Q,H)
    gB = gB + torch.einsum("bcshp,bchpn->bcsn", xf * w[..., None], gst)
    gdt = gdt + dw * decay_out
    dww = dw * w
    last = (torch.arange(Q, device=xc.device) == Q - 1).to(ft)
    gla = gla - dww + dww.sum(dim=2, keepdim=True) * last[:, None]
    return (gx.to(xc.dtype), gdt.to(dtc.dtype), gla.to(la.dtype), gB.to(Bc.dtype),
            gC.to(Cc.dtype))


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


def _validate(xc, dtc, la, Bc, Cc) -> None:
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
    f64 = all(t.dtype == torch.float64 and t.device.type == "cpu"
              for t in (xc, dtc, la, Bc, Cc))
    if not f64 and (xc.dtype not in _DTYPES or Bc.dtype != xc.dtype or Cc.dtype != xc.dtype):
        raise TypeError(f"xc, Bc and Cc must share one dtype, float32, bfloat16 or float16, "
                        f"not {xc.dtype}/{Bc.dtype}/{Cc.dtype}")
    if not f64 and (dtc.dtype != torch.float32 or la.dtype != torch.float32):
        raise TypeError(f"dtc and la must be float32, not {dtc.dtype}/{la.dtype} (float64 "
                        "only with float64 x, B and C, on the CPU)")


def _launch(xc, dtc, la, Bc, Cc):
    """The plain version on the CPU; on a CUDA device the route's kernel,
    counted in ``ssd_intra_chunk.launches``, or raise."""
    if xc.device.type == "cpu":
        return ssd_intra_chunk_plain(xc, dtc, la, Bc, Cc)
    Bsz, nc, Q, H, P = (int(s) for s in xc.shape)
    N = int(Bc.shape[3])
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


class _IntraChunk(torch.autograd.Function):
    """The kernel forward, the torch-ops backward, and a vmap rule that folds
    the vmapped axis into B: one launch for all workers."""

    @staticmethod
    def forward(xc, dtc, la, Bc, Cc):
        return _launch(xc, dtc, la, Bc, Cc)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)            # the inputs only: M is recomputed

    @staticmethod
    def backward(ctx, gy, gst):
        return ssd_intra_chunk_backward(*ctx.saved_tensors, gy, gst)

    @staticmethod
    def vmap(info, in_dims, xc, dtc, la, Bc, Cc):
        n = info.batch_size

        def fold(t, d):
            t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
            return t.reshape(n * t.shape[1], *t.shape[2:])

        y, st = _IntraChunk.apply(*(fold(t, d) for t, d in zip((xc, dtc, la, Bc, Cc), in_dims)))
        return (y.unflatten(0, (n, -1)), st.unflatten(0, (n, -1))), (0, 0)


def ssd_intra_chunk(xc, dtc, la, Bc, Cc):
    """The intra-chunk outputs of every (batch, chunk) and head.

    ``xc``: (B, nc, Q, H, P); ``Bc``, ``Cc``: (B, nc, Q, N), of one dtype
    (float32, bfloat16 or float16); ``dtc``, ``la``: (B, nc, Q, H) float32
    (post-softplus dt and the cumulative log-decay); on the CPU all five may
    also be float64. Dimensions 0, 1 and 2 may have any strides (a chunk of
    a column slice of the conv output is taken as it lies); the others must
    be dense. Returns (y_intra (B, nc, Q, H, P), chunk_states (B, nc, H, P,
    N)), float32 (float64 for float64 inputs). One launch covers every
    chunk, and under ``torch.func.vmap`` every vmapped copy too; bfloat16
    takes the tensor-core route, float32 and float16 the CUDA-core route
    (:func:`kernel_plan`). Differentiable: the backward is
    :func:`ssd_intra_chunk_backward`.
    """
    _validate(xc, dtc, la, Bc, Cc)
    return _IntraChunk.apply(xc, dtc, la, Bc, Cc)


ssd_intra_chunk.launches = 0
