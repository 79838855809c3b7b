"""One matmul-BFS hop over a batch of restarts.

The CUDA kernel is ``csrc/hop_bfs.cu``; the plain PyTorch version sits
beside it. The wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. It counts its
launches in ``hop_step.launches``.

The kernel works on bits: each block packs a band of reach rows and a
chunk of adj's columns into shared memory and ORs adj rows together.
:func:`hop_plan` chooses the band and chunk sizes; when it splits a row's
columns over blocks, their partial counts meet in a per-device int32
workspace that the kernel leaves zeroed (``launch_util.workspace``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import launch_util as _lu

__all__ = ["hop_step", "hop_step_plain", "hop_plan"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"hop_step_u8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}
_BYTES = (torch.bool, torch.uint8)
#: Dynamic shared memory one block may take on the H100 (227 KB).
SMEM_BYTES = 232_448
#: What a split of the columns costs in :func:`hop_plan`'s model, in bytes
#: one block loads: the partial counts' atomics, the fences and the
#: ticket, a few dependent round trips through L2.
SPLIT_BYTES = 16_384


def hop_step_plain(reach: torch.Tensor, adj: torch.Tensor):
    """``new = reach ∨ (reach @ adj)`` by a float32 batched product of the
    0/1 matrices (exact: row sums ≤ n), plus each row's reach count."""
    prod = torch.bmm(reach.to(torch.float32), adj.to(torch.float32))
    new = (reach != 0) | (prod > 0)
    return new.to(reach.dtype), new.sum(dim=-1, dtype=torch.int32)


def hop_smem_bytes(n: int, bm: int, cw: int) -> int:
    """Dynamic shared memory of one block: the packed reach band (bm × nw
    words), adj's packed chunk (32·nw × (cw|1) words: n rows padded to a
    whole word of rows) and bm row counts."""
    nw = -(-n // 32)
    return 4 * (bm * nw + 32 * nw * (cw | 1) + bm)


@functools.lru_cache(maxsize=256)
def hop_plan(R: int, n: int, sm_count: int) -> tuple[int, int]:
    """``(bm, cw)``: rows per block and 32-column output words per block.

    Every block packs the adj columns it needs, so blocks are not free:
    where all of adj's columns fit one block's shared memory (n up to about
    1,300) the columns are not split (``cw = nw``), and the band is sized
    for half a wave, ``bm = max(4, floor(R·n / (sm_count / 2)))`` — on the
    H100 at R=4, n=256 64 blocks of 16 rows beat 148 blocks of 7 and every
    column split (PERF.md). Past that, among the column splits
    (``chunks = ceil(nw / cw)``) it takes, for each, the largest band that
    still gives ``sm_count`` blocks, and keeps the plan whose block loads
    the fewest bytes, ``n·(bm + 32·cw)``, plus :data:`SPLIT_BYTES` for the
    split, within :data:`SMEM_BYTES`. Ties go to fewer chunks."""
    if R < 1 or n < 1:
        raise ValueError(f"hop_plan needs R, n ≥ 1, got R={R}, n={n}")
    nw = -(-n // 32)
    bm = min(n, max(4, R * n // max(1, sm_count // 2)))
    while bm > 1 and hop_smem_bytes(n, bm, nw) > SMEM_BYTES:
        bm = max(1, bm // 2)
    if hop_smem_bytes(n, bm, nw) <= SMEM_BYTES and -(-n // bm) <= 65535:
        return bm, nw
    best = None
    for chunks in sorted({-(-nw // cw) for cw in range(1, nw + 1)}):
        cw = -(-nw // chunks)
        need_bands = -(-sm_count // (R * chunks))
        bm = max(1, n // need_bands)
        while bm > 1 and hop_smem_bytes(n, bm, cw) > SMEM_BYTES:
            bm = max(1, bm // 2)
        if hop_smem_bytes(n, bm, cw) > SMEM_BYTES:
            continue
        bands = -(-n // bm)
        if bands > 65535:
            continue
        cost = n * (bm + 32 * cw) + (SPLIT_BYTES if chunks > 1 else 0)
        if best is None or cost < best[0]:
            best = (cost, bm, cw)
    if best is None:
        raise ValueError(f"hop_step: n={n} does not fit one block's shared memory")
    return best[1], best[2]


def hop_step(reach: torch.Tensor, adj: torch.Tensor):
    """One hop for R restarts at once.

    ``reach``, ``adj``: (R, n, n) 0/1, ``torch.bool`` or ``torch.uint8``,
    the same type (a nonzero byte counts as 1). Returns ``(new_reach,
    counts)``: ``new_reach`` (R, n, n) 0/1 of the input type and ``counts``
    (R, n) int32, the number of nodes each source reaches in ``new_reach``.
    """
    if reach.dim() != 3 or reach.shape[1] != reach.shape[2] or adj.shape != reach.shape:
        raise ValueError(f"reach and adj must both be (R, n, n), got "
                         f"{tuple(reach.shape)} and {tuple(adj.shape)}")
    if reach.dtype not in _BYTES or adj.dtype != reach.dtype:
        raise TypeError(f"hop_step takes bool or uint8 0/1 matrices of one type, "
                        f"not {reach.dtype}/{adj.dtype}")
    dev = reach.device
    if dev.type == "cpu":
        return hop_step_plain(reach, adj)
    if dev.type != "cuda" or adj.device != dev:
        raise ValueError(f"reach and adj must lie on the CPU or one CUDA device, "
                         f"not {reach.device} and {adj.device}")
    if not (reach.is_contiguous() and adj.is_contiguous()):
        raise ValueError("reach and adj must be contiguous")
    R, n = int(reach.shape[0]), int(reach.shape[1])
    if R > 65535:
        raise ValueError(f"hop_step takes at most 65535 restarts, got {R}")
    new = torch.empty_like(reach)
    counts = torch.empty((R, n), dtype=torch.int32, device=dev)
    if R == 0 or n == 0:
        return new, counts
    index = dev.index
    bm, cw = hop_plan(R, n, _lu.sm_count(index))
    if cw < -(-n // 32):                          # the columns are split
        part, tickets = _lu.workspace("hop_step", dev, (R * n, torch.int32),
                                      (R * -(-n // bm), torch.int32))
    else:
        part = tickets = 0
    err = _lu.library("hop_bfs", _SIGNATURES).hop_step_u8(
        reach.data_ptr(), adj.data_ptr(), new.data_ptr(), counts.data_ptr(), part, tickets,
        R, n, bm, cw, index, _lu.raw_stream(index))
    if err != 0:
        _lu.raise_launch_error("hop_step", err, index)
    hop_step.launches += 1
    return new, counts


hop_step.launches = 0

