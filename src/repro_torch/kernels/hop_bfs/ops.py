"""One matmul-BFS hop over a batch of restarts.

The CUDA kernel is ``csrc/hop_bfs.cu``; the plain PyTorch version sits
beside it. The wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. It counts its
launches in ``hop_step.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build as _build

__all__ = ["hop_step", "hop_step_plain"]

_P = ctypes.c_void_p
_SIGNATURES = {"hop_step_u8": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]}
_BYTES = (torch.bool, torch.uint8)


def hop_step_plain(reach: torch.Tensor, adj: torch.Tensor):
    """``new = reach ∨ (reach @ adj)`` by a float32 batched product of the
    0/1 matrices (exact: row sums ≤ n), plus each row's reach count."""
    prod = torch.bmm(reach.to(torch.float32), adj.to(torch.float32))
    new = (reach != 0) | (prod > 0)
    return new.to(reach.dtype), new.sum(dim=-1, dtype=torch.int32)


def hop_step(reach: torch.Tensor, adj: torch.Tensor):
    """One hop for R restarts at once.

    ``reach``, ``adj``: (R, n, n) 0/1, ``torch.bool`` or ``torch.uint8``,
    the same type. Returns ``(new_reach, counts)``: ``new_reach`` (R, n, n)
    of the input type and ``counts`` (R, n) int32, the number of nodes each
    source reaches in ``new_reach``.
    """
    if reach.dim() != 3 or reach.shape[1] != reach.shape[2] or adj.shape != reach.shape:
        raise ValueError(f"reach and adj must both be (R, n, n), got "
                         f"{tuple(reach.shape)} and {tuple(adj.shape)}")
    if reach.dtype not in _BYTES or adj.dtype != reach.dtype:
        raise TypeError(f"hop_step takes bool or uint8 0/1 matrices of one type, "
                        f"not {reach.dtype}/{adj.dtype}")
    if reach.device.type == "cpu":
        return hop_step_plain(reach, adj)
    for t, what in ((reach, "reach"), (adj, "adj")):
        if t.device.type != "cuda":
            raise ValueError(f"{what} must lie on the CPU or a CUDA device, "
                             f"not {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{what} lies on {t.device}, but the current "
                             f"CUDA device is cuda:{torch.cuda.current_device()}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    R, n = int(reach.shape[0]), int(reach.shape[1])
    if R > 65535:
        raise ValueError(f"hop_step takes at most 65535 restarts, got {R}")
    new = torch.empty_like(reach)
    counts = torch.empty((R, n), dtype=torch.int32, device=reach.device)
    lib = _build.load("hop_bfs", _SIGNATURES)
    err = lib.hop_step_u8(reach.data_ptr(), adj.data_ptr(), new.data_ptr(),
                          counts.data_ptr(), R, n,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hop_step kernel launch failed with CUDA error {err}")
    hop_step.launches += 1
    return new, counts


hop_step.launches = 0
