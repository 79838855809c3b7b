"""Eq. 1 gossip mixing of stacked worker parameters.

The CUDA kernels are ``csrc/gossip_mix.cu``; the plain PyTorch versions of
the reference's ``ref.py`` sit beside them. A wrapper takes its plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. Each wrapper counts its launches in ``fn.launches``.

Unlike the reference's wrapper, nothing is padded to (8, 1024) tiles and no
(n, deg, ...) neighbour gather is built: the batched kernel reads each
neighbour row through ``nbr_idx`` itself.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils._pytree import tree_map

from ...device import DeviceFault
from .. import build as _build

__all__ = ["gossip_mix_batched", "gossip_mix_batched_plain", "gossip_mix",
           "gossip_mix_plain", "gossip_mix_tree"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "gossip_mix_batched": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    "gossip_mix_single": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_DEG = 4095            # deg+1 row pointers and weights in 48 KB of shared memory


def gossip_mix_batched_plain(x: torch.Tensor, nbr_idx: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """``ref.gossip_mix_batched``: w[i,0]·x[i] + Σ_d w[i,d+1]·x[nbr_idx[i,d]]
    for every worker i, in float32, cast to x's dtype."""
    w = weights.float()
    tail = (1,) * (x.dim() - 1)
    nbrs = x[nbr_idx.long()].float()                       # (n, deg) + x.shape[1:]
    acc = x.float() * w[:, 0].reshape((-1,) + tail)
    acc = acc + torch.sum(nbrs * w[:, 1:].reshape(tuple(nbr_idx.shape) + tail), dim=1)
    return acc.to(x.dtype)


def gossip_mix_plain(x: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``ref.gossip_mix``: w[0]·x + Σ_d w[d+1]·nbrs[d] in float32, cast to
    x's dtype."""
    w = weights.float()
    acc = x.float() * w[0]
    acc = acc + torch.tensordot(w[1:], nbrs.float(), dims=([0], [0]))
    return acc.to(x.dtype)


def _check_card(**tensors) -> None:
    for what, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{what} lies on {t.device}, but the current CUDA device "
                             f"is cuda:{torch.cuda.current_device()}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _vector(row_elems: int, size: int, *tensors) -> int:
    """1 when every row of every operand starts 16-byte aligned."""
    return int((row_elems * size) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_types(x, weights) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"gossip mixing takes float32, bfloat16 or float16, not {x.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, not {weights.dtype}")


def gossip_mix_batched(x: torch.Tensor, nbr_idx: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Mix all n workers' copies of one leaf in one launch.

    ``x``: (n, ...) stacked copies; ``nbr_idx``: (n, deg) int32 neighbour
    rows (padded slots point at the row itself); ``weights``: (n, deg+1)
    float32, column 0 the self weight, padded slots 0 — the layout of
    :func:`repro_torch.dsgd.gossip.padded_neighbors`. Returns x's shape
    and dtype.
    """
    if x.dim() < 1 or nbr_idx.dim() != 2 or nbr_idx.shape[0] != x.shape[0]:
        raise ValueError(f"x must be (n, ...) and nbr_idx (n, deg), got "
                         f"{tuple(x.shape)} and {tuple(nbr_idx.shape)}")
    n, deg = int(nbr_idx.shape[0]), int(nbr_idx.shape[1])
    if tuple(weights.shape) != (n, deg + 1):
        raise ValueError(f"weights must be (n, deg+1) = {(n, deg + 1)}, "
                         f"got {tuple(weights.shape)}")
    _check_types(x, weights)
    if x.device.type == "cpu":
        return gossip_mix_batched_plain(x, nbr_idx, weights)
    if nbr_idx.dtype != torch.int32:
        raise TypeError(f"nbr_idx must be int32, not {nbr_idx.dtype}")
    if deg > _MAX_DEG:
        raise ValueError(f"gossip_mix_batched takes deg ≤ {_MAX_DEG}, got {deg}")
    _check_card(x=x, nbr_idx=nbr_idx, weights=weights)
    out = torch.empty_like(x)
    M = x.numel() // n if n else 0
    if M == 0:
        return out
    lib = _build.load("gossip_mix", _SIGNATURES)
    err = lib.gossip_mix_batched(
        x.data_ptr(), nbr_idx.data_ptr(), weights.data_ptr(), out.data_ptr(), n, M, deg,
        _DTYPES[x.dtype], _vector(M, x.element_size(), x, out),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise DeviceFault(f"gossip_mix_batched kernel launch failed with CUDA error {err}")
    gossip_mix_batched.launches += 1
    return out


def gossip_mix(x: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mix one worker's leaf with its neighbours' copies.

    ``x``: any shape; ``nbrs``: (deg,) + x.shape; ``weights``: (deg+1,)
    float32, ``weights[0]`` the self weight (one row of W). Returns x's
    shape and dtype.
    """
    deg = int(nbrs.shape[0]) if nbrs.dim() else -1
    if deg < 0 or tuple(nbrs.shape[1:]) != tuple(x.shape):
        raise ValueError(f"nbrs must be (deg,) + x.shape = (deg,) + {tuple(x.shape)}, "
                         f"got {tuple(nbrs.shape)}")
    if tuple(weights.shape) != (deg + 1,):
        raise ValueError(f"weights must be (deg+1,) = {(deg + 1,)}, got {tuple(weights.shape)}")
    _check_types(x, weights)
    if nbrs.dtype != x.dtype:
        raise TypeError(f"nbrs must have x's dtype {x.dtype}, not {nbrs.dtype}")
    if x.device.type == "cpu":
        return gossip_mix_plain(x, nbrs, weights)
    if deg > _MAX_DEG:
        raise ValueError(f"gossip_mix takes deg ≤ {_MAX_DEG}, got {deg}")
    _check_card(x=x, nbrs=nbrs, weights=weights)
    out = torch.empty_like(x)
    M = x.numel()
    if M == 0:
        return out
    lib = _build.load("gossip_mix", _SIGNATURES)
    err = lib.gossip_mix_single(
        x.data_ptr(), nbrs.data_ptr(), weights.data_ptr(), out.data_ptr(), M, deg,
        _DTYPES[x.dtype], _vector(M, x.element_size(), x, nbrs, out),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise DeviceFault(f"gossip_mix kernel launch failed with CUDA error {err}")
    gossip_mix.launches += 1
    return out


def gossip_mix_tree(params, nbr_params, weights: torch.Tensor):
    """:func:`gossip_mix` leaf by leaf over a parameter pytree: ``params`` a
    pytree of one worker's tensors, ``nbr_params`` the same pytree with a
    leading (deg,) axis on every leaf, ``weights`` (deg+1,) float32."""
    return tree_map(lambda x, nb: gossip_mix(x, nb, weights), params, nbr_params)


gossip_mix_batched.launches = 0
gossip_mix.launches = 0
