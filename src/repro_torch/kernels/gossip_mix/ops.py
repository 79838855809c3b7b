"""Eq. 1 gossip mixing of stacked worker parameters.

The CUDA kernels are ``csrc/gossip_mix.cu``; the plain PyTorch versions of
the reference's ``ref.py`` sit beside them. A wrapper takes its plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. Each wrapper counts its launches in ``fn.launches``.

Unlike the reference's wrapper, nothing is padded to (8, 1024) tiles and no
(n, deg, ...) neighbour gather is built: the batched kernel stages column
tiles of all n rows of a leaf in shared memory and reads every neighbour
from there, and :func:`gossip_mix_batched_leaves` mixes all leaves that
share a table in one launch per dtype. :func:`gossip_plan` is its plan, in
plain Python. :func:`gossip_mix_batched_witness` launches the first-cut
kernel, which no path calls: it is the new kernel's timing witness and
bitwise reference on the card.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from itertools import accumulate

import torch
from torch.utils._pytree import tree_map

from .. import launch_util as _lu

__all__ = ["gossip_mix_batched", "gossip_mix_batched_leaves", "gossip_mix_batched_plain",
           "gossip_mix_batched_witness", "gossip_mix", "gossip_mix_plain", "gossip_mix_tree",
           "GossipPlan", "gossip_plan", "max_rows"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "gossip_mix_batched_leaves": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P],
    "gossip_mix_batched_witness": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    "gossip_mix_single": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_DEG = 4095            # deg+1 row pointers and weights in 48 KB of shared memory

# The plan's constants below: tools/gossip_tune.py times each varied alone at
# the paths' shapes on the card.
SMEM_BYTES = 232_448       # a block's shared memory on the H100 (227 KB)
SMEM_PER_SM = 233_472      # an SM's (228 KB), 1 KB of it reserved for each resident block
STAGE_TARGET = 20 << 10    # a stage: n rows × the tile's bytes a row
RING_TARGET = 40 << 10     # the ring, 2 to 4 stages
MAX_TILE_BYTES = 8192      # a row's segment of one tile
MIN_SPLIT_BYTES = 128      # the narrowest tile a split for parallelism goes to
BULK_MIN_BYTES = 1024      # narrower rows of a tile come in by 16-byte cp.async
MAX_LEAVES = 128           # leaves of one launch (its parameters' 4 KB)
MIX_THREADS = 288          # eight consumer warps and the producer warp
MIN_BLOCKS = 4             # blocks an SM the kernel's registers allow (its launch bound)


@dataclass(frozen=True)
class GossipPlan:
    """The tiled kernel's launch: tiles of ``tile_bytes`` a row (a power of
    two, a multiple of 16) over all n rows, a ring of ``stages`` stages,
    ``smem`` bytes of shared memory a block, ``blocks`` blocks walking the
    tiles (``blocks_per_sm`` resident on an SM), ``tiles`` tiles in all,
    leaf l's tiles ending at ``tile_end[l]``; ``bulk``: aligned rows come in
    by ``cp.async.bulk``, else by 16-byte ``cp.async``."""
    tile_bytes: int
    tile_elems: int
    stages: int
    smem: int
    blocks: int
    blocks_per_sm: int
    tiles: int
    tile_end: tuple
    bulk: bool


def _smem(n: int, deg: int, tile_bytes: int, stages: int) -> int:
    """The ring, a full and an empty mbarrier a stage, the weights (n,
    deg+1) fp32 and the neighbours' offsets (n, deg) int32 — the kernel's
    ``tiles_smem``."""
    return stages * n * tile_bytes + 16 * stages + 4 * n * (deg + 1) + 4 * n * deg


def max_rows(deg: int) -> int:
    """The most rows n the kernel takes at ``deg``: two stages 16 bytes wide
    and the table within a block's shared memory (2,766 at deg 6, 1,760 at
    deg 12)."""
    return (SMEM_BYTES - 2 * 16) // (2 * 16 + 4 * (2 * deg + 1))


def gossip_plan(n: int, deg: int, M, size: int, sm_count: int) -> GossipPlan:
    """The plan for leaves of ``M`` elements a row (an int, or one per leaf
    of the launch) of ``size``-byte elements over an (n, deg) table, on a
    card of ``sm_count`` SMs.

    - Tile: the widest power of two up to 8 KB a row whose stage (n rows)
      fits in 20 KB, halved while the launch has fewer than two tiles an
      SM, down to 128 bytes.
    - Stages: as many as fit in 40 KB, 2 to 4, fewer where the table leaves
      no room (then a narrower tile).
    - Blocks: one per tile, at most as many as are resident at once (by
      shared memory, and 4 an SM by the kernel's registers); each walks
      its tiles with a stride of the grid.
    - Copies: one ``cp.async.bulk`` a row where a tile's row is 1 KB or
      more, else 16-byte ``cp.async`` spread over the producer's lanes.

    Raises ``ValueError`` past :func:`max_rows`: no narrower route exists.
    """
    Ms = (int(M),) if isinstance(M, int) else tuple(int(m) for m in M)
    return _plan(int(n), int(deg), Ms, int(size), int(sm_count))


@functools.lru_cache(maxsize=512)
def _plan(n: int, deg: int, Ms: tuple, size: int, sm_count: int) -> GossipPlan:
    if n < 1 or deg < 0 or size not in (2, 4) or any(m < 0 for m in Ms):
        raise ValueError(f"gossip_plan: bad n={n}, deg={deg}, size={size} or M={Ms}")
    limit = max_rows(deg)
    if n > limit:
        raise ValueError(f"gossip_mix_batched takes at most {limit:,} rows at deg {deg} (two "
                         f"stages 16 bytes wide and the neighbour table in {SMEM_BYTES:,} "
                         f"bytes of shared memory), got n = {n:,}")

    def tiles_at(tb):
        per = tb // size
        return [-(-m // per) for m in Ms]

    tb = MAX_TILE_BYTES
    while tb > 16 and n * tb > STAGE_TARGET:
        tb //= 2
    while tb > MIN_SPLIT_BYTES and sum(tiles_at(tb)) < 2 * sm_count:
        tb //= 2
    stages = max(2, min(4, RING_TARGET // (n * tb)))
    while stages > 2 and _smem(n, deg, tb, stages) > SMEM_BYTES:
        stages -= 1
    while _smem(n, deg, tb, stages) > SMEM_BYTES:
        tb //= 2                                # ends at 16 bytes by the limit above
    smem = _smem(n, deg, tb, stages)
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), MIN_BLOCKS))
    counts = tiles_at(tb)
    tiles = sum(counts)
    if tiles >= 1 << 31:
        raise ValueError(f"gossip_mix_batched: {tiles:,} tiles exceed the kernel's int32 count")
    return GossipPlan(tile_bytes=tb, tile_elems=tb // size, stages=stages, smem=smem,
                      blocks=max(1, min(tiles, sm_count * per_sm)),
                      blocks_per_sm=per_sm, tiles=tiles, tile_end=tuple(accumulate(counts)),
                      bulk=tb >= BULK_MIN_BYTES)


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


def _aligned(row_elems: int, size: int, *tensors) -> int:
    """1 when every row of every operand starts 16-byte aligned."""
    return int((row_elems * size) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_types(x, weights) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"gossip mixing takes float32, bfloat16 or float16, not {x.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, not {weights.dtype}")


def _check_batched(x, nbr_idx, weights) -> tuple[int, int]:
    """(n, deg) of a stacked leaf over its table, or raise."""
    if x.dim() < 1 or nbr_idx.dim() != 2 or nbr_idx.shape[0] != x.shape[0]:
        raise ValueError(f"x must be (n, ...) and nbr_idx (n, deg), got "
                         f"{tuple(x.shape)} and {tuple(nbr_idx.shape)}")
    n, deg = int(nbr_idx.shape[0]), int(nbr_idx.shape[1])
    if tuple(weights.shape) != (n, deg + 1):
        raise ValueError(f"weights must be (n, deg+1) = {(n, deg + 1)}, "
                         f"got {tuple(weights.shape)}")
    _check_types(x, weights)
    return n, deg


def gossip_mix_batched_leaves(leaves, nbr_idx: torch.Tensor,
                              weights: torch.Tensor) -> list[torch.Tensor]:
    """Mix every leaf of ``leaves`` (each (n, ...) stacked copies, float32,
    bfloat16 or float16, any mix) over one table, in one launch per dtype
    present (per 128 leaves of it).

    ``nbr_idx``: (n, deg) int32 neighbour rows (padded slots point at the
    row itself); ``weights``: (n, deg+1) float32, column 0 the self
    weight, padded slots 0 — the layout of
    :func:`repro_torch.dsgd.gossip.padded_neighbors`. Returns one tensor a
    leaf, in its shape and dtype. The leaves' pointers and row lengths
    travel in the kernel's parameters: no copy to the card, no sync. Raises
    ``ValueError`` for more rows than :func:`max_rows` allows at deg.
    """
    leaves = list(leaves)
    for x in leaves:
        _check_batched(x, nbr_idx, weights)
    on_cpu = [x.device.type == "cpu" for x in leaves]
    if all(on_cpu):
        return [gossip_mix_batched_plain(x, nbr_idx, weights) for x in leaves]
    if any(on_cpu):
        raise ValueError("gossip_mix_batched_leaves: the leaves lie on the CPU and on a card")
    if nbr_idx.dtype != torch.int32:
        raise TypeError(f"nbr_idx must be int32, not {nbr_idx.dtype}")
    _check_card(nbr_idx=nbr_idx, weights=weights)
    for k, x in enumerate(leaves):
        _check_card(**{f"leaf {k}": x})
    n, deg = int(nbr_idx.shape[0]), int(nbr_idx.shape[1])
    outs = [torch.empty_like(x) for x in leaves]
    index = leaves[0].device.index
    groups: dict = {}
    for k, x in enumerate(leaves):
        if x.numel():
            groups.setdefault(x.dtype, []).append(k)
    if not groups:
        return outs
    lib = _lu.library("gossip_mix", _SIGNATURES)
    stream = _lu.raw_stream(index)
    sms = _lu.sm_count(index)
    for dtype, ks in groups.items():
        size = leaves[ks[0]].element_size()
        for at in range(0, len(ks), MAX_LEAVES):
            part = ks[at:at + MAX_LEAVES]
            Ms = [leaves[k].numel() // n for k in part]
            plan = gossip_plan(n, deg, Ms, size, sms)
            c = len(part)
            err = lib.gossip_mix_batched_leaves(
                (_P * c)(*[leaves[k].data_ptr() for k in part]),
                (_P * c)(*[outs[k].data_ptr() for k in part]),
                (_LL * c)(*Ms), (_I * c)(*plan.tile_end),
                (ctypes.c_ubyte * c)(*[_aligned(m, size, leaves[k]) for k, m in zip(part, Ms)]),
                (ctypes.c_ubyte * c)(*[_aligned(m, size, outs[k]) for k, m in zip(part, Ms)]),
                c, nbr_idx.data_ptr(), weights.data_ptr(), n, deg, plan.tile_bytes, plan.stages,
                plan.blocks, int(plan.bulk), _DTYPES[dtype], stream)
            if err != 0:
                _lu.raise_launch_error("gossip_mix_batched", err, index)
            gossip_mix_batched.launches += 1
    return outs


def gossip_mix_batched(x: torch.Tensor, nbr_idx: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Mix all n workers' copies of one leaf: :func:`gossip_mix_batched_leaves`
    of one leaf, one launch. Returns x's shape and dtype."""
    _check_batched(x, nbr_idx, weights)
    return gossip_mix_batched_leaves([x], nbr_idx, weights)[0]


def gossip_mix_batched_witness(x: torch.Tensor, nbr_idx: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """The first-cut batched kernel on one leaf (a block per worker row,
    each neighbour row read through the table): no path calls it; it is the
    tiled kernel's timing witness and bitwise reference on the card. Its
    launches count in ``gossip_mix_batched_witness.launches``, which
    :mod:`repro_torch.kernels` does not list. The CPU takes the plain
    version."""
    n, deg = _check_batched(x, nbr_idx, weights)
    if x.device.type == "cpu":
        return gossip_mix_batched_plain(x, nbr_idx, weights)
    if nbr_idx.dtype != torch.int32:
        raise TypeError(f"nbr_idx must be int32, not {nbr_idx.dtype}")
    if deg > _MAX_DEG:
        raise ValueError(f"gossip_mix_batched_witness takes deg ≤ {_MAX_DEG}, got {deg}")
    _check_card(x=x, nbr_idx=nbr_idx, weights=weights)
    out = torch.empty_like(x)
    M = x.numel() // n if n else 0
    if M == 0:
        return out
    index = x.device.index
    err = _lu.library("gossip_mix", _SIGNATURES).gossip_mix_batched_witness(
        x.data_ptr(), nbr_idx.data_ptr(), weights.data_ptr(), out.data_ptr(), n, M, deg,
        _DTYPES[x.dtype], _aligned(M, x.element_size(), x, out), _lu.raw_stream(index))
    if err != 0:
        _lu.raise_launch_error("gossip_mix_batched_witness", err, index)
    gossip_mix_batched_witness.launches += 1
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
    index = x.device.index
    err = _lu.library("gossip_mix", _SIGNATURES).gossip_mix_single(
        x.data_ptr(), nbrs.data_ptr(), weights.data_ptr(), out.data_ptr(), M, deg,
        _DTYPES[x.dtype], _aligned(M, x.element_size(), x, nbrs, out), _lu.raw_stream(index))
    if err != 0:
        _lu.raise_launch_error("gossip_mix", err, index)
    gossip_mix.launches += 1
    return out


def gossip_mix_tree(params, nbr_params, weights: torch.Tensor):
    """:func:`gossip_mix` leaf by leaf over a parameter pytree: ``params`` a
    pytree of one worker's tensors, ``nbr_params`` the same pytree with a
    leading (deg,) axis on every leaf, ``weights`` (deg+1,) float32."""
    return tree_map(lambda x, nb: gossip_mix(x, nb, weights), params, nbr_params)


gossip_mix_batched.launches = 0
gossip_mix_batched_witness.launches = 0
gossip_mix.launches = 0
