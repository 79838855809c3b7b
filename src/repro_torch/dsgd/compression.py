"""CHOCO-Gossip: compressed consensus (the reference's ``repro/dsgd/compression.py``).

Each round transmits compress(x − x̂) instead of x; under the paper's time
model (Eq. 34) the per-iteration cost scales by the compression ratio ω,
while CHOCO's error feedback keeps convergence:

    q_i   = C(x_i − x̂_i)                 (compressed innovation)
    x̂_j  += q_j  for every neighbour j   (all nodes track the same x̂'s)
    x_i  += γ Σ_j W_ij (x̂_j − x̂_i)      (gossip on the estimates)

The compressors and ``choco_mix`` are shared by the engines of
:mod:`repro_torch.dsgd.sim` and the step loop here. ``choco_mix`` takes the
product (W − I)x̂ either as a dense matmul or, given a neighbour table whose
column 0 holds float32(W_ii − 1), through the ``gossip_mix_batched`` kernel.

Random-k draws its masks from a ``torch.Generator``: the reference's
``jax.random.bernoulli`` stream cannot be reproduced, so the two agree in
distribution (kept fraction, 1/frac scaling), not in bits.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.gossip_mix.ops import gossip_mix_batched

__all__ = ["Compressor", "compress_top_k", "compress_random_k",
           "compression_ratio", "top_k_compressor", "random_k_compressor",
           "identity_compressor", "ChocoState", "choco_gossip_init",
           "choco_gossip_step", "choco_mix", "choco_gamma"]


class Compressor(NamedTuple):
    fn: Callable            # (x, generator) -> sparse y with x's shape
    ratio: float            # transmitted fraction of the dense bytes
    name: str


def compression_ratio(frac: float) -> float:
    """Transmitted fraction ω of the dense bytes for a sparsifying compressor:
    indices cost ~half a float each in practice, so charge 1.5× values."""
    return min(1.5 * frac, 1.0)


def _kth_largest_bitselect(absx: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest per row of a non-negative float array, by radix
    select over its bit patterns; shape ``absx.shape[:-1] + (1,)``.

    For non-negative IEEE floats value order is the unsigned order of the
    bit patterns, and with the sign bit 0 it is also the order of their
    ``int32``/``int64`` views, which torch has (it lacks ``uint32``/
    ``uint64`` comparisons). The k-th largest is built top-down: keep bit b
    iff at least k elements match the prefix. The sign bit is never set in
    the answer, so the loop starts below it. Bit-identical to
    ``torch.topk(absx, k).values[..., k-1]``, the threshold
    :func:`compress_top_k` takes, and to the reference's radix select
    (its CPU path), which the tests hold it against.
    """
    bits = 64 if absx.dtype == torch.float64 else 32
    if absx.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bitselect takes float32 or float64, not {absx.dtype}")
    idt = torch.int64 if bits == 64 else torch.int32
    v = absx.contiguous().view(idt)
    prefix = torch.zeros(absx.shape[:-1], dtype=idt, device=absx.device)
    one = torch.ones((), dtype=idt, device=absx.device)
    for b in range(bits - 2, -1, -1):
        cand = prefix | (one << b)
        cnt = (v >= cand[..., None]).sum(dim=-1)
        prefix = torch.where(cnt >= k, cand, prefix)
    return prefix.view(absx.dtype)[..., None]


def compress_top_k(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top-⌈frac·d⌉ magnitudes per worker row, zero the rest.

    The threshold is the exact k-th largest |x| (``torch.topk``) and the
    kept set is ``|x| >= thresh`` (ties kept), as the reference's.
    """
    flat = x.reshape(x.shape[0], -1)
    k = max(int(np.ceil(frac * flat.shape[1])), 1)
    absx = torch.abs(flat)
    thresh = torch.topk(absx, k, dim=1).values[:, k - 1:k]
    mask = absx >= thresh
    return (flat * mask).reshape(x.shape)


def random_k_mask(shape, frac: float, generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(frac) keep-mask of ``shape`` drawn from ``generator``, on
    the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u < frac


def compress_random_k(x: torch.Tensor, frac: float, generator: torch.Generator,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Unbiased random-k sparsification (kept entries scaled by 1/frac).

    The keep-mask (one per worker row and element) is drawn from
    ``generator`` unless ``mask`` gives it: the batched engines draw one
    (n, d) mask per leaf and step and share it across runs, as the
    reference's vmap shares its key."""
    flat = x.reshape(x.shape[0], -1)
    if mask is None:
        mask = random_k_mask(flat.shape, frac, generator)
    return (flat * mask.reshape(flat.shape) / frac).reshape(x.shape)


def top_k_compressor(frac: float) -> Compressor:
    """Keep the top-⌈frac·d⌉ magnitudes (per worker), zero the rest."""
    return Compressor(lambda x, gen: compress_top_k(x, frac),
                      compression_ratio(frac), f"top{int(frac * 100)}%")


def random_k_compressor(frac: float) -> Compressor:
    """Unbiased random-k sparsification (scaled by 1/frac)."""
    return Compressor(lambda x, gen: compress_random_k(x, frac, gen),
                      compression_ratio(frac), f"rand{int(frac * 100)}%")


def identity_compressor() -> Compressor:
    return Compressor(lambda x, gen: x, 1.0, "dense")


class ChocoState(NamedTuple):
    x: torch.Tensor        # (n, d) worker values
    x_hat: torch.Tensor    # (n, d) public estimates (identical on all nodes)


def choco_gamma(topo, delta: float) -> float:
    """The CHOCO paper's practical step size γ = δ/(8 + δ)."""
    return delta / (8.0 + delta)


def choco_gossip_init(x0: torch.Tensor) -> ChocoState:
    return ChocoState(x=x0, x_hat=torch.zeros_like(x0))


def choco_weights(weights: torch.Tensor) -> torch.Tensor:
    """Kernel weights of (W − I) from those of W: column 0 becomes
    float32(W_ii − 1), the value the reference's float32 ``W - eye`` holds."""
    return torch.cat([weights[..., :1] - 1.0, weights[..., 1:]], dim=-1)


def choco_mix(x: torch.Tensor, x_hat: torch.Tensor, W: torch.Tensor | None, gamma, *,
              nbr: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """x + γ (W − I) x̂ on a stacked ``(n, ...)`` tensor.

    Without ``nbr`` the product is the dense ``(W − I) @ x̂`` in W's dtype
    (as the reference's ``dot_general``); a (B, n, n) W mixes B runs'
    (B, n, d) values. With ``nbr = (idx, w)``, a
    neighbour table whose weights already hold (W − I) (see
    :func:`choco_weights`), it is one ``gossip_mix_batched`` launch and W is
    not read. ``gamma`` is a scalar or a tensor that broadcasts over x.
    """
    if nbr is not None:
        delta = gossip_mix_batched(x_hat, *nbr)
    elif W.dim() == 2:
        A = W - torch.eye(W.shape[-1], dtype=W.dtype, device=W.device)
        delta = (A @ x_hat.reshape(x_hat.shape[0], -1)).reshape(x_hat.shape)
    else:                                   # (B, n, n) over (B, n, d): B runs at once
        delta = (W - torch.eye(W.shape[-1], dtype=W.dtype, device=W.device)) @ x_hat
    return x + gamma * delta


def choco_gossip_step(state: ChocoState, W: torch.Tensor, comp: Compressor,
                      gamma: float, generator: torch.Generator | None) -> ChocoState:
    q = comp.fn(state.x - state.x_hat, generator)     # innovation, compressed
    x_hat = state.x_hat + q                           # everyone updates copies
    return ChocoState(x=choco_mix(state.x, x_hat, W, gamma), x_hat=x_hat)
