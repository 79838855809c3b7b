"""Shared model building blocks: functions of explicit parameter dicts.

Mirrors ``repro/models/common.py``: ``rms_norm`` scales by ``1 + scale`` and
computes in float32; ``apply_rope`` rotates the two split halves of the head
dimension (not interleaved pairs). Initializers draw from an explicit
``torch.Generator``, so they give other numbers than ``jax.random``; the
parity tests carry one set of weights to both packages instead.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "softcap", "dense_init", "embed_init",
           "torch_dtype", "tp_reduce", "tp_matmul"]


def torch_dtype(name: str) -> torch.dtype:
    """The parameter dtype of a config's ``dtype`` string."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending partial sums reduced (an explicit all-reduce
    over the mesh dims that hold them), as the tensor-parallel steps want
    after every matmul that contracts a sharded dim; a plain tensor, or a
    DTensor with none, as it is."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in x.placements])
    return x


def tp_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; on a DTensor weight, Megatron's layouts and FSDP's gather:
    over each mesh dim the weight keeps a shard of its contracting dim only
    where ``x`` is sharded on its last dim there (row-parallel), and a shard
    of its output dim only where ``x`` is not sharded there
    (column-parallel); any other shard of the weight is gathered first (an
    explicit all-gather), and the product's partial sums are reduced
    (:func:`tp_reduce`). A plain ``w``: ``x @ w`` as it is."""
    if isinstance(w, DTensor):
        xp = x.placements if isinstance(x, DTensor) else [Replicate()] * w.device_mesh.ndim
        want = []
        for p, q in zip(w.placements, xp):
            row = p.is_shard(w.ndim - 2) and q.is_shard(x.ndim - 1)
            col = p.is_shard(w.ndim - 1) and not q.is_shard()
            want.append(p if row or col else Replicate())
        if want != list(w.placements):
            w = w.redistribute(w.device_mesh, want)
    return tp_reduce(x @ w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if isinstance(scale, DTensor):
        # a scale sharded over the model dim (its spec) would shard the
        # normed activations along the dim the next matmul contracts: gather
        # the (d,) scale instead (an explicit all-gather of d values)
        scale = scale.redistribute(scale.device_mesh, [Replicate()] * scale.device_mesh.ndim)
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap · tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)            # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs             # (..., seq, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               lead: tuple = ()) -> torch.Tensor:
    """N(0, 1/in_dim) weights of shape ``lead + (in_dim, out_dim)``, drawn in
    float32 on the generator's device and cast to ``dtype``."""
    w = torch.randn(lead + (in_dim, out_dim), generator=gen, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32)
    return (w * 0.02).to(dtype)
