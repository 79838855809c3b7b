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

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "softcap", "dense_init", "embed_init",
           "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """The parameter dtype of a config's ``dtype`` string."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
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
