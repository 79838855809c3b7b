"""Grouped-query attention with full / sliding-window masks, optional score
soft-capping (Gemma-2) and QKV bias (Qwen1.5): the full-sequence (train)
path of ``repro/models/attention.py``.

Shapes:
  x              (B, S, D)
  q              (B, S, Hq, hd)
  k, v           (B, S, Hkv, hd)

Masked scores are −1e30 and the softmax runs in float32, as in the
reference. ``attend_full`` takes the score product in the input dtype and
only then casts to float32, which is where the reference rounds. The KV
cache and the single-token decode path wait for the serving slice.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import apply_rope, dense_init, softcap

__all__ = ["init_attn", "attend_full", "attend_chunked", "attn_forward"]

_MASKED = -1e30


def init_attn(gen: torch.Generator, cfg, dtype, lead: tuple = ()) -> dict:
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, lead),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, lead),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, lead),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (cfg.num_heads * hd,), dtype=dtype)
        p["bk"] = torch.zeros(lead + (cfg.num_kv_heads * hd,), dtype=dtype)
        p["bv"] = torch.zeros(lead + (cfg.num_kv_heads * hd,), dtype=dtype)
    return p


def _qkv(params, x, cfg):
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def attend_full(q, k, v, mask, attn_softcap: float = 0.0):
    """q: (B,Sq,Hq,hd); k,v: (B,Sk,Hkv,hd); mask: (B,1,Sq,Sk) or
    broadcastable. GQA: query heads grouped onto kv heads."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() / math.sqrt(hd)
    if attn_softcap:
        scores = softcap(scores, attn_softcap)
    scores = torch.where(mask[:, :, None] if mask.dim() == 4 else mask, scores, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, hd)


def _causal_mask(S: int, window: int, device=None) -> torch.Tensor:
    """Causal(+sliding-window) mask (1, 1, S, S); ``window`` 0 = full causal."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m[None, None]


def attend_chunked(q, k, v, window: int, attn_softcap: float = 0.0, *, chunk: int = 1024,
                   causal: bool = True):
    """Flash-style online-softmax attention, a loop over KV chunks, all in
    float32. q: (B,S,Hq,hd); k,v: (B,S,Hkv,hd); window 0 = full causal.
    The reference checkpoints each chunk's body to save memory; here the
    chunks are recorded for backward as they run."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    C = min(chunk, S)
    while S % C:  # largest divisor of S ≤ chunk
        C -= 1
    nc = S // C
    qf = q.reshape(B, S, Hkv, group, hd).float()
    kc = k.reshape(B, nc, C, Hkv, hd).float()
    vc = v.reshape(B, nc, C, Hkv, hd).float()
    qpos = torch.arange(S, device=q.device)
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))

    m = torch.full((B, S, Hkv, group), _MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, Hkv, group), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Hkv, group, hd), dtype=torch.float32, device=q.device)
    for c in range(nc):
        kpos = c * C + torch.arange(C, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc[:, c]) * scale
        if attn_softcap:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        msk = (kpos[None, :] <= qpos[:, None] if causal
               else torch.ones((S, C), dtype=torch.bool, device=q.device))
        if window > 0:
            msk = msk & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(msk[None, :, None, None, :], s, _MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc[:, c])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def attn_forward(params, x, cfg, *, window: int = 0, positions=None, cache=None,
                 chunked: bool = True):
    """Full-sequence forward (train). Returns ``(out, None)``: the second
    slot is the reference's new KV cache, which the port does not build yet."""
    if cache is not None:
        raise NotImplementedError(
            "attn_forward with a KV cache is not ported yet: it waits for the "
            "serving slice (ROADMAP.md, Queue 1, 'Serving and decode')")
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if chunked and S > 128:
        out = attend_chunked(q, k, v, window, cfg.attn_logit_softcap)
    else:
        out = attend_full(q, k, v, _causal_mask(S, window, x.device), cfg.attn_logit_softcap)
    hd = cfg.resolved_head_dim
    return out.reshape(B, S, cfg.num_heads * hd) @ params["wo"], None
