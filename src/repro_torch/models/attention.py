"""Grouped-query attention with full / sliding-window masks, optional score
soft-capping (Gemma-2) and QKV bias (Qwen1.5); the full-sequence (train and
prefill) and single-token decode paths of ``repro/models/attention.py``,
with an explicit KV cache.

Shapes:
  x              (B, S, D)
  q              (B, S, Hq, hd)
  k, v           (B, S, Hkv, hd)
  cache k/v      (B, C, Hkv, hd)   C = cache capacity (full sequence or window)

Masked scores are −1e30 and the softmax runs in float32, as in the
reference. ``attend_full`` takes the score product in the input dtype and
only then casts to float32, which is where the reference rounds. The
reference returns a new cache and donates the old one; here the cache is
written in place and returned.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from torch.distributed.tensor import DTensor, Replicate

from ..kernels.decode_attention import ops as _dec_ops
from .common import apply_rope, dense_init, softcap, tp_matmul

__all__ = ["init_attn", "attend_full", "attend_chunked", "attn_forward", "attn_decode",
           "decode_valid", "KVCache", "init_kv_cache"]

_MASKED = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, Hkv, hd)
    v: torch.Tensor
    # the ring-buffer write slot follows from the absolute position


def init_kv_cache(batch: int, capacity: int, kv_heads: int, head_dim: int, dtype,
                  device=None) -> KVCache:
    shape = (batch, capacity, kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


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


def attn_forward(params, x, cfg, *, window: int = 0, positions=None,
                 cache: KVCache | None = None, chunked: bool = True):
    """Full-sequence forward (train / prefill). Returns ``(out, cache)``.

    With a cache of capacity C ≥ S, k and v go to slots [0, S) (the
    reference's ``dynamic_update_slice`` at 0); with C < S the cache keeps
    the last C positions at slot = position mod C (the reference's
    ``roll(k[:, S−C:], S mod C)``). The cache is written in place."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if isinstance(params["wq"], DTensor):
        if cache is not None:
            raise NotImplementedError("a KV cache over DTensor weights is serving over a mesh "
                                      "(ROADMAP.md, Queue 1, item 7c′)")
        return _attn_forward_tp(params, x, cfg, window, positions, chunked), None
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if chunked and S > 128:
        out = attend_chunked(q, k, v, window, cfg.attn_logit_softcap)
    else:
        out = attend_full(q, k, v, _causal_mask(S, window, x.device), cfg.attn_logit_softcap)
    if cache is not None:
        C = cache.k.shape[1]
        if cache.k.shape[0] != B or tuple(cache.k.shape[2:]) != tuple(k.shape[2:]):
            raise ValueError(f"cache {tuple(cache.k.shape)} does not fit keys "
                             f"{tuple(k.shape)}: need (B, C, Hkv, hd)")
        if C >= S:
            cache.k[:, :S] = k
            cache.v[:, :S] = v
        else:
            cache.k.copy_(torch.roll(k[:, S - C:], S % C, dims=1))
            cache.v.copy_(torch.roll(v[:, S - C:], S % C, dims=1))
    hd = cfg.resolved_head_dim
    return out.reshape(B, S, cfg.num_heads * hd) @ params["wo"], cache


def _head_placements(t: DTensor, heads: int) -> list:
    """Where a (B, S, heads·hd) projection's heads may stay sharded: the
    batch dim's shards and a head-dim shard over a mesh dim that divides
    ``heads`` stay, everything else is replicated."""
    mesh = t.device_mesh
    return [p if p.is_shard(0) or (p.is_shard(2) and heads % mesh.size(i) == 0) else Replicate()
            for i, p in enumerate(t.placements)]


def _attn_forward_tp(params, x, cfg, window: int, positions, chunked: bool):
    """The full-sequence forward on DTensor weights (the tensor-parallel
    train steps), Megatron's head-parallel attention: q, k, v are the
    column-parallel products (partial sums reduced), each rank attends over
    its local heads (and batch rows) as plain tensors, with the same code
    as one device, and ``wo`` takes the heads back row-parallel. Heads stay
    sharded over a mesh dim only where it divides the kv heads (so the
    query groups stay with their kv head); elsewhere q, k and v are
    gathered (an explicit redistribution) and every rank of that dim
    attends over all heads."""
    hd = cfg.resolved_head_dim
    q, k, v = (tp_matmul(x, params[w]) for w in ("wq", "wk", "wv"))
    if "bq" in params:
        q, k, v = (t + _like_last_dim(params[b], t) for t, b in zip((q, k, v), ("bq", "bk", "bv")))
    want = _head_placements(k, cfg.num_kv_heads)
    if want != _head_placements(q, cfg.num_heads):
        want = [p if p.is_shard(0) else Replicate() for p in want]
    q, k, v = (t.redistribute(t.device_mesh, want) for t in (q, k, v))
    local = [t.to_local() for t in (q, k, v)]
    Bl, S = local[0].shape[:2]
    ql, kl, vl = (t.reshape(Bl, S, -1, hd) for t in local)
    ql = apply_rope(ql, positions, cfg.rope_theta)
    kl = apply_rope(kl, positions, cfg.rope_theta)
    if chunked and S > 128:
        out = attend_chunked(ql, kl, vl, window, cfg.attn_logit_softcap)
    else:
        out = attend_full(ql, kl, vl, _causal_mask(S, window, ql.device), cfg.attn_logit_softcap)
    out = DTensor.from_local(out.reshape(Bl, S, -1), q.device_mesh, want, run_check=False)
    return tp_matmul(out, params["wo"])


def _like_last_dim(b: DTensor, t: DTensor) -> DTensor:
    """A (n,) bias laid out as ``t``'s last dim: sharded over the mesh dims
    that shard it, replicated elsewhere (an explicit redistribution)."""
    from torch.distributed.tensor import Shard

    want = [Shard(0) if p.is_shard(t.ndim - 1) else Replicate() for p in t.placements]
    return b if want == list(b.placements) else b.redistribute(b.device_mesh, want)


def decode_valid(C: int, pos: int, window: int = 0, *, ring: bool = False,
                 device=None) -> torch.Tensor:
    """(C,) bool: the cache slots a token at absolute position ``pos`` sees.
    Ring caches hold slots [0, slot] until they wrap, then all of them; a
    linear cache holds [0, slot], cut to the last ``window`` positions when
    ``window`` > 0."""
    idx = torch.arange(C, device=device)
    if ring:
        slot = pos % C
        return (idx <= slot) | (pos >= C)
    valid = idx <= min(pos, C - 1)
    if window > 0:
        valid = valid & (idx > pos - window)
    return valid


def attn_decode(params, x, cfg, cache: KVCache, pos: int, *, window: int = 0,
                ring: bool = False, use_kernel: bool = True, valid=None):
    """Single-token decode: x (B, 1, D); ``pos`` the absolute position.

    Two cache regimes (chosen by the serving layer):
      linear (C ≥ max position): slot = min(pos, C−1), the window enforced by
        the mask;
      ring (C == window): slot = pos mod C, the buffer itself is the window.
    The new k, v go into the cache in place (the reference donates it). The
    attention runs through the ``decode_attention`` kernel unless
    ``use_kernel`` is False, which takes the reference's ``attend_full``
    route. ``valid`` may carry :func:`decode_valid`'s mask, computed once
    per step for every layer of one window. Returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    C = cache.k.shape[1]
    slot = pos % C if ring else min(pos, C - 1)
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    if valid is None:
        valid = decode_valid(C, pos, window, ring=ring, device=x.device)
    if use_kernel:
        out = _dec_ops.decode_attention(q[:, 0], cache.k, cache.v, valid,
                                        attn_softcap=cfg.attn_logit_softcap)[:, None]
    else:
        out = attend_full(q, cache.k, cache.v, valid[None, None, None, :],
                          cfg.attn_logit_softcap)
    return out.reshape(B, 1, cfg.num_heads * hd) @ params["wo"], cache
