"""Model assembly of ``repro/models/transformer.py``, for two families:

  dense — GQA attention + SwiGLU (smollm, minitron, qwen1.5, and gemma2 with
          local/global alternating windows and logit softcaps): train,
          prefill and KV-cache decode;
  ssm   — Mamba-2 / SSD blocks (mamba2-780m): prefill and recurrent decode.

Parameters are a nested dict with the reference's keys; the layers are
stacked on a leading L axis, as the reference's vmapped init stacks them,
and a Python loop over that axis takes the place of ``lax.scan``. The
reference's per-layer ``jax.checkpoint`` is dropped: it only saves memory,
and ``torch.utils.checkpoint`` does not compose with the ``torch.func``
transforms the trainer applies. Decode caches are stacked (L, ...) too and
written in place, layer slice by layer slice (the reference donates them).

The other families (``moe``, ``hybrid``, ``vlm``, ``audio``) raise
``NotImplementedError``, and so does ``train_loss`` for ``ssm`` (the SSD
kernel has no backward yet).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from .attention import KVCache, attn_decode, attn_forward, decode_valid, init_attn
from .common import dense_init, embed_init, rms_norm, softcap, torch_dtype
from .mlp import init_swiglu, swiglu
from .ssm import SSMCache, init_mamba2, init_ssm_cache, mamba2_decode, mamba2_forward

__all__ = ["init_params", "param_count", "layer_windows", "train_loss", "loss_chunk_for",
           "prefill", "decode_step", "init_caches", "Caches"]

_PORTED = ("dense", "ssm")


def _ported_only(cfg, families=_PORTED, what: str = "") -> None:
    if cfg.arch_type not in families:
        raise NotImplementedError(
            f"{cfg.name}: {what}the {cfg.arch_type!r} family is not ported yet; only "
            f"{', '.join(repr(f) for f in families)} (ROADMAP.md, Queue 1, "
            "'Non-dense model families')")


class Caches(NamedTuple):
    """Stacked per-layer decode state. Unused fields are () placeholders."""
    kv: Any = ()         # KVCache with (L, B, C, Hkv, hd) leaves — self-attention KV
    ssm: Any = ()        # SSMCache with (L, B, ...) leaves
    shared_kv: Any = ()  # hybrid (not ported)
    cross_kv: Any = ()   # audio (not ported)


def layer_windows(cfg, *, long_context: bool = False) -> list[int]:
    """Per-layer sliding windows (0 = full attention).

    gemma2 ``local_global``: even layers SWA, odd layers global — in the
    long-context serving variant every layer is SWA. ``swa``: every layer
    windowed.
    """
    L = cfg.num_layers
    if cfg.attn_pattern == "local_global" and cfg.sliding_window:
        return [cfg.sliding_window if (i % 2 == 0 or long_context) else 0 for i in range(L)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * L
    if long_context and cfg.arch_type == "hybrid":
        return [4096] * L
    return [0] * L


def init_params(gen: torch.Generator | int, cfg) -> dict:
    """Random parameters on the CPU, from ``gen`` (or a seed). The layer
    leaves are stacked (L, ...)."""
    _ported_only(cfg)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    dtype = torch_dtype(cfg.dtype)
    p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
               "final_norm": torch.zeros((cfg.d_model,), dtype=dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    L = (cfg.num_layers,)
    if cfg.arch_type == "ssm":
        p["layers"] = {"ln": torch.zeros(L + (cfg.d_model,), dtype=dtype),
                       "mamba": init_mamba2(gen, cfg, dtype, L)}
        return p
    p["layers"] = {"ln1": torch.zeros(L + (cfg.d_model,), dtype=dtype),
                   "attn": init_attn(gen, cfg, dtype, L),
                   "ln2": torch.zeros(L + (cfg.d_model,), dtype=dtype),
                   "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, L)}
    return p


def param_count(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))


def _attn_block(lp, x, cfg, window: int, positions, cache=None):
    h, _ = attn_forward(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                        window=window, positions=positions, cache=cache)
    x = x + h
    return x + swiglu(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))


def _ssm_block(lp, x, cfg, cache=None, use_kernel: bool = True):
    h, new_cache = mamba2_forward(lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                                  cache=cache, use_kernel=use_kernel)
    return x + h, new_cache


def _layers(params):
    """The stacked layer leaves as L per-layer dicts. ``unbind`` splits each
    leaf once, and its backward stacks the L layer gradients in one op;
    indexing ``a[i]`` per layer would instead build a zero (L, ...) gradient
    and add into it once per layer."""
    leaves, spec = tree_flatten(params["layers"])
    per_layer = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten([p[i] for p in per_layer], spec) for i in range(len(per_layer[0]))]


def _stack_dense(params, x, cfg, windows, positions, *, with_cache: bool, cache_cap: int = 0):
    """The attention layers over x; with a cache, each layer writes its k, v
    into its slice of one stacked (L, B, C, Hkv, hd) cache."""
    B = x.shape[0]
    kv = ()
    if with_cache:
        shape = (cfg.num_layers, B, cache_cap, cfg.num_kv_heads, cfg.resolved_head_dim)
        kv = KVCache(torch.zeros(shape, dtype=x.dtype, device=x.device),
                     torch.zeros(shape, dtype=x.dtype, device=x.device))
    for i, (lp, w) in enumerate(zip(_layers(params), windows)):
        cache = KVCache(kv.k[i], kv.v[i]) if with_cache else None
        x = _attn_block(lp, x, cfg, w, positions, cache=cache)
    return x, kv


def _stack_ssm(params, x, cfg, *, with_cache: bool, use_kernel: bool = True):
    """The Mamba-2 layers over x; with a cache, the stacked (L, ...) conv
    tails and final states. ``use_kernel`` defaults to on (the reference's
    to off, and its prefill never passes it)."""
    convs, states = [], []
    for lp in _layers(params):
        # mamba2_forward reads only the cache's dtype, so an empty batch will do
        cache = init_ssm_cache(0, cfg, x.dtype, x.device) if with_cache else None
        x, c = _ssm_block(lp, x, cfg, cache=cache, use_kernel=use_kernel)
        if with_cache:
            convs.append(c.conv)
            states.append(c.state)
    if not with_cache:
        return x, ()
    return x, SSMCache(torch.stack(convs), torch.stack(states))


def _embed(params, tokens, cfg):
    x = F.embedding(tokens, params["embed"])
    if cfg.logit_softcap:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _logits(params, x, cfg):
    head = params.get("lm_head")
    logits = (x @ head if head is not None else x @ params["embed"].T).float()
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


def _forward_seq(params, cfg, batch, *, with_cache: bool = False, cache_cap: int = 0,
                 long_context: bool = False):
    """Shared full-sequence path. Returns (hidden states (B, S, D) after the
    final norm, caches)."""
    _ported_only(cfg)
    x = _embed(params, batch["tokens"], cfg)
    if cfg.arch_type == "ssm":
        x, ssm = _stack_ssm(params, x, cfg, with_cache=with_cache)
        caches = Caches(ssm=ssm)
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, kv = _stack_dense(params, x, cfg, layer_windows(cfg, long_context=long_context),
                             positions, with_cache=with_cache, cache_cap=cache_cap)
        caches = Caches(kv=kv)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def _nll_sum(params, x, labels, cfg):
    """Σ nll over valid positions and the valid count, for one (B, c, D)
    chunk: nll = logsumexp(logits) − logits[label]. The target logit is a
    gather, where the reference takes a one-hot masked sum (a form that
    stays sharded on a vocab-sharded mesh); both pick the same value."""
    logits = _logits(params, x, cfg)              # (B,c,V) f32
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    target = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - target
    return torch.sum(nll * valid), torch.sum(valid)


def loss_chunk_for(cfg, batch_size: int, budget_bytes: float = 2e9) -> int:
    """Sequence-chunk length keeping the (B, c, V) f32 logits under budget."""
    c = budget_bytes / (4.0 * batch_size * cfg.vocab_size)
    return max(64, int(2 ** np.floor(np.log2(max(c, 64)))))


def train_loss(params, cfg, batch, *, aux_weight: float = 0.01,
               loss_chunk: int | None = None):
    """Causal-LM next-token loss. batch: tokens (B,S), labels (B,S) with
    -100 = ignore. The unembedding and cross-entropy run over sequence
    chunks by the reference's rule; ``loss_chunk=None`` picks the chunk
    from a 2 GB logits budget, 0 disables chunking. The dense family has no
    auxiliary loss, so ``aux_weight`` only keeps the reference's signature."""
    _ported_only(cfg, ("dense",), "training ")
    x, _ = _forward_seq(params, cfg, batch)
    labels = batch["labels"]
    B, S, _ = x.shape
    if loss_chunk is None:
        loss_chunk = loss_chunk_for(cfg, B)
    if loss_chunk and S % loss_chunk == 0 and S > loss_chunk:
        tot, cnt = 0.0, 0
        for c0 in range(0, S, loss_chunk):
            si, ni = _nll_sum(params, x[:, c0:c0 + loss_chunk],
                              labels[:, c0:c0 + loss_chunk], cfg)
            tot, cnt = tot + si, cnt + ni
    else:
        tot, cnt = _nll_sum(params, x, labels, cfg)
    return tot / torch.clamp(cnt, min=1)


def prefill(params, cfg, batch, *, cache_cap: int | None = None, long_context: bool = False):
    """Prefill: the full forward writing KV/SSM caches. Returns (logits of
    the last position (B, 1, V) float32, caches). ``cache_cap`` defaults to
    the prompt length, or to the sliding window in the long-context variant
    (a ring cache)."""
    S = batch["tokens"].shape[1]
    if cache_cap is None:
        w = int(cfg.sliding_window) if cfg.sliding_window else 0
        cache_cap = min(S, w) if (w and long_context) else S
    x, caches = _forward_seq(params, cfg, batch, with_cache=True, cache_cap=cache_cap,
                             long_context=long_context)
    return _logits(params, x[:, -1:], cfg), caches


def init_caches(cfg, batch_size: int, cache_cap: int, dtype=None, device=None) -> Caches:
    """Empty decode caches sized for ``cache_cap`` past positions."""
    _ported_only(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    L, B = cfg.num_layers, batch_size
    if cfg.arch_type == "ssm":
        c = init_ssm_cache(B, cfg, dtype, device)
        return Caches(ssm=SSMCache(*(a[None].repeat((L,) + (1,) * a.dim()) for a in c)))
    shape = (L, B, cache_cap, cfg.num_kv_heads, cfg.resolved_head_dim)
    return Caches(kv=KVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device)))


def decode_step(params, cfg, token, caches: Caches, pos: int, *, long_context: bool = False,
                use_kernel: bool = True):
    """One-token decode. token: (B, 1) integer; ``pos`` the absolute
    position (a host int). Returns (logits (B, 1, V) float32, caches); the
    KV cache is updated in place, the SSM cache replaced layer by layer in
    its stacked tensors. ``use_kernel`` (default on, the reference's off)
    sends every attention through the ``decode_attention`` kernel."""
    _ported_only(cfg)
    x = _embed(params, token, cfg)
    if cfg.arch_type == "ssm":
        for i, lp in enumerate(_layers(params)):
            c = SSMCache(caches.ssm.conv[i], caches.ssm.state[i])
            h, nc = mamba2_decode(lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), cfg, c)
            x = x + h
            caches.ssm.conv[i] = nc.conv
            caches.ssm.state[i] = nc.state
    else:
        C = caches.kv.k.shape[2]
        windows = layer_windows(cfg, long_context=long_context)
        valid = {w: decode_valid(C, pos, w, ring=long_context, device=x.device)
                 for w in set(windows)}
        for i, (lp, w) in enumerate(zip(_layers(params), windows)):
            a, _ = attn_decode(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                               KVCache(caches.kv.k[i], caches.kv.v[i]), pos, window=w,
                               ring=long_context, use_kernel=use_kernel, valid=valid[w])
            x = x + a
            x = x + swiglu(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), caches
