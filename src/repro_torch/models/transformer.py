"""Model assembly, dense family: the train path of ``repro/models/transformer.py``.

``dense`` is GQA attention + SwiGLU (smollm, minitron, qwen1.5, and gemma2
with local/global alternating windows and logit softcaps). Parameters are a
nested dict with the reference's keys; the layers are stacked on a leading
L axis, as the reference's vmapped init stacks them, and a Python loop over
that axis takes the place of ``lax.scan``. The reference's per-layer
``jax.checkpoint`` is dropped: it only saves memory, and
``torch.utils.checkpoint`` does not compose with the ``torch.func``
transforms the trainer applies.

The other families (``moe``, ``ssm``, ``hybrid``, ``vlm``, ``audio``) raise
``NotImplementedError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from .attention import attn_forward, init_attn
from .common import dense_init, embed_init, rms_norm, softcap, torch_dtype
from .mlp import init_swiglu, swiglu

__all__ = ["init_params", "param_count", "layer_windows", "train_loss", "loss_chunk_for"]


def _dense_only(cfg) -> None:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type!r} family is not ported yet; only "
            "'dense' is (ROADMAP.md, Queue 1, 'Non-dense model families')")


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
    _dense_only(cfg)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    dtype = torch_dtype(cfg.dtype)
    p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
               "final_norm": torch.zeros((cfg.d_model,), dtype=dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    L = (cfg.num_layers,)
    p["layers"] = {"ln1": torch.zeros(L + (cfg.d_model,), dtype=dtype),
                   "attn": init_attn(gen, cfg, dtype, L),
                   "ln2": torch.zeros(L + (cfg.d_model,), dtype=dtype),
                   "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, L)}
    return p


def param_count(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))


def _attn_block(lp, x, cfg, window: int, positions):
    h, _ = attn_forward(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                        window=window, positions=positions)
    x = x + h
    return x + swiglu(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))


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


def _forward_seq(params, cfg, batch):
    """Hidden states (B, S, D) after the final norm. The stacked layer
    leaves are split once with ``unbind``, whose backward stacks the L
    layer gradients in one op; indexing ``a[i]`` per layer would instead
    build a zero (L, ...) gradient and add into it once per layer."""
    _dense_only(cfg)
    x = _embed(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    leaves, spec = tree_flatten(params["layers"])
    per_layer = [leaf.unbind(0) for leaf in leaves]
    for i, w in enumerate(layer_windows(cfg)):
        lp = tree_unflatten([p[i] for p in per_layer], spec)
        x = _attn_block(lp, x, cfg, w, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


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
    x = _forward_seq(params, cfg, batch)
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
