"""Model assembly of ``repro/models/transformer.py``, for all six families,
each trained (``train_loss``), prefilled and decoded from a KV or SSM cache:

  dense  — GQA attention + SwiGLU (smollm, minitron, qwen1.5, and gemma2 with
           local/global alternating windows and logit softcaps);
  moe    — GQA attention + top-k MoE FFN (mixtral with SWA, granite), whose
           load-balance aux term joins the training loss;
  ssm    — Mamba-2 / SSD blocks (mamba2-780m);
  hybrid — Mamba-2 blocks with one SHARED attention block after every
           ``shared_attn_every`` layers, with its own KV cache per group
           (zamba2);
  vlm    — the dense decoder over [patch embeddings ; text embeddings]
           (internvl2; the vision frontend is a stub that hands over the
           patch embeddings, and the loss skips their positions);
  audio  — encoder-decoder with cross attention (whisper; the mel and conv
           frontend is a stub that hands over the frame embeddings).

Parameters are a nested dict with the reference's keys; the layers are
stacked on a leading L axis, as the reference's vmapped init stacks them,
and a Python loop over that axis takes the place of ``lax.scan``. The
reference's per-layer ``jax.checkpoint`` is dropped: it only saves memory,
and ``torch.utils.checkpoint`` does not compose with the ``torch.func``
transforms the trainer applies. Decode caches are stacked (L, ...) too and
written in place, layer slice by layer slice (the reference donates them).

Deviations from the reference: the ssm and hybrid stacks' Mamba-2 layers
take the ``ssd_intra_chunk`` kernel in training too, and the hybrid's in
its prefill (the reference trains both and prefills the hybrid on its
einsum route), since the port keeps kernels on; and the frontend
embeddings are promoted explicitly to the wider of their dtype and the
projector's before ``@ frontend_proj``, which JAX does implicitly. The
audio encoder's self-attention is causal, as the reference's
``attn_forward`` makes it.

On DTensor parameters (the tensor-parallel steps of ``launch/steps.py``)
every family trains; the dense family also prefills and decodes, its
caches DTensors laid out by ``launch/sharding.py``'s ``cache_specs``, which
the caller allocates (``launch/steps.py``'s prefill); serving the other
families over a mesh is ROADMAP.md Queue 1 item 7c″ and raises.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from .attention import (KVCache, _qkv, attend_full, attn_decode, attn_forward, decode_valid,
                        init_attn)
from .common import dense_init, embed_init, rms_norm, softcap, tp_matmul, torch_dtype, tp_reduce
from .mlp import gelu_mlp, init_gelu_mlp, init_swiglu, swiglu
from .moe import init_moe, moe_forward
from .ssm import SSMCache, init_mamba2, init_ssm_cache, mamba2_decode, mamba2_forward

__all__ = ["init_params", "param_count", "layer_windows", "train_loss", "loss_chunk_for",
           "prefill", "decode_step", "init_caches", "Caches"]

class Caches(NamedTuple):
    """Stacked per-layer decode state. Unused fields are () placeholders."""
    kv: Any = ()         # KVCache with (L, B, C, Hkv, hd) leaves — self-attention KV
    ssm: Any = ()        # SSMCache with (L, B, ...) leaves
    shared_kv: Any = ()  # hybrid: KVCache with (G, B, C, Hkv, hd) leaves, one per group
    cross_kv: Any = ()   # audio: KVCache with (L, B, Tenc, Hkv, hd) leaves, from the encoder


def layer_windows(cfg, *, long_context: bool = False) -> list[int]:
    """Per-layer sliding windows (0 = full attention).

    gemma2 ``local_global``: even layers SWA, odd layers global — in the
    long-context serving variant every layer is SWA. ``swa``: every layer
    windowed. zamba2 in the long-context variant: its shared attention
    takes a 4,096-position ring cache (the Mamba-2 state is the long path).
    """
    L = cfg.num_layers
    if cfg.attn_pattern == "local_global" and cfg.sliding_window:
        return [cfg.sliding_window if (i % 2 == 0 or long_context) else 0 for i in range(L)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * L
    if long_context and cfg.arch_type == "hybrid":
        return [4096] * L
    return [0] * L


def _attn_layer(gen: torch.Generator, cfg, dtype, lead: tuple = ()) -> dict:
    """One attention layer (ln1, attn, ln2 and the FFN: MoE, GELU for audio,
    else SwiGLU; audio decoder layers add ln_x and the cross attention)."""
    d = cfg.d_model
    p = {"ln1": torch.zeros(lead + (d,), dtype=dtype), "attn": init_attn(gen, cfg, dtype, lead),
         "ln2": torch.zeros(lead + (d,), dtype=dtype)}
    if cfg.num_experts:
        p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.num_experts, dtype, lead)
    elif cfg.arch_type == "audio":
        p["mlp"] = init_gelu_mlp(gen, d, cfg.d_ff, dtype, lead)
    else:
        p["mlp"] = init_swiglu(gen, d, cfg.d_ff, dtype, lead)
    if cfg.cross_attention and cfg.arch_type == "audio":
        p["ln_x"] = torch.zeros(lead + (d,), dtype=dtype)
        p["xattn"] = init_attn(gen, cfg, dtype, lead)
    return p


def _ssm_layer(gen: torch.Generator, cfg, dtype, lead: tuple) -> dict:
    return {"ln": torch.zeros(lead + (cfg.d_model,), dtype=dtype),
            "mamba": init_mamba2(gen, cfg, dtype, lead)}


def _no_cross(cfg):
    return replace(cfg, cross_attention=False)


def init_params(gen: torch.Generator | int, cfg) -> dict:
    """Random parameters on the CPU, from ``gen`` (or a seed). The layer
    leaves are stacked (L, ...); hybrid's one shared attention block and
    the frontend projector are not."""
    if cfg.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        raise ValueError(cfg.arch_type)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    dtype = torch_dtype(cfg.dtype)
    p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
               "final_norm": torch.zeros((cfg.d_model,), dtype=dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    L = (cfg.num_layers,)
    if cfg.arch_type in ("ssm", "hybrid"):
        p["layers"] = _ssm_layer(gen, cfg, dtype, L)
        if cfg.arch_type == "hybrid":
            p["shared_attn"] = _attn_layer(gen, cfg, dtype)      # ONE block, reused
    elif cfg.arch_type == "audio":
        p["enc_layers"] = _attn_layer(gen, _no_cross(cfg), dtype, (cfg.encoder_layers,))
        p["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dtype)
        p["layers"] = _attn_layer(gen, cfg, dtype, L)
    else:
        p["layers"] = _attn_layer(gen, cfg, dtype, L)
    if cfg.frontend:
        p["frontend_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype)
    return p


def param_count(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))


def _ffn(lp, h, cfg, *, min_capacity: int = 1):
    """The layer's FFN on its normed input: (out, MoE aux or 0.0)."""
    if "moe" in lp:
        return moe_forward(lp["moe"], h, top_k=cfg.experts_per_token,
                           capacity_factor=cfg.moe_capacity_factor, min_capacity=min_capacity)
    if cfg.arch_type == "audio":
        return gelu_mlp(lp["mlp"], h), 0.0
    return swiglu(lp["mlp"], h), 0.0


def _attn_block(lp, x, cfg, window: int, positions, cache=None):
    h, _ = attn_forward(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                        window=window, positions=positions, cache=cache)
    x = x + h
    out, aux = _ffn(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + out, aux


def _ssm_block(lp, x, cfg, cache=None, use_kernel: bool = True):
    h, new_cache = mamba2_forward(lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                                  cache=cache, use_kernel=use_kernel)
    return x + h, new_cache


def _layers(stacked: dict) -> list[dict]:
    """The stacked layer leaves as L per-layer dicts. ``unbind`` splits each
    leaf once, and its backward stacks the L layer gradients in one op;
    indexing ``a[i]`` per layer would instead build a zero (L, ...) gradient
    and add into it once per layer."""
    leaves, spec = tree_flatten(stacked)
    per_layer = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten([p[i] for p in per_layer], spec) for i in range(len(per_layer[0]))]


def _replicated(t: DTensor) -> DTensor:
    """``t`` replicated over its whole mesh (an explicit all-gather)."""
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _kv_stack(n: int, B: int, C: int, cfg, dtype, device) -> KVCache:
    shape = (n, B, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _stack_dense(params, x, cfg, windows, positions, *, with_cache: bool, cache_cap: int = 0,
                 kv: KVCache | None = None):
    """The attention layers over x, and the sum of their MoE aux values;
    with a cache, each layer writes its k, v into its slice of one stacked
    (L, B, C, Hkv, hd) cache: ``kv`` where given, else new zeros."""
    if not with_cache:
        kv = ()
    elif kv is None:
        kv = _kv_stack(cfg.num_layers, x.shape[0], cache_cap, cfg, x.dtype, x.device)
    aux = 0.0
    for i, (lp, w) in enumerate(zip(_layers(params["layers"]), windows)):
        cache = KVCache(kv.k[i], kv.v[i]) if with_cache else None
        x, a = _attn_block(lp, x, cfg, w, positions, cache=cache)
        aux = aux + a
    return x, aux, kv


def _ssm_caches(caches: list) -> SSMCache:
    return SSMCache(torch.stack([c.conv for c in caches]), torch.stack([c.state for c in caches]))


def _stack_ssm(params, x, cfg, *, with_cache: bool, use_kernel: bool = True):
    """The Mamba-2 layers over x; with a cache, the stacked (L, ...) conv
    tails and final states. ``use_kernel`` defaults to on (the reference's
    to off, and its prefill never passes it)."""
    caches = []
    for lp in _layers(params["layers"]):
        # mamba2_forward reads only the cache's dtype, so an empty batch will do
        cache = init_ssm_cache(0, cfg, x.dtype, x.device) if with_cache else None
        x, c = _ssm_block(lp, x, cfg, cache=cache, use_kernel=use_kernel)
        caches.append(c)
    return x, (_ssm_caches(caches) if with_cache else ())


def _stack_hybrid(params, x, cfg, windows, positions, *, with_cache: bool, cache_cap: int = 0):
    """zamba2: groups of ``shared_attn_every`` Mamba-2 layers, each group
    followed by the one shared attention block, which writes group g's
    slice of a (G, B, C, Hkv, hd) cache. Its window is layer 0's."""
    k = cfg.shared_attn_every
    G = cfg.num_layers // k
    layers = _layers(params["layers"])
    kv = _kv_stack(G, x.shape[0], cache_cap, cfg, x.dtype, x.device) if with_cache else ()
    caches = []
    for g in range(G):
        for lp in layers[g * k:(g + 1) * k]:
            cache = init_ssm_cache(0, cfg, x.dtype, x.device) if with_cache else None
            x, c = _ssm_block(lp, x, cfg, cache=cache)
            caches.append(c)
        cache = KVCache(kv.k[g], kv.v[g]) if with_cache else None
        x, _ = _attn_block(params["shared_attn"], x, cfg, windows[0], positions, cache=cache)
    return x, (_ssm_caches(caches) if with_cache else ()), kv


def _promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the wider of their dtypes, as JAX promotes a mixed matmul."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _encode_audio(params, frames, cfg):
    """The whisper encoder over the projected stub frame embeddings: its
    self-attention is causal, as the reference's ``attn_forward`` makes it."""
    x = _promoted_matmul(frames, params["frontend_proj"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    enc_cfg = _no_cross(cfg)
    for lp in _layers(params["enc_layers"]):
        a, _ = attn_forward(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), enc_cfg,
                            window=0, positions=positions)
        x = x + a
        x = x + gelu_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attend(lp, h, ck, cv, cfg):
    """h + the cross attention of h's positions over every encoder key."""
    B, S, _ = h.shape
    q, _, _ = _qkv(lp["xattn"], rms_norm(h, lp["ln_x"], cfg.norm_eps), cfg)
    every_key = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=h.device)
    xa = attend_full(q, ck, cv, every_key)
    return h + xa.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim) @ lp["xattn"]["wo"]


def _stack_audio_decoder(params, x, enc_out, cfg, positions, *, with_cache: bool,
                         cache_cap: int = 0):
    """The whisper decoder: causal self-attention, cross attention over the
    encoder's output, GELU MLP. With a cache, the self-attention's stacked
    KV cache and each layer's cross keys and values."""
    L = cfg.num_layers
    kv = _kv_stack(L, x.shape[0], cache_cap, cfg, x.dtype, x.device) if with_cache else ()
    cross = []
    for i, lp in enumerate(_layers(params["layers"])):
        cache = KVCache(kv.k[i], kv.v[i]) if with_cache else None
        a, _ = attn_forward(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                            window=0, positions=positions, cache=cache)
        x = x + a
        _, ck, cv = _qkv(lp["xattn"], enc_out, cfg)
        x = _cross_attend(lp, x, ck, cv, cfg)
        x = x + gelu_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        cross.append((ck, cv))
    if not with_cache:
        return x, (), ()
    return x, kv, KVCache(torch.stack([c[0] for c in cross]), torch.stack([c[1] for c in cross]))


def _embed(params, tokens, cfg):
    table = params["embed"]
    if isinstance(table, DTensor):
        x = _sharded_lookup(table, tokens)
    else:
        x = F.embedding(tokens, table)
    if cfg.logit_softcap and cfg.arch_type in ("dense", "moe", "vlm"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _sharded_lookup(table: DTensor, tokens) -> DTensor:
    """The embedding lookup of a DTensor table (the tensor-parallel steps),
    Megatron's vocab-parallel form: each rank looks its tokens up in its own
    rows of the table, the tokens outside them masked to zero rows, and the
    mesh dims that shard the vocabulary add the ranks' rows (an explicit
    all-reduce of one nonzero term a row: exact). The table keeps its vocab
    shards only where the tokens are not sharded; elsewhere it is gathered
    first (an explicit all-gather), and there its gradient is a partial sum
    of the ranks' token shards. DTensor's own sharded lookup leaves a masked
    partial sum that it reduces once only, and the residual stream reads it
    twice."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    tp = tokens.placements if isinstance(tokens, DTensor) else [Replicate()] * mesh.ndim
    want = [p if p.is_shard(0) and not q.is_shard() else Replicate()
            for p, q in zip(table.placements, tp)]
    if want != list(table.placements):
        table = table.redistribute(mesh, want)
    local = table.to_local(grad_placements=[Partial() if q.is_shard() else p
                                            for p, q in zip(want, tp)])
    _, (lo, _) = compute_local_shape_and_global_offset(table.shape, mesh, want)
    ids = (tokens.to_local() if isinstance(tokens, DTensor) else tokens).long() - lo
    inside = (ids >= 0) & (ids < local.shape[0])
    rows = F.embedding(torch.where(inside, ids, 0), local) * inside[..., None].to(local.dtype)
    return tp_reduce(DTensor.from_local(rows, mesh, [Partial() if p.is_shard() else q
                                                     for p, q in zip(want, tp)],
                                        run_check=False))


def _logits(params, x, cfg):
    head = params.get("lm_head")
    logits = (tp_matmul(x, head) if head is not None else tp_matmul(x, params["embed"].T)).float()
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


def _forward_seq(params, cfg, batch, *, with_cache: bool = False, cache_cap: int = 0,
                 long_context: bool = False, kv: KVCache | None = None):
    """Shared full-sequence path. ``batch``: ``tokens`` (B, S) and, for vlm
    and audio, ``embeds`` (B, T, D); ``kv``: the dense family's caches to
    write into (see :func:`prefill`). Returns (hidden states (B, S_total, D)
    after the final norm, the MoE aux sum, caches, n_prefix: the vlm patch
    positions in front of the text)."""
    x = _embed(params, batch["tokens"], cfg)
    n_prefix = 0
    windows = layer_windows(cfg, long_context=long_context)
    if cfg.arch_type == "vlm":
        patches = _promoted_matmul(batch["embeds"], params["frontend_proj"])
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        n_prefix = patches.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = 0.0
    if cfg.arch_type == "audio":
        enc_out = _encode_audio(params, batch["embeds"], cfg)
        x, kv, cross = _stack_audio_decoder(params, x, enc_out, cfg, positions,
                                            with_cache=with_cache, cache_cap=cache_cap)
        caches = Caches(kv=kv, cross_kv=cross)
    elif cfg.arch_type == "ssm":
        x, ssm = _stack_ssm(params, x, cfg, with_cache=with_cache)
        caches = Caches(ssm=ssm)
    elif cfg.arch_type == "hybrid":
        x, ssm, shared = _stack_hybrid(params, x, cfg, windows, positions,
                                       with_cache=with_cache, cache_cap=cache_cap)
        caches = Caches(ssm=ssm, shared_kv=shared)
    else:
        x, aux, kv = _stack_dense(params, x, cfg, windows, positions, with_cache=with_cache,
                                  cache_cap=cache_cap, kv=kv)
        caches = Caches(kv=kv)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, caches, n_prefix


def _nll_sum(params, x, labels, cfg):
    """Σ nll over valid positions and the valid count, for one (B, c, D)
    chunk: nll = logsumexp(logits) − logits[label]. The target logit is a
    gather; of DTensor logits (the tensor-parallel steps, sharded over the
    vocab) it is the reference's one-hot masked sum, a reduction over the
    vocab that stays sharded where DTensor's gather does not. Both pick the
    same value, and so do their gradients."""
    logits = _logits(params, x, cfg)              # (B,c,V) f32
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    if isinstance(logits, DTensor):
        vocab = torch.arange(logits.shape[-1], device=safe.device)
        onehot = vocab[None, None, :] == safe[..., None]
        target = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    else:
        target = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - target
    return torch.sum(nll * valid), torch.sum(valid)


def loss_chunk_for(cfg, batch_size: int, budget_bytes: float = 2e9) -> int:
    """Sequence-chunk length keeping the (B, c, V) f32 logits under budget."""
    c = budget_bytes / (4.0 * batch_size * cfg.vocab_size)
    return max(64, int(2 ** np.floor(np.log2(max(c, 64)))))


def train_loss(params, cfg, batch, *, aux_weight: float = 0.01,
               loss_chunk: int | None = None):
    """Causal-LM next-token loss plus ``aux_weight`` × the MoE load-balance
    aux sum. batch: tokens (B,S), labels (B,S) with -100 = ignore; vlm and
    audio also ``embeds`` (B,T,D), and vlm's T patch positions are cut off
    before the loss. The unembedding and cross-entropy run over sequence
    chunks by the reference's rule; ``loss_chunk=None`` picks the chunk
    from a 2 GB logits budget, 0 disables chunking."""
    x, aux, _, n_prefix = _forward_seq(params, cfg, batch)
    if n_prefix:
        x = x[:, n_prefix:]
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
    loss = tot / torch.clamp(cnt, min=1)
    if isinstance(aux, torch.Tensor):        # the families without a MoE add 0.0
        loss = loss + aux_weight * aux
    return loss


def prefill(params, cfg, batch, *, cache_cap: int | None = None, long_context: bool = False,
            caches: Caches | None = None):
    """Prefill: the full forward writing KV/SSM caches. Returns (logits of
    the last position (B, 1, V) float32, caches). ``cache_cap`` defaults to
    the prompt length (for vlm with the patch prefix, which takes cache
    slots too), or to the sliding window in the long-context variant (a
    ring cache). ``caches`` (the dense family): zero KV caches of
    ``cache_cap`` slots to write into, new ones if None. On DTensor
    parameters they must be given, as DTensors laid out by
    ``launch/sharding.py``'s ``cache_specs`` (``launch/steps.py``'s prefill
    does so)."""
    S = batch["tokens"].shape[1]
    if cfg.arch_type == "vlm":
        S = S + cfg.frontend_tokens
    if cache_cap is None:
        w = int(cfg.sliding_window) if cfg.sliding_window else 0
        cache_cap = min(S, w) if (w and long_context) else S
    if isinstance(params["embed"], DTensor):
        check_mesh_serving(cfg, "prefill")
        if caches is None:
            raise ValueError("a prefill on DTensor parameters writes into caches laid out by "
                             "cache_specs: pass them as caches=")
    x, _, caches, _ = _forward_seq(params, cfg, batch, with_cache=True, cache_cap=cache_cap,
                                   long_context=long_context,
                                   kv=None if caches is None else caches.kv)
    return _logits(params, x[:, -1:], cfg), caches


def check_mesh_serving(cfg, what: str) -> None:
    """Serving on DTensor parameters is ported for the dense family only:
    ``what`` of another family raises."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{what} of the {cfg.arch_type} family on DTensor parameters (serving over a mesh "
            "beyond the dense family) is not ported yet (ROADMAP.md, Queue 1, item 7c″)")


def init_caches(cfg, batch_size: int, cache_cap: int, dtype=None, device=None) -> Caches:
    """Empty decode caches sized for ``cache_cap`` past positions (audio's
    cross keys for ``frontend_tokens`` encoder frames)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    L, B = cfg.num_layers, batch_size
    if cfg.arch_type in ("ssm", "hybrid"):
        c = init_ssm_cache(B, cfg, dtype, device)
        ssm = SSMCache(*(a[None].repeat((L,) + (1,) * a.dim()) for a in c))
        if cfg.arch_type == "ssm":
            return Caches(ssm=ssm)
        G = cfg.num_layers // cfg.shared_attn_every
        return Caches(ssm=ssm, shared_kv=_kv_stack(G, B, cache_cap, cfg, dtype, device))
    kv = _kv_stack(L, B, cache_cap, cfg, dtype, device)
    if cfg.arch_type == "audio":
        return Caches(kv=kv, cross_kv=_kv_stack(L, B, max(cfg.frontend_tokens, 1), cfg, dtype,
                                                device))
    return Caches(kv=kv)


def _mamba_decode(lp, x, cfg, ssm: SSMCache, i: int):
    """Layer i's recurrent step; its conv tail and state go back into the
    stacked cache."""
    h, nc = mamba2_decode(lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                          SSMCache(ssm.conv[i], ssm.state[i]))
    ssm.conv[i] = nc.conv
    ssm.state[i] = nc.state
    return x + h


def decode_step(params, cfg, token, caches: Caches, pos: int, *, long_context: bool = False,
                use_kernel: bool = True):
    """One-token decode. token: (B, 1) integer; ``pos`` the absolute
    position (a host int; for vlm it counts the patch prefix). Returns
    (logits (B, 1, V) float32, caches); the KV caches are updated in place,
    the SSM cache replaced layer by layer in its stacked tensors, and the
    audio cross keys only read. ``use_kernel`` (default on, the
    reference's off) sends every self-attention through the
    ``decode_attention`` kernel; audio's cross attention takes
    ``attend_full``, as in the reference. On DTensor parameters (the dense
    family) the caches are DTensors laid out by ``cache_specs``, written in
    place on the rank that owns the slot, and each self-attention runs the
    kernel's rank form on the rank's slice of the sequence."""
    layers = params["layers"]
    if isinstance(params["embed"], DTensor):
        check_mesh_serving(cfg, "decode")
        # every layer's norm scales in one all-gather a leaf, where rms_norm
        # would gather one layer's at a time
        layers = dict(layers, **{k: _replicated(layers[k]) for k in ("ln1", "ln2")})
    x = _embed(params, token, cfg)
    B = x.shape[0]
    windows = layer_windows(cfg, long_context=long_context)
    if cfg.arch_type == "ssm":
        for i, lp in enumerate(_layers(params["layers"])):
            x = _mamba_decode(lp, x, cfg, caches.ssm, i)
    elif cfg.arch_type == "hybrid":
        k = cfg.shared_attn_every
        shared, kv = params["shared_attn"], caches.shared_kv
        valid = decode_valid(kv.k.shape[2], pos, windows[0], ring=long_context, device=x.device)
        for i, lp in enumerate(_layers(params["layers"])):
            x = _mamba_decode(lp, x, cfg, caches.ssm, i)
            if (i + 1) % k:
                continue
            g = i // k
            a, _ = attn_decode(shared["attn"], rms_norm(x, shared["ln1"], cfg.norm_eps), cfg,
                               KVCache(kv.k[g], kv.v[g]), pos, window=windows[0],
                               ring=long_context, use_kernel=use_kernel, valid=valid)
            x = x + a
            x = x + swiglu(shared["mlp"], rms_norm(x, shared["ln2"], cfg.norm_eps))
    elif cfg.arch_type == "audio":
        kv, cross = caches.kv, caches.cross_kv
        valid = decode_valid(kv.k.shape[2], pos, device=x.device)
        for i, lp in enumerate(_layers(params["layers"])):
            a, _ = attn_decode(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                               KVCache(kv.k[i], kv.v[i]), pos, use_kernel=use_kernel,
                               valid=valid)
            x = _cross_attend(lp, x + a, cross.k[i], cross.v[i], cfg)
            x = x + gelu_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    else:
        C = caches.kv.k.shape[2]
        valid = {w: decode_valid(C, pos, w, ring=long_context, device=x.device)
                 for w in set(windows)}
        for i, (lp, w) in enumerate(zip(_layers(layers), windows)):
            a, _ = attn_decode(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                               KVCache(caches.kv.k[i], caches.kv.v[i]), pos, window=w,
                               ring=long_context, use_kernel=use_kernel, valid=valid[w])
            x = x + a
            out, _ = _ffn(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg,
                          min_capacity=B * cfg.experts_per_token)
            x = x + out
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), caches
