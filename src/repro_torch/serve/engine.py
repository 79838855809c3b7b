"""Serving runtime of the port (``repro/serve/engine.py``).

``make_serve_step`` builds the one-token decode step: ONE new token per
request against a KV/SSM cache of past positions. ``ServingEngine`` is the
host loop: admit a batch of prompts, prefill, then decode greedily or with
temperature until ``max_new_tokens`` or until every request hit EOS.

Deviations from the reference, by design:
- ``ServeConfig.use_kernel`` defaults to True, so every attention decode
  runs the ``decode_attention`` kernel and every SSD chunk the
  ``ssd_intra_chunk`` kernel.
- With ``temperature`` > 0 the Gumbel noise comes from a ``torch.Generator``
  seeded by ``seed``; ``jax.random``'s stream cannot be reproduced.
- There is no jit and no donation: the step runs eagerly and writes the KV
  cache in place, which is what the reference's donation achieves.
- ``extra_inputs`` (the vlm patch and audio frame embeddings) are moved
  onto the engine's device, and that copy counts in the prefill time.
- ``DecodeState.pos`` is a host int, not a device scalar.

Over a mesh (DTensor parameters, ``launch/steps.py``'s decode step) the
logits are sharded over the vocabulary and the batch over "data":
:func:`greedy_sample` takes each rank's local max and its lowest index and
reduces them over the vocab shards, the lowest global index winning a tie
as ``jnp.argmax`` does; the tokens come back as a DTensor with the batch's
sharding.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..models import transformer

__all__ = ["ServeConfig", "DecodeState", "make_serve_step", "make_functional_serve_step",
           "greedy_sample", "ServingEngine"]


@dataclass(frozen=True)
class ServeConfig:
    batch_size: int
    cache_len: int                 # past-context capacity
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 → greedy
    long_context: bool = False     # ring/SWA caches + SSM state path
    use_kernel: bool = True        # the decode_attention / ssd_intra_chunk kernels


class DecodeState(NamedTuple):
    tokens: torch.Tensor           # (B, 1) last emitted token
    caches: Any                    # transformer.Caches
    pos: int                       # absolute position of ``tokens``
    rng: torch.Generator | None    # Gumbel noise source (temperature > 0)
    done: torch.Tensor             # (B,) bool — hit EOS


def greedy_sample(logits: torch.Tensor, rng: torch.Generator | None,
                  temperature: float) -> torch.Tensor:
    """logits (B, 1, V) → (B, 1) int32: the argmax, or with temperature the
    argmax of logits/temperature plus Gumbel noise drawn from ``rng``. Of
    DTensor logits (greedy only): :func:`_sharded_argmax`."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        if temperature > 0.0:
            raise NotImplementedError(
                "sampling with temperature over vocab-sharded logits is not ported yet "
                "(ROADMAP.md, Queue 1, item 7c″); serve greedily (temperature 0)")
        return _sharded_argmax(logits)
    last = logits[:, -1]
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    u = torch.rand(last.shape, generator=rng, dtype=torch.float32, device=last.device)
    g = -torch.log(-torch.log(u + 1e-9) + 1e-9)
    return torch.argmax(last / temperature + g, dim=-1)[:, None].to(torch.int32)


def _sharded_argmax(logits) -> torch.Tensor:
    """The last position's argmax of DTensor logits (B, S, V), with the
    lowest index among equal maxima: each rank takes the max of its vocab
    shard and the first index of it (``torch.argmax``), then over each mesh
    dim that shards the vocabulary an all-reduce of the max and one of the
    least global index holding it. Returns (B, 1) int32 as a DTensor laid
    out as the logits' batch."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = logits.device_mesh
    last = logits.to_local()[:, -1]
    idx = torch.argmax(last, dim=-1)
    best = last.gather(-1, idx[:, None])[:, 0]
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, logits.placements)
    idx = idx + offset[-1]
    for i, p in enumerate(logits.placements):
        if not p.is_shard(logits.ndim - 1):
            continue
        group = mesh.get_group(i)
        top = best.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        idx = torch.where(best == top, idx, torch.iinfo(idx.dtype).max)
        dist.all_reduce(idx, op=dist.ReduceOp.MIN, group=group)
        best = top
    rows = [p if p.is_shard(0) else Replicate() for p in logits.placements]
    return DTensor.from_local(idx[:, None].to(torch.int32), mesh, rows, run_check=False)


def _advance(cfg, scfg: ServeConfig, params, state: DecodeState, eos_id: int) -> DecodeState:
    logits, caches = transformer.decode_step(
        params, cfg, state.tokens, state.caches, state.pos,
        long_context=scfg.long_context, use_kernel=scfg.use_kernel)
    nxt = greedy_sample(logits, state.rng, scfg.temperature)
    done = state.done | (nxt[:, 0] == eos_id)
    nxt = torch.where(done[:, None], torch.full_like(nxt, eos_id), nxt)
    return DecodeState(nxt, caches, state.pos + 1, state.rng, done)


def make_serve_step(cfg, scfg: ServeConfig, *, eos_id: int = 0):
    """One-token decode step: ``bind(params)`` gives (DecodeState) →
    DecodeState, the cache updated in place (the reference's ``donate``
    argument has no counterpart)."""

    def bind(params):
        return lambda state: _advance(cfg, scfg, params, state, eos_id)

    return bind


def make_functional_serve_step(cfg, scfg: ServeConfig, *, eos_id: int = 0):
    """(params, state) → state, params as an argument."""

    def step(params, state: DecodeState) -> DecodeState:
        return _advance(cfg, scfg, params, state, eos_id)

    return step


class ServingEngine:
    """Host loop: admit → prefill → decode until done / max_new_tokens.

    ``params`` lie on the device the engine runs on. After ``generate``,
    ``timings`` holds the prefill time (to the first token on the host) and
    each decode step's time, in seconds by the host clock; every one ends
    in the host read of that step's tokens, which waits for the device.
    """

    def __init__(self, cfg, params, scfg: ServeConfig, *, eos_id: int = 0):
        self.cfg, self.scfg, self.eos_id = cfg, scfg, eos_id
        self.params = params
        self.device = tree_leaves(params)[0].device
        self._step = make_serve_step(cfg, scfg, eos_id=eos_id)(params)
        self.timings: dict = {}

    def generate(self, prompts: np.ndarray, extra_inputs: dict | None = None,
                 seed: int = 0) -> np.ndarray:
        """prompts: (B, S) int32, all of one length; ``extra_inputs``, for
        vlm and audio, ``{"embeds": (B, frontend_tokens, d_model)}`` float32
        (numpy or a tensor). Returns (B, n) int32 with n ≤ max_new_tokens
        (fewer when every request hit EOS)."""
        B, S = prompts.shape
        if B != self.scfg.batch_size:
            raise ValueError(
                f"prompts batch shape {(B, S)} does not match the engine's "
                f"fixed batch_size={self.scfg.batch_size}; this engine "
                f"serves one (batch_size, S) shape — pad or re-batch the "
                f"prompts, or build a ServeConfig with batch_size={B}")
        t0 = time.perf_counter()
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32), device=self.device)}
        for name, value in (extra_inputs or {}).items():
            batch[name] = torch.as_tensor(value, device=self.device)
        logits, caches = transformer.prefill(self.params, self.cfg, batch,
                                             cache_cap=self.scfg.cache_len,
                                             long_context=self.scfg.long_context)
        rng = None
        if self.scfg.temperature > 0.0:
            rng = torch.Generator(device=self.device).manual_seed(seed)
        first = greedy_sample(logits, rng, self.scfg.temperature)
        # the vlm patch prefix takes the first positions
        pos = S + (self.cfg.frontend_tokens if self.cfg.arch_type == "vlm" else 0)
        state = DecodeState(first, caches, pos, rng,
                            torch.zeros((B,), dtype=torch.bool, device=self.device))
        out = [first[:, 0].cpu().numpy()]
        steps = []
        self.timings = {"prefill_s": time.perf_counter() - t0, "step_s": steps}
        for _ in range(self.scfg.max_new_tokens - 1):
            t1 = time.perf_counter()
            state = self._step(state)
            out.append(state.tokens[:, 0].cpu().numpy())
            all_done = bool(state.done.all())
            steps.append(time.perf_counter() - t1)
            if all_done:
                break
        return np.stack(out, axis=1)
