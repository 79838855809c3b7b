"""Token-choice top-k Mixture-of-Experts with capacity-based dispatch, as in
``repro/models/moe.py``, with one dispatch group (G = 1: global capacity).

Dispatch is scatter/gather-based (O(E·C·D) memory): each (token, choice)
takes the next slot of its expert's queue in token order, and choices past
the expert's capacity C are dropped (they contribute zero). The reference's
grouped dispatch (``moe_groups``) and its expert-parallel block wait for
``models/{partitioning,moe_ep}.py`` (ROADMAP.md, Queue 1, item 7d), and
serving the MoE over a mesh for item 7c″.

Where the port must take care to give the reference's bits:
- top-k keeps the lower expert index first on a tie, as ``jax.lax.top_k``
  does: a stable descending sort, not ``torch.topk`` (which promises no
  order among equal values);
- a dropped choice goes to slot C of an (E, C + 1, D) buffer whose last row
  is cut off, so no index ever leaves the buffer; the buffer is written by
  the out-of-place ``index_put``, so the dispatch composes with the
  trainer's ``torch.func.vmap`` and ``grad`` (capacity is then per worker,
  T = B·S of one worker, as under the reference's vmap);
- the combine adds the k choices one by one in x's dtype, each weight
  ``topv · keep`` cast to x's dtype first, each product and sum rounded, as
  the reference's loop does (a sum over a k axis would round once);
- ``silu`` is x·sigmoid(x) with sigmoid as 1 / (1 + exp(−x)), each op
  rounded to x's dtype: the form XLA expands ``jax.nn.silu`` into for
  bfloat16.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from .common import dense_init

__all__ = ["init_moe", "moe_forward"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int, dtype,
             lead: tuple = ()) -> dict:
    """Router (D, E) and the experts' SwiGLU weights (E, D, F), (E, D, F),
    (E, F, D), behind ``lead`` stacking axes."""
    E = num_experts
    return {
        "router": dense_init(gen, d_model, E, dtype, lead),
        "w_gate": dense_init(gen, d_model, E * d_ff, dtype, lead)
        .reshape(lead + (d_model, E, d_ff)).movedim(-2, -3).contiguous(),
        "w_up": dense_init(gen, d_model, E * d_ff, dtype, lead)
        .reshape(lead + (d_model, E, d_ff)).movedim(-2, -3).contiguous(),
        "w_down": dense_init(gen, E * d_ff, d_model, dtype, lead)
        .reshape(lead + (E, d_ff, d_model)),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1 / (1 + torch.exp(-x)))


def moe_forward(params, x, *, top_k: int, capacity_factor: float = 1.25,
                min_capacity: int = 1):
    """x: (B, S, D) → (out (B, S, D) in x's dtype, aux float32 scalar).
    Decode passes ``min_capacity = B·k`` so that single-token steps never
    drop."""
    if isinstance(x, DTensor):
        return _moe_forward_tp(params, x, top_k=top_k, capacity_factor=capacity_factor,
                               min_capacity=min_capacity)
    B, S, D = x.shape
    out, aux = _moe(params, x.reshape(B * S, D), top_k, capacity_factor, min_capacity)
    return out.reshape(B, S, D), aux


def _moe(params, xt, top_k: int, capacity_factor: float, min_capacity: int):
    """The dispatch, experts and combine of the (T, D) tokens: (out (T, D),
    aux)."""
    T, D = xt.shape
    E = params["router"].shape[1]
    probs = torch.softmax((xt @ params["router"]).float(), dim=-1)       # (T, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = order.values[:, :top_k], order.indices[:, :top_k]     # (T, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)                        # renormalise

    C = max(int(capacity_factor * T * top_k / E), 1, min_capacity)
    # each (token, choice)'s place in its expert's queue, in (t, j) order:
    # a comparison, not one_hot, which reads the indices back to the host,
    # laid out (E, T·k) so that the running count scans the contiguous axis
    # (a scan over the outer axis of (T·k, E) took 50 ms a layer on the card)
    experts = torch.arange(E, device=xt.device)
    flat = (experts[:, None] == topi.reshape(1, -1)).to(torch.int32)   # (E, T·k)
    before = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = before.gather(0, topi.reshape(1, -1)).reshape(T, top_k)
    keep = pos < C
    slot = torch.where(keep, pos, C)                                    # C: dropped

    # every kept (expert, slot) holds one choice, so writing is the
    # reference's add into zeros; the dropped ones land in row C, cut off.
    # Out of place: torch.func.vmap refuses an in-place write of the
    # workers' values into a buffer made here
    buf = torch.zeros((E, C + 1, D), dtype=xt.dtype, device=xt.device).index_put(
        (topi.reshape(-1), slot.reshape(-1)), xt[:, None].expand(T, top_k, D).reshape(-1, D))
    expert_in = buf[:, :C]
    h = _silu(torch.bmm(expert_in, params["w_gate"])) * torch.bmm(expert_in, params["w_up"])
    expert_out = torch.bmm(h, params["w_down"])                          # (E, C, D)

    w = (topv * keep).to(xt.dtype)                                       # (T, k)
    rows = slot.clamp(max=C - 1)
    out = torch.zeros((T, D), dtype=xt.dtype, device=xt.device)
    for j in range(top_k):
        out = out + expert_out[topi[:, j], rows[:, j]] * w[:, j, None]

    # load-balance aux loss: E · Σ_e f_e · P_e over all tokens
    f = flat.sum(dim=1).float() / T
    aux = E * torch.sum(f * probs.mean(dim=0)) / top_k
    return out, aux


def _moe_forward_tp(params, x: DTensor, *, top_k: int, capacity_factor: float,
                    min_capacity: int):
    """:func:`moe_forward` of a DTensor ``x`` (the tensor-parallel steps):
    one dispatch group over all the worker's tokens, as on one device. The
    tokens are gathered first (an explicit all-gather over the mesh dims
    that shard the batch) and the output goes back to ``x``'s layout (an
    explicit redistribution). Around each view between (B, S, D) and
    (T, D) the tokens are laid out replicated, in both directions: the
    dispatch and the combine leave the token dim of their results and
    gradients sharded over the expert dims too, and the view of such a
    token dim into a batch dim that cannot carry those shards fails (a
    redistribution to the layout a tensor already has still lays out its
    gradient so)."""
    B, S, D = x.shape
    mesh, layout = x.device_mesh, x.placements
    rep = [Replicate()] * mesh.ndim
    xt = x.redistribute(mesh, rep).reshape(B * S, D).redistribute(mesh, rep)
    out, aux = _moe(params, xt, top_k, capacity_factor, min_capacity)
    return out.redistribute(mesh, rep).reshape(B, S, D).redistribute(mesh, layout), aux
