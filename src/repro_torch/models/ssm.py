"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block, as in
``repro/models/ssm.py``.

Chunked SSD forward for prefill (quadratic within chunks, linear state
passing across chunks) and an O(1)-per-token recurrent decode step. Heads of
size P = ssm_head_dim over d_inner = expand·d_model channels; one B/C group
(G = 1); scalar decay A per head.

Recurrence (per head):
  h_t = exp(A·dt_t) · h_{t−1} + dt_t · B_t ⊗ x_t        h ∈ R^{P×N}
  y_t = (C_t · h_tᵀ) + D ⊙ x_t

The dtypes follow the reference's promotions op for op (a bfloat16 model
keeps ``A_log``, ``D`` and ``dt_bias`` in float32, and every mixed product
is taken in float32), and it rounds where the reference rounds: the
intra-chunk output and the carried state in float32, ``y_inter`` against
the state cast to x's dtype, the chunk output cast to x's dtype. The
reference's ``jax.checkpoint`` around the scan body only saves memory and
is dropped. ``silu`` is written as x·sigmoid(x), two roundings as in
``jax.nn.silu``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.ssd_scan import ops as _ssd_ops
from .common import dense_init, rms_norm

__all__ = ["SSMCache", "init_mamba2", "mamba2_forward", "mamba2_decode", "init_ssm_cache",
           "ssd_chunk_scan", "INTRA_CALL_BYTES"]


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K−1, conv_channels) rolling conv input buffer
    state: torch.Tensor  # (B, H, P, N) SSD state, float32


def _conv_channels(cfg) -> int:
    # x, B, C are convolved (Mamba-2): d_inner + 2·N
    return cfg.d_inner + 2 * cfg.ssm_state


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_ssm_cache(batch: int, cfg, dtype, device=None) -> SSMCache:
    K = cfg.ssm_conv
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, K - 1, _conv_channels(cfg)), dtype=dtype, device=device),
        state=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device))


def init_mamba2(gen: torch.Generator, cfg, dtype, lead: tuple = ()) -> dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * N + H  # z, x, B, C, dt
    conv_w = torch.randn(lead + (cfg.ssm_conv, _conv_channels(cfg)), generator=gen,
                         dtype=torch.float32)
    return {
        "in_proj": dense_init(gen, d, proj_out, dtype, lead),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (_conv_channels(cfg),), dtype=dtype),
        "A_log": torch.zeros(lead + (H,), dtype=torch.float32),   # A = −exp(A_log)
        "D": torch.ones(lead + (H,), dtype=torch.float32),
        "dt_bias": torch.zeros(lead + (H,), dtype=torch.float32),
        "norm": torch.zeros(lead + (di,), dtype=dtype),            # gated RMSNorm scale
        "out_proj": dense_init(gen, di, d, dtype, lead),
    }


def _split_proj(proj, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di: 2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, xBC, dt


def _causal_depthwise_conv(xBC, w, b):
    """xBC: (B, S, C); w: (K, C) depthwise causal conv + SiLU, summed tap by
    tap in x's dtype as the reference's Python ``sum`` does."""
    K, S = w.shape[0], xBC.shape[1]
    pad = torch.nn.functional.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i: i + S] * w[i]
    return _silu(out + b)


#: Bytes of float32 output (y_intra and chunk states) one ``ssd_intra_chunk``
#: call may produce: past it a layer's chunks go to the kernel in groups.
INTRA_CALL_BYTES = 1 << 30


def _intra_chunk_group(xc, dtc, la, Bc, Cc) -> int:
    """G: how many chunks one ``ssd_intra_chunk`` call takes, so that its
    float32 outputs (y_intra and chunk states) stay under
    ``INTRA_CALL_BYTES`` (at least one chunk; all of them where all fit)."""
    Bsz, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    return max(1, INTRA_CALL_BYTES // (4 * Bsz * (Q * H * P + H * P * N)))


def ssd_chunk_scan(x, dt, A, B_mat, C_mat, chunk: int, h0=None, use_kernel: bool = True):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) float32 (post-softplus); A: (H,) negative;
    B_mat/C_mat: (B, S, N). Returns (y (B, S, H, P) in x's dtype, final
    state (B, H, P, N) float32). With ``use_kernel`` the quadratic part of
    the chunks goes through the ``ssd_intra_chunk`` kernel in groups of G
    chunks (all chunks in one launch where their float32 outputs fit
    ``INTRA_CALL_BYTES``): the loop over chunks calls the kernel for a
    group when its first chunk comes up and drops the previous group's
    outputs, so one group's y_intra and states are live at a time; each
    chunk then only adds the incoming state's part and carries the state.
    The reference calls its kernel once per chunk inside its scan; the
    intra-chunk half does not depend on the carried state. The kernel's
    wrapper is differentiable (its backward recomputes the mask in torch
    ops), and under the trainer's ``torch.func.vmap`` one launch takes
    every worker's group, so training keeps the kernel on. False takes the
    reference's einsum route, chunk by chunk. There G = C·Bᵀ stays
    float32: the reference's einsum of two x-dtype operands would round it
    to x's dtype, but XLA removes that round trip inside the compiled scan,
    so the reference computes it in float32 too.
    """
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    S0 = S
    if S % chunk:
        # pad the tail with dt = 0 steps: decay exp(A·0) = 1 and zero input
        # leave the final state untouched; padded outputs are sliced off
        pad = chunk - S % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B_mat = torch.nn.functional.pad(B_mat, (0, 0, 0, pad))
        C_mat = torch.nn.functional.pad(C_mat, (0, 0, 0, pad))
        S = S + pad
    nc, Q = S // chunk, chunk
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = B_mat.reshape(Bsz, nc, Q, N)
    Cc = C_mat.reshape(Bsz, nc, Q, N)

    la = torch.cumsum(A[None, None, None, :] * dtc, dim=2)          # (B,nc,Q,H) log-decay
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    if use_kernel:
        group = _intra_chunk_group(xc, dtc, la, Bc, Cc)
    else:
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xq, dtq, laq, Bq, Cq = xc[:, c], dtc[:, c], la[:, c], Bc[:, c], Cc[:, c]
        if use_kernel:
            if c % group == 0:
                # one group's outputs live at a time: drop the last one's first
                y_g = st_g = y_intra = st = None
                y_g, st_g = _ssd_ops.ssd_intra_chunk(
                    xc[:, c:c + group], dtc[:, c:c + group], la[:, c:c + group],
                    Bc[:, c:c + group], Cc[:, c:c + group])
            y_intra, st = y_g[:, c % group], st_g[:, c % group]
        else:
            Ldec = torch.exp(laq[:, :, None, :] - laq[:, None, :, :])     # (B,Qt,Qs,H)
            Ldec = torch.where(causal[None, :, :, None], Ldec, 0.0)
            CB = torch.einsum("btn,bsn->bts", Cq.float(), Bq.float())
            y_intra = torch.einsum("bts,btsh,bsh,bshp->bthp", CB, Ldec, dtq, xq.float())
            decay_out = torch.exp(laq[:, -1:, :] - laq)                   # (B,Q,H)
            st = torch.einsum("bsh,bsh,bsn,bshp->bhpn", decay_out, dtq, Bq.float(),
                              xq.float())
        # incoming-state contribution (against the state in x's dtype) + update
        y_inter = torch.einsum("btn,bth,bhpn->bthp", Cq.float(), torch.exp(laq),
                               h.to(x.dtype).float())
        dec = torch.exp(laq[:, -1, :])                                    # (B,H)
        h = dec[:, :, None, None] * h + st.float()
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y[:, :S0], h


def mamba2_forward(params, x, cfg, cache: SSMCache | None = None, use_kernel: bool = True):
    """Full-sequence forward. x: (B, S, D) → (out, new_cache). With a cache
    (its dtype and shape only are read) the new cache holds the last K−1
    pre-conv inputs and the final state."""
    B, S, D = x.shape
    proj = x @ params["in_proj"]
    z, xBC_pre, dt = _split_proj(proj, cfg)
    xBC = _causal_depthwise_conv(xBC_pre, params["conv_w"], params["conv_b"])
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs = xBC[..., :di].reshape(B, S, H, P)
    B_mat = xBC[..., di: di + N]
    C_mat = xBC[..., di + N:]
    dt = _softplus(dt.float() + params["dt_bias"])                   # (B,S,H) f32
    A = -torch.exp(params["A_log"])
    y, hT = ssd_chunk_scan(xs, dt, A, B_mat, C_mat, cfg.ssm_chunk, use_kernel=use_kernel)
    y = y + params["D"][None, None, :, None] * xs                    # f32
    y = y.reshape(B, S, di)
    y = rms_norm(y * _silu(z), params["norm"], cfg.norm_eps)         # gated norm, f32
    out = (y @ params["out_proj"].float()).to(x.dtype)
    new_cache = None
    if cache is not None:
        K = cfg.ssm_conv
        # the last K−1 *pre-conv* xBC inputs carry the conv into decode
        tail = torch.nn.functional.pad(xBC_pre, (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]
        new_cache = SSMCache(conv=tail.to(cache.conv.dtype), state=hT)
    return out, new_cache


def mamba2_decode(params, x, cfg, cache: SSMCache):
    """Single-token recurrent step. x: (B, 1, D) → (out, new_cache)."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x[:, 0] @ params["in_proj"]                                # (B, proj)
    z, xBC_new, dt = _split_proj(proj, cfg)
    window = torch.cat([cache.conv, xBC_new[:, None].to(cache.conv.dtype)], dim=1)  # (B,K,C)
    xBC = _silu(torch.sum(window * params["conv_w"][None], dim=1) + params["conv_b"])
    xs = xBC[..., :di].reshape(B, H, P)
    B_mat = xBC[..., di: di + N]
    C_mat = xBC[..., di + N:]
    dt = _softplus(dt.float() + params["dt_bias"])                   # (B,H)
    A = -torch.exp(params["A_log"])
    dec = torch.exp(A[None] * dt)                                     # (B,H)
    h = dec[:, :, None, None] * cache.state + torch.einsum(
        "bh,bn,bhp->bhpn", dt, B_mat.float(), xs.float())
    y = torch.einsum("bn,bhpn->bhp", C_mat.float(), h.to(x.dtype).float()).to(x.dtype)
    y = y + params["D"][None, :, None] * xs                           # f32
    y = y.reshape(B, di)
    y = rms_norm(y * _silu(z), params["norm"], cfg.norm_eps)
    out = (y @ params["out_proj"].float())[:, None].to(x.dtype)
    return out, SSMCache(conv=window[:, 1:], state=h)
