"""Single-token GQA attention over a KV cache (the decode hot spot).

The CUDA kernel is ``csrc/decode_attention.cu``; the plain PyTorch version
of the reference's ``ref.py`` sits beside it. The wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. It counts its launches in ``decode_attention.launches``.

Unlike the reference's wrapper, the cache is neither padded to a multiple
of 512 keys nor transposed to (B, Hkv, C, hd): the kernel reads K and V as
they lie, through their strides, and masks the ragged edge itself.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build as _build

__all__ = ["decode_attention", "decode_attention_plain", "decode_attention_bound",
           "num_splits"]

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128, 256)
_GROUP_PER_BLOCK = 4          # query heads of one KV head that one block serves
_MIN_KEYS_PER_SPLIT = 128
_sm_count: dict[int, int] = {}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid: torch.Tensor, *, attn_softcap: float = 0.0) -> torch.Tensor:
    """``ref.decode_attention``: s = q·kᵀ/√hd in float32, optional
    softcap·tanh(s/softcap), invalid keys −1e30, softmax over the C keys,
    ·v, cast to q's dtype. q (B, Hq, hd); k, v (B, C, Hkv, hd); valid (C,)."""
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bhgd,bchd->bhgc", qg, k.float()) / torch.tensor(
        math.sqrt(hd), dtype=torch.float32)
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    s = torch.where(valid.bool()[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


def decode_attention_bound(q, k, v, valid, *, attn_softcap: float = 0.0) -> torch.Tensor:
    """A first-order float32 error bound per output element, (B, Hq, hd):
    2⁻²⁴·(2·hd·A + C + hd)·Σ_t p_t·|v_t|, where p is the softmax of the
    plain version and A the row's largest Σ_i|q_i·k_ti|/√hd. The score
    dot of hd terms errs by at most hd·2⁻²⁴·A, which moves each p_t by that
    much relatively (twice, through the max); the sums over C keys and the
    division add C + hd units of 2⁻²⁴. Two float32 versions that take the
    sums in other orders agree within it."""
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bhgd,bchd->bhgc", qg, k.float()) / scale
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    s = torch.where(valid.bool()[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    terms = torch.einsum("bhgc,bchd->bhgd", p, v.float().abs())
    a = torch.einsum("bhgd,bchd->bhgc", qg.abs(), k.float().abs()).amax(dim=-1) / scale
    C = k.shape[1]
    bound = (2 * hd * a[..., None] + C + hd) * 2.0 ** -24 * terms
    return bound.reshape(B, Hq, hd)


def num_splits(B: int, Hkv: int, group: int, C: int, sm_count: int) -> int:
    """Key-range splits per (batch, KV head): enough blocks for two waves
    of ``sm_count`` SMs, and at least 128 keys in each split."""
    blocks = B * Hkv * -(-group // _GROUP_PER_BLOCK)
    want = -(-2 * sm_count // blocks)
    return max(1, min(want, -(-C // _MIN_KEYS_PER_SPLIT)))


def _check_card(**tensors) -> None:
    for what, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{what} lies on {t.device}, but the current CUDA device "
                             f"is cuda:{torch.cuda.current_device()}")


def _sms(dev: torch.device) -> int:
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_count[dev.index]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, attn_softcap: float = 0.0) -> torch.Tensor:
    """One query token per sequence against its KV cache.

    ``q``: (B, Hq, hd) contiguous; ``k``, ``v``: (B, C, Hkv, hd) of q's
    dtype (float32, bfloat16 or float16), any strides with the head
    dimension contiguous (a layer's slice of a stacked cache is taken as
    it lies); ``valid``: (C,) bool, which cache slots hold a key the token
    may see. Returns (B, Hq, hd) in q's dtype. Masked keys score −1e30, as
    in the reference, so a row with no valid key averages all C values.
    """
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, hd) and k, v (B, C, Hkv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = (int(s) for s in q.shape)
    C, Hkv = int(k.shape[1]), int(k.shape[2])
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}: need "
                         f"(B, C, Hkv, hd) with Hkv dividing Hq")
    if tuple(valid.shape) != (C,):
        raise ValueError(f"valid must be (C,) = ({C},), got {tuple(valid.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes q, k, v of one dtype, float32, bfloat16 "
                        f"or float16, not {q.dtype}/{k.dtype}/{v.dtype}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, attn_softcap=attn_softcap)
    if hd not in _HEAD_DIMS:
        raise ValueError(f"decode_attention takes head dims {_HEAD_DIMS}, not {hd}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, not {valid.dtype}")
    _check_card(q=q, k=k, v=v, valid=valid)
    if not q.is_contiguous() or not valid.is_contiguous():
        raise ValueError("q and valid must be contiguous")
    if q.data_ptr() % 16:
        raise ValueError("q must start 16-byte aligned")
    size = q.element_size()
    for what, t in (("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{what}'s head dimension must be contiguous")
        if t.data_ptr() % 16 or any((t.stride(d) * size) % 16 for d in range(3)):
            raise ValueError(f"{what} must start 16-byte aligned with 16-byte aligned "
                             "strides")
    out = torch.empty_like(q)
    if B == 0 or Hq == 0 or C == 0:
        return out
    group = Hq // Hkv
    splits = num_splits(B, Hkv, group, C, _sms(q.device))
    rows = B * Hq * (splits if splits > 1 else 0)
    part_ml = torch.empty((max(rows, 1), 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((max(rows, 1), hd), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), B, Hq, Hkv, hd, C,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        float(attn_softcap), splits, _DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
