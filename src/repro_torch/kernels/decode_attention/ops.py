"""Single-token GQA attention over a KV cache (the decode hot spot).

The CUDA kernel is ``csrc/decode_attention.cu``; the plain PyTorch version
of the reference's ``ref.py`` sits beside it. The wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. It counts its launches in ``decode_attention.launches``.

The rank form, :func:`decode_attention_partial`, serves a KV cache whose
sequence is sharded over several ranks (``launch/sharding.py``'s
``cache_specs``): each rank attends over its slice and gets the float32
output and each row's log-sum-exp, and :func:`merge_partials` combines the
ranks' rows, so the cache is never gathered. It is a mode of the same
kernel (its final combine writes the float32 output and m + log l instead
of dividing them away into q's dtype), counted in
``decode_attention_partial.launches``.

Unlike the reference's wrapper, the cache is neither padded to a multiple
of 512 keys nor transposed to (B, Hkv, C, hd): the kernel reads K and V as
they lie, through their strides, and masks the ragged edge itself.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import launch_util as _lu

__all__ = ["decode_attention", "decode_attention_plain", "decode_attention_bound",
           "decode_attention_partial", "decode_attention_partial_plain", "merge_partials",
           "decode_plan", "DecodePlan", "lanes_per_key"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         ctypes.POINTER(ctypes.c_longlong), _F, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 80, 128, 256)
_MASKED = -1e30
_MIN_KEYS_PER_SPLIT = 128
_MAX_SPAN = 32_768            # keys a split at most: its mask bytes sit in shared memory
#: What one bulk copy costs in :func:`decode_plan`'s model, in bytes of K/V.
COPY_BYTES = 512
#: The kernel's constants (csrc/decode_attention.cu): keys a lane group
#: takes from a tile, consumer threads a block (at hd ≤ 128 and at hd 256;
#: the producer warp comes on top), ring stages, the mbarriers' bytes.
KPL, MAX_THREADS, MAX_THREADS_256, MAX_STAGES, BAR_BYTES = 4, 320, 128, 8, 128
#: Dynamic shared memory a block may take on the H100, the SM's shared
#: memory, and the most the ring takes.
SMEM_BYTES, SMEM_PER_SM, RING_BYTES = 232_448, 233_472, 196_608


def _plain(q, k, v, valid, attn_softcap: float):
    """The plain versions' arithmetic: the masked float32 scores (B, Hkv,
    group, C) and the float32 softmax · v (B, Hq, hd)."""
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bhgd,bchd->bhgc", qg, k.float()) / torch.tensor(
        math.sqrt(hd), dtype=torch.float32)
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    s = torch.where(valid.bool()[None, None, None, :], s, _MASKED)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    return s, out.reshape(B, Hq, hd)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid: torch.Tensor, *, attn_softcap: float = 0.0) -> torch.Tensor:
    """``ref.decode_attention``: s = q·kᵀ/√hd in float32, optional
    softcap·tanh(s/softcap), invalid keys −1e30, softmax over the C keys,
    ·v, cast to q's dtype. q (B, Hq, hd); k, v (B, C, Hkv, hd); valid (C,)."""
    return _plain(q, k, v, valid, attn_softcap)[1].to(q.dtype)


def decode_attention_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   valid: torch.Tensor, *, attn_softcap: float = 0.0
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank form of :func:`decode_attention_plain` on one slice of the
    cache's sequence: the same scores and softmax over the slice's keys,
    the output left in float32, and each row's log-sum-exp of the scores.
    Returns (out (B, Hq, hd) float32, lse (B, Hq) float32). A slice with no
    valid key averages its values, with lse −1e30 + log C_r (−1e30 in
    float32)."""
    s, out = _plain(q, k, v, valid, attn_softcap)
    return out, torch.logsumexp(s, dim=-1).reshape(q.shape[:2])


def merge_partials(out: torch.Tensor, lse: torch.Tensor, group=None, *, keys) -> torch.Tensor:
    """Attention over a whole cache from its slices' rank-form rows
    (:func:`decode_attention_partial`): with M the largest lse of a row
    over the slices, out = Σ_r e^(lse_r − M) out_r / Σ_r e^(lse_r − M), in
    float32 (the caller casts once). A slice with no valid key drops out
    (its weight e^(−1e30 − M) is 0); where no slice of a row has one, the
    slices weigh by their ``keys`` (cache slots), which gives the mean over
    all C values, as ``ref.py``'s softmax of an all −1e30 row does.

    ``group``: the process group over which the cache's sequence is
    sharded, or a sequence of them (the sequence split over several mesh
    dims, reduced in turn): an all-reduce of the max, then one of the
    weighted sums and weights packed together; ``keys`` this rank's slots.
    ``group`` None: ``out`` (R, B, Hq, hd) and ``lse`` (R, B, Hq) hold R
    slices in this process, ``keys`` their R slot counts, and the
    reductions run over the leading axis."""
    import torch.distributed as dist

    if group is not None and not isinstance(group, (list, tuple)):
        group = (group,)

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        if group is None:
            return t.amax(dim=0) if op == "max" else t.sum(dim=0)
        t = t.clone()
        for g in group:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                            group=g)
        return t

    keys = torch.as_tensor(keys, dtype=torch.float32, device=out.device)
    if group is None:
        keys = keys[:, None, None]
    m = reduce(lse, "max")
    w = torch.where(m <= _MASKED / 2, keys, torch.exp(lse - m))
    total = reduce(torch.cat([w[..., None] * out, w[..., None]], dim=-1), "sum")
    return total[..., :-1] / total[..., -1:]


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


class DecodePlan(NamedTuple):
    """How the kernel cuts one call: ``gn`` query heads a unit (a divisor
    of the group, ≤ 4), ``qpb`` units of one KV head and ``hb`` KV heads a
    block, ``lgu`` lane groups a unit (``threads`` consumer threads in all,
    and a producer warp), tiles of ``kt`` keys in a ring of ``stages``
    buffers, ``splits`` key ranges of ``span`` keys, ``smem`` bytes of
    dynamic shared memory; ``head_blocks`` blocks a sequence for each
    split."""
    gn: int
    qpb: int
    hb: int
    lgu: int
    kt: int
    stages: int
    splits: int
    span: int
    threads: int
    smem: int
    head_blocks: int


def _divisors(x: int) -> list[int]:
    return [d for d in range(x, 0, -1) if x % d == 0]


def _valid_bytes(span: int) -> int:
    return -(-span // 128) * 128


def lanes_per_key(hd: int, size: int) -> int:
    """LPK, the lanes that share one key (csrc/decode_attention.cu's
    ``Layout``): one 16-byte vector of the row a lane, rounded up to a power
    of two so that the shuffles tile a warp, at most 32. At hd 80 that is
    16 lanes in bf16 (10 hold a vector) and 32 in fp32 (20 do)."""
    vectors = hd // (16 // size)
    return min(32, 1 << (vectors - 1).bit_length())


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, Hq: int, Hkv: int, hd: int, C: int, size: int,
                sm_count: int) -> DecodePlan:
    """The kernel's plan for q (B, Hq, hd) against C keys of ``size``-byte
    elements on a card of ``sm_count`` SMs.

    - GN = the largest divisor of the group up to 4 (no padded head);
      LPK = :func:`lanes_per_key` lanes a key; within 320 consumer
      threads (128 at hd 256) and whole warps, as many lane groups a unit
      as fit, KT = 4 keys each; one producer warp on top issues the copies.
    - Blocks an SM: one, or two at hd 256 (the kernel's launch bound
      there), whose lane groups then hide each other's latency.
    - Stages: as many as fit in 192 KB (one block an SM) or in half of the
      SM's 228 KB (two), 3 to 8.
    - Splits, for each head split (``hb`` KV heads and ``qpb`` query-head
      chunks a block): for one or two full waves of ``sm_count`` SMs
      (two only where that fills the last wave 5 % better), at least 128
      and at most 32,768 keys a split; the span is ``ceil(C / splits)`` and
      splits that would be empty are dropped.
    - Among the head splits it keeps the one whose slowest SM moves the
      fewest bytes: waves × the K/V bytes of a block, plus the partial rows
      the last split block writes and reads back, plus
      :data:`COPY_BYTES` for each bulk copy (one a tile for K and one for V
      when the block takes every KV head, else one a key). Ties go to more
      heads a block.
    """
    group = Hq // Hkv
    gn = max(d for d in (1, 2, 3, 4) if group % d == 0)
    qcn = group // gn
    lpk = lanes_per_key(hd, size)
    per_warp = 32 // lpk
    resident = 2 if hd >= 256 else 1
    max_threads = MAX_THREADS_256 if hd >= 256 else MAX_THREADS
    block_smem = min(SMEM_BYTES, SMEM_PER_SM // resident - 1024)
    reserve = BAR_BYTES + _valid_bytes(min(C, _MAX_SPAN))
    slots = sm_count * resident
    best = None
    for hb in _divisors(Hkv):
        for qpb in _divisors(qcn):
            units = hb * qpb
            step = per_warp // math.gcd(units, per_warp)
            lgu = step * (max_threads // (units * step * lpk))
            stage = 2 * KPL * lgu * hb * hd * size
            while lgu >= step and reserve + 3 * stage > block_smem:
                lgu -= step
                stage = 2 * KPL * lgu * hb * hd * size
            if lgu < step:
                continue
            kt = KPL * lgu
            head_blocks = (Hkv // hb) * (qcn // qpb)
            pairs = B * head_blocks
            most = max(1, -(-C // _MIN_KEYS_PER_SPLIT))
            least = -(-C // _MAX_SPAN)
            splits, fill = 1, 0.0
            for waves in (1, 2):
                s_ = max(1, least, min(waves * slots // pairs, most))
                blocks = pairs * s_
                f = blocks / (-(-blocks // slots) * slots)
                if f > fill + 0.05:       # two waves only for a much fuller last wave
                    splits, fill = s_, f
            span = -(-C // splits)
            splits = -(-C // span)
            waves = -(-(pairs * splits) // slots)
            rows = units * gn
            tail = 8 * rows * splits * hd if splits > 1 else 0
            copies = 2 * (-(-span // kt) if hb == Hkv else span)
            cost = (waves * resident * span * hb * hd * size * 2 + tail
                    + COPY_BYTES * copies)
            key = (cost, -units, -hb)
            if best is None or key < best[0]:
                best = (key, hb, qpb, lgu, kt, stage, splits, span, head_blocks)
    if best is None:
        raise ValueError(f"decode_attention: no plan fits Hq={Hq}, Hkv={Hkv}, hd={hd}")
    _, hb, qpb, lgu, kt, stage, splits, span, head_blocks = best
    ring = min(RING_BYTES, block_smem - BAR_BYTES - _valid_bytes(span))
    stages = max(3, min(MAX_STAGES, ring // stage))
    threads = hb * qpb * lgu * lpk
    # the block merge reuses the ring: the lane groups' (m, l, acc) and
    # each row's weights
    rows = hb * qpb * gn
    scratch = ((threads // lpk) * gn * (hd + 2) + rows * (lgu + 2)) * 4
    smem = BAR_BYTES + _valid_bytes(span) + max(stages * stage, scratch)
    return DecodePlan(gn, qpb, hb, lgu, kt, stages, splits, span, threads, smem, head_blocks)


def _plan_args(q, k, v):
    """The cached plan of a call's shapes and strides, and the kernel's
    int64 argument array (csrc/decode_attention.cu's ``plan``)."""
    B, Hq, hd = (int(s) for s in q.shape)
    C, Hkv = int(k.shape[1]), int(k.shape[2])
    key = (B, Hq, Hkv, hd, C, k.stride(), v.stride(), q.dtype, q.device.index)
    hit = _args.get(key)
    if hit is not None:
        return hit
    size = q.element_size()
    for what, t in (("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{what}'s head dimension must be contiguous")
        if any((t.stride(d) * size) % 16 for d in range(3)):
            raise ValueError(f"{what} must start 16-byte aligned with 16-byte aligned "
                             "strides")
    plan = decode_plan(B, Hq, Hkv, hd, C, size, _lu.sm_count(q.device.index))
    ks, vs = k.stride(), v.stride()
    if (plan.hb == Hkv and ks[2] == hd and ks[1] == Hkv * hd and vs[2] == hd
            and vs[1] == Hkv * hd):
        mode = 0                      # a tile of keys x every head: one copy
    elif ks[2] == hd and vs[2] == hd:
        mode = 1                      # one copy a key
    else:
        mode = 2                      # one copy a key and head
    arr = (ctypes.c_longlong * 22)(
        B, Hq, Hkv, hd, C, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], _DTYPES[q.dtype],
        plan.gn, plan.qpb, plan.hb, plan.lgu, plan.stages, plan.splits, plan.span, mode,
        plan.threads, plan.smem)
    hit = _args[key] = (plan, arr)
    return hit


def _check(q, k, v, valid, name: str) -> None:
    """The calls' shapes and dtypes (both forms, every device)."""
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
        raise TypeError(f"{name} takes q, k, v of one dtype, float32, bfloat16 "
                        f"or float16, not {q.dtype}/{k.dtype}/{v.dtype}")


def _launch(q, k, v, valid, out, lse, attn_softcap: float, name: str) -> bool:
    """The kernel on CUDA tensors: ``lse`` None writes q's dtype's output,
    a float32 (B, Hq) tensor the rank form (float32 ``out``). Whether it
    launched (an empty call does not)."""
    B, Hq, hd = (int(s) for s in q.shape)
    C = int(k.shape[1])
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {_HEAD_DIMS}, not {hd}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, not {valid.dtype}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev or valid.device != dev:
        raise ValueError(f"q, k, v and valid must lie on the CPU or a CUDA device, all on "
                         f"one, not {q.device}, {k.device}, {v.device}, {valid.device}")
    if not q.is_contiguous() or not valid.is_contiguous():
        raise ValueError("q and valid must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v must start 16-byte aligned")
    if B == 0 or Hq == 0 or C == 0:
        return False
    plan, args = _plan_args(q, k, v)
    if plan.splits > 1:
        rows = B * Hq * plan.splits
        ml, acc, tickets = _lu.workspace(
            "decode_attention", dev, (2 * rows, torch.float32), (hd * rows, torch.float32),
            (B * plan.head_blocks, torch.int32))
    else:
        ml = acc = tickets = 0
    index = dev.index
    err = _lu.library("decode_attention", _SIGNATURES).decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), ml, acc, tickets, args, float(attn_softcap),
        index, _lu.raw_stream(index))
    if err != 0:
        _lu.raise_launch_error(name, err, index)
    return True


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
    _check(q, k, v, valid, "decode_attention")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, attn_softcap=attn_softcap)
    out = torch.empty_like(q)
    if _launch(q, k, v, valid, out, None, attn_softcap, "decode_attention"):
        decode_attention.launches += 1
    return out


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid: torch.Tensor, *, attn_softcap: float = 0.0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank form: one query token per sequence against one rank's slice
    of the cache's sequence, ``k``, ``v`` (B, C_r, Hkv, hd) and ``valid``
    (C_r,) laid out as for :func:`decode_attention`. Returns the float32
    output (B, Hq, hd) over the slice's keys and each row's log-sum-exp
    (B, Hq) float32, for :func:`merge_partials`. Masked keys score −1e30,
    so a slice with no valid key averages its values with lse
    −1e30 + log C_r."""
    _check(q, k, v, valid, "decode_attention_partial")
    if q.device.type == "cpu":
        return decode_attention_partial_plain(q, k, v, valid, attn_softcap=attn_softcap)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if _launch(q, k, v, valid, out, lse, attn_softcap, "decode_attention_partial"):
        decode_attention_partial.launches += 1
    return out, lse


decode_attention_partial.launches = 0
decode_attention.launches = 0

_args: dict[tuple, tuple] = {}
