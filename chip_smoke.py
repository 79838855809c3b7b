"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at its path's shapes and times it,
and drives the port's paths on ``cuda``:

- the topology solve (``solve_topology`` at n=64, r=128 and the n=16 BCube
  scenario; every CG matvec A·Aᵀλ in one ``edge_schur_matvec`` launch, the
  right-hand side's ``A_op`` in one ``edge_laplacian_blocks`` launch and
  the last ``AT_op`` in one ``edge_adjoint`` launch), checked against the
  CPU at n=16, evaluated by consensus simulation, with short profiled
  windows of its device stages; main_n64's request again through the
  barrier engine (``engine="barrier"``: restarts as one batched ADMM
  solve), held to main_n64's support;
- the batched ADMM: the four ADMM-path edge forms with their batch axis,
  bitwise per instance against their unbatched launches;
  ``HomogeneousADMM.solve_batched`` over main_n64's four annealed restarts
  against the four sequential solves (fp32, and at n=16 in float64, held
  equal); ``solve_topologies`` at n=64 over four budgets as ONE batched
  solve, and at n=16 card vs CPU;
- the topology service (``repro_torch.serve.TopologyService``): a bucket
  of four n=64 budgets as one batched solve, a cache hit, the full tier
  through the barrier engine, drift invalidation, a deadlined request on
  the anytime route, a NaN full-tier stub degrading to the guarded warm
  ADMM on the card, and an overload rejection;
- DSGD training of smollm-135m at full width through the launcher
  (``repro_torch.launch.train``): n=8 workers on one card, BA topology
  (r=16) solved on the card, 10 steps, every step's gossip one
  ``gossip_mix_batched`` launch for all 11 leaves (the tiled kernel, held
  bitwise to the first-cut witness kernel at the first gossip); the witness
  and the tiled kernel timed over tables of degree 1, 4 and 7 at the same
  bytes (``tools/gossip_deg.py``); then the row-loop oracle of one-worker
  ``gossip_mix`` kernels on the trained leaves, reduced smollm card vs CPU,
  and one profiled full-width train step;
- DSGD with one worker a rank (``make_sharded_train_step``): main_dsgd's
  cluster as 8 gloo ranks spawned on the one card, 2 steps whose gossip is
  the schedule's matching rounds as point-to-point sends (staged through
  pinned host memory: gloo sends host memory only), step 1's gossip held
  bitwise to a stacked oracle and its params to the stacked
  ``dsgd_train_step``; the elastic rank step without faults bitwise the
  plain one, a dead rank frozen, a dropped straggler's round bitwise its
  oracle;
- tensor parallelism inside a worker on DTensor: qwen1.5-0.5b at full
  width on 4 gloo ranks spawned on the one card: ``build_step`` on a data=2
  × model=2 mesh (the rank-per-worker schedule step, each worker's leaves
  DTensors over its two "model" ranks, the gossip on local shards; 2
  steps), ``make_tp_train_step`` of one pod-sized worker over both dims
  (2 microbatches) and ``make_matmul_gossip_train_step`` on a pod=2 ×
  data=1 × model=2 mesh, each held against its comparison in this
  process (the stacked ``dsgd_train_step``, the same steps unsharded);
- elastic DSGD training through the launcher (``--elastic``): main_dsgd's
  run with churn, stragglers, packet loss and a NIC collapse (a re-solve on
  the card, adopted mid-run), every round mixing leaf by leaf through
  ``gossip_mix_batched`` over ``deg_cap = n − 1`` tables; a fault-free
  elastic run held bitwise to main_dsgd's curve; and a full-width run
  killed by SIGKILL and resumed from its checkpoint in subprocesses,
  bitwise the uninterrupted run;
- serving through the launcher (``repro_torch.launch.serve``): smollm-135m
  at full width (batch 16, 2,048-token prompts, 128 new tokens), every
  attention decode through the ``decode_attention`` kernel, and
  mamba2-780m at full width (batch 8, 1,024-token prompts, 64 new tokens),
  every layer's SSD chunks of its prefill through one ``ssd_intra_chunk``
  launch (the bf16 tensor-core route); the other four families at full
  width: granite-moe-1b-a400m (32 experts, top-8; batch 16, 1,024-token
  prompts, 64 new tokens), internvl2-1b (256 stub patch embeddings before
  768-token prompts, group 7), whisper-tiny (fp32, 1,500 stub encoder
  frames, cross attention; 64-token prompts, 128 new tokens) and
  zamba2-2.7b (54 Mamba-2 layers, the shared attention block at head dim
  80 after every 6; batch 8, 1,024-token prompts, 64 new tokens), every
  self-attention decode through ``decode_attention`` and zamba2's prefill
  through ``ssd_intra_chunk``, each family with one profiled prefill and
  decode step on the launcher's weights; then both kernels at every
  family's serving shape and at gemma2-9b's, the six families reduced
  card vs CPU, one profiled full-width decode step and one profiled
  mamba2-780m prefill;
- DSGD training of the other families at full width, 6 steps each, BA
  topology (r = 2n), batch 4 × 256 tokens a worker: whisper-tiny (n = 8)
  through the launcher, granite-moe-1b-a400m (12 of 24 layers),
  mamba2-780m (16 of 48), zamba2-2.7b (6 of 54: one shared-attention
  group) and internvl2-1b (20 of 24, 256 stub patches before the text) at
  n = 4 on their depth-cut configs through ``dsgd_train_step``; every step's gossip one
  ``gossip_mix_batched`` launch a dtype, every Mamba-2 layer's SSD through one
  ``ssd_intra_chunk`` launch a step for all workers (the vmap rule), its
  first launch held against the plain version forward and backward; then
  the reduced families card vs CPU. The bigram tables of the six
  vocabularies are built in background processes from the start of the
  run;
- the §VI-B evaluation (``repro_torch.dsgd.sim``): bench_training_time's
  homo setup at n=16 (the paper's baselines and BA-Topo at r = 16, 24, 32,
  solved on the card) trained by one ``accuracy_curves`` call, 30 epochs,
  every step's gossip one ``gossip_mix_batched`` launch for all four
  leaves and nine topologies, checked against the CPU and the host oracle;
  the kernel at that fp32 shape beside ``torch.bmm``, one profiled epoch; the
  cross-product engine ({static, round-robin} × {dense, top-k, random-k})
  and bench_compression's consensus curves; the chaos engine at
  bench_chaos's defaults with its re-optimized run (the drift detector and
  ``reoptimize_topology`` on the card), with a fault-free spec held bitwise
  to the cross engine;
- the topology CLI (``repro_torch.launch.topo``) at n=16 on the node
  scenario.

Every phase prints one JSON line; any failure raises and the script exits
non-zero. Each path's kernel launches are counted from 0 over that path
alone, and every kernel the path must run has to have launched. The line
before the last lists every kernel with its launches on its path, its
error against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero without one. It imports only torch,
numpy, ``repro_torch`` (from ``src/`` beside this file) and
``tools/gossip_deg.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import types
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: The kernels each path must launch, counted from 0 over that path alone.
PATH_KERNELS = {
    "solve": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec",
              "hop_step"),
    "dsgd": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec",
             "hop_step", "gossip_mix_batched"),
    "sweep": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec",
              "hop_step"),
    "rowloop": ("gossip_mix",),
    "dsgd_dynamic": ("gossip_mix_batched",),
    "xstep_kkt": ("edge_laplacian_blocks", "edge_adjoint"),
    "serve_dense": ("decode_attention",),
    "serve_ssm": ("ssd_intra_chunk",),
    "serve_moe": ("decode_attention",),
    "serve_vlm": ("decode_attention",),
    "serve_audio": ("decode_attention",),
    "serve_hybrid": ("decode_attention", "ssd_intra_chunk"),
    "train_moe": ("gossip_mix_batched",),
    "train_vlm": ("gossip_mix_batched",),
    "train_audio": ("gossip_mix_batched",),
    "train_ssm": ("gossip_mix_batched", "ssd_intra_chunk"),
    "train_hybrid": ("gossip_mix_batched", "ssd_intra_chunk"),
    "sim": ("gossip_mix_batched",),
    "barrier": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec",
                "hop_step"),
    "service": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec",
                "hop_step"),
    "reopt": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec"),
    "elastic": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec",
                "gossip_mix_batched"),
    "topo_cli": ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec",
                 "hop_step"),
}

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
INT8_OP_PER_S = 1.979e15        # H100 SXM dense int8 tensor-core rate
BF16_OP_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
FP32_OP_PER_S = 67e12           # H100 SXM float32 rate outside the tensor cores
TIMED_LAUNCHES = 200             # a timing's launches: few enough for the run's time limit
WARMUP_LAUNCHES = 20
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - T0},
                     default=float), flush=True)


def eager_ms(fn, launches: int = TIMED_LAUNCHES, warmup: int = WARMUP_LAUNCHES) -> float:
    """Mean time of one eager ``fn()`` call over ``launches`` back-to-back
    calls, by CUDA events after a warm-up: at these sizes it is the host's
    launch rate, Python and binding included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def device_ms(fn, launches: int = TIMED_LAUNCHES) -> float:
    """Mean device time of one ``fn()`` call: ``launches`` calls captured in
    one CUDA graph and replayed, timed by CUDA events, so the host's launch
    cost is out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / launches
    del graph
    return ms


def rotating(calls):
    """One callable that runs ``calls`` in turn, one per call: timed by
    :func:`device_ms` over layer slices of one stacked cache bigger than the
    50 MB L2, each call finds its operands cold, as the decode step does."""
    turn = iter(range(1 << 62))
    return lambda: calls[next(turn) % len(calls)]()


def timings(kernel, plain, library=None) -> dict:
    return dict(ms=device_ms(kernel), plain_ms=device_ms(plain),
                library_ms=None if library is None else device_ms(library),
                call_ms=eager_ms(kernel), plain_call_ms=eager_ms(plain))


def large_timings(kernel, plain, library=None, reps: int = 10) -> dict:
    """Timings of calls that each take a large fraction of a millisecond or
    more (and allocate GBs, which a CUDA graph would hold): ``reps`` eager
    back-to-back calls timed by CUDA events after two warm-ups. The host's
    launch cost (microseconds) hides behind the device time, so the eager
    number is the device number and ``call_ms`` equals ``ms``."""
    def timed(fn):
        return eager_ms(fn, reps, warmup=2) if fn is not None else None

    ms = timed(kernel)
    return dict(ms=ms, plain_ms=timed(plain), library_ms=timed(library), call_ms=ms)


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    import repro_torch  # noqa: F401 — sets the TF32 switches
    from repro_torch.kernels import build

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off"
    assert not torch.backends.cudnn.allow_tf32, "TF32 cuDNN must be off"
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction, \
        "bf16 matmuls must accumulate in full float32"
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: build.parse_ptxas(log) for name, log in build.ptxas_logs.items()}
    emit("build", seconds=build_s, card=smi, torch=torch.__version__,
         cuda=torch.version.cuda, ptxas=ptxas)
    return smi


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version, and its times
# ---------------------------------------------------------------------------

def _edge_laplacian_case(n, dtype, rng):
    from repro_torch.kernels.edge_laplacian import ops

    m = n * (n - 1) // 2
    g = torch.from_numpy(rng.random(m)).to(device="cuda", dtype=dtype)
    lidx = ops.packed_edge_index(n, "cuda")
    got = ops.edge_laplacian(g, n)
    want = ops.edge_laplacian_plain(g, lidx)
    err = float((got - want).abs().max())
    row_max = float(want.diagonal().abs().max())
    tol = 1e-12 if dtype == torch.float64 else 1e-5 * row_max
    assert err <= tol, f"edge_laplacian n={n} {dtype}: err {err} > {tol}"
    size = g.element_size()
    return dict(
        max_abs_err=err, tol=tol,
        **timings(lambda: ops.edge_laplacian(g, n),
                  lambda: ops.edge_laplacian_plain(g, lidx)),
        bound_ms=1e3 * size * (m + n * n) / HBM_BYTES_PER_S, bound_by="bytes")


def _edge_quadform_case(n, dtype, rng):
    from repro_torch.kernels.edge_laplacian import ops

    iu = np.triu_indices(n, 1)
    ei = torch.from_numpy(iu[0].astype(np.int64)).cuda()
    ej = torch.from_numpy(iu[1].astype(np.int64)).cuda()
    P = torch.from_numpy(rng.standard_normal((n, n))).to(device="cuda", dtype=dtype)
    got = ops.edge_quadform(P, ei, ej)
    want = ops.edge_quadform_plain(P, ei, ej)
    assert torch.equal(got.view(torch.int64 if dtype == torch.float64 else torch.int32),
                       want.view(torch.int64 if dtype == torch.float64 else torch.int32)), \
        f"edge_quadform n={n} {dtype}: not bitwise equal to the plain version"
    m, size = int(ei.shape[0]), P.element_size()
    # P read once and the form written once; the endpoints are not counted:
    # on the main path the edge list is the complete lexicographic one, so
    # they follow from the edge index as edge_laplacian derives them
    return dict(
        max_abs_err=float((got - want).abs().max()), tol=0.0,
        **timings(lambda: ops.edge_quadform(P, ei, ej),
                  lambda: ops.edge_quadform_plain(P, ei, ej)),
        bound_ms=1e3 * size * (n * n + m) / HBM_BYTES_PER_S, bound_by="bytes")


def _edge_laplacian_blocks_case(n, dtype, rng):
    """The fused form against the L-only kernel followed by the torch ops,
    bitwise; timed against its plain version. Bound: g, λ, S, T and y read
    once, the 2n² + n outputs written once."""
    from repro_torch.kernels.edge_laplacian import ops

    m = n * (n - 1) // 2
    g = torch.from_numpy(rng.random(m)).to(device="cuda", dtype=dtype)
    S, T = (torch.from_numpy(rng.standard_normal((n, n))).to(device="cuda", dtype=dtype)
            for _ in range(2))
    y = torch.from_numpy(rng.standard_normal(n)).to(device="cuda", dtype=dtype)
    lam = torch.tensor(-0.7, dtype=dtype, device="cuda")
    out = torch.empty(2 * n * n + n, dtype=dtype, device="cuda")
    ops.edge_laplacian_blocks(g, lam, S, T, y, out)
    L = ops.edge_laplacian(g, n)
    I = torch.eye(n, dtype=dtype, device="cuda")
    want = torch.cat([(L - lam * I + S).reshape(-1), (L + lam * I + T).reshape(-1),
                      torch.diagonal(L) + y])
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits)), \
        f"edge_laplacian_blocks n={n} {dtype}: not bitwise equal to the kernel + torch ops"
    out2 = torch.empty_like(out)
    return dict(
        max_abs_err=0.0, tol=0.0,
        **timings(lambda: ops.edge_laplacian_blocks(g, lam, S, T, y, out),
                  lambda: ops.edge_laplacian_blocks_plain(g, lam, S, T, y, out2)),
        bound_ms=1e3 * g.element_size() * (m + 1 + 4 * n * n + 2 * n) / HBM_BYTES_PER_S,
        bound_by="bytes")


def _adjoint_operands(n, dtype, rng, hetero=False):
    P, Q = (torch.from_numpy(rng.standard_normal((n, n))).to(device="cuda", dtype=dtype)
            for _ in range(2))
    w = torch.from_numpy(rng.standard_normal(n)).to(device="cuda", dtype=dtype)
    v = (torch.from_numpy(rng.standard_normal(n * (n - 1) // 2)).to(device="cuda", dtype=dtype)
         if hetero else None)
    return P, Q, w, v


def _trace_tol(P, Q) -> float:
    """2n·u·(Σ|P_ii| + Σ|Q_ii|): how far two orders of summing the two
    diagonals may move −tr P + tr Q."""
    u = torch.finfo(P.dtype).eps / 2
    return 2 * P.shape[0] * u * float(P.diagonal().abs().sum() + Q.diagonal().abs().sum())


def _adjoint_composition(P, Q, w, v=None):
    """AT_op's x-part as the card composed it before ``edge_adjoint``: the
    ``edge_quadform`` kernel and ten torch ops."""
    from repro_torch.kernels.edge_laplacian import ops

    ei, ej = ops.edge_endpoints(P.shape[0], "cuda")
    xg = ops.edge_quadform(P + Q, ei, ej) + (w[ei] + w[ej])
    if v is not None:
        xg = xg + v
    return torch.cat([xg, (-torch.trace(P) + torch.trace(Q))[None]])


def _edge_adjoint_case(n, dtype, rng, hetero=False, timed=True):
    """``edge_adjoint`` against the torch composition on the card: the edge
    entries bitwise, −tr P + tr Q within :func:`_trace_tol`. Timed against
    its plain version and the composition it replaced (the ``edge_quadform``
    kernel and torch ops). Bound: P, Q, w (and v) read once, the m + 1
    outputs written once."""
    from repro_torch.kernels.edge_laplacian import ops

    P, Q, w, v = _adjoint_operands(n, dtype, rng, hetero)
    m = n * (n - 1) // 2
    got = ops.edge_adjoint(P, Q, w, v)
    want = ops.edge_adjoint_plain(P, Q, w, v)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(got[:m].view(bits), want[:m].view(bits)), \
        f"edge_adjoint n={n} {dtype} hetero={hetero}: edge entries not bitwise equal"
    trace_err, tol = abs(float(got[m] - want[m])), _trace_tol(P, Q)
    assert trace_err <= tol, f"edge_adjoint n={n} {dtype}: trace err {trace_err} > {tol}"
    assert torch.equal(_adjoint_composition(P, Q, w, v)[:m].view(bits), got[:m].view(bits))
    out = dict(max_abs_err=trace_err, tol=tol, trace_bitwise=trace_err == 0.0)
    if not timed:
        return out
    size = P.element_size()
    def composition():
        return _adjoint_composition(P, Q, w, v)

    return dict(
        out, **timings(lambda: ops.edge_adjoint(P, Q, w, v),
                       lambda: ops.edge_adjoint_plain(P, Q, w, v)),
        composition_ms=device_ms(composition), composition_call_ms=eager_ms(composition),
        bound_ms=1e3 * size * (2 * n * n + n + m + 1 + (m if hetero else 0)) / HBM_BYTES_PER_S,
        bound_by="bytes")


def _edge_schur_matvec_case(n, dtype, rng, hetero=False, timed=True):
    """``edge_schur_matvec`` bitwise against ``edge_laplacian_blocks`` fed
    ``edge_adjoint``'s output (and its adjoint output against
    ``edge_adjoint``), and against the plain torch composition within
    2n·u·(max row Σ|xg| + Σ|P_ii| + Σ|Q_ii|) + 2u·max|out|. Timed against
    its plain version and the composition it replaced (the card's old
    ``A_op(AT_op(λ))``: ``edge_quadform``, ten torch ops and
    ``edge_laplacian_blocks``). Bound: P, Q and w read once, the 2n² + n
    outputs written once."""
    from repro_torch.kernels.edge_laplacian import ops

    P, Q, w, v = _adjoint_operands(n, dtype, rng, hetero)
    m, k = n * (n - 1) // 2, 2 * n * n + n
    out = torch.empty(k, dtype=dtype, device="cuda")
    x_adj = torch.empty(m + 1, dtype=dtype, device="cuda")
    ops.edge_schur_matvec(P, Q, w, out, v=v, x_adj=x_adj)
    x = ops.edge_adjoint(P, Q, w, v)
    want = torch.empty_like(out)
    ops.edge_laplacian_blocks(x[:-1], x[-1], P, Q, w, want)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits)) and \
        torch.equal(x_adj.view(bits), x.view(bits)), \
        f"edge_schur_matvec n={n} {dtype} hetero={hetero}: not bitwise equal to " \
        "edge_laplacian_blocks fed edge_adjoint"
    plain = ops.edge_schur_matvec_plain(P, Q, w, torch.empty_like(out), v)
    G = torch.cat([x[:-1].abs(), x.new_zeros(1)])[ops.packed_edge_index(n, "cuda")]
    u = torch.finfo(dtype).eps / 2
    tol = (2 * n * u * float(G.sum(dim=1).max()) + _trace_tol(P, Q)
           + 2 * u * float(plain.abs().max()))
    err = float((out - plain).abs().max())
    assert err <= tol, f"edge_schur_matvec n={n} {dtype}: err {err} > {tol}"
    res = dict(max_abs_err=err, tol=tol, bitwise_vs_blocks_of_adjoint=True)
    if not timed:
        return res
    out2, out3 = torch.empty_like(out), torch.empty_like(out)

    def composition():
        xc = _adjoint_composition(P, Q, w, v)
        return ops.edge_laplacian_blocks(xc[:-1], xc[-1], P, Q, w, out3)

    return dict(
        res, **timings(lambda: ops.edge_schur_matvec(P, Q, w, out, v=v),
                       lambda: ops.edge_schur_matvec_plain(P, Q, w, out2, v)),
        composition_ms=device_ms(composition), composition_call_ms=eager_ms(composition),
        bound_ms=1e3 * P.element_size() * (4 * n * n + 2 * n + (m if hetero else 0))
        / HBM_BYTES_PER_S, bound_by="bytes")


def _a_op_case(n, r):
    """``A_op`` and the CG matvec on a homogeneous fp32 spec at the main
    path's n, each fused form (one launch) against the composition it
    replaced: ``A_op`` bitwise against the L-only kernel and eight torch ops;
    ``schur_matvec`` bitwise against ``A_op(AT_op(λ))`` through
    ``edge_adjoint`` and ``edge_laplacian_blocks``, and within the trace's
    tolerance of the card's old route (the ``edge_quadform`` kernel, ten
    torch ops and ``edge_laplacian_blocks``). Each timed from a CUDA graph
    and eagerly, with the device launches of one eager call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine as te

    spec = te.make_homo_spec(n, r, te.ADMMConfig(device="cuda"))
    st = te.init_state(spec, np.random.default_rng(n).random(spec.m) * 0.3, 0.5)
    st, _ = te.step(spec, st)
    X = st.X
    lamv = torch.cat([b.reshape(-1) for b in st.lam])
    P, Q, w = te.split_lam(spec, lamv)[:3]

    def composition():
        x, S, y, T = X[:4]
        g, lam = x[:-1], x[-1]
        L = te._L_of_g(spec, g)
        return torch.cat([(L - lam * spec.I + S).reshape(-1),
                          (L + lam * spec.I + T).reshape(-1), torch.diagonal(L) + y])

    def fused():
        return te.A_op(spec, X)

    def matvec():
        return te.schur_matvec(spec, lamv)

    def matvec_composition():
        return te.A_op(spec, (_adjoint_composition(P, Q, w), P, w, Q))

    bits = torch.int32
    assert torch.equal(fused().view(bits), composition().view(bits)), \
        f"A_op n={n}: the fused form differs from the composition"
    got = matvec()
    assert torch.equal(got.view(bits), te.A_op(spec, te.AT_op(spec, lamv)).view(bits)), \
        f"schur_matvec n={n}: differs from A_op(AT_op(λ)) through the fused forms"
    matvec_err = float((got - matvec_composition()).abs().max())
    # xg is bitwise, so only the diagonals' (deg ∓ xl) ± P_aa can move: by
    # the trace's difference and two roundings
    u = torch.finfo(torch.float32).eps / 2
    matvec_tol = _trace_tol(P, Q) + 2 * u * float(got.abs().max())
    assert matvec_err <= matvec_tol, \
        f"schur_matvec n={n}: {matvec_err} from the old route > {matvec_tol}"
    launches = {}
    for name, fn in (("fused", fused), ("composition", composition), ("matvec", matvec),
                     ("matvec_composition", matvec_composition)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches[name] = sum(1 for ev in prof.events() if str(ev.device_type).endswith("CUDA"))
    return dict(n=n, r=r, dtype="fp32", bitwise_equal=True,
                fused_ms=device_ms(fused), composition_ms=device_ms(composition),
                fused_call_ms=eager_ms(fused), composition_call_ms=eager_ms(composition),
                matvec_bitwise_vs_fused_forms=True, matvec_err_vs_old_route=matvec_err,
                matvec_tol=matvec_tol,
                matvec_ms=device_ms(matvec), matvec_composition_ms=device_ms(matvec_composition),
                matvec_call_ms=eager_ms(matvec),
                matvec_composition_call_ms=eager_ms(matvec_composition),
                device_launches=launches)


def _random_graphs(R, n, rng):
    """(R, n, n) bool adjacency of sparse random graphs (about 4 edges per
    node) — the SA's operands — and the BFS start reach = I ∨ adj."""
    upper = np.triu(rng.random((R, n, n)) < 4.0 / n, 1)
    adj = upper | upper.transpose(0, 2, 1)
    reach = adj | np.eye(n, dtype=bool)[None]
    return (torch.from_numpy(reach).cuda().contiguous(),
            torch.from_numpy(adj).cuda().contiguous())


def _hop_step_case(R, n, rng):
    from repro_torch.kernels.hop_bfs import ops

    reach, adj = _random_graphs(R, n, rng)
    for _ in range(3):                                # three hops deep
        got, got_cnt = ops.hop_step(reach, adj)
        want, want_cnt = ops.hop_step_plain(reach, adj)
        assert torch.equal(got, want) and torch.equal(got_cnt, want_cnt), \
            f"hop_step R={R} n={n}: differs from the plain version"
        reach = got
    adj_f = adj.to(torch.float32)
    reach_f = reach.to(torch.float32)
    # reach and adj read once, new and the int32 counts written once; the
    # product is of 0/1 bytes, so its peak is the int8 tensor-core rate
    bytes_s = (3 * R * n * n + 4 * R * n) / HBM_BYTES_PER_S
    ops_s = 2 * R * n ** 3 / INT8_OP_PER_S
    bm, cw = ops.hop_plan(R, n, torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(
        max_abs_err=0.0, tol=0.0, plan=dict(rows_per_block=bm, words_per_block=cw),
        **timings(lambda: ops.hop_step(reach, adj),
                  lambda: ops.hop_step_plain(reach, adj),
                  lambda: torch.bmm(reach_f, adj_f)),
        library_note="torch.bmm of the fp32 0/1 matrices: matmul part only",
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="operations" if ops_s > bytes_s else "bytes")


def phase_kernels() -> dict:
    """Checks at the main path's shapes — n=64 (main_n64) and n=16
    (main_bcube, ragged against every tile) in fp32, the SA's one restart
    per hop — and at n=256, fp64 and R=4, and hop_step from n=5 to n=2,000
    (past the plan that holds all of adj's columns in one block); the fused
    ``edge_laplacian_blocks`` bitwise at n = 5, 16, 64 and 256;
    ``edge_adjoint`` and ``edge_schur_matvec`` timed at n = 16, 64 and 256
    in fp32 and fp64 and checked at n = 5, 16, 64 and 256, homogeneous and
    heterogeneous; ``A_op`` and the CG matvec at n=64 fused against the
    compositions they replaced; returns the n=64 case per kernel."""
    rng = np.random.default_rng(0)
    cases = []
    for n, dtypes in ((16, (torch.float32,)), (64, (torch.float32, torch.float64)),
                      (256, (torch.float32, torch.float64))):
        for dtype in dtypes:
            tag = "fp32" if dtype == torch.float32 else "fp64"
            cases.append(dict(kernel="edge_laplacian", n=n, dtype=tag,
                              **_edge_laplacian_case(n, dtype, rng)))
            cases.append(dict(kernel="edge_quadform", n=n, dtype=tag,
                              **_edge_quadform_case(n, dtype, rng)))
            cases.append(dict(kernel="edge_laplacian_blocks", n=n, dtype=tag,
                              **_edge_laplacian_blocks_case(n, dtype, rng)))
    for R, n in ((1, 5), (1, 16), (1, 64), (4, 64), (4, 256), (1, 2000)):
        cases.append(dict(kernel="hop_step", R=R, n=n, dtype="bool",
                          **_hop_step_case(R, n, rng)))
    for n in (5, 256):
        for dtype in (torch.float32, torch.float64):
            _edge_laplacian_blocks_case(n, dtype, rng)        # bitwise only
    adjoint_checks = []
    for n in (16, 64, 256):
        for dtype in (torch.float32, torch.float64):
            tag = "fp32" if dtype == torch.float32 else "fp64"
            cases.append(dict(kernel="edge_adjoint", n=n, dtype=tag,
                              **_edge_adjoint_case(n, dtype, rng)))
            cases.append(dict(kernel="edge_schur_matvec", n=n, dtype=tag,
                              **_edge_schur_matvec_case(n, dtype, rng)))
    for n in (5, 16, 64, 256):
        for dtype in (torch.float32, torch.float64):
            for hetero in (False, True):
                adjoint_checks.append(dict(
                    n=n, dtype="fp32" if dtype == torch.float32 else "fp64", hetero=hetero,
                    edge_adjoint=_edge_adjoint_case(n, dtype, rng, hetero, timed=False),
                    edge_schur_matvec=_edge_schur_matvec_case(n, dtype, rng, hetero,
                                                              timed=False)))
    a_op = _a_op_case(64, 128)
    torch.cuda.synchronize()
    emit("kernel_checks", cases=cases, a_op=a_op, adjoint_checks=adjoint_checks)
    # the main path's shapes: ADMM in fp32 at n=64, SA one restart at n=64
    main = {}
    for c in cases:
        if c["n"] == 64 and c.get("dtype") in ("fp32", "bool") and c.get("R", 1) == 1:
            main[c["kernel"]] = c
    return main


# ---------------------------------------------------------------------------
# phase 3: the main path on the card
# ---------------------------------------------------------------------------

def phase_solve(label: str, request, cut: str | None = None):
    """Drive one full solve on the card with the default config through the
    anytime handle, which ``solve_topology`` drains the same way; returns
    the result and the kernel launches of that run alone. The best classic
    is the best of the incumbents the classic candidates installed (they
    are polished and offered first)."""
    from repro_torch import kernels
    from repro_torch.core import BATopoConfig, check_invariants
    from repro_torch.core.anytime import AnytimeSolver

    cfg = BATopoConfig()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    solver = AnytimeSolver(request, cfg)
    classic = None
    while (inc := solver.next_improvement()) is not None:
        if inc.quality_tier == "classic":
            classic = inc.r_asym if classic is None else min(classic, inc.r_asym)
    res = solver.result()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    bad = check_invariants(res.topology)
    assert bad is None, f"{label}: release invariant {bad!r} fails"
    assert res.complete, f"{label}: the solve did not complete ({res.reason})"
    assert np.isfinite(res.r_asym) and res.r_asym < 1.0, f"{label}: r_asym {res.r_asym}"
    if classic is not None:
        assert res.r_asym <= classic + 1e-12, \
            f"{label}: r_asym {res.r_asym} worse than the best classic {classic}"
    missing = [k for k in PATH_KERNELS["solve"] if launches[k] == 0]
    assert not missing, f"{label}: kernels never launched on the path: {missing}"
    assert launches["edge_quadform"] == 0, \
        f"{label}: the standalone edge_quadform ran on the ADMM path"
    emit(label, n=request.n, r=request.r, scenario=request.scenario,
         restarts=cfg.restarts if request.restarts is None else request.restarts,
         cut=cut, r_asym=res.r_asym, best_classic_r_asym=classic,
         selected_from=res.topology.meta.get("selected_from"),
         edges=len(res.topology.edges), wall_s=wall_s,
         profile_s=res.profile.phases, launches=launches)
    return res, launches


def phase_main_n64():
    """main_n64 (n=64, r=128, 4 restarts) through :func:`phase_solve`, its
    four restart solves recorded for main_restarts. Returns the result, the
    run's launches and the recorded solves."""
    from repro_torch.core import TopologyRequest

    with _recorded_restarts() as restarts:
        res, launches = phase_solve("main_n64", TopologyRequest(n=64, r=128, restarts=4))
    return res, launches, restarts


def _support(topo) -> list:
    return sorted(tuple(sorted(e)) for e in topo.edges)


def _missing(path: str, launches: dict) -> list:
    return [k for k in PATH_KERNELS[path] if launches[k] == 0]


def phase_main_barrier(res64) -> dict:
    """main_n64's request through the barrier engine
    (``solve_topology(..., engine="barrier")``, default config, not cut):
    the four restarts' SA in one batched call, their ADMM as ONE
    ``solve_batched``, one polish call, the pick. Check: release-valid, every
    solve kernel launched, and the reference's anytime-vs-barrier band
    against main_n64's answer (ref ``tests/test_anytime.py:40``): the same
    support, |Δr_asym| ≤ 1e-3."""
    from repro_torch import kernels
    from repro_torch.core import TopologyRequest, check_invariants, solve_topology

    req = TopologyRequest(n=64, r=128, restarts=4)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_topology(req, engine="barrier")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    same = _support(res.topology) == _support(res64.topology)
    out = dict(n=req.n, r=req.r, restarts=req.restarts, cut=None, wall_s=wall_s,
               profile_s=res.profile.phases, r_asym=res.r_asym,
               selected_from=res.topology.meta.get("selected_from"),
               edges=len(res.topology.edges), launches=launches,
               main_n64=dict(r_asym=res64.r_asym,
                             selected_from=res64.topology.meta.get("selected_from")),
               abs_d_r_asym=abs(res.r_asym - res64.r_asym), same_support=same)
    emit("main_barrier", **out)
    bad = check_invariants(res.topology)
    assert bad is None, f"main_barrier: release invariant {bad!r} fails"
    assert not _missing("barrier", launches), \
        f"main_barrier: kernels never launched: {_missing('barrier', launches)}"
    assert same and out["abs_d_r_asym"] <= 1e-3, \
        f"main_barrier: support equal {same}, |Δr_asym| {out['abs_d_r_asym']}"
    return out


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU
# ---------------------------------------------------------------------------

def _relabel_witness(res, cfg, perms: int = 4) -> dict:
    """What the float64 device polish gives on the CPU for the same support
    with its nodes relabeled: the same convex problem, but LAPACK returns
    other eigenvectors inside a repeated eigenspace, so the subgradient
    path and the final r_asym move. Also the eigenvalues that set r_asym
    at the polished weights, to show the clusters."""
    from repro_torch.core.graph import Topology, laplacian_from_weights
    from repro_torch.core.weights import metropolis_weights, polish_weights_batched

    n, edges = res.topology.n, res.topology.edges
    rng = np.random.default_rng(0)
    relabeled = []
    for _ in range(perms):
        p = rng.permutation(n)
        relabeled.append(sorted(tuple(sorted((int(p[i]), int(p[j])))) for i, j in edges))
    gs = polish_weights_batched(n, relabeled, [metropolis_weights(n, e) for e in relabeled],
                                iters=cfg.polish_iters, dtype="float64", device="cpu")
    vals = [Topology(n, e, g).r_asym() for e, g in zip(relabeled, gs)]
    ev = np.linalg.eigvalsh(laplacian_from_weights(n, edges, res.topology.g))
    return dict(r_asym_relabeled_cpu=vals,
                max_drift_relabeled=max(abs(v - res.r_asym) for v in vals),
                lowest_nonzero_eigs=ev[1:4].tolist(), highest_eigs=ev[-3:].tolist())


def phase_card_vs_cpu() -> None:
    """n=16, r=32 homo with the host SA and a float64 ADMM on the card and
    on the CPU. The ADMM solve alone, from one warm start, must agree within
    1e-7. With the host polish the two must pick the same support and
    agree on r_asym within 1e-7. With the float64 device polish the support
    must agree and r_asym within 5e-4: the polish is a subgradient method
    stepping along one eigenvector of λ_max or λ₂, and near its optimum
    those eigenvalues cluster, so the eigenvector cuSOLVER or LAPACK returns
    in the cluster sets the path. The witness is the CPU alone: the same
    support with its nodes relabeled moves r_asym by as much."""
    from repro_torch.core import (BATopoConfig, HomogeneousADMM, TopologyRequest,
                                  solve_topology)

    def support(res):
        return sorted(tuple(sorted(e)) for e in res.topology.edges)

    g0 = np.random.default_rng(16).random(16 * 15 // 2) * 0.2
    admm = {}
    for device in ("cuda", "cpu"):
        cfg = dataclasses.replace(BATopoConfig().admm, dtype="float64", device=device)
        admm[device] = HomogeneousADMM(16, 32, cfg).solve(g0=g0, lam0=0.5)
    lam_drift = abs(admm["cuda"].lam_tilde - admm["cpu"].lam_tilde)
    g_drift = float(np.abs(admm["cuda"].g - admm["cpu"].g).max())
    admm_out = dict(lam_drift=lam_drift, g_drift=g_drift, iters=admm["cuda"].iters,
                    cg_iters_cuda=admm["cuda"].cg_iters, cg_iters_cpu=admm["cpu"].cg_iters)
    out = {}
    for polish, band in (("host", 1e-7), ("device", 5e-4)):
        runs = {}
        for device in ("cuda", "cpu"):
            cfg = BATopoConfig(warmstart="host", polish=polish, polish_dtype="float64",
                               device=device)
            cfg = dataclasses.replace(cfg, admm=dataclasses.replace(cfg.admm,
                                                                    dtype="float64"))
            t0 = time.perf_counter()
            res = solve_topology(TopologyRequest(n=16, r=32), cfg=cfg)
            runs[device] = (res, time.perf_counter() - t0)
        (gpu, gpu_s), (cpu, cpu_s) = runs["cuda"], runs["cpu"]
        drift = abs(gpu.r_asym - cpu.r_asym)
        out[polish] = dict(r_asym_cuda=gpu.r_asym, r_asym_cpu=cpu.r_asym, drift=drift,
                           band=band, support_equal=support(gpu) == support(cpu),
                           selected_from=gpu.topology.meta.get("selected_from"),
                           wall_s_cuda=gpu_s, wall_s_cpu=cpu_s)
        if polish == "device":
            out[polish]["witness"] = _relabel_witness(cpu, cfg)
    emit("card_vs_cpu", n=16, r=32, scenario="homo", **out, admm=admm_out)
    assert lam_drift <= 1e-7 and g_drift <= 1e-7, \
        f"ADMM card/CPU drift: lam {lam_drift}, g {g_drift}"
    for polish, o in out.items():
        assert o["support_equal"], f"polish={polish}: supports differ"
        assert o["drift"] <= o["band"], \
            f"polish={polish}: r_asym drift {o['drift']} > {o['band']}"


# ---------------------------------------------------------------------------
# phase 5: evaluation of the n=64 result (§VI-A consensus)
# ---------------------------------------------------------------------------

def phase_consensus(topo) -> None:
    from repro_torch.core.consensus import simulate_consensus_batched, time_to_error
    from repro_torch.core.topologies import make_baseline

    n = topo.n
    topos = [topo, make_baseline("ring", n), make_baseline("torus", n)]
    traces = simulate_consensus_batched(topos, iters=400, device="cuda")
    rows = []
    for t, tr in zip(topos, traces):
        assert np.all(np.isfinite(tr.errors)), f"{t.name}: non-finite consensus error"
        rows.append(dict(topology=t.name, r_asym=t.r_asym(),
                         iters_to_1e_4=time_to_error(tr, 1e-4),
                         final_rel_error=float(tr.errors[-1] / tr.errors[0])))
    ours, ring = rows[0], rows[1]
    assert ours["iters_to_1e_4"] <= ring["iters_to_1e_4"], \
        "the solved topology reaches consensus slower than a ring"
    emit("consensus", n=n, iters=400, rows=rows)


# ---------------------------------------------------------------------------
# phase 6: where the time goes (torch.profiler over short stage windows)
# ---------------------------------------------------------------------------

def _profiled(fn, match: tuple = ()) -> dict:
    """Wall time, device busy time, idle share, kernel launches and host
    syncs of one call of ``fn``, with the top kernels by device time, and
    the device time and launches of the kernels whose name holds one of
    ``match``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels, syncs, busy_us = {}, 0, 0.0
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            dev_us = ev.time_range.elapsed_us()
            busy_us += dev_us
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += dev_us
        elif ev.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaEventSynchronize"):
            syncs += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    if not kernels:             # the profiler saw no device activity: say so
        return dict(wall_s=wall_s, device_busy_s=None, idle_share=None,
                    device_launches=None, host_syncs=syncs, top_kernels=None)
    matched = {m: [sum(c for k, (c, _) in kernels.items() if m in k),
                   sum(t for k, (_, t) in kernels.items() if m in k) / 1e3] for m in match}
    return dict(wall_s=wall_s, device_busy_s=busy_us / 1e6,
                idle_share=1.0 - busy_us / 1e6 / wall_s,
                device_launches=sum(c for c, _ in kernels.values()), host_syncs=syncs,
                top_kernels=[dict(name=name[:80], launches=c, device_ms=t / 1e3)
                             for name, (c, t) in top],
                matched={m: dict(launches=c, device_ms=t,
                                 share_of_busy=t / (busy_us / 1e3)) for m, (c, t) in matched.items()})


def phase_profile() -> None:
    """Short windows of the n=64 main path's three device stages, each run
    once unprofiled to warm up: 20 ADMM steps (pipeline stack; the
    ``edge_schur_matvec`` launches count its CG matvecs, the
    ``edge_laplacian_blocks`` and ``edge_adjoint`` launches its right-hand
    sides and last adjoints; no ``edge_quadform`` may launch there), 50 SA
    moves, 50 polish iterations (short for the run's time limit)."""
    from repro_torch.core import BATopoConfig, HomogeneousADMM
    from repro_torch.core.anneal import greedy_degree_graph
    from repro_torch.core.api import _pack_warm
    from repro_torch.core.warmstart import anneal_topology_batched
    from repro_torch.core.weights import metropolis_weights, polish_weights_batched

    n, r = 64, 128
    edges = greedy_degree_graph(n, np.full(n, 4), np.random.default_rng(0))
    g0, _, lam0 = _pack_warm(n, edges)
    cfg = BATopoConfig()
    admm_cfg = dataclasses.replace(cfg.admm, max_iters=20, device="cuda")
    solver = HomogeneousADMM(n, r, admm_cfg)
    stages = {
        "admm_20_steps": lambda: solver.solve(g0=g0, lam0=lam0),
        "sa_50_moves": lambda: anneal_topology_batched(n, [edges], None, iters=50,
                                                       seeds=[0]),
        "polish_50_iters": lambda: polish_weights_batched(
            n, [edges], [metropolis_weights(n, edges)], iters=50),
    }
    admm_kernels = ("edge_schur_matvec", "edge_adjoint", "edge_laplacian_blocks",
                    "edge_quadform")
    out = {}
    for name, fn in stages.items():
        fn()
        out[name] = _profiled(fn, match=admm_kernels if name.startswith("admm") else ())
    emit("profile", n=n, r=r, stages=out)
    matched = out["admm_20_steps"].get("matched")
    assert matched is not None, "the profiler saw no device activity in the ADMM steps"
    assert matched["edge_schur_matvec"]["launches"] > 0 and \
        matched["edge_quadform"]["launches"] == 0, f"ADMM steps' kernels: {matched}"


# ---------------------------------------------------------------------------
# phase 6b: the batched ADMM — restarts and budgets as one solve
# ---------------------------------------------------------------------------

def _bits(dtype):
    return torch.int64 if dtype == torch.float64 else torch.int32


def _batched_operands(B, n, dtype, rng):
    """Operands of the four batched forms as the batched ADMM lays them out:
    λ's P, Q, w, v blocks views of one (B, K) constraint-space matrix, the
    edge weights g and λ̃ columns of the (B, m + 1) x block."""
    m = n * (n - 1) // 2
    K = 2 * n * n + n + 3 + m
    flat = torch.from_numpy(rng.standard_normal((B, K))).to(device="cuda", dtype=dtype)
    P = flat[:, :n * n].view(B, n, n)
    Q = flat[:, n * n:2 * n * n].view(B, n, n)
    w = flat[:, 2 * n * n:2 * n * n + n]
    v = flat[:, K - m:]
    x = torch.from_numpy(rng.random((B, m + 1))).to(device="cuda", dtype=dtype)
    return P, Q, w, v, x[:, :-1], x[:, -1]


def _batched_against_plain(n, L, blocks, x, out, g, lam, P, Q, w, v) -> dict:
    """The batched forms' outputs against the batched plain versions on the
    same (B, …) tensors, per instance, with the tolerances of
    ``test_batched_edge_forms_on_card``: L(g) within 1e-12 (fp64) or 1e-5 ×
    the largest degree; the blocks (S = P, T = Q, y = w) within L's error
    plus 4u·(max L_aa + |λ| + max|P, Q, w|), since only the degree's order
    of summing differs and two roundings follow; the adjoint's edge entries
    bitwise and its trace within 2n·u·(Σ|P_ii| + Σ|Q_ii|); the matvec
    within 2n·u·(max row Σ|xg|) + the trace's tolerance + 2u·max|out|.
    Returns each form's largest error over the batch."""
    from repro_torch.kernels.edge_laplacian import ops

    B, dtype = g.shape[0], g.dtype
    m, k = n * (n - 1) // 2, 2 * n * n + n
    u = torch.finfo(dtype).eps / 2
    lidx = ops.packed_edge_index(n, "cuda")
    Lp = ops.edge_laplacian_plain(g, lidx)
    bp = ops.edge_laplacian_blocks_plain(g, lam, P, Q, w,
                                         torch.empty(B, k, dtype=dtype, device="cuda"))
    xp = ops.edge_adjoint_plain(P, Q, w, v)
    mp = ops.edge_schur_matvec_plain(P, Q, w, torch.empty(B, k, dtype=dtype, device="cuda"), v)
    deg = Lp.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
    e_L = (L - Lp).abs().amax((-2, -1))
    tol_L = torch.full_like(deg, 1e-12) if dtype == torch.float64 else 1e-5 * deg
    operand = torch.stack([P.abs().amax((-2, -1)), Q.abs().amax((-2, -1)),
                           w.abs().amax(-1)]).amax(0)
    e_B = (blocks - bp).abs().amax(-1)
    tol_B = e_L + 4 * u * (deg + lam.abs() + operand)
    e_T = (x[:, m] - xp[:, m]).abs()
    tol_T = 2 * n * u * (P.diagonal(dim1=-2, dim2=-1).abs().sum(-1)
                         + Q.diagonal(dim1=-2, dim2=-1).abs().sum(-1))
    G = torch.cat([x[:, :m].abs(), x.new_zeros(B, 1)], dim=-1)[:, lidx]
    e_M = (out - mp).abs().amax(-1)
    tol_M = 2 * n * u * G.sum(-1).amax(-1) + tol_T + 2 * u * mp.abs().amax(-1)
    case = f"B={B} n={n} {dtype} hetero={v is not None}"
    assert torch.equal(x[:, :m].view(_bits(dtype)), xp[:, :m].view(_bits(dtype))), \
        f"batched edge_adjoint {case}: edge entries differ from the plain version"
    for name, err, tol in (("edge_laplacian", e_L, tol_L), ("edge_laplacian_blocks", e_B, tol_B),
                           ("edge_adjoint", e_T, tol_T), ("edge_schur_matvec", e_M, tol_M)):
        assert bool((err <= tol).all()), \
            f"batched {name} {case}: errors {err.tolist()} against the plain version " \
            f"over tolerances {tol.tolist()}"
    return {"edge_laplacian": float(e_L.max()), "edge_laplacian_blocks": float(e_B.max()),
            "edge_adjoint": float(e_T.max()), "edge_schur_matvec": float(e_M.max())}


def _batched_case(B, n, dtype, rng, hetero) -> dict:
    """Each batched form against its unbatched launch on every instance,
    bitwise (the instance's operands copied out contiguous), and against its
    batched plain version on the same tensors (:func:`_batched_against_plain`),
    each form launched once for the batch."""
    from repro_torch.kernels.edge_laplacian import ops

    P, Q, w, v, g, lam = _batched_operands(B, n, dtype, rng)
    v = v if hetero else None
    m, k = n * (n - 1) // 2, 2 * n * n + n
    before = {f: getattr(ops, f).launches for f in BATCHED_FORMS}
    L = ops.edge_laplacian(g, n)
    blocks = ops.edge_laplacian_blocks(g, lam, P, Q, w, torch.empty(B, k, dtype=dtype,
                                                                   device="cuda"))
    x = ops.edge_adjoint(P, Q, w, v)
    out = torch.full((B, k + 2), 7.0, dtype=dtype, device="cuda")
    x_adj = torch.empty(B, m + 1, dtype=dtype, device="cuda")
    ops.edge_schur_matvec(P, Q, w, out, v=v, x_adj=x_adj)
    assert all(getattr(ops, f).launches == before[f] + 1 for f in BATCHED_FORMS), \
        f"batched forms B={B} n={n}: not one launch each"
    bits = _bits(dtype)
    for b in range(B):
        Pb, Qb, wb = P[b].contiguous(), Q[b].contiguous(), w[b].contiguous()
        vb = None if v is None else v[b].contiguous()
        ob = torch.empty(k, dtype=dtype, device="cuda")
        xb = torch.empty(m + 1, dtype=dtype, device="cuda")
        ops.edge_schur_matvec(Pb, Qb, wb, ob, v=vb, x_adj=xb)
        same = (torch.equal(L[b].view(bits), ops.edge_laplacian(g[b].contiguous(), n).view(bits))
                and torch.equal(blocks[b].view(bits), ops.edge_laplacian_blocks(
                    g[b].contiguous(), lam[b].contiguous(), Pb, Qb, wb,
                    torch.empty(k, dtype=dtype, device="cuda")).view(bits))
                and torch.equal(x[b].view(bits), ops.edge_adjoint(Pb, Qb, wb, vb).view(bits))
                and torch.equal(out[b, :k].view(bits), ob.view(bits))
                and torch.equal(x_adj[b].view(bits), xb.view(bits))
                and bool((out[b, k:] == 7.0).all()))
        assert same, f"batched forms B={B} n={n} {dtype} hetero={hetero}: instance {b} " \
            "differs from its unbatched launch"
    errs = _batched_against_plain(n, L, blocks, x, out[:, :k], g, lam, P, Q, w, v)
    return dict(B=B, n=n, dtype="fp32" if dtype == torch.float32 else "fp64", hetero=hetero,
                bitwise_vs_unbatched=True, max_abs_err_vs_plain=errs)


BATCHED_FORMS = ("edge_laplacian", "edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec")


def phase_batched_kernels() -> dict:
    """The four ADMM-path forms with the batch axis: bitwise per instance
    against their unbatched launches at n = 16, 64, 256, B = 1, 4, 8,
    fp32/fp64, homogeneous and heterogeneous, and against their plain
    versions on the same tensors; each timed at B = 4, n = 64, fp32 (the
    batched solve's shape) in a CUDA graph and eagerly, beside its plain
    version, with its error against the plain version on the timed inputs.
    Bound: each operand read once and each output written once, B times the
    unbatched bytes."""
    from repro_torch.kernels.edge_laplacian import ops

    rng = np.random.default_rng(19)
    checks = [_batched_case(B, n, dtype, rng, hetero)
              for n in (16, 64, 256) for B in (1, 4, 8)
              for dtype in (torch.float32, torch.float64) for hetero in (False, True)]
    B, n, dtype = 4, 64, torch.float32
    P, Q, w, _, g, lam = _batched_operands(B, n, dtype, rng)
    m, k, size = n * (n - 1) // 2, 2 * n * n + n, 4
    outs = [torch.empty(B, k, dtype=dtype, device="cuda") for _ in range(4)]
    lidx = ops.packed_edge_index(n, "cuda")
    x_adj = torch.empty(B, m + 1, dtype=dtype, device="cuda")
    errs = _batched_against_plain(
        n, ops.edge_laplacian(g, n), ops.edge_laplacian_blocks(g, lam, P, Q, w, outs[0]),
        ops.edge_adjoint(P, Q, w), ops.edge_schur_matvec(P, Q, w, outs[2], x_adj=x_adj),
        g, lam, P, Q, w, None)
    calls = {
        "edge_laplacian": (lambda: ops.edge_laplacian(g, n),
                           lambda: ops.edge_laplacian_plain(g, lidx), m + n * n),
        "edge_laplacian_blocks": (
            lambda: ops.edge_laplacian_blocks(g, lam, P, Q, w, outs[0]),
            lambda: ops.edge_laplacian_blocks_plain(g, lam, P, Q, w, outs[1]),
            m + 1 + 4 * n * n + 2 * n),
        "edge_adjoint": (lambda: ops.edge_adjoint(P, Q, w),
                         lambda: ops.edge_adjoint_plain(P, Q, w), 2 * n * n + n + m + 1),
        "edge_schur_matvec": (lambda: ops.edge_schur_matvec(P, Q, w, outs[2]),
                              lambda: ops.edge_schur_matvec_plain(P, Q, w, outs[3]),
                              4 * n * n + 2 * n),
    }
    timing = {name: dict(B=B, n=n, dtype="fp32", max_abs_err=errs[name],
                         **timings(kernel, plain),
                         bound_ms=1e3 * size * B * elems / HBM_BYTES_PER_S, bound_by="bytes")
              for name, (kernel, plain, elems) in calls.items()}
    torch.cuda.synchronize()
    emit("batched_kernel_checks", checks=len(checks), cases=checks, timing=timing)
    return timing


@contextlib.contextmanager
def _recorded_restarts():
    """For the block, every ``HomogeneousADMM.solve`` call (the anytime
    engine's restarts, one at a time) is recorded with its solver, warm
    start, result, wall (the card synchronized on both sides) and edge-form
    launches, in the yielded list."""
    from repro_torch import kernels
    from repro_torch.core.admm import HomogeneousADMM

    calls = []
    orig = HomogeneousADMM.solve

    def solve(self, g0=None, lam0=0.5):
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        res = orig(self, g0=g0, lam0=lam0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = kernels.launch_counts()
        calls.append(dict(solver=self, g0=np.asarray(g0), lam0=float(lam0), result=res,
                          wall_s=wall, launches={f: after[f] - before[f] for f in BATCHED_FORMS}))
        return res

    HomogeneousADMM.solve = solve
    try:
        yield calls
    finally:
        HomogeneousADMM.solve = orig


def _timed_solves(fn):
    """Wall, edge-form launches and results of ``fn()``, on counts from 0."""
    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    return out, wall, {f: counts[f] for f in BATCHED_FORMS}


def _compare_restarts(batched, seq) -> list:
    rows = []
    for a, b in zip(batched, seq):
        sa, sb = set(np.nonzero(a.g > 1e-6)[0].tolist()), set(np.nonzero(b.g > 1e-6)[0].tolist())
        rows.append(dict(lam_batched=a.lam_tilde, lam_sequential=b.lam_tilde,
                         lam_drift=abs(a.lam_tilde - b.lam_tilde), support_equal=sa == sb,
                         support_overlap=len(sa & sb) / max(len(sa | sb), 1),
                         iters=[a.iters, b.iters], cg_iters=[a.cg_iters, b.cg_iters]))
    return rows


#: Steps in main_restarts' profiled windows: reading the profiler's events
#: of 4 × 60 sequential and 60 batched steps took about a minute.
RESTART_PROFILE_STEPS = 20


def phase_main_restarts(restarts: list) -> dict:
    """main_n64's ADMM over its 4 annealed warm starts (n=64, r=128, the
    pipeline's default stack, 600 iterations) as one ``solve_batched``,
    against the 4 sequential ``solve`` calls that main_n64 made from the
    same warm starts earlier in this process (``restarts``, from
    :func:`_recorded_restarts`; reused rather than run again, as is their
    SA). Wall (host clock, ending in the host reads), launches of each edge
    form and, over a profiled window of ``RESTART_PROFILE_STEPS`` batched
    steps, host syncs and device launches (no sequential window: the
    run's time limit). The restarts are fp32 and start
    from tied Metropolis weights, so batched and sequential are compared
    (λ̃ drift, support overlap) and not held equal; main_restarts_f64
    holds them."""
    from repro_torch.core import HomogeneousADMM

    solver, R = restarts[0]["solver"], len(restarts)
    n, r = solver.n, solver.r
    assert R == 4 and all(c["solver"] is solver for c in restarts), \
        f"main_restarts: main_n64 made {R} restart solves"
    g0s = np.stack([c["g0"] for c in restarts])
    lam0s = np.array([c["lam0"] for c in restarts])
    batched, wall_b, launches_b = _timed_solves(lambda: solver.solve_batched(g0s, lam0s))
    seq = [c["result"] for c in restarts]
    wall_s = sum(c["wall_s"] for c in restarts)
    launches_s = {f: sum(c["launches"][f] for c in restarts) for f in BATCHED_FORMS}
    short = HomogeneousADMM(n, r, dataclasses.replace(solver.cfg,
                                                      max_iters=RESTART_PROFILE_STEPS))
    prof_b = _profiled(lambda: short.solve_batched(g0s, lam0s), match=BATCHED_FORMS)
    rows = _compare_restarts(batched, seq)
    out = dict(n=n, r=r, restarts=R, max_iters=solver.cfg.max_iters, dtype=solver.cfg.dtype,
               sequential_from="main_n64",
               wall_s=dict(batched=wall_b, sequential=wall_s),
               launches=dict(batched=launches_b, sequential=launches_s),
               profile_steps=RESTART_PROFILE_STEPS,
               profile=dict(batched=prof_b), restarts_rows=rows)
    emit("main_restarts", **out)
    assert all(np.isfinite(row["lam_batched"]) for row in rows)
    assert launches_b["edge_laplacian"] == 1 and launches_s["edge_laplacian"] == R, \
        f"main_restarts: init_state launches {launches_b} / {launches_s}"
    return dict(out, batched=batched, g0s=g0s, lam0s=lam0s, cfg=solver.cfg)


def phase_main_restarts_f64() -> dict:
    """The card-vs-CPU configuration (homogeneous n=16, r=32, the pipeline
    stack in float64) from 4 random warm starts (card_vs_cpu's kind, tie
    free), batched against sequential on the card at the configuration's
    own iteration count: the same support and λ̃ within 1e-6 per restart."""
    from repro_torch.core import BATopoConfig, HomogeneousADMM

    n, r, R = 16, 32, 4
    rng = np.random.default_rng(16)
    g0s = rng.random((R, n * (n - 1) // 2)) * 0.2
    lam0s = np.array([0.5, 0.4, 0.6, 0.3])
    solver = HomogeneousADMM(n, r, dataclasses.replace(BATopoConfig().admm, dtype="float64",
                                                       device="cuda"))
    batched, wall_b, launches_b = _timed_solves(lambda: solver.solve_batched(g0s, lam0s))
    seq, wall_s, launches_s = _timed_solves(
        lambda: [solver.solve(g0=g0, lam0=lam0) for g0, lam0 in zip(g0s, lam0s)])
    rows = _compare_restarts(batched, seq)
    emit("main_restarts_f64", n=n, r=r, restarts=R, dtype="float64",
         wall_s=dict(batched=wall_b, sequential=wall_s),
         launches=dict(batched=launches_b, sequential=launches_s), restarts_rows=rows)
    for k, row in enumerate(rows):
        assert row["support_equal"] and row["lam_drift"] <= 1e-6, \
            f"main_restarts_f64 restart {k}: batched differs from sequential: {row}"
        assert row["iters"][0] == row["iters"][1], f"restart {k}: iterations {row['iters']}"
    return rows


# ---------------------------------------------------------------------------
# the sharded ADMM (core/shard.py) on torch.distributed: two ranks on the card
# ---------------------------------------------------------------------------

#: bench_scalability.py's partition compare (run_partition_compare): n = 1024,
#: r = 2n, the greedy balanced-degree warm start with Metropolis weights
#: (seed 0), the fp32 inexact-CG Newton–Schulz stack at 20 iterations, eps 0
SHARD_N, SHARD_R, SHARD_SEED = 1024, 2048, 0
SHARD_WORLD = 2
SHARD_ADMM = dict(dtype="float32", cg_inexact=True, psd_backend="newton_schulz", psd_iters=16,
                  max_iters=20, check_every=10, eps=0.0)
SHARD_F64 = dict(SHARD_ADMM, dtype="float64", max_iters=5)
#: float64 sharded against unsharded λ̃ (the reassociation of the cross-rank sums)
SHARD_F64_TOL = 1e-9
#: float32 sharded against unsharded: each inexact X-step is solved to a
#: relative CG tolerance of at most INEXACT_CAP = 1e-3, and a CG stop moved
#: by one iteration by the reassociation moves the iterate by up to that, so
#: |Δλ̃| ≤ 1e-3; the rounded candidates' r_asym within 0.01 (a few of the
#: 2,048 edges flipping at the top-r threshold; PERF.md §4)
SHARD_LAM_BOUND = 1e-3
SHARD_RASYM_BOUND = 1e-2
SHARD_TIMEOUT_S = 300
SHARD_DIR = ROOT / "build" / "chip_smoke" / "main_sharded"


def _shard_rank(rank: int, world: int, init: str, jobs, out_dir: str) -> None:
    """One rank of main_sharded, in a process of its own (the spawn start
    method; the port puts every rank on ``cuda:<rank % device_count>``, so
    both share the one card, over gloo). Solves main_sharded's problem
    edge-partitioned in float32 and in float64 and main_n64's restarts
    instance-partitioned; writes its results, launches and per-step CG
    counts to ``out_dir``."""
    import datetime
    import pickle

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    from repro_torch import kernels
    from repro_torch.core import engine as te
    from repro_torch.core import shard
    from repro_torch.device import resolve_device

    job = jobs[rank].get()
    out = {"device": str(resolve_device("cuda"))}
    orig = shard.pcg_solve
    for label, kw in (("float32", SHARD_ADMM), ("float64", SHARD_F64)):
        cfg = te.ADMMConfig(**kw)
        spec = te.make_homo_spec(SHARD_N, SHARD_R, cfg)
        # only rank 0 holds the warm start: the entry broadcast hands it over
        g0 = job["g0"] if rank == 0 else np.zeros(spec.m)
        st = te.init_state(spec, g0, job["lam0"])
        shard.solve_spec_sharded(spec, st, dataclasses.replace(cfg, max_iters=2))  # warm-up
        ks = []

        def spy(*a, **kw):
            X, lam, k = orig(*a, **kw)
            ks.append(k)
            return X, lam, k

        shard.pcg_solve = spy
        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = shard.solve_spec_sharded(spec, st, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shard.pcg_solve = orig
        out[label] = dict(result=res, wall_s=wall, launches=kernels.launch_counts(),
                          cg_steps=[int(k) for k in ks])
    out["collectives_ms"] = _collective_ms(world)
    cfg = job["restart_cfg"]
    spec = te.make_homo_spec(64, 128, cfg)
    states = te.init_state(spec, job["g0s"], job["lam0s"])
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    results = shard.solve_batched_spec_sharded(spec, states, cfg)
    torch.cuda.synchronize()
    out["instances"] = dict(results=results, wall_s=time.perf_counter() - t0)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _collective_ms(world: int, reps: int = 20) -> dict:
    """Mean time of the edge path's two large collectives on this group, at
    main_sharded's float32 shapes, host clock around a synchronized loop:
    the all-reduce of the (n, n) window Laplacian (one a CG matvec) and the
    all-gather of both Newton–Schulz row blocks (one a sign iteration)."""
    import torch.distributed as dist

    rows = -(-SHARD_N // world)
    cases = {"all_reduce_L": torch.ones(SHARD_N, SHARD_N, device="cuda"),
             "all_gather_ns": torch.ones(2 * rows * SHARD_N, device="cuda")}
    out = {}
    for name, t in cases.items():
        buf = t.new_empty(world * t.numel()) if name == "all_gather_ns" else None

        def call():
            if buf is None:
                dist.all_reduce(t)
            else:
                dist.all_gather_into_tensor(buf, t)

        call()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def _candidate_r_asym(n: int, res, r: int) -> float:
    """bench_scalability's ``_candidate_r_asym``: the top-r support of g +
    g_raw, Metropolis weights, the spectral gap (no polish)."""
    from repro_torch.core.api import extract_support
    from repro_torch.core.graph import Topology, all_edges, is_connected
    from repro_torch.core.weights import metropolis_weights

    sel = extract_support(n, np.asarray(res.g) + np.asarray(res.g_raw), r, tol=1e-6)
    edges_full = all_edges(n)
    edges = [edges_full[k] for k in np.nonzero(sel)[0]]
    if not edges or not is_connected(n, edges):
        return 1.0
    return float(Topology(n, edges, metropolis_weights(n, edges)).r_asym())


def _shard_launches(cg_steps: list, iters: int) -> int:
    """The windowed ``edge_laplacian`` (and ``edge_adjoint``) launches a
    sharded solve makes: per ADMM step, A of the right-hand side and A·Aᵀ
    of the start (two), then one A·Aᵀ per CG loop pass; the loop runs until
    the first multiple of CG_CHECK_EVERY at or after its count k."""
    from repro_torch.core.linalg import CG_CHECK_EVERY

    assert len(cg_steps) == iters, (len(cg_steps), iters)
    return sum(2 + CG_CHECK_EVERY * -(-k // CG_CHECK_EVERY) for k in cg_steps)


def _window_cases(n: int, dtype) -> dict:
    """The windowed forms at main_sharded's shape against their plain
    versions, for each rank's window: ``edge_laplacian``'s within L's
    tolerance, ``edge_adjoint``'s entries bitwise the plain form's and the
    trace entry within :func:`_trace_tol`; timed on rank 0's window.
    Bounds: the window's g read and L written (n² + count); P and Q at
    (i, j) and (j, i) of each edge, both diagonals, w, and the count + 1
    outputs."""
    from repro_torch.kernels.edge_laplacian import ops

    rng = np.random.default_rng(n)
    m = n * (n - 1) // 2
    m_loc = -(-m // SHARD_WORLD)
    g = torch.from_numpy(rng.random(m)).to(device="cuda", dtype=dtype)
    P, Q, w, _ = _adjoint_operands(n, dtype, rng)
    lidx = ops.packed_edge_index(n, "cuda")
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    lap, adj = [], []
    for rank in range(SHARD_WORLD):
        first, count = rank * m_loc, min(m_loc, m - rank * m_loc)
        gw = g[first:first + count]
        L = ops.edge_laplacian(gw, n, first)
        want = ops.edge_laplacian_window_plain(gw, lidx, first)
        err = float((L - want).abs().max())
        tol = 1e-12 if dtype == torch.float64 else 1e-5 * float(want.diagonal().abs().max())
        assert err <= tol, f"edge_laplacian window {rank}: err {err} > {tol}"
        x = ops.edge_adjoint(P, Q, w, None, first, count)
        xp = ops.edge_adjoint_plain(P, Q, w, None, first, count)
        assert torch.equal(x[:count].view(bits), xp[:count].view(bits)), \
            f"edge_adjoint window {rank}: edge entries not bitwise the plain form's"
        terr, ttol = abs(float(x[count] - xp[count])), _trace_tol(P, Q)
        assert terr <= ttol, f"edge_adjoint window {rank}: trace err {terr} > {ttol}"
        lap.append(dict(first=first, count=count, err=err, tol=tol))
        adj.append(dict(first=first, count=count, trace_err=terr, tol=ttol))
    size = g.element_size()
    first, count = 0, m_loc
    gw = g[:count]
    return {
        "edge_laplacian_window": dict(
            n=n, windows=lap, max_abs_err=max(c["err"] for c in lap),
            **timings(lambda: ops.edge_laplacian(gw, n, first),
                      lambda: ops.edge_laplacian_window_plain(gw, lidx, first)),
            bound_ms=1e3 * size * (count + n * n) / HBM_BYTES_PER_S, bound_by="bytes"),
        "edge_adjoint_window": dict(
            n=n, windows=adj, max_abs_err=max(c["trace_err"] for c in adj),
            **timings(lambda: ops.edge_adjoint(P, Q, w, None, first, count),
                      lambda: ops.edge_adjoint_plain(P, Q, w, None, first, count)),
            bound_ms=1e3 * size * (5 * count + 3 * n + 1) / HBM_BYTES_PER_S,
            bound_by="bytes")}


def _greedy_warm_start(n: int, r: int):
    """bench_scalability's ``_partition_warm_start``: (g0, z0, λ̃0) of the
    greedy balanced-degree graph with Metropolis weights, seed SHARD_SEED."""
    from repro_torch.core.anneal import greedy_degree_graph
    from repro_torch.core.api import _homo_degree_targets, _pack_warm

    edges0 = greedy_degree_graph(n, _homo_degree_targets(n, r),
                                 np.random.default_rng(SHARD_SEED), None)
    return _pack_warm(n, edges0)


def _nccl_one_rank() -> dict:
    """The edge path once through a process group of one rank on NCCL (every
    collective runs, with nothing to exchange), n = 64, float64, eigh, exact
    CG, against ``solve_spec``: one window is the whole list and its kernels
    are the full launches, so g, λ̃ and the counts are the same bits."""
    import torch.distributed as dist

    from repro_torch.core import engine as te
    from repro_torch.core import shard

    init = SHARD_DIR / "nccl_rendezvous"
    init.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        cfg = te.ADMMConfig(dtype="float64", max_iters=20, check_every=10)
        spec = te.make_homo_spec(64, 128, cfg)
        g0, _, lam0 = _greedy_warm_start(64, 128)
        st = te.init_state(spec, g0, lam0)
        want = te.solve_spec(spec, st, cfg)
        got = shard.solve_spec_sharded(spec, st, cfg)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    row = dict(backend="nccl", world=1, n=64, lam_sharded=got.lam_tilde, lam=want.lam_tilde,
               g_bitwise=got.g.tobytes() == want.g.tobytes(),
               iters=[got.iters, want.iters], cg_iters=[got.cg_iters, want.cg_iters])
    assert row["g_bitwise"] and got.lam_tilde == want.lam_tilde, f"main_sharded NCCL: {row}"
    assert got.iters == want.iters and got.cg_iters == want.cg_iters, f"main_sharded NCCL: {row}"
    return row


def phase_main_sharded(restarts: list, main_restarts: dict) -> dict:
    """The sharded ADMM on the card. bench_scalability's partition compare
    (n = 1024, r = 2048, m = 523,776) edge-partitioned over two gloo ranks
    spawned on the one card, against the unsharded ``solve_spec`` of the same
    spec in this process: ms per iteration of both, |Δλ̃| and the rounded
    candidates' r_asym drift within the stated float32 bounds, each rank's
    windowed ``edge_laplacian``/``edge_adjoint`` launches pinned exactly to
    its CG counts (and no other edge form), the two ranks' results the same
    bits; the same in float64 at 5 iterations, λ̃ within SHARD_F64_TOL.
    main_n64's four restarts instance-partitioned over the two ranks against
    main_restarts' batched solve (``tests/test_torch_batched.py``'s
    tolerances); the edge path through a one-rank NCCL group; the windowed
    forms at this shape against their plain versions, timed."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    from repro_torch.core import engine as te

    t_phase = time.perf_counter()
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    spawn = mp.get_context("spawn")
    jobs = [spawn.SimpleQueue() for _ in range(SHARD_WORLD)]
    ranks = mp.start_processes(_shard_rank, nprocs=SHARD_WORLD, join=False, start_method="spawn",
                               args=(SHARD_WORLD, f"file://{SHARD_DIR / 'rendezvous'}", jobs,
                                     str(SHARD_DIR)))
    try:
        # the ranks start while this process builds the warm start
        n, r = SHARD_N, SHARD_R
        t0 = time.perf_counter()
        g0, _, lam0 = _greedy_warm_start(n, r)
        warm_s = time.perf_counter() - t0
        unsharded = {}
        for label, kw in (("float32", SHARD_ADMM), ("float64", SHARD_F64)):
            cfg = te.ADMMConfig(**kw)
            spec = te.make_homo_spec(n, r, cfg)
            st = te.init_state(spec, g0, lam0)
            te.solve_spec(spec, st, dataclasses.replace(cfg, max_iters=2))        # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = te.solve_spec(spec, st, cfg)
            torch.cuda.synchronize()
            unsharded[label] = dict(result=res, wall_s=time.perf_counter() - t0)
            del spec, st
        for rank in range(SHARD_WORLD):
            jobs[rank].put(dict(g0=g0 if rank == 0 else None, lam0=lam0,
                                restart_cfg=main_restarts["cfg"], g0s=main_restarts["g0s"],
                                lam0s=main_restarts["lam0s"]))
        r_asym = {"unsharded": _candidate_r_asym(n, unsharded["float32"]["result"], r)}
        while not ranks.join(timeout=1.0):
            pass
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    outs = [pickle.loads((SHARD_DIR / f"rank{k}.pkl").read_bytes()) for k in range(SHARD_WORLD)]
    sharded = {label: outs[0][label] for label in ("float32", "float64")}
    r_asym["sharded"] = _candidate_r_asym(n, sharded["float32"]["result"], r)
    rows = {}
    for label in ("float32", "float64"):
        a, b = sharded[label]["result"], unsharded[label]["result"]
        for k in range(1, SHARD_WORLD):
            o = outs[k][label]["result"]
            assert o.g.tobytes() == a.g.tobytes() and o.lam_tilde == a.lam_tilde \
                and o.cg_iters == a.cg_iters, f"main_sharded {label}: rank {k} differs from rank 0"
        pins = []
        for k in range(SHARD_WORLD):
            counts, steps = outs[k][label]["launches"], outs[k][label]["cg_steps"]
            want = _shard_launches(steps, a.iters)
            assert counts["edge_laplacian"] == counts["edge_adjoint"] == want, \
                f"main_sharded {label} rank {k}: launches {counts}, {want} expected"
            assert sum(steps) == a.cg_iters, (label, k, sum(steps), a.cg_iters)
            others = {f: counts[f] for f in ("edge_laplacian_blocks", "edge_schur_matvec",
                                             "edge_quadform")}
            assert not any(others.values()), f"main_sharded {label} rank {k}: {others}"
            pins.append(dict(rank=k, edge_laplacian=counts["edge_laplacian"],
                             edge_adjoint=counts["edge_adjoint"], expected=want))
        coll = outs[0]["collectives_ms"]
        passes = pins[0]["edge_laplacian"] - 2 * a.iters    # CG loop passes
        per_iter = (2 + passes / a.iters) * coll["all_reduce_L"] + \
            (SHARD_ADMM["psd_iters"] + 1) * coll["all_gather_ns"]
        rows[label] = dict(
            iters=[a.iters, b.iters], cg_iters=[a.cg_iters, b.cg_iters],
            collective_ms_per_iter_est=per_iter if label == "float32" else None,
            lam_sharded=a.lam_tilde, lam_unsharded=b.lam_tilde,
            abs_d_lam=abs(a.lam_tilde - b.lam_tilde),
            ms_per_iter=dict(sharded=1e3 * sharded[label]["wall_s"] / a.iters,
                             unsharded=1e3 * unsharded[label]["wall_s"] / b.iters),
            launches=pins)
    inst = outs[0]["instances"]
    inst_rows = []
    for k, (got, want) in enumerate(zip(inst["results"], main_restarts["batched"])):
        sa = tuple(np.nonzero(got.g > 1e-6)[0].tolist())
        sb = tuple(np.nonzero(want.g > 1e-6)[0].tolist())
        inst_rows.append(dict(restart=k, support_equal=sa == sb,
                              abs_d_lam=abs(got.lam_tilde - want.lam_tilde),
                              iters=[got.iters, want.iters], cg_iters=[got.cg_iters, want.cg_iters],
                              history_its_equal=[h[0] for h in got.history]
                              == [h[0] for h in want.history]))
    windows = _window_cases(n, torch.float32)
    nccl = _nccl_one_rank()
    cards = [f"cuda:{k % torch.cuda.device_count()}" for k in range(SHARD_WORLD)]
    assert [o["device"] for o in outs] == cards, ([o["device"] for o in outs], cards)
    out = dict(n=n, r=r, m=n * (n - 1) // 2, world=SHARD_WORLD, backend="gloo",
               rank_devices=[o["device"] for o in outs],
               config=SHARD_ADMM, float64_config=SHARD_F64, warm_start_s=warm_s,
               float32=rows["float32"], float64=rows["float64"],
               r_asym=dict(r_asym, drift=abs(r_asym["sharded"] - r_asym["unsharded"])),
               bounds=dict(float32_lam=SHARD_LAM_BOUND, float32_r_asym=SHARD_RASYM_BOUND,
                           float64_lam=SHARD_F64_TOL),
               collectives_ms=outs[0]["collectives_ms"],
               instances=dict(wall_s=[o["instances"]["wall_s"] for o in outs], rows=inst_rows),
               nccl=nccl, windows={k: {f: v for f, v in c.items() if f != "windows"}
                                   for k, c in windows.items()},
               phase_s=time.perf_counter() - t_phase)
    emit("main_sharded", **out)
    assert rows["float64"]["abs_d_lam"] <= SHARD_F64_TOL, rows["float64"]
    assert rows["float32"]["abs_d_lam"] <= SHARD_LAM_BOUND, rows["float32"]
    assert out["r_asym"]["drift"] <= SHARD_RASYM_BOUND, out["r_asym"]
    assert all(np.isfinite(v) for v in r_asym.values()), r_asym
    for row in inst_rows:
        assert row["support_equal"] and row["abs_d_lam"] <= 1e-6 and \
            row["iters"][0] == row["iters"][1] and row["history_its_equal"] and \
            abs(row["cg_iters"][0] - row["cg_iters"][1]) <= 0.01 * row["cg_iters"][1], \
            f"main_sharded instances: {row}"
    for name in ("edge_laplacian_window", "edge_adjoint_window"):
        windows[name]["path_launches"] = rows["float32"]["launches"][0][name.rsplit("_", 1)[0]]
    return windows


def _overlap(a, b) -> float:
    sa, sb = set(np.nonzero(a.g > 1e-6)[0].tolist()), set(np.nonzero(b.g > 1e-6)[0].tolist())
    return len(sa & sb) / max(len(sa | sb), 1)


#: helper processes of the phases, stopped when the script ends
_CHILDREN: list = []
XSTEP_FORMS = ("edge_laplacian_blocks", "edge_adjoint", "edge_schur_matvec")
#: the depth of main_xstep_backends' whole solves from main_n64's start, cut
#: from the pipeline's 600 to pay for main_sharded, and from 150 for
#: main_tp_dsgd (PERF.md §4)
XSTEP_SOLVE_ITERS = 60
#: card against CPU at card_vs_cpu's request, per backend: |Δλ̃| (float64)
XSTEP_CARD_CPU_BAND = 1e-7
XSTEP_CARD_CPU_BACKENDS = {"scan/kkt_bicgstab": dict(solver="kkt_bicgstab"),
                           "python/schur_cg": dict(driver="python"),
                           "python/kkt_bicgstab_ilu": dict(solver="kkt_bicgstab_ilu")}
#: card_vs_cpu's request by each backend on the CPU, in a process of its own
XSTEP_CPU_SIDE = """
import dataclasses, json, sys, time
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.core import BATopoConfig, HomogeneousADMM
g16 = np.random.default_rng(16).random(16 * 15 // 2) * 0.2
out = {}
for label, kw in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(BATopoConfig().admm, dtype="float64", device="cpu", **kw)
    t0 = time.perf_counter()
    res = HomogeneousADMM(16, 32, cfg).solve(g0=g16, lam0=0.5)
    out[label] = dict(lam=res.lam_tilde, g=res.g.tolist(), iters=res.iters,
                      wall_s=time.perf_counter() - t0)
print(json.dumps(out))
"""


def phase_main_xstep_backends(restarts: list) -> dict:
    """The ADMM's X-step backends and the per-iteration driver on the card,
    from main_n64's first recorded restart (n = 64, r = 128, its annealed
    warm start):

    - one X-step by ``schur_cg``, ``kkt_bicgstab`` and the scipy ILU from
      the same float64 state (``init_state`` of the warm start, as the
      reference's ``tests/test_engine_parity.py:29-45``) with the exact CG
      tolerance: the ILU's x, S, y and T within 1e-6 of schur_cg's (the
      reference's band). ``kkt_bicgstab`` from a state with A X₀ = b stops
      at its first iteration with ω = 0 (α rounds to 1, so s has no X part
      and ⟨t, s⟩ = 0): JAX's bicgstab does the same there (ROADMAP.md Queue
      3), so its X-step is held to the CPU's, within 1e-9, and its distance
      from schur_cg's and its constraint residual ‖A X − b‖∞ are reported;
    - whole solves from the warm start, cut to ``XSTEP_SOLVE_ITERS``
      iterations: scan/kkt_bicgstab, python/schur_cg and python/kkt_bicgstab
      at the pipeline default (fp32, inexact CG), beside main_n64's own
      600-iteration scan/schur_cg solve of the same start (not run again),
      and the ILU (float64, exact tolerance) beside a float64 scan solve at
      the same tolerance: wall, iterations, λ̃, support overlap,
      edge-form launches (no ``edge_schur_matvec`` on the kkt route) and the
      ILU's ``spsolve`` fallbacks;
    - card_vs_cpu's request (n = 16, r = 32, float64) by each backend on the
      card and on the CPU: for python/schur_cg and the ILU the same support
      and λ̃ within ``XSTEP_CARD_CPU_BAND``; for kkt_bicgstab, whose X-steps
      stop on ω = 0 or at rounding-level ω (the reference's fault), both
      reported without a band."""
    from repro_torch.core import BATopoConfig, HomogeneousADMM
    from repro_torch.core import engine as te

    rec = restarts[0]
    base, g0, lam0 = rec["solver"], rec["g0"], rec["lam0"]
    n, r, cfg = base.n, base.r, base.cfg
    exact64 = dataclasses.replace(cfg, dtype="float64", cg_inexact=False)
    # the CPU side of the card-vs-CPU rows runs in a process of its own
    # while the card works through the rest of the phase
    cpu_side = subprocess.Popen(
        [sys.executable, "-c", XSTEP_CPU_SIDE, json.dumps(XSTEP_CARD_CPU_BACKENDS)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE, text=True)
    _CHILDREN.append(cpu_side)

    # one X-step per backend from the same float64 state
    spec = te.make_homo_spec(n, r, exact64)
    st = te.init_state(spec, g0, lam0)
    ilu_step = te.make_ilu_step(spec)
    xsteps, launches_x = {}, {}
    for name, fn in (("schur_cg", lambda: te.step(spec, st, "schur_cg")),
                     ("kkt_bicgstab", lambda: te.step(spec, st, "kkt_bicgstab")),
                     ("kkt_bicgstab_ilu", lambda: ilu_step(st))):
        (out, _), wall, counts = _timed_xstep(fn)
        xsteps[name] = out
        launches_x[name] = dict(counts, wall_s=wall)
    xstep_diff = {name: max(float((a - b).abs().max()) for a, b in
                            zip(xsteps[name].X, xsteps["schur_cg"].X))
                  for name in ("kkt_bicgstab", "kkt_bicgstab_ilu")}
    spec_cpu = te.make_homo_spec(n, r, dataclasses.replace(exact64, device="cpu"))
    kkt_cpu, _ = te.step(spec_cpu, te.init_state(spec_cpu, g0, lam0), "kkt_bicgstab")
    kkt_vs_cpu = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(xsteps["kkt_bicgstab"].X, kkt_cpu.X))
    kkt_residual = float((te.A_op(spec, xsteps["kkt_bicgstab"].X) - te.b_rhs(spec)).abs().max())

    def solve(solver_cfg):
        solver = HomogeneousADMM(n, r, solver_cfg)
        res, wall, counts = _timed_solves(lambda: solver.solve(g0=g0, lam0=lam0))
        fallbacks = (solver._ilu_step().ilu.fallbacks
                     if solver_cfg.solver == "kkt_bicgstab_ilu" else None)
        return res, dict(wall_s=wall, iters=res.iters, lam_tilde=res.lam_tilde,
                         cg_iters=res.cg_iters, residual=res.residual, launches=counts,
                         ilu_fallbacks=fallbacks)

    ref = rec["result"]
    solves = {"scan/schur_cg (600 iterations)": dict(wall_s=rec["wall_s"], iters=ref.iters,
                                    lam_tilde=ref.lam_tilde, cg_iters=ref.cg_iters,
                                    residual=ref.residual, launches=rec["launches"],
                                    support_overlap=1.0, from_main_n64=True)}
    cut = dict(max_iters=XSTEP_SOLVE_ITERS)
    for label, kw in (("scan/kkt_bicgstab", dict(solver="kkt_bicgstab")),
                      ("python/schur_cg", dict(driver="python")),
                      ("python/kkt_bicgstab", dict(driver="python", solver="kkt_bicgstab"))):
        res, row = solve(dataclasses.replace(cfg, **kw, **cut))
        solves[label] = dict(row, support_overlap=_overlap(res, ref))
    scan64, row64 = solve(dataclasses.replace(exact64, **cut))
    ilu, row_ilu = solve(dataclasses.replace(exact64, solver="kkt_bicgstab_ilu", **cut))
    solves["scan/schur_cg float64"] = dict(row64, support_overlap=_overlap(scan64, ref))
    solves["python/kkt_bicgstab_ilu float64"] = dict(
        row_ilu, support_overlap=_overlap(ilu, scan64),
        abs_d_lam_vs_scan64=abs(ilu.lam_tilde - scan64.lam_tilde))

    # card against CPU at card_vs_cpu's request, per backend
    g16 = np.random.default_rng(16).random(16 * 15 // 2) * 0.2
    card_cpu = {}
    for label, kw in XSTEP_CARD_CPU_BACKENDS.items():
        c16 = dataclasses.replace(BATopoConfig().admm, dtype="float64", device="cuda", **kw)
        t0 = time.perf_counter()
        a = HomogeneousADMM(16, 32, c16).solve(g0=g16, lam0=0.5)
        card_cpu[label] = dict(lam_cuda=a.lam_tilde, iters=[a.iters],
                               wall_s=[time.perf_counter() - t0], g=a.g)
    out_cpu, _ = cpu_side.communicate(timeout=600)
    assert cpu_side.returncode == 0, f"main_xstep_backends: the CPU side exited {cpu_side.returncode}"
    for label, b in json.loads(out_cpu.splitlines()[-1]).items():
        row = card_cpu[label]
        g_cuda, g_cpu = row.pop("g"), np.asarray(b["g"])
        row.update(lam_cpu=b["lam"], lam_drift=abs(row["lam_cuda"] - b["lam"]),
                   support_equal=bool(np.array_equal(g_cuda > 1e-6, g_cpu > 1e-6)),
                   iters=row["iters"] + [b["iters"]], wall_s=row["wall_s"] + [b["wall_s"]])
    out = dict(n=n, r=r, start="main_n64 restart 0", xstep_max_abs_diff_vs_schur_cg=xstep_diff,
               kkt_xstep=dict(max_abs_diff_vs_cpu=kkt_vs_cpu, constraint_residual=kkt_residual,
                              loop_passes=(launches_x["kkt_bicgstab"]["edge_adjoint"] - 1)
                              // 2),
               xstep_launches=launches_x, solves=solves,
               card_vs_cpu=dict(n=16, r=32, dtype="float64", band=XSTEP_CARD_CPU_BAND,
                                rows=card_cpu))
    emit("main_xstep_backends", **out)
    assert xstep_diff["kkt_bicgstab_ilu"] <= 1e-6, f"X-steps differ: {xstep_diff}"
    assert kkt_vs_cpu <= 1e-9, f"kkt_bicgstab X-step: card and CPU differ by {kkt_vs_cpu}"
    kkt = launches_x["kkt_bicgstab"]
    assert kkt["edge_schur_matvec"] == 0 and not _missing("xstep_kkt", kkt), kkt
    assert kkt["edge_laplacian_blocks"] == kkt["edge_adjoint"], kkt
    for label, row in solves.items():
        assert np.isfinite(row["lam_tilde"]), (label, row)
        if "kkt_bicgstab" in label and "ilu" not in label:
            assert row["launches"]["edge_schur_matvec"] == 0 and \
                not _missing("xstep_kkt", row["launches"]), (label, row["launches"])
    for label, row in card_cpu.items():
        if "ilu" in label or "schur" in label:
            assert row["support_equal"] and row["lam_drift"] <= XSTEP_CARD_CPU_BAND, (label, row)
        assert np.isfinite(row["lam_cuda"]) and np.isfinite(row["lam_cpu"]), (label, row)
    return out


def _timed_xstep(fn):
    """``fn()``'s result, wall and edge-form launches, on counts from 0."""
    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    return out, wall, {f: counts[f] for f in XSTEP_FORMS}


@contextlib.contextmanager
def _spied(owner, attr: str):
    """For the block, ``owner.<attr>`` records each call's arguments, result
    and seconds (host clock, the card synchronized at the end) in the
    yielded list."""
    calls = []
    orig = getattr(owner, attr)

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((args, kwargs, out, time.perf_counter() - t0))
        return out

    setattr(owner, attr, spy)
    try:
        yield calls
    finally:
        setattr(owner, attr, orig)


#: main_sweep's SA moves per warm start, cut from the default 1,500: the
#: four budgets' SAs run one after another (a 2-swap keeps the edge count,
#: so budgets do not share a batch), and at 1,500 they took most of the
#: phase's 44 s on the H100.
SWEEP_SA_ITERS = 500


def phase_main_sweep() -> tuple[dict, dict]:
    """``solve_topologies`` at n=64, r = 64, 96, 128, 192 with the default
    config but ``SWEEP_SA_ITERS`` SA moves: one warm start per budget, ONE
    batched ADMM solve of all four (``solve_sweep_spec`` called once), the
    polish and the pick per budget, each stage timed.
    Every result release-valid, within its budget. The edge forms are
    launched for the batch: init_state's L(g) once, and the CG matvecs at
    most 1.1× those of the sweep's slowest instance (most CG iterations)
    solved alone from the same warm start, where solving the budgets one by
    one would take about 4×. Returns the run's launches and its record."""
    from repro_torch import kernels
    from repro_torch.core import BATopoConfig, TopologyRequest, check_invariants
    from repro_torch.core import api
    from repro_torch.core import engine as te
    from repro_torch.core.anytime import solve_topologies

    n, rs = 64, (64, 96, 128, 192)
    cfg = BATopoConfig(sa_iters=SWEEP_SA_ITERS)
    with _spied(te, "solve_sweep_spec") as sweeps, _spied(api, "_anneal_edges") as sas, \
            _spied(api, "_finalize_batch") as polishes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        results = solve_topologies([TopologyRequest(n=n, r=r) for r in rs], cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    rows = []
    for r, res in zip(rs, results):
        bad = check_invariants(res.topology)
        assert bad is None, f"main_sweep r={r}: release invariant {bad!r} fails"
        assert len(res.topology.edges) <= r and np.isfinite(res.r_asym) and res.r_asym < 1.0, \
            f"main_sweep r={r}: {len(res.topology.edges)} edges, r_asym {res.r_asym}"
        rows.append(dict(r=r, r_asym=res.r_asym, edges=len(res.topology.edges),
                         selected_from=res.topology.meta.get("selected_from")))
    missing = [k for k in PATH_KERNELS["sweep"] if launches[k] == 0]
    assert not missing, f"main_sweep: kernels never launched on the path: {missing}"
    assert len(sweeps) == 1 and launches["edge_laplacian"] == 1, \
        f"main_sweep: {len(sweeps)} sweep solves, {launches['edge_laplacian']} init_states"
    (spec, rs_solved, states, admm), _, sweep, admm_s = sweeps[0]
    slow = int(np.argmax([s.cg_iters for s in sweep]))
    alone, alone_wall, alone_launches = _timed_solves(lambda: te.solve_spec(
        spec.replace(r=torch.tensor(rs_solved[slow], device="cuda")),
        states.map(lambda t: t[slow]), admm))
    ratio = launches["edge_schur_matvec"] / alone_launches["edge_schur_matvec"]
    out = dict(n=n, rs=list(rs), cut=f"sa_iters {SWEEP_SA_ITERS} of {BATopoConfig().sa_iters}",
               wall_s=wall, stage_s=dict(sa=sum(c[3] for c in sas), admm=admm_s,
                                         finalize=sum(c[3] for c in polishes)),
               launches=launches, rows=rows,
               admm_sweep=dict(cg_iters=[s.cg_iters for s in sweep],
                               lam_tilde=[s.lam_tilde for s in sweep]),
               slowest_alone=dict(r=rs[slow], wall_s=alone_wall, launches=alone_launches,
                                  cg_iters=alone.cg_iters, lam_tilde=alone.lam_tilde),
               matvec_launch_ratio=ratio)
    emit("main_sweep", **out)
    assert ratio <= 1.1, f"main_sweep: {ratio:.3f}× the slowest instance's matvec launches"
    return launches, out


def _answer(label: str, resp, launches: dict | None = None) -> dict:
    """One service response as a row of main_service's line; it must be a
    release-valid topology."""
    from repro_torch.core import check_invariants

    assert resp.ok, f"main_service {label}: rejected ({resp.reason})"
    bad = check_invariants(resp.topology)
    assert bad is None, f"main_service {label}: release invariant {bad!r} fails"
    row = dict(request=label, tier=resp.quality_tier, latency_ms=resp.latency_ms,
               r_asym=float(resp.topology.r_asym()), edges=len(resp.topology.edges),
               reason=resp.reason)
    if launches is not None:
        row["launches"] = launches
    return row


def phase_main_service() -> dict:
    """One ``TopologyService`` on the card (default config, SA cut to
    ``SWEEP_SA_ITERS`` moves), fed one ``submit`` per request, then
    ``drain``: four homogeneous n=64 budgets as one bucket (ONE batched
    ``solve_sweep_spec``); r=128 again (a cache hit, the same object); a
    node-scenario n=16, r=32 request (the full tier, the barrier engine),
    then ``observe`` of the drifted profile (the four fast NICs at 1 GB/s)
    invalidates it; n=64, r=112 under a 3 s deadline (the anytime route,
    seeded by the bucket's stage times per instance), then n=64, r=120
    under a 3 s deadline (seeded by what the first deadlined solve
    learned): both have to answer within it.
    A second service whose full-tier hook answers n=16, r=24 with the real
    barrier answer and r=32 with a NaN topology: the warm tier runs the
    guarded ADMM on the card from the cached r=24 support. A third with
    ``max_queue=2`` rejects its third submit as overloaded. Every answer
    passes ``check_invariants``."""
    from repro_torch import kernels
    from repro_torch.core import BATopoConfig, solve_topology
    from repro_torch.core import engine as te
    from repro_torch.core.graph import Topology
    from repro_torch.serve import ServiceHooks, ServicePolicy, TopologyService, TopoRequest

    cfg = BATopoConfig(sa_iters=SWEEP_SA_ITERS)
    cut = f"sa_iters {SWEEP_SA_ITERS} of {BATopoConfig().sa_iters}"
    rows = []
    svc = TopologyService(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _spied(te, "solve_sweep_spec") as sweeps:
        rs = (96, 128, 160, 192)
        for r in rs:
            svc.submit(TopoRequest(n=64, r=r))
        bucket = svc.drain()
    rows += [_answer(f"n=64,r={r}", resp) for r, resp in zip(rs, bucket)]
    assert len(sweeps) == 1 and svc.stats["bucketed_solves"] == 1, \
        f"main_service: {len(sweeps)} sweep solves for the bucket, stats {svc.stats}"
    assert all(resp.quality_tier == "full" for resp in bucket)
    svc.submit(TopoRequest(n=64, r=128))
    hit = svc.drain()[0]
    rows.append(_answer("n=64,r=128 again", hit))
    assert hit.quality_tier == "cache" and hit.topology is bucket[1].topology, \
        f"main_service: the repeat is {hit.quality_tier}, not the cached object"
    svc.submit(TopoRequest(n=16, r=32, scenario="node", node_bandwidths=NODE_BW_16))
    node = svc.drain()[0]
    rows.append(_answer("node n=16,r=32", node))
    assert node.quality_tier == "full", node.quality_tier
    drifted = NODE_BW_16.copy()
    drifted[:4] = 1.0
    evicted = svc.observe(drifted)
    assert evicted == 1 and svc.stats["invalidations"] == 1, (evicted, svc.stats)
    seeded = dict(svc._seed_profiles[64].phases)
    svc.submit(TopoRequest(n=64, r=112, deadline_ms=3000.0))
    timed = svc.drain()[0]
    rows.append(_answer("n=64,r=112 deadline 3000 ms (seeded by the bucket)", timed))
    learned = dict(svc._seed_profiles[64].phases)
    svc.submit(TopoRequest(n=64, r=120, deadline_ms=3000.0))
    again = svc.drain()[0]
    rows.append(_answer("n=64,r=120 deadline 3000 ms (learned estimates)", again))
    assert "admm" in learned, f"main_service: no ADMM estimate learned at n=64: {learned}"
    assert timed.latency_ms <= 3000.0, \
        f"main_service: the first deadlined request took {timed.latency_ms:.1f} ms ({timed.reason})"
    assert again.latency_ms <= 3000.0, \
        f"main_service: the second deadlined request took {again.latency_ms:.1f} ms ({again.reason})"
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    assert not _missing("service", launches), \
        f"main_service: kernels never launched: {_missing('service', launches)}"

    def full_hook(req, prof):
        if int(req.r) == 32:
            edges = [(i, (i + 1) % 16) for i in range(16)]
            return Topology(16, edges, np.full(16, np.nan), name="nan-stub",
                            meta={"connected": True})
        return solve_topology(req, cfg=cfg, profile=prof, engine="barrier").topology

    stub = TopologyService(cfg, hooks=ServiceHooks(full=full_hook))
    stub.submit(TopoRequest(n=16, r=24))
    rows.append(_answer("stub n=16,r=24", stub.drain()[0]))
    kernels.reset_launch_counts()
    stub.submit(TopoRequest(n=16, r=32))
    warm = stub.drain()[0]
    warm_launches = kernels.launch_counts()
    rows.append(_answer("stub n=16,r=32 (NaN full tier)", warm, warm_launches))
    assert warm.quality_tier == "warm" and warm_launches["edge_schur_matvec"] > 0, \
        f"main_service: the NaN stub degraded to {warm.quality_tier}, {warm_launches}"

    small = TopologyService(cfg, policy=ServicePolicy(max_queue=2))
    outs = [small.submit(TopoRequest(n=16, r=r)) for r in (24, 32, 40)]
    assert [isinstance(o, int) for o in outs] == [True, True, False], outs
    assert outs[2].reason.startswith("overloaded"), outs[2].reason
    rows += [_answer(f"max_queue=2 n=16,r={r}", resp) for r, resp in zip((24, 32), small.drain())]
    out = dict(cut=cut, wall_s=wall_s, launches=launches, rows=rows, stats=svc.stats,
               deadline_latency_ms=[timed.latency_ms, again.latency_ms],
               bucket_seeded_stage_s=seeded, learned_stage_s=learned,
               stub_stats=stub.stats, overload=dict(reason=outs[2].reason, stats=small.stats))
    emit("main_service", **out)
    return out


def _same_graph(n: int, a: list, b: list) -> bool:
    """Whether two edge lists are the same graph up to node labels, by its
    degree sequence and the spectrum of its unweighted Laplacian (two
    labelings of the n-cycle, say)."""
    from repro_torch.core.graph import degrees, laplacian_from_weights

    def spectrum(edges):
        return np.linalg.eigvalsh(laplacian_from_weights(n, edges, np.ones(len(edges))))

    return (sorted(degrees(n, a)) == sorted(degrees(n, b))
            and np.allclose(spectrum(a), spectrum(b), rtol=0, atol=1e-9))


def phase_sweep_card_vs_cpu() -> None:
    """``solve_topologies`` at n=16, r = 16, 24, 32 with the host SA, a
    float64 ADMM and the float64 device polish, on the card and on the CPU:
    the same supports, and r_asym within 5e-4 (card_vs_cpu's eigenspace
    band for the device polish). One exception, reported as a tie: where
    the two winners are the same graph up to labels (at r = n both the
    classic ring and the ADMM's Hamiltonian cycle are 16-cycles, equal in
    r_asym up to the polish's rounding) and agree in r_asym within 1e-7,
    either side may pick either."""
    from repro_torch.core import BATopoConfig, TopologyRequest
    from repro_torch.core.anytime import solve_topologies

    rs = (16, 24, 32)
    runs = {}
    for device in ("cuda", "cpu"):
        cfg = BATopoConfig(warmstart="host", polish_dtype="float64", device=device)
        cfg = dataclasses.replace(cfg, admm=dataclasses.replace(cfg.admm, dtype="float64"))
        t0 = time.perf_counter()
        runs[device] = (solve_topologies([TopologyRequest(n=16, r=r) for r in rs], cfg=cfg),
                        time.perf_counter() - t0)
    rows = []
    for r, gpu, cpu in zip(rs, runs["cuda"][0], runs["cpu"][0]):
        support = [sorted(tuple(sorted(e)) for e in x.topology.edges) for x in (gpu, cpu)]
        drift = abs(gpu.r_asym - cpu.r_asym)
        rows.append(dict(r=r, r_asym_cuda=gpu.r_asym, r_asym_cpu=cpu.r_asym,
                         drift=drift, support_equal=support[0] == support[1],
                         tie=(support[0] != support[1] and drift <= 1e-7
                              and _same_graph(16, *support)),
                         selected_from=[gpu.topology.meta.get("selected_from"),
                                        cpu.topology.meta.get("selected_from")]))
    emit("sweep_card_vs_cpu", n=16, rs=list(rs), rows=rows,
         wall_s=dict(cuda=runs["cuda"][1], cpu=runs["cpu"][1]))
    for row in rows:
        assert row["support_equal"] or row["tie"], \
            f"sweep_card_vs_cpu r={row['r']}: supports differ: {row}"
        assert row["drift"] <= 5e-4, f"sweep_card_vs_cpu r={row['r']}: drift {row['drift']}"


# ---------------------------------------------------------------------------
# phase 7: DSGD training of smollm-135m at full width, through the launcher
# ---------------------------------------------------------------------------

DSGD_ARGS = ["--arch", "smollm-135m", "--workers", "8", "--topo", "ba", "--r", "16",
             "--optimizer", "sgd", "--batch", "4", "--seq", "256", "--steps", "10",
             "--log-every", "1", "--seed", "0", "--device", "cuda"]
DSGD_WORKERS = 8
SMOLLM_PARAMS = 134_515_008
SMOLLM_LEAVES = 11
TOPO_CACHE = ROOT / "build" / "chip_smoke" / "topo_cache_torch.json"


def _leaves(tree, prefix: str = "") -> dict:
    """Flat ``a.b.c`` → leaf view of a nested parameter dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _within(got, want, terms, deg) -> tuple[float, bool]:
    """Max |got − want|, and whether every element lies within one ulp of
    the output dtype at the larger of the two (none for fp32) plus the
    float32 summation bound (deg+2)·2⁻²⁴·Σ|w·x|: the plain version sums
    the neighbour terms in another order than the kernel."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = (deg + 2) * 2.0 ** -24 * terms
    if got.dtype != torch.float32:
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        tol = tol + torch.ldexp(torch.full_like(tol, torch.finfo(got.dtype).eps), e - 1)
    return float(err.max()), bool((err <= tol).all())


def _batched_check(got, x, nbr_idx, weights) -> tuple[float, bool]:
    """:func:`_within` for ``gossip_mix_batched``'s output against the plain
    version, one worker's row at a time in the plain version's order (the
    neighbour terms summed, then added to the own term): a whole leaf's
    plain version gathers (n, deg) float32 copies of it (9 GiB at a
    16-layer granite's expert weights), a row only deg."""
    err, ok = 0.0, True
    deg = int(nbr_idx.shape[1])
    tail = (deg,) + (1,) * (x.dim() - 1)
    for i in range(x.shape[0]):
        w = weights[i].float()
        nbrs = x[nbr_idx[i].long()].float()
        want = (x[i].float() * w[0] + torch.sum(nbrs * w[1:].reshape(tail), dim=0)).to(x.dtype)
        terms = x[i].float().abs() * w[0].abs() + torch.sum(
            nbrs.abs_() * w[1:].abs().reshape(tail), dim=0)
        del nbrs
        e, o = _within(got[i], want, terms, deg)
        err, ok = max(err, e), ok and o
    return err, ok


def _first_gossip(mixed: dict, leaves: dict, nbr_idx, weights) -> dict:
    """A path's first gossip, leaf by leaf: (max |err|, within
    :func:`_batched_check`'s tolerance of the plain version, bitwise equal
    to the first-cut witness kernel on the same inputs)."""
    from repro_torch.kernels.gossip_mix import ops as gm

    return {k: _batched_check(mixed[k], x, nbr_idx, weights)
            + (torch.equal(mixed[k], gm.gossip_mix_batched_witness(x, nbr_idx, weights)),)
            for k, x in leaves.items()}


def _first_summary(first: dict) -> dict:
    return dict(max_abs_err=max(e for e, _, _ in first.values()),
                within=all(ok for _, ok, _ in first.values()),
                equal_to_witness=all(eq for _, _, eq in first.values()))


def _dtypes(tree) -> int:
    """The dtypes among a parameter tree's leaves: the gossip's launches a step."""
    return len({x.dtype for x in _leaves(tree).values()})


def phase_main_dsgd():
    """The launcher's run at full width on the card: the BA topology solved
    on the card (a fresh cache file), 10 steps with every gossip through
    ``gossip_mix_batched``. The first gossip (step 1) is also mixed by the
    plain version from the same pre-gossip leaves and held against the
    kernel's, and bitwise against the first-cut witness kernel's, by
    wrapping the trainer's ``gossip_sim_tree``. One launch a step mixes all
    leaves (one dtype)."""
    from repro_torch import kernels
    from repro_torch.dsgd import trainer
    from repro_torch.launch import steps, train

    TOPO_CACHE.unlink(missing_ok=True)
    mix = trainer.gossip_sim_tree
    step1: dict = {}

    def checked_mix(tree, W, *, use_kernel=True, nbr=None):
        out = mix(tree, W, use_kernel=use_kernel, nbr=nbr)
        if not step1:
            step1.update(_first_gossip(_leaves(out), _leaves(tree), *nbr))
            # the check's own scratch stays out of the training's peak: the
            # later steps reach the same peak as step 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return out

    last = {}
    trainer.gossip_sim_tree = checked_mix
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = train.main(DSGD_ARGS + ["--topo-cache", str(TOPO_CACHE)],
                         on_step=lambda s, state, m: last.update(state=state))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        trainer.gossip_sim_tree = mix
    peak = torch.cuda.max_memory_allocated()
    topo = steps.topology_for(DSGD_WORKERS, "ba", 16, 0, device="cuda", cache_path=TOPO_CACHE)
    hist = res["history"]
    n_steps = len(res["step_ms"])
    losses = [h["loss"] for h in hist]
    cons = [h["consensus_err"] for h in hist]
    deg = int(max(np.bincount(np.asarray(topo.edges).reshape(-1), minlength=topo.n)))
    emit("main_dsgd", arch=res["arch"], workers=DSGD_WORKERS, batch=4, seq=256,
         steps=n_steps, param_count_per_worker=res["param_count_per_worker"],
         topology=res["topology"], edges=res["edges"], max_degree=deg, r_asym=res["r_asym"],
         topology_solve_s=res["topology_s"], bigram_table=res["bigram_table"],
         step_ms=res["step_ms"], steady_step_ms=float(np.mean(res["step_ms"][2:])),
         losses=losses, loss_max=[h["loss_max"] for h in hist], consensus_err=cons,
         step1_gossip_vs_plain={k: dict(max_abs_err=e, within=ok, equal_to_witness=eq)
                                for k, (e, ok, eq) in step1.items()},
         max_memory_allocated_bytes=peak, wall_s=wall_s, launches=launches)
    assert res["param_count_per_worker"] == SMOLLM_PARAMS, res["param_count_per_worker"]
    assert len(hist) == n_steps == 10 and all(np.isfinite(losses)) and all(np.isfinite(cons))
    assert abs(losses[0] - np.log(49152)) <= 0.5, f"first loss {losses[0]} vs ln 49152"
    assert launches["gossip_mix_batched"] == _dtypes(last["state"].params) * n_steps, launches
    missing = [k for k in PATH_KERNELS["dsgd"] if launches[k] == 0]
    assert not missing, f"main_dsgd: kernels never launched on the path: {missing}"
    assert len(step1) == SMOLLM_LEAVES and all(ok for _, ok, _ in step1.values()), \
        f"step-1 gossip differs from the plain mix: {step1}"
    assert all(eq for _, _, eq in step1.values()), f"step-1 gossip is not the witness's: {step1}"
    run = dict(history=hist, peak_bytes=peak, steady_step_ms=float(np.mean(res["step_ms"][2:])))
    return last["state"], topo, launches, max(e for e, _, _ in step1.values()), run


# ---------------------------------------------------------------------------
# phase 8: both gossip kernels at smollm-135m's leaf shapes, and their times
# ---------------------------------------------------------------------------

def _table_bytes(idx, w) -> int:
    return idx.numel() * idx.element_size() + w.numel() * w.element_size()


def _gossip_step_case(params, W, idx, w) -> dict:
    """A whole step's gossip (every leaf of ``params``, one neighbour table):
    the tiled kernel (one launch a dtype, through ``gossip_sim_tree``), the
    first-cut witness kernel a leaf, the plain version and the dense
    ``torch.matmul(W, x)`` a leaf, with the byte bound. The timing calls
    leave the launch count as it was."""
    from repro_torch.dsgd.gossip import gossip_sim_tree
    from repro_torch.kernels.gossip_mix import ops as gm

    leaves = _leaves(params)
    n = W.shape[0]
    launches = gm.gossip_mix_batched.launches
    t = large_timings(
        lambda: gossip_sim_tree(params, W, nbr=(idx, w)),
        lambda: [gm.gossip_mix_batched_plain(x, idx, w) for x in leaves.values()],
        lambda: [torch.matmul(W.to(x.dtype), x.view(n, -1)) for x in leaves.values()])
    t["witness_ms"] = large_timings(
        lambda: [gm.gossip_mix_batched_witness(x, idx, w) for x in leaves.values()], None)["ms"]
    gm.gossip_mix_batched.launches = launches
    nbytes = sum(2 * x.numel() * x.element_size() for x in leaves.values()) + _table_bytes(idx, w)
    return dict(t, workers=n, leaves=len(leaves), deg=int(idx.shape[1]), bytes=nbytes,
                dtypes=sorted({str(x.dtype).replace("torch.", "") for x in leaves.values()}),
                bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")


def phase_gossip_kernels(state, topo) -> dict:
    """Each kernel against its plain version on the trained leaves: the
    embedding (bf16 and fp32), ``layers.mlp.w_gate``, ``layers.attn.wk``
    and a norm leaf, n = 8, with the BA topology's neighbour table and with
    deg = 7 (every other worker). Times: kernel, plain, the dense
    ``torch.matmul(W, x)`` of ``gossip_sim`` as the library call, and the
    bound 2·n·M·size bytes (x read once, the output written once), and
    the first-cut witness kernel (bitwise equal) beside the tiled one. Also
    the whole step's gossip (all 11 leaves, one launch) and the one-worker
    kernel at the embedding. Returns the rows of the kernels line."""
    from repro_torch.core.graph import weight_matrix_from_weights
    from repro_torch.dsgd.gossip import padded_neighbors
    from repro_torch.kernels.gossip_mix import ops as gm

    n = DSGD_WORKERS
    W = torch.tensor(weight_matrix_from_weights(topo.n, topo.edges, topo.g),
                     dtype=torch.float32, device="cuda")
    full = torch.full((n, n), 1.0 / n, device="cuda")
    tables = {"ba": (padded_neighbors(W), W), "deg7": (padded_neighbors(full), full)}
    leaves = _leaves(state.params)
    cases = []
    for name in ("embed", "layers.mlp.w_gate", "layers.attn.wk", "layers.ln1"):
        for dtype in ((torch.bfloat16, torch.float32) if name == "embed" else (torch.bfloat16,)):
            x = leaves[name].to(dtype).contiguous()
            for tag, ((idx, w), Wd) in tables.items():
                got = gm.gossip_mix_batched(x, idx, w)
                err, ok = _batched_check(got, x, idx, w)
                same = torch.equal(got, gm.gossip_mix_batched_witness(x, idx, w))
                del got
                Wx = Wd.to(dtype)
                big = x.numel() * x.element_size() > 64 << 20
                t = (large_timings if big else timings)(
                    lambda: gm.gossip_mix_batched(x, idx, w),
                    lambda: gm.gossip_mix_batched_plain(x, idx, w),
                    lambda: torch.matmul(Wx, x.view(n, -1)))

                def witness():
                    return gm.gossip_mix_batched_witness(x, idx, w)

                t["witness_ms"] = large_timings(witness, None)["ms"] if big else device_ms(witness)
                nbytes = 2 * x.numel() * x.element_size() + _table_bytes(idx, w)
                cases.append(dict(kernel="gossip_mix_batched", leaf=name, shape=list(x.shape),
                                  dtype=str(dtype).replace("torch.", ""), table=tag,
                                  deg=int(idx.shape[1]), max_abs_err=err, within=ok,
                                  equal_to_witness=same, **t,
                                  bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes"))
                assert ok, f"gossip_mix_batched {name} {dtype} {tag}: outside the tolerance"
                assert same, f"gossip_mix_batched {name} {dtype} {tag}: not the witness's bits"
            del x
    # the whole step's gossip: the 11 leaves of the main path, BA table
    step_row = _gossip_step_case(state.params, W, *tables["ba"][0])
    # the one-worker kernel at the embedding: worker 0 and its neighbours
    x = leaves["embed"]
    row0 = [j for j in range(n) if j != 0 and float(W[0, j]) != 0.0]
    nbrs = x[torch.tensor(row0, device="cuda")].contiguous()
    wrow = torch.tensor([float(W[0, 0])] + [float(W[0, j]) for j in row0], device="cuda")
    got = gm.gossip_mix(x[0], nbrs, wrow)
    want = gm.gossip_mix_plain(x[0], nbrs, wrow)
    terms = gm.gossip_mix_plain(x[0].abs().float(), nbrs.abs().float(), wrow.abs())
    err, ok = _within(got, want, terms, len(row0))
    assert ok, "gossip_mix (one worker) at the embedding: outside the tolerance"
    wlib, beta = wrow[1:].to(x.dtype), float(wrow[0])

    def addmv():                  # beta·x + nbrsᵀ·w: the one-call library form
        return torch.addmv(x[0].view(-1), nbrs.view(len(row0), -1).t(), wlib, beta=beta)

    try:
        addmv()
    except RuntimeError:          # no bf16 addmv in this build: no library time
        addmv = None
    one_t = large_timings(lambda: gm.gossip_mix(x[0], nbrs, wrow),
                          lambda: gm.gossip_mix_plain(x[0], nbrs, wrow), addmv)
    one_bytes = (len(row0) + 2) * x[0].numel() * x.element_size() + 4 * wrow.numel()
    one_row = dict(**one_t, max_abs_err=err, deg=len(row0), shape=list(x[0].shape),
                   bound_ms=1e3 * one_bytes / HBM_BYTES_PER_S, bound_by="bytes")
    torch.cuda.synchronize()
    emit("gossip_kernel_checks", cases=cases, whole_step=step_row, one_worker=one_row,
         library_note="gossip_mix_batched: torch.matmul(W.to(dtype), x.view(n, -1)) "
                      "(the dense Eq. 1 of gossip_sim); gossip_mix: torch.addmv; witness_ms: "
                      "the first-cut gossip_mix_batched_witness kernel")
    return {"gossip_mix_batched": step_row, "gossip_mix": one_row}


def phase_gossip_deg() -> list:
    """The first-cut witness kernel and the tiled kernel on smollm's
    embedding leaf (n = 8, bf16) over tables of degree 1, 4 and 7 and a
    degree-7 table with 3 padded slots, at the same bytes
    (``tools/gossip_deg.py``'s ``measure``): the witness's time grows with
    the degree (it reads x's rows deg + 1 times), the tiled kernel's should
    not. The two are bitwise equal in every case."""
    import importlib.util

    from repro_torch.kernels.gossip_mix import ops as gm

    spec = importlib.util.spec_from_file_location("gossip_deg", ROOT / "tools" / "gossip_deg.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    launches = gm.gossip_mix_batched.launches
    rows = tool.measure()
    gm.gossip_mix_batched.launches = launches
    torch.cuda.empty_cache()
    emit("gossip_deg", shape=[tool.N, tool.ROWS], dtype="bfloat16", rows=rows)
    assert all(r["bitwise_equal"] for r in rows), f"gossip_deg: kernels differ: {rows}"
    return rows


# ---------------------------------------------------------------------------
# phase 9: the row-loop oracle (the path of the one-worker kernel)
# ---------------------------------------------------------------------------

def phase_rowloop(state, topo) -> dict:
    """``gossip_sim_tree_rowloop`` over the trained full-width leaves: one
    ``gossip_mix`` launch per worker row per leaf. It must equal the batched
    kernel's mix bitwise (the same products added in the same order)."""
    from repro_torch import kernels
    from repro_torch.core.graph import weight_matrix_from_weights
    from repro_torch.dsgd.gossip import gossip_sim_tree, gossip_sim_tree_rowloop

    W = torch.tensor(weight_matrix_from_weights(topo.n, topo.edges, topo.g),
                     dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loop = gossip_sim_tree_rowloop(state.params, W)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    batched = gossip_sim_tree(state.params, W)
    equal = {k: torch.equal(a, b) for (k, a), b in
             zip(_leaves(loop).items(), _leaves(batched).values())}
    emit("rowloop", workers=DSGD_WORKERS, leaves=len(equal), wall_s=wall_s,
         bitwise_equal_to_batched=all(equal.values()), launches=launches)
    assert all(equal.values()), f"row loop differs from the batched kernel: {equal}"
    assert launches["gossip_mix"] == DSGD_WORKERS * SMOLLM_LEAVES, launches
    missing = [k for k in PATH_KERNELS["rowloop"] if launches[k] == 0]
    assert not missing, f"rowloop: kernels never launched on the path: {missing}"
    return launches


# ---------------------------------------------------------------------------
# phase 10: where a full-width train step's time goes
# ---------------------------------------------------------------------------

def phase_profile_dsgd(state, topo) -> None:
    """One full-width train step (n=8, batch 4, seq 256) under
    torch.profiler, after one unprofiled warm-up step, with the gossip
    kernels' share of the device time named."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, lm_batch_numpy
    from repro_torch.dsgd import dsgd_train_step
    from repro_torch.optim import make_optimizer, warmup_cosine

    cfg = get_arch("smollm-135m")
    _, upd = make_optimizer("sgd", warmup_cosine(0.05, 1, 10))
    step = dsgd_train_step(cfg, topo, upd, device="cuda")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, batch_size=4, seed=0)

    def batch(s):
        per = [lm_batch_numpy(dc, s, node=i) for i in range(DSGD_WORKERS)]
        return {k: torch.from_numpy(np.stack([b[k] for b in per])).cuda() for k in per[0]}

    state, _ = step(state, batch(10))
    b = batch(11)
    prof = _profiled(lambda: step(state, b), match=("gossip_mix",))
    emit("profile_dsgd", arch=cfg.name, workers=DSGD_WORKERS, batch=4, seq=256, step=prof)


# ---------------------------------------------------------------------------
# phase 11: DSGD on the card against the CPU
# ---------------------------------------------------------------------------

def phase_dsgd_card_vs_cpu() -> None:
    """Reduced smollm (fp32, 2 layers, width 128), n = 4 on a ring, 3
    steps from the same weights and batches on the card and on the CPU
    (the CPU mixes by the plain version): the losses agree within 1e-4
    relative. With the CPU against the JAX package (tests/test_torch_dsgd.py)
    this closes the chain JAX ⇄ port (CPU) ⇄ port (card)."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.core.topologies import make_baseline
    from repro_torch.data import DataConfig, lm_batch_numpy
    from repro_torch.dsgd import dsgd_train_step, init_dsgd_state
    from repro_torch.optim import make_optimizer, warmup_cosine

    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    n, n_steps = 4, 3
    init, upd = make_optimizer("sgd", warmup_cosine(0.05, 1, n_steps))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4, seed=0)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = init_dsgd_state(0, cfg, n, init, device=dev)
        step = dsgd_train_step(cfg, make_baseline("ring", n), upd, device=dev)
        kernels.reset_launch_counts()
        losses, cons = [], []
        for s in range(n_steps):
            per = [lm_batch_numpy(dc, s, node=i) for i in range(n)]
            bt = {k: torch.from_numpy(np.stack([b[k] for b in per])).to(dev) for k in per[0]}
            state, m = step(state, bt)
            losses.append(float(m["loss"]))
            cons.append(float(m["consensus_err"]))
        runs[dev] = (losses, cons, _leaves(state.params), kernels.launch_counts())
    (gl, gc, gp, glaunch), (cl, cc, cp, _) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    cons_rel = max(abs(a - b) / abs(b) for a, b in zip(gc, cc))
    param_drift = max(float((gp[k].cpu() - cp[k]).abs().max()) for k in cp)
    emit("dsgd_card_vs_cpu", arch=cfg.name, workers=n, steps=n_steps, losses_cuda=gl,
         losses_cpu=cl, loss_max_rel_diff=loss_rel, consensus_cuda=gc, consensus_cpu=cc,
         consensus_max_rel_diff=cons_rel, param_max_abs_diff=param_drift,
         gossip_launches_cuda=glaunch["gossip_mix_batched"])
    assert glaunch["gossip_mix_batched"] == n_steps * len({x.dtype for x in gp.values()})
    assert loss_rel <= 1e-4, f"DSGD card vs CPU: losses differ by {loss_rel} relative"


# ---------------------------------------------------------------------------
# phase 11a: --sync dynamic, one matching of the topology a step
# ---------------------------------------------------------------------------

def phase_main_dsgd_dynamic(dsgd_run: dict) -> dict:
    """main_dsgd's run (smollm-135m at full width, 8 workers, BA r = 16 from
    main_dsgd's cache, batch 4 × 256, 10 steps) with ``--sync dynamic``:
    step t mixes by the matching W_{t mod R}, all 11 leaves in one
    ``gossip_mix_batched`` launch (one dtype) over its slot's deg-1 table.
    The first gossip is held against the plain version and bitwise against
    the first-cut witness kernel, by wrapping the trainer's
    ``gossip_sim_tree`` as main_dsgd does. Then the whole step's gossip at
    that shape is timed (row 4i). Returns the timing row with the run's
    launches."""
    from repro_torch import kernels
    from repro_torch.dsgd import trainer
    from repro_torch.launch import train

    mix = trainer.gossip_sim_tree
    first: dict = {}
    tables: list = []

    def checked_mix(tree, W, *, use_kernel=True, nbr=None):
        out = mix(tree, W, use_kernel=use_kernel, nbr=nbr)
        if not first:
            first.update(_first_gossip(_leaves(out), _leaves(tree), *nbr))
            tables.append((W, nbr))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return out

    last = {}
    trainer.gossip_sim_tree = checked_mix
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = train.main(DSGD_ARGS + ["--topo-cache", str(TOPO_CACHE), "--sync", "dynamic"],
                         on_step=lambda s, state, m: last.update(state=state))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        trainer.gossip_sim_tree = mix
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    steady = float(np.mean(res["step_ms"][2:]))
    W, (idx, w) = tables[0]
    step_row = _gossip_step_case(last["state"].params, W, idx, w)
    out = dict(arch=res["arch"], workers=DSGD_WORKERS, batch=4, seq=256,
               steps=len(res["step_ms"]), topology=res["topology"], edges=res["edges"],
               rounds=res["rounds"], step_ms=res["step_ms"], steady_step_ms=steady,
               main_dsgd_steady_step_ms=dsgd_run["steady_step_ms"], losses=losses,
               consensus_err=[h["consensus_err"] for h in hist],
               step1_gossip_vs_plain=_first_summary(first), whole_step_gossip=step_row,
               max_memory_allocated_bytes=peak, wall_s=wall_s, launches=launches)
    emit("main_dsgd_dynamic", **out)
    n_steps = len(res["step_ms"])
    assert n_steps == 10 and all(np.isfinite(losses)), losses
    assert abs(losses[0] - np.log(49152)) <= 0.5, f"first loss {losses[0]} vs ln 49152"
    assert res["rounds"] >= 2 and idx.shape[1] == 1, (res["rounds"], tuple(idx.shape))
    assert launches["gossip_mix_batched"] == _dtypes(last["state"].params) * n_steps == 10, \
        launches
    assert launches["gossip_mix"] == 0, launches
    assert not _missing("dsgd_dynamic", launches), _missing("dsgd_dynamic", launches)
    assert len(first) == SMOLLM_LEAVES and all(ok for _, ok, _ in first.values()), \
        f"step-1 dynamic gossip differs from the plain mix: {first}"
    assert all(eq for _, _, eq in first.values()), f"step-1 gossip is not the witness's: {first}"
    return dict(step_row, launches=launches["gossip_mix_batched"], rounds=res["rounds"],
                steady_step_ms=steady)


# ---------------------------------------------------------------------------
# phase 11a: DSGD with one worker a rank (make_sharded_train_step) on the card
# ---------------------------------------------------------------------------

SDSGD_STEPS = 2
SDSGD_BATCH, SDSGD_SEQ = 4, 256
SDSGD_SEED = 0
SDSGD_LR = 0.05
SDSGD_STRAGGLER, SDSGD_DEAD = 3, 5
SDSGD_TIMEOUT_S = 300
SDSGD_DIR = ROOT / "build" / "chip_smoke" / "main_sharded_dsgd"
#: step 1 against the stacked ``dsgd_train_step`` from the same start, per
#: leaf, in bf16 ulps at the leaf's largest magnitude: both run the same
#: bf16 forward and backward, but with their GEMMs batched over one worker
#: or eight, so the gradients agree to bf16 rounding noise, and a local
#: update that lands near a rounding boundary of its parameter flips by an
#: ulp; the gossip itself is pinned bitwise and within ``_within``'s bound
SDSGD_ULPS = 8
#: step 1's momentum (SGD-momentum: the first gradient plus weight decay,
#: float32) against the stacked step's, ‖Δ‖/‖m‖ for each leaf and worker:
#: the same bf16 noise of GEMMs batched over one worker or eight; the
#: controls (a zero gradient, the gradient of half the batch) must lie
#: beyond it
SDSGD_MOMENTUM_RTOL = 0.05
SDSGD_LOSS_RTOL = 1e-3


def _sdsgd_batch(step: int, worker: int, n: int, vocab: int) -> dict:
    """Worker ``worker``'s batch of ``step``: token ids drawn with numpy from
    (seed, step), (1, b, s) int32, the labels the next tokens."""
    tok = np.random.default_rng((SDSGD_SEED, step)).integers(
        0, vocab, size=(n, SDSGD_BATCH, SDSGD_SEQ + 1), dtype=np.int64).astype(np.int32)
    tok = tok[worker:worker + 1]
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tok[..., :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(tok[..., 1:]))}


def _flat(tree) -> torch.Tensor:
    """Every leaf of a one-dtype tree in one flat buffer, in ``_leaves`` order."""
    return torch.cat([x.reshape(-1) for x in _leaves(tree).values()])


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (−0.0 is not 0.0)."""
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


def _same_bits(a, b) -> bool:
    """Whether two trees' leaves hold the same bits."""
    return all(_bits_equal(x, y) for x, y in zip(_leaves(a).values(), _leaves(b).values()))


def _stacked_rounds(X: torch.Tensor, sched, mix=None) -> torch.Tensor:
    """The rank-per-worker gossip over stacked (n, M) copies in one process:
    the float32 per-round accumulation of ``gossip_shard`` (``mix=None``)
    or of ``gossip_shard_elastic`` (``mix`` the (n,) flags), op for op, so
    its bits are the ranks'."""
    from repro_torch.dsgd.gossip import _peers, schedule_weight_arrays

    ws, wr = schedule_weight_arrays(sched)
    n = X.shape[0]
    dev = X.device
    if mix is None:
        acc = X.float() * torch.from_numpy(ws).to(dev)[:, None]
        for r, perm in enumerate(sched.perms):
            for i in range(n):
                src = _peers(perm, i)[1]
                if src is not None:
                    acc[i] += X[src].float() * float(wr[r, i])
        return acc.to(X.dtype)
    a = torch.as_tensor(mix, dtype=torch.float32, device=dev)
    w_self = torch.from_numpy(ws).to(dev)
    w_recv = torch.from_numpy(wr).to(dev)
    acc = torch.stack([X[i].float() * w_self[i] for i in range(n)])
    lost = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(n)]
    for r, perm in enumerate(sched.perms):
        for i in range(n):
            src, w = _peers(perm, i)[1], w_recv[r, i]
            if src is None:
                lost[i] = lost[i] + w
                continue
            acc[i] += X[src].float() * (w * a[src])
            lost[i] = lost[i] + w * (1.0 - a[src])
    for i in range(n):
        acc[i] += X[i].float() * lost[i]
    return acc.to(X.dtype)


def _timed(owner, attr: str, log: list, dev):
    """Wrap ``owner.attr`` so each call's time, synchronized on ``dev``, is
    appended to ``log``; returns the original."""
    orig = getattr(owner, attr)

    def wrapped(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize(dev)
        log.append(1e3 * (time.perf_counter() - t0))
        return out

    setattr(owner, attr, wrapped)
    return orig


def _rel_rows(a: torch.Tensor, b: torch.Tensor) -> float:
    """max_i ‖a_i − b_i‖ / ‖b_i‖ over the rows (workers) of two (n, ...)
    tensors, in float32."""
    a, b = a.reshape(a.shape[0], -1).float(), b.reshape(b.shape[0], -1).float()
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def _mix_rows(X: torch.Tensor, W: torch.Tensor, row: int, f) -> torch.Tensor:
    """Σ_j W[row, j] · f(X_j) in float32 over the row's nonzero j, one
    worker's copy at a time (a whole (n, M) float32 temporary of the
    full-width model is 4.3 GB)."""
    out = torch.zeros(X.shape[1:], dtype=torch.float32, device=X.device)
    for j in torch.nonzero(W[row]).flatten().tolist():
        out += f(X[j]) * W[row, j]
    return out


def _expandable_segments(on: bool) -> None:
    """Switch the caching allocator's expandable segments for the segments
    this process creates from now on."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(f"expandable_segments:{on}")


def _sdsgd_rank(rank: int, world: int, init: str, jobs, share, out_dir: str) -> None:
    """One worker of main_sharded_dsgd, in a process of its own (spawned;
    ``resolve_device("cuda")`` puts every rank on ``cuda:<rank % count>``,
    so all share the one card, over gloo). Builds the seed's start and
    warms the model up on a small batch while the parent runs the stacked
    step, then trains SDSGD_STEPS steps of ``make_sharded_train_step``,
    timing each step, its gossip and gloo's staging copies; runs the
    elastic step three times from the same start (no faults, a dropped
    straggler, a dead rank); hands step 1's pre- and post-gossip leaves, its
    momentum (on the host while the steps run: 8 ranks fill the card) and
    the straggler run's params to the parent (CUDA IPC) and keeps them
    alive until the parent has checked them. Trains in expandable
    segments: with fixed-size segments a rank reserved 8.1–9.5 GB at a
    peak of 5.3–6.4 GB allocated, and 8 ranks filled the card. Writes its
    results and the times it reached each stage to ``out_dir``."""
    import datetime
    import pickle

    import torch.distributed as dist

    t_start = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_start

    torch.set_num_threads(1)
    _expandable_segments(True)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SDSGD_TIMEOUT_S))
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.graph import Topology
    from repro_torch.device import resolve_device
    from repro_torch.dsgd import (gossip, init_dsgd_state, make_elastic_sharded_train_step,
                                  make_sharded_train_step, schedule_from_topology,
                                  schedule_weight_arrays, trainer)
    from repro_torch.optim import sgd_momentum

    mark("ready")
    dev = resolve_device("cuda")
    cfg = get_arch("smollm-135m")
    opt_init, opt_update = sgd_momentum(SDSGD_LR)
    state0 = init_dsgd_state(SDSGD_SEED, cfg, 1, opt_init, device=dev)
    batches = [{k: v.to(dev) for k, v in _sdsgd_batch(s, rank, world, cfg.vocab_size).items()}
               for s in range(SDSGD_STEPS)]
    mark("state")
    # the process's first forward and backward (library handles, kernel
    # modules) on one short sequence, before the timed steps
    warm = {k: v[:, :1, :16] for k, v in batches[0].items()}
    grad_fn = torch.func.vmap(torch.func.grad_and_value(trainer._loss_fn(cfg)))
    grad_fn(state0.params, warm)
    torch.cuda.synchronize(dev)
    mark("warm")
    job = jobs[rank].get()
    mark("job")
    topo = Topology(world, [tuple(e) for e in job["edges"]], np.asarray(job["g"]), "ba")
    sched = schedule_from_topology(topo)
    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    step_fn = make_sharded_train_step(cfg, sched, opt_update, mesh)
    gossip_ms, to_host_ms, to_device_ms, captured = [], [], [], []
    orig_shard = trainer.gossip_shard

    def spy(tree, sched_, axis):
        # step 1's leaves wait on the host while the steps run
        if not captured:
            captured.append(_flat(tree).cpu())
        out = orig_shard(tree, sched_, axis)
        if len(captured) == 1:
            captured.append(_flat(out).cpu())
        return out

    trainer.gossip_shard = spy
    origs = [_timed(trainer, "gossip_shard", gossip_ms, dev),
             _timed(gossip, "_to_host", to_host_ms, dev),
             _timed(gossip, "_to_device", to_device_ms, dev)]
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    # the start waits on the host while the steps run (8 ranks share the card)
    host0 = tree_map(lambda t: t.to("cpu"), state0)
    state, state0, step_ms, losses, at = state0, None, [], [], []
    torch.cuda.synchronize(dev)
    dist.barrier()
    mark("train")
    for s in range(SDSGD_STEPS):
        at.append((len(gossip_ms), len(to_host_ms), len(to_device_ms)))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if s == 0:     # step 1's params are captured[1]
            momentum1 = tree_map(lambda t: t.to("cpu"), state.opt.momentum)
    mark("trained")
    at.append((len(gossip_ms), len(to_host_ms), len(to_device_ms)))
    launches = kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev))
    for (owner, attr), orig in zip(((trainer, "gossip_shard"), (gossip, "_to_host"),
                                    (gossip, "_to_device")), origs):
        setattr(owner, attr, orig)
    trainer.gossip_shard = orig_shard
    per_step = [dict(step_ms=step_ms[s], gossip_ms=sum(gossip_ms[a[0]:b[0]]),
                     to_host_ms=sum(to_host_ms[a[1]:b[1]]),
                     to_device_ms=sum(to_device_ms[a[2]:b[2]]),
                     to_device_copies=b[2] - a[2])
                for s, (a, b) in enumerate(zip(at, at[1:]))]

    # the elastic step from the same start: no faults, a dropped straggler,
    # a dead rank
    del state
    state0 = tree_map(lambda t: t.to(dev), host0)
    elastic = make_elastic_sharded_train_step(cfg, sched, opt_update, mesh)
    ws, wr = (torch.from_numpy(a).to(dev) for a in schedule_weight_arrays(sched))
    ones = torch.ones(world, device=dev)
    drop, dead = ones.clone(), ones.clone()
    drop[SDSGD_STRAGGLER] = 0.0
    dead[SDSGD_DEAD] = 0.0
    e_free, mf = elastic(state0, batches[0], ones, ones, ws, wr)
    free_bitwise = (_bits_equal(_flat(e_free.params).cpu(), captured[1])
                    and _same_bits(tree_map(lambda t: t.cpu(), e_free.opt.momentum), momentum1)
                    and float(mf["loss"]) == losses[0])
    del e_free
    e_drop, md = elastic(state0, batches[0], ones, drop, ws, wr)
    straggler = _flat(e_drop.params).cpu()
    del e_drop
    e_dead, mdead = elastic(state0, batches[0], dead, dead, ws, wr)
    frozen = _same_bits(e_dead.params, state0.params) and _same_bits(e_dead.opt.momentum,
                                                                     state0.opt.momentum)
    del e_dead
    mark("elastic")
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(state0.params).values())
    del state0, batches
    torch.cuda.empty_cache()
    # CUDA IPC shares fixed-size segments: the hand-over's buffers get their own
    _expandable_segments(False)
    pre, post, momentum, straggler = (x.to(dev) for x in (captured[0], captured[1],
                                                          _flat(momentum1), straggler))
    del captured, momentum1
    # the parent collects step 1's pre- and post-gossip leaves, its momentum
    # and the straggler run's params through a torch.multiprocessing queue:
    # they travel as CUDA IPC handles (no copy), so each rank keeps its own
    # alive until the parent has checked them
    share.put((rank, dict(pre=pre, post=post, momentum=momentum, straggler=straggler)))
    jobs[rank].get()
    mark("released")
    del pre, post, momentum, straggler
    out = dict(rank=rank, device=str(dev), losses=losses, per_step=per_step, peak_bytes=peak,
               launches=launches, param_bytes=param_bytes,
               bytes_sent_per_step=int(sched.degrees[rank]) * param_bytes,
               rounds_active=sum(gossip._peers(p, rank)[0] is not None for p in sched.perms),
               elastic=dict(faultfree_bitwise=free_bitwise, dead_frozen=frozen,
                            losses=dict(faultfree=float(mf["loss"]), straggler=float(md["loss"]),
                                        dead=float(mdead["loss"]))),
               marks=marks)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _sdsgd_checks(gathered: dict, stacked: dict, leaf_slices: dict, topo, sched, drop,
                  world: int, dev) -> dict:
    """The parent's checks of main_sharded_dsgd on the collected (n, M) leaves:
    step 1's gossip and the straggler run's participants bitwise the
    stacked oracle (:func:`_stacked_rounds`), the straggler's row its local
    update; step 1's gossip within ``_batched_check``'s bound of the plain
    padded-table mix of the stacked step's kernel route on the same
    pre-gossip leaves, and the straggler's participants within ``_within``'s
    bound of the degraded W's dense mix; then step 1 against the parent's
    stacked ``dsgd_train_step``, leaf by leaf, before the gossip and after
    it (max |Δ| in bf16 ulps at the leaf's largest magnitude, ‖Δ‖/‖p‖ and
    the share of equal bits), and step 1's momentum against the stacked
    step's (:func:`_rel_rows`, leaf by leaf: the bf16 params' update lies
    below one ulp of most elements, the float32 momentum does not)."""
    from repro_torch.dsgd.chaos import degrade_matrix
    from repro_torch.dsgd.gossip import padded_neighbors

    t0 = time.perf_counter()
    X = gathered["pre"].to(dev)
    want = _stacked_rounds(X, sched)
    post = gathered["post"].to(dev)
    rows_equal = [_bits_equal(want[i], post[i]) for i in range(world)]
    out = dict(step1_bitwise=all(rows_equal), step1_rows_bitwise=rows_equal)
    del want
    W = torch.tensor(topo.W, dtype=torch.float32, device=dev)
    e, ok = _batched_check(post, X, *padded_neighbors(W))
    out["step1_vs_plain_mix"] = dict(max_abs_err=e, within=ok)
    got = gathered["straggler"].to(dev)
    want = _stacked_rounds(X, sched, mix=drop)
    rows = [i for i in range(world) if i != SDSGD_STRAGGLER]
    out["straggler_participants_bitwise"] = all(_bits_equal(want[i], got[i]) for i in rows)
    out["straggler_keeps_its_update"] = _bits_equal(got[SDSGD_STRAGGLER], X[SDSGD_STRAGGLER])
    del want
    # the degraded W's dense mix in float32: the reference's own check
    Wd = degrade_matrix(W, drop, torch.ones_like(W))
    deg = int(max(sched.degrees))
    errs, ok = [], True
    for i in rows:
        dense = _mix_rows(X, Wd, i, lambda x: x.float())
        terms = _mix_rows(X, Wd.abs(), i, lambda x: x.float().abs())
        e, o = _within(got[i], dense.to(got.dtype), terms, deg)
        errs.append(e)
        ok = ok and o
    out.update(straggler_vs_dense_max_abs_err=max(errs), straggler_vs_dense_within=ok)
    del got
    mom = gathered["momentum"]
    theirs = stacked["momentum"]
    out["momentum_rel"] = {
        name: _rel_rows(mom[:, off:off + size], theirs[:, off:off + size].to(dev))
        for name, (off, size) in leaf_slices.items()}
    del mom, theirs
    out["vs_stacked"] = {}
    for what, mine_all in (("pre_gossip", X), ("params", post)):
        theirs_all = stacked[what].to(dev)
        leaves = {}
        for name, (off, size) in leaf_slices.items():
            a = mine_all[:, off:off + size].float()
            b = theirs_all[:, off:off + size].float()
            err = (a - b).abs()
            _, ex = torch.frexp(b.abs().max())
            ulp = float(torch.ldexp(torch.ones(()), ex.cpu() - 8))
            leaves[name] = dict(max_abs_err=float(err.max()), ulps=float(err.max()) / ulp,
                                rel_diff=float((a - b).norm() / b.norm()),
                                share_bitwise=float((err == 0).float().mean()))
            del a, b, err
        out["vs_stacked"][what] = dict(leaves=leaves,
                                       max_ulps=max(r["ulps"] for r in leaves.values()))
        del theirs_all
    out["checks_s"] = time.perf_counter() - t0
    return out


def phase_main_sharded_dsgd() -> dict:
    """DSGD with one worker a rank: main_dsgd's cluster (smollm-135m at full
    width, BA n = 8, r = 16 from main_dsgd's cache, 4 × 256 random tokens a
    worker) as 8 gloo ranks spawned on the one card, SDSGD_STEPS steps of
    ``make_sharded_train_step`` (the schedule's matching rounds as
    point-to-point sends, staged through pinned host memory by gloo). While
    the ranks start, this process runs the stacked ``dsgd_train_step``
    (kernel route) from the same start and batch, and two controls of step
    1's momentum from that start: the optimizer's momentum from a zero
    gradient and from the gradient of half of each worker's batch. Pins:
    step 1's gossip on every rank bitwise the stacked oracle's
    (:func:`_stacked_rounds` on the collected pre-gossip leaves) and within
    ``_batched_check``'s bound of the kernel route's plain mix; step 1's
    pre-gossip leaves and params within SDSGD_ULPS of the stacked step's,
    its momentum (with SGD-momentum the first gradient, float32) within
    SDSGD_MOMENTUM_RTOL of the stacked step's by relative norm, leaf by leaf
    and row by row, with both controls beyond it; the loss near log(vocab)
    and within SDSGD_LOSS_RTOL of the stacked step's; the elastic step
    without faults bitwise the plain step, a dead rank frozen bitwise, a
    dropped straggler's participants bitwise the elastic oracle and within
    ``_within``'s bound of the degraded W's dense mix; no kernel launched in
    the ranks (their gossip is torch ops); gloo's staging ran."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    from repro_torch.configs import get_arch
    from repro_torch.dsgd import dsgd_train_step, init_dsgd_state, schedule_from_topology, trainer
    from repro_torch.dsgd.schedule import bytes_per_sync
    from repro_torch.launch import steps
    from repro_torch.optim import sgd_momentum

    t_phase = time.perf_counter()
    n = DSGD_WORKERS
    # 8 ranks of a full-width step fill the card: the parent keeps no cache
    torch.cuda.empty_cache()
    parent_bytes = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    shutil.rmtree(SDSGD_DIR, ignore_errors=True)
    SDSGD_DIR.mkdir(parents=True)
    spawn = mp.get_context("spawn")
    jobs, share = [spawn.SimpleQueue() for _ in range(n)], spawn.SimpleQueue()
    ranks = mp.start_processes(_sdsgd_rank, nprocs=n, join=False, start_method="spawn",
                               args=(n, f"file://{SDSGD_DIR / 'rendezvous'}", jobs, share,
                                     str(SDSGD_DIR)))
    try:
        # the stacked step from the same start, while the ranks start
        dev = torch.device("cuda")
        topo = steps.topology_for(n, "ba", 16, 0, device="cuda", cache_path=TOPO_CACHE)
        cfg = get_arch("smollm-135m")
        opt_init, opt_update = sgd_momentum(SDSGD_LR)
        t0 = time.perf_counter()
        start = init_dsgd_state(SDSGD_SEED, cfg, n, opt_init, device=dev)
        per = [_sdsgd_batch(0, i, n, cfg.vocab_size) for i in range(n)]
        batch = {k: torch.cat([b[k] for b in per]).to(dev) for k in per[0]}
        mix, pre = trainer.gossip_sim_tree, []
        trainer.gossip_sim_tree = lambda tree, *a, **kw: pre.append(
            {k: v.clone() for k, v in _leaves(tree).items()}) or mix(tree, *a, **kw)
        try:
            state, m = dsgd_train_step(cfg, topo, opt_update, device=dev)(start, batch)
        finally:
            trainer.gossip_sim_tree = mix
        stacked_loss = float(m["loss"])
        # the controls' momentum against the stacked step's, on the card
        momentum = _leaves(state.opt.momentum)
        grad_fn = torch.func.vmap(torch.func.grad_and_value(trainer._loss_fn(cfg)))
        opt_fn = torch.func.vmap(opt_update)
        g_half, _ = grad_fn(start.params, {k: v[:, :SDSGD_BATCH // 2] for k, v in batch.items()})
        controls = {}
        with torch.no_grad():
            for what, g in (("half_batch", g_half), ("zero", tree_map(torch.zeros_like, g_half))):
                got = _leaves(opt_fn(g, start.opt, start.params)[1].momentum)
                controls[what] = {k: _rel_rows(got[k], momentum[k]) for k in momentum}
                del got
        del g_half, start
        # on the host while the ranks train: 8 ranks share the card
        stacked = {what: torch.cat([x.reshape(n, -1) for x in tree.values()], dim=1).cpu()
                   for what, tree in (("pre_gossip", pre[0]), ("params", _leaves(state.params)),
                                      ("momentum", momentum))}
        leaf_slices, off = {}, 0
        for name, x in _leaves(state.params).items():
            leaf_slices[name] = (off, x[0].numel())
            off += x[0].numel()
        stacked_s = time.perf_counter() - t0
        del state, m, batch, pre, momentum
        torch.cuda.empty_cache()
        for q in jobs:
            q.put(dict(edges=[list(e) for e in topo.edges], g=np.asarray(topo.g)))
        # the card's least free memory while the ranks train, sampled here
        parts, card_free = {}, torch.cuda.mem_get_info()[0]
        while len(parts) < n:
            card_free = min(card_free, torch.cuda.mem_get_info()[0])
            if not ranks.join(timeout=0) and not share.empty():
                r, t = share.get()
                parts[r] = t
            elif time.perf_counter() - t_phase > SDSGD_TIMEOUT_S:
                raise TimeoutError(f"main_sharded_dsgd: {len(parts)} of {n} ranks reported "
                                   f"after {SDSGD_TIMEOUT_S} s")
            else:
                time.sleep(0.05)
        t_collected = time.perf_counter() - t_phase
        gathered = {k: torch.stack([parts[r][k] for r in range(n)]) for k in parts[0]}
        del parts
        drop = torch.ones(n, device=dev)
        drop[SDSGD_STRAGGLER] = 0.0
        checks = _sdsgd_checks(gathered, stacked, leaf_slices, topo,
                               schedule_from_topology(topo), drop, n, dev)
        del gathered, stacked
        torch.cuda.empty_cache()
        for q in jobs:
            q.put("checked")
        while not ranks.join(timeout=1.0):
            if time.perf_counter() - t_phase > SDSGD_TIMEOUT_S:
                raise TimeoutError(f"main_sharded_dsgd: ranks still running after "
                                   f"{SDSGD_TIMEOUT_S} s")
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    outs = [pickle.loads((SDSGD_DIR / f"rank{k}.pkl").read_bytes()) for k in range(n)]
    shutil.rmtree(SDSGD_DIR, ignore_errors=True)
    sched = schedule_from_topology(topo)
    o0 = outs[0]
    mean_ms = {k: [float(np.mean([o["per_step"][s][k] for o in outs])) for s in range(SDSGD_STEPS)]
               for k in ("step_ms", "gossip_ms", "to_host_ms", "to_device_ms")}
    momentum_check = dict(
        rtol=SDSGD_MOMENTUM_RTOL, leaves=checks.pop("momentum_rel"),
        controls={what: dict(leaves=c, min=min(c.values())) for what, c in controls.items()})
    momentum_check["max"] = max(momentum_check["leaves"].values())
    out = dict(
        arch="smollm-135m", workers=n, world=n, backend="gloo",
        rank_devices=[o["device"] for o in outs], batch=SDSGD_BATCH, seq=SDSGD_SEQ,
        steps=SDSGD_STEPS, topology=topo.name, edges=len(topo.edges), rounds=sched.rounds,
        degrees=[int(d) for d in sched.degrees], param_bytes=o0["param_bytes"],
        bytes_per_sync=dict(bytes_per_sync(sched, o0["param_bytes"]),
                            per_rank=[o["bytes_sent_per_step"] for o in outs]),
        losses=o0["losses"], stacked_step1_loss=stacked_loss, stacked_s=stacked_s,
        mean_ms=mean_ms, peak_bytes=[o["peak_bytes"] for o in outs],
        parent_bytes=parent_bytes, card_min_free_bytes=card_free,
        card_total_bytes=torch.cuda.mem_get_info()[1], collected_s=t_collected,
        marks_s={k: max(o["marks"].get(k, 0.0) for o in outs) for k in o0["marks"]},
        per_rank=[dict(rank=o["rank"], per_step=o["per_step"], rounds_active=o["rounds_active"])
                  for o in outs],
        elastic=[o["elastic"] for o in outs], checks=checks, momentum=momentum_check,
        launches=o0["launches"], wall_s=time.perf_counter() - t_phase)
    emit("main_sharded_dsgd", **out)
    assert all(np.isfinite(o["losses"]).all() and o["losses"] == o0["losses"] for o in outs), \
        "main_sharded_dsgd: ranks disagree on the loss"
    assert abs(o0["losses"][0] - np.log(cfg.vocab_size)) <= 0.5, o0["losses"]
    assert abs(o0["losses"][0] - stacked_loss) <= SDSGD_LOSS_RTOL * abs(stacked_loss), \
        (o0["losses"][0], stacked_loss)
    assert checks["step1_bitwise"], checks
    assert checks["straggler_participants_bitwise"] and checks["straggler_keeps_its_update"] \
        and checks["straggler_vs_dense_within"], checks
    assert checks["step1_vs_plain_mix"]["within"], checks["step1_vs_plain_mix"]
    for what in ("pre_gossip", "params"):
        assert checks["vs_stacked"][what]["max_ulps"] <= SDSGD_ULPS, checks["vs_stacked"][what]
    assert momentum_check["max"] <= SDSGD_MOMENTUM_RTOL, momentum_check
    assert all(c["min"] > SDSGD_MOMENTUM_RTOL for c in momentum_check["controls"].values()), \
        momentum_check
    assert all(o["elastic"]["faultfree_bitwise"] for o in outs), [o["elastic"] for o in outs]
    assert outs[SDSGD_DEAD]["elastic"]["dead_frozen"], outs[SDSGD_DEAD]["elastic"]
    assert not any(any(o["launches"].values()) for o in outs), [o["launches"] for o in outs]
    assert all(s["to_device_copies"] > 0 for o in outs for s in o["per_step"]
               if o["rounds_active"]), "gloo staging never ran"
    return out


# ---------------------------------------------------------------------------
# phase 11a′: tensor parallelism inside a worker, on DTensor
# ---------------------------------------------------------------------------

TPD_ARCH = "qwen1.5-0.5b"
TPD_WORLD = 4                   # data = 2 × model = 2
TPD_BATCH, TPD_SEQ = 4, 256     # cut from train_4k's 128 × 4,096 a worker
TPD_STEPS = 2
TPD_ACCUM = 2
TPD_SEED = 0
TPD_TIMEOUT_S = 400
TPD_DIR = ROOT / "build" / "chip_smoke" / "main_tp_dsgd"
#: each step against its comparison from the same start: params in bf16
#: ulps at the leaf's largest magnitude, momentum by ‖Δ‖/‖m‖ a leaf and
#: worker (SDSGD_ULPS, SDSGD_MOMENTUM_RTOL: the same bf16 noise, here of
#: the partial sums that the row-parallel products all-reduce in bf16)
TPD_ULPS = SDSGD_ULPS
TPD_MOMENTUM_RTOL = SDSGD_MOMENTUM_RTOL
TPD_LOSS_RTOL = 1e-3


def _tpd_batch(step: int, n: int, vocab: int, batch: int = TPD_BATCH) -> dict:
    """(n, batch, seq) random tokens of ``step`` (numpy, from the seed), the
    labels the next tokens."""
    tok = np.random.default_rng((TPD_SEED, 28, step)).integers(
        0, vocab, size=(n, batch, TPD_SEQ + 1), dtype=np.int64).astype(np.int32)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tok[..., :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(tok[..., 1:]))}


def _tpd_shard(x):
    """(local shard, its slice of the global tensor) of a DTensor on this
    rank, or None where a rank of lower coordinate on a replicated mesh dim
    holds the same shard. Even shards, the first mesh dim outermost."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    if any(c and not p.is_shard() for c, p in zip(coord, x.placements)):
        return None
    size, off = list(x.shape), [0] * x.dim()
    for i, p in enumerate(x.placements):
        if p.is_shard():
            size[p.dim] //= mesh.size(i)
            off[p.dim] += coord[i] * size[p.dim]
    return x.to_local(), tuple(slice(o, o + k) for o, k in zip(off, size))


def _tpd_rank(rank: int, world: int, init: str, jobs, share, out_dir: str) -> None:
    """One rank of main_tp_dsgd (spawned; all four share ``cuda:0`` over
    gloo). Three steps on the mesh, each timed with its DTensor collectives
    counted (``CommDebugMode``): ``build_step`` on a data × model mesh (the
    standard plan, two steps from ``init_dsgd_state``), the TP step of one
    pod-sized worker on the same mesh (accumulating), and the W-matmul step
    on a pod × data × model mesh. After each, rank 0 gathers the full
    params and momentum (``full_tensor``) and hands them to the parent (CUDA
    IPC), keeping them alive until the parent has checked them. The ranks
    build their step while the parent runs the comparisons, and allocate
    their states once it has left the card."""
    import datetime
    import pickle

    import torch.distributed as dist

    t_start = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_start

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TPD_TIMEOUT_S))
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.dsgd import (gossip, init_dsgd_state, make_matmul_gossip_train_step,
                                  make_tp_train_step, stack_workers, trainer)
    from repro_torch.dsgd.tensor_parallel import place_tree
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import DistPlan, batch_specs, tree_param_specs
    from repro_torch.optim import sgd_momentum

    mark("ready")
    dev = resolve_device("cuda")
    cfg = get_arch(TPD_ARCH)
    opt_init, opt_update = sgd_momentum(0.05)     # build_step's optimizer
    mesh = make_host_mesh(2, 2)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    gossip_ms, to_host_ms, to_device_ms = [], [], []
    origs = [_timed(trainer, "gossip_shard", gossip_ms, dev),
             _timed(gossip, "_to_host", to_host_ms, dev),
             _timed(gossip, "_to_device", to_device_ms, dev)]
    out = dict(rank=rank, device=str(dev), runs={})

    def timed(label, fn, *args):
        at = (len(gossip_ms), len(to_host_ms), len(to_device_ms))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            res = fn(*args)
        loss = float(res[1]["loss"])
        torch.cuda.synchronize(dev)
        out["runs"][label] = dict(
            step_ms=1e3 * (time.perf_counter() - t0), loss=loss,
            dtensor_collectives={str(k): v for k, v in comm.get_comm_counts().items()},
            gossip_ms=sum(gossip_ms[at[0]:]), to_host_ms=sum(to_host_ms[at[1]:]),
            to_device_ms=sum(to_device_ms[at[2]:]), to_device_copies=len(to_device_ms) - at[2])
        return res

    def hand_over(label, state, stacked: bool):
        """This rank's shards of the params and momentum, each with its
        slice of the full (n, ...) leaf, to the parent (CUDA IPC, no copy),
        kept alive until the parent has checked them; a shard that other
        ranks hold too goes from one of them."""
        shards = {}
        for what, tree in (("params", state.params), ("momentum", state.opt.momentum)):
            for name, x in _leaves(tree).items():
                got = _tpd_shard(x)
                if got is not None:
                    local, sl = got
                    shards[(what, name)] = ((local, sl) if stacked else
                                            (local.unsqueeze(0), (slice(0, 1),) + sl))
        share.put((label, rank, shards))
        jobs[rank].get()
        del shards
        mark(f"{label}_checked")

    # 1. build_step on data × model: the standard plan
    t0 = time.perf_counter()
    built = steps.build_step(TPD_ARCH, "train_4k", mesh)
    out["build_step_s"] = time.perf_counter() - t0
    out["meta"] = dict(built.meta)
    out["plan"] = dataclasses.asdict(built.plan)
    n = built.meta["n_workers"]
    # one worker's start, drawn on the host while the parent runs the
    # comparisons, and kept there for the later steps
    host1 = init_dsgd_state(TPD_SEED, cfg, 1, opt_init, device="cpu")
    mark("host_state")
    jobs[rank].get()           # the parent's comparisons have left the card
    mark("go")

    def start_of(k: int):
        return trainer.DSGDState(*(stack_workers(tree_map(lambda t: t[0].to(dev), tree), k)
                                   for tree in (host1.params, host1.opt)),
                                 host1.step.to(dev))

    state = start_of(n)
    batches = [{k: v.to(dev) for k, v in _tpd_batch(s, n, cfg.vocab_size).items()}
               for s in range(TPD_STEPS)]
    mark("state")
    state, _ = timed("build_step/1", built.fn, state, batches[0])
    mark("step1")
    hand_over("build_step", state, True)
    state, _ = timed("build_step/2", built.fn, state, batches[1])
    mark("step2")
    del state, batches
    torch.cuda.empty_cache()

    # 2. one pod-sized worker, TP over data × model, accumulating
    plan = DistPlan(gossip_axes=(), tensor_axes=("data", "model"), batch_axes=("data",),
                    n_workers=1)
    one = trainer.DSGDState(*(tree_map(lambda t: t[0].to(dev), tree)
                              for tree in (host1.params, host1.opt)), host1.step.to(dev))
    b = {k: v[0].to(dev) for k, v in _tpd_batch(0, 1, cfg.vocab_size).items()}
    placed = trainer.DSGDState(
        place_tree(one.params, mesh, tree_param_specs(one.params, plan, mesh)),
        place_tree(one.opt, mesh, tree_param_specs(one.opt, plan, mesh)), one.step)
    bp = place_tree(b, mesh, batch_specs(cfg, plan, mesh,
                                         {k: tuple(v.shape) for k, v in b.items()}))
    del one, b
    st, _ = timed("tp", make_tp_train_step(cfg, opt_update, accum_steps=TPD_ACCUM), placed, bp)
    del placed, bp
    mark("tp")
    hand_over("tp", st, False)
    del st
    torch.cuda.empty_cache()

    # 3. the W-matmul step on pod × data × model
    mesh3 = DeviceMesh("cuda", torch.arange(world).reshape(2, 1, 2),
                       mesh_dim_names=("pod", "data", "model"))
    plan3 = DistPlan(gossip_axes=("pod",), tensor_axes=("data", "model"), batch_axes=("data",),
                     n_workers=2)
    topo = steps.topology_for(2, device=dev)
    start = start_of(2)
    b3 = {k: v.to(dev) for k, v in _tpd_batch(0, 2, cfg.vocab_size).items()}
    placed = trainer.DSGDState(
        place_tree(start.params, mesh3, tree_param_specs(start.params, plan3, mesh3, stacked=True)),
        place_tree(start.opt, mesh3, tree_param_specs(start.opt, plan3, mesh3, stacked=True)),
        start.step)
    bp = place_tree(b3, mesh3, batch_specs(cfg, plan3, mesh3,
                                           {k: tuple(v.shape) for k, v in b3.items()},
                                           stacked=True))
    del start, b3
    st, _ = timed("matmul", make_matmul_gossip_train_step(cfg, topo, opt_update), placed, bp)
    del placed, bp
    mark("matmul")
    hand_over("matmul", st, True)
    del st
    for (owner, attr), orig in zip(((trainer, "gossip_shard"), (gossip, "_to_host"),
                                    (gossip, "_to_device")), origs):
        setattr(owner, attr, orig)
    # the kernels registered for the functional all-gather on CUDA once the
    # TP regions have closed: torch's own, not the gloo reroute's
    dump = torch._C._dispatch_dump("_c10d_functional::all_gather_into_tensor")
    out.update(launches=kernels.launch_counts(),
               peak_bytes=(torch.cuda.max_memory_allocated(dev),
                           torch.cuda.max_memory_reserved(dev)), marks=marks,
               all_gather_cuda_after=[ln for ln in dump.splitlines() if ln.startswith("CUDA")])
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _tpd_compare(parts: list, ref: dict, zero_start: set) -> dict:
    """A step's shards (one dict a rank of (what, leaf) → (shard, slice))
    against its comparison's full (n, ...) leaves on the host, leaf by
    leaf: params in bf16 ulps at the leaf's largest magnitude, ‖Δ‖/‖p‖ and
    the share of equal bits; momentum by ‖Δ‖/‖m‖ a worker (the row sums
    of squares added over the shards). Leaves that start at zero (norm
    scales, biases) are −lr·m after one step: their params are held by
    ‖Δ‖/‖p‖ as the momentum is, the others by ulps. The sums stay on the
    card until every shard is in (one copy to the host a leaf)."""
    acc: dict = {}
    dev = next(iter(parts[0].values()))[0].device
    for shards in parts:
        for (what, name), (a, sl) in shards.items():
            r = acc.get((what, name))
            if r is None:                        # each leaf to the card once, whole
                full = ref[what][name].to(dev)
                n = full.shape[0]
                r = acc[(what, name)] = dict(
                    full=full, amax=full.abs().max().float(), count=0,
                    err=torch.zeros((), device=dev), eq=torch.zeros((), dtype=torch.int64,
                                                                    device=dev),
                    dd=torch.zeros(n, device=dev), bb=torch.zeros(n, device=dev))
            b = r["full"][sl]
            a, b = a.float(), b.float()
            d = (a - b).reshape(a.shape[0], -1)
            r["err"] = torch.maximum(r["err"], d.abs().max())
            r["eq"] += (d == 0).sum()
            r["count"] += d.numel()
            r["dd"][sl[0]] += d.square().sum(dim=1)
            r["bb"][sl[0]] += b.reshape(b.shape[0], -1).square().sum(dim=1)
            del a, b, d
    out = {"params": {}, "momentum": {}}
    for (what, name), r in acc.items():
        del r["full"]
        err, eq, amax, dd, bb = (r[k].cpu() for k in ("err", "eq", "amax", "dd", "bb"))
        if what == "momentum":
            out["momentum"][name] = float((dd / bb).sqrt().max())
            continue
        _, ex = torch.frexp(amax)
        ulp = float(torch.ldexp(torch.ones(()), ex - 8))
        out["params"][name] = dict(ulps=float(err) / ulp, zero_start=name in zero_start,
                                   rel_diff=float((dd.sum() / bb.sum()).sqrt()),
                                   share_bitwise=int(eq) / r["count"])
    p = out["params"]
    out["max_ulps"] = max(v["ulps"] for v in p.values() if not v["zero_start"])
    out["max_zero_start_rel"] = max(v["rel_diff"] for v in p.values() if v["zero_start"])
    out["max_momentum_rel"] = max(out["momentum"].values())
    return out


def phase_main_tp_dsgd() -> dict:
    """Tensor parallelism inside a worker, on DTensor: qwen1.5-0.5b at full
    width (24 layers, d 1,024, 16/16 heads, d_ff 2,816, vocab 151,936,
    bf16) on 4 gloo ranks spawned on the one card, one spawn (NCCL refuses
    two ranks on one card). The ranks run (1) ``build_step(qwen1.5-0.5b,
    train_4k, data=2 × model=2)``: the standard plan (gossip over "data",
    TP over "model", n = 2, topology pair, 1 round), 2 steps of its ``fn``
    from ``init_dsgd_state``, the batch cut from train_4k's 128 × 4,096 a
    worker to TPD_BATCH × TPD_SEQ random tokens (no bigram table); (2)
    ``make_tp_train_step`` of one pod-sized worker on the same ranks
    (tensor dims ("data", "model"), TPD_ACCUM microbatches), one step; (3)
    ``make_matmul_gossip_train_step`` on a pod=2 × data=1 × model=2 mesh,
    one step. Meanwhile this process runs their comparisons from the same
    starts and batches: the stacked ``dsgd_train_step`` (n = 2, kernel
    route) with main_sharded_dsgd's two controls of step 1's momentum (a zero gradient,
    half of each worker's batch), the TP step unsharded (plain tensors,
    accumulation included) and the W-matmul step unsharded. Pins: each
    step's params within TPD_ULPS bf16 ulps and its momentum within
    TPD_MOMENTUM_RTOL of its comparison's, the controls beyond it; the
    losses finite, equal on every rank, near log(vocab) and within
    TPD_LOSS_RTOL of the comparison's; gloo's staging ran in the gossip; no
    kernel launched in the ranks."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    from repro_torch.configs import get_arch
    from repro_torch.dsgd import (dsgd_train_step, init_dsgd_state, make_matmul_gossip_train_step,
                                  make_tp_train_step, trainer)
    from repro_torch.launch import steps
    from repro_torch.optim import sgd_momentum

    t_phase = time.perf_counter()
    world = TPD_WORLD
    torch.cuda.empty_cache()
    shutil.rmtree(TPD_DIR, ignore_errors=True)
    TPD_DIR.mkdir(parents=True)
    spawn = mp.get_context("spawn")
    jobs, share = [spawn.SimpleQueue() for _ in range(world)], spawn.SimpleQueue()
    ranks = mp.start_processes(_tpd_rank, nprocs=world, join=False, start_method="spawn",
                               args=(world, f"file://{TPD_DIR / 'rendezvous'}", jobs, share,
                                     str(TPD_DIR)))
    try:
        dev = torch.device("cuda")
        cfg = get_arch(TPD_ARCH)
        opt_init, opt_update = sgd_momentum(0.05)
        topo = steps.topology_for(2, device="cuda")
        t0 = time.perf_counter()
        refs, losses = {}, {}
        host = lambda t: {k: v.cpu() for k, v in _leaves(t).items()}
        # (1) the stacked dsgd_train_step and its controls
        start = init_dsgd_state(TPD_SEED, cfg, 2, opt_init, device=dev)
        zero_start = {k for k, v in _leaves(start.params).items() if not bool(v.any())}
        batch = {k: v.to(dev) for k, v in _tpd_batch(0, 2, cfg.vocab_size).items()}
        st, m = dsgd_train_step(cfg, topo, opt_update, device=dev)(start, batch)
        losses["build_step"] = float(m["loss"])
        momentum = _leaves(st.opt.momentum)
        grad_fn = torch.func.vmap(torch.func.grad_and_value(trainer._loss_fn(cfg)))
        opt_fn = torch.func.vmap(opt_update)
        g_half, _ = grad_fn(start.params, {k: v[:, :TPD_BATCH // 2] for k, v in batch.items()})
        controls = {}
        with torch.no_grad():
            for what, g in (("half_batch", g_half), ("zero", tree_map(torch.zeros_like, g_half))):
                got = _leaves(opt_fn(g, start.opt, start.params)[1].momentum)
                controls[what] = {k: _rel_rows(got[k], momentum[k]) for k in momentum}
                del got
        del g_half
        refs["build_step"] = dict(params=host(st.params), momentum=host(st.opt.momentum))
        del st, momentum
        # (3) the W-matmul step unsharded, from the same start and batch
        st, m = make_matmul_gossip_train_step(cfg, topo, opt_update)(start, batch)
        losses["matmul"] = float(m["loss"])
        refs["matmul"] = dict(params=host(st.params), momentum=host(st.opt.momentum))
        del st, start, batch
        # (2) the TP step unsharded: one worker, accumulating
        one = init_dsgd_state(TPD_SEED, cfg, 1, opt_init, device=dev)
        one = trainer.DSGDState(tree_map(lambda x: x[0], one.params),
                                tree_map(lambda x: x[0], one.opt), one.step)
        b = {k: v[0].to(dev) for k, v in _tpd_batch(0, 1, cfg.vocab_size).items()}
        st, m = make_tp_train_step(cfg, opt_update, accum_steps=TPD_ACCUM)(one, b)
        losses["tp"] = float(m["loss"])
        refs["tp"] = dict(params={k: v.unsqueeze(0) for k, v in host(st.params).items()},
                          momentum={k: v.unsqueeze(0) for k, v in host(st.opt.momentum).items()})
        del st, one, b
        refs_s, refs_at = time.perf_counter() - t0, time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        for q in jobs:
            q.put("go")
        checks, parts, card_free, check_s = {}, {}, torch.cuda.mem_get_info()[0], {}
        while len(checks) < 3:
            card_free = min(card_free, torch.cuda.mem_get_info()[0])
            if not ranks.join(timeout=0) and not share.empty():
                label, _, shards = share.get()
                parts.setdefault(label, []).append(shards)
                del shards
                if len(parts[label]) == world:
                    t_in = time.perf_counter() - t_phase
                    checks[label] = _tpd_compare(parts.pop(label), refs.pop(label), zero_start)
                    check_s[label] = (t_in, time.perf_counter() - t_phase)
                    torch.cuda.ipc_collect()       # the ranks' shared blocks, released
                    torch.cuda.empty_cache()
                    for q in jobs:
                        q.put("checked")
            elif time.perf_counter() - t_phase > TPD_TIMEOUT_S:
                raise TimeoutError(f"main_tp_dsgd: {len(checks)} of 3 hand-overs after "
                                   f"{TPD_TIMEOUT_S} s")
            else:
                time.sleep(0.05)
        while not ranks.join(timeout=1.0):
            if time.perf_counter() - t_phase > TPD_TIMEOUT_S:
                raise TimeoutError(f"main_tp_dsgd: ranks still running after {TPD_TIMEOUT_S} s")
        joined_s = time.perf_counter() - t_phase
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    outs = [pickle.loads((TPD_DIR / f"rank{k}.pkl").read_bytes()) for k in range(world)]
    shutil.rmtree(TPD_DIR, ignore_errors=True)
    o0 = outs[0]
    controls = {what: dict(min=min(c.values()), leaves=c) for what, c in controls.items()}
    out = dict(
        arch=TPD_ARCH, world=world, backend="gloo", rank_devices=[o["device"] for o in outs],
        batch=TPD_BATCH, seq=TPD_SEQ, steps=TPD_STEPS, accum_steps=TPD_ACCUM,
        meta=o0["meta"], plan=o0["plan"], build_step_s=o0["build_step_s"],
        comparison_losses=losses, comparisons_s=refs_s, checks=checks,
        momentum_controls=controls, momentum_rtol=TPD_MOMENTUM_RTOL, ulps=TPD_ULPS,
        per_rank=[dict(rank=o["rank"], runs=o["runs"], peak_bytes=o["peak_bytes"])
                  for o in outs],
        card_min_free_bytes=card_free, card_total_bytes=torch.cuda.mem_get_info()[1],
        marks_s={k: max(o["marks"].get(k, 0.0) for o in outs) for k in o0["marks"]},
        launches=[o["launches"] for o in outs],
        all_gather_cuda_after=o0["all_gather_cuda_after"],
        check_s={k: dict(in_at=a, done_at=b) for k, (a, b) in check_s.items()},
        refs_done_at_s=refs_at, ranks_joined_at_s=joined_s, wall_s=time.perf_counter() - t_phase)
    emit("main_tp_dsgd", **out)
    meta = o0["meta"]
    assert (meta["n_workers"], meta["topology"], meta["rounds"], meta["gossip_impl"]) == \
        (2, "pair", 1, "ppermute-schedule"), meta
    assert o0["plan"]["gossip_axes"] == ("data",) and o0["plan"]["tensor_axes"] == ("model",), \
        o0["plan"]
    for label, run in o0["runs"].items():
        ls = [o["runs"][label]["loss"] for o in outs]
        assert np.isfinite(ls).all() and len(set(ls)) == 1, (label, ls)
        assert abs(ls[0] - np.log(cfg.vocab_size)) <= 0.5, (label, ls)
    for label, key in (("build_step/1", "build_step"), ("tp", "tp"), ("matmul", "matmul")):
        got, want = o0["runs"][label]["loss"], losses[key]
        assert abs(got - want) <= TPD_LOSS_RTOL * abs(want), (label, got, want)
    for label, c in checks.items():
        assert c["max_ulps"] <= TPD_ULPS, (label, c)
        assert c["max_zero_start_rel"] <= TPD_MOMENTUM_RTOL, (label, c)
        assert c["max_momentum_rel"] <= TPD_MOMENTUM_RTOL, (label, c)
    assert all(c["min"] > TPD_MOMENTUM_RTOL for c in controls.values()), controls
    assert not any(any(o["launches"].values()) for o in outs), [o["launches"] for o in outs]
    assert not any("tensor_parallel.py" in ln for o in outs
                   for ln in o["all_gather_cuda_after"]), o0["all_gather_cuda_after"]
    assert all(o["runs"][s]["to_device_copies"] > 0 for o in outs
               for s in ("build_step/1", "build_step/2")), "gloo staging never ran"
    return out

# ---------------------------------------------------------------------------
# phase 11b: elastic DSGD training at full width, through the launcher
# ---------------------------------------------------------------------------

ELASTIC_ARGS = ["--elastic", "--churn-events", "1", "--drift-step", "6", "--slow-nodes", "2",
                "--slow-bw", "1.0", "--straggler-prob", "0.1", "--p-drop", "0.05",
                "--steps", "12"]
ELASTIC_PROFILE_ROUND = 4       # a steady round: no drift, re-solve or adoption


def _elastic_step_timings(leaves: dict, W_eff, topo_W) -> dict:
    """The elastic step's mix of the 11 leaves at n = 8 through
    ``deg_cap = 7`` tables (weights gathered from the degraded matrix,
    padded slots 0), one launch a leaf as the elastic step mixes, against
    the BA topology's max-degree tables (row 4's shape) and the dense
    ``torch.matmul(W_eff, x)``; the tiled kernel's, the first-cut witness
    kernel's and the library's times from CUDA graphs of 10 steps, the
    eager call of the kernel and the plain version eagerly (the plain
    neighbour gather allocates GBs)."""
    from repro_torch.dsgd.gossip import (elastic_neighbor_tables, gather_neighbor_weights,
                                         padded_neighbors)
    from repro_torch.kernels.gossip_mix import ops as gm

    n = DSGD_WORKERS
    idx, mask = elastic_neighbor_tables(W_eff)
    w = gather_neighbor_weights(W_eff, idx, mask)
    pidx, pw = padded_neighbors(topo_W)
    xs = list(leaves.values())
    Wd = {x.dtype: W_eff.to(x.dtype) for x in xs}
    out = dict(
        ms=device_ms(lambda: [gm.gossip_mix_batched(x, idx, w) for x in xs], launches=10),
        max_degree_ms=device_ms(lambda: [gm.gossip_mix_batched(x, pidx, pw) for x in xs],
                                launches=10),
        witness_ms=device_ms(lambda: [gm.gossip_mix_batched_witness(x, idx, w) for x in xs],
                             launches=10),
        max_degree_witness_ms=device_ms(
            lambda: [gm.gossip_mix_batched_witness(x, pidx, pw) for x in xs], launches=10),
        library_ms=device_ms(lambda: [torch.matmul(Wd[x.dtype], x.view(n, -1)) for x in xs],
                             launches=10),
        call_ms=eager_ms(lambda: [gm.gossip_mix_batched(x, idx, w) for x in xs],
                         launches=10, warmup=2),
        plain_ms=large_timings(lambda: [gm.gossip_mix_batched_plain(x, idx, w) for x in xs],
                               None, reps=3)["ms"])
    nbytes = sum(2 * x.numel() * x.element_size() + _table_bytes(idx, w) for x in xs)
    out.update(bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes", bytes=nbytes,
               deg=int(idx.shape[1]), max_degree=int(pidx.shape[1]),
               library="torch.matmul(W_eff.to(dtype), x.view(n, -1)), all 11 leaves")
    return out


def phase_main_elastic(dsgd_run: dict) -> dict:
    """``launch.train --elastic`` at full width on the card: main_dsgd's
    arguments (smollm-135m, 8 workers, BA r=16 from the cache, batch 4, seq
    256) with churn, stragglers, packet loss and two NICs collapsing at step
    6, 12 rounds. Every round mixes through ``gossip_mix_batched`` over
    ``deg_cap = 7`` tables; the drift fires a warm re-solve on the card,
    adopted one round later. The first round's gossip is held against the
    plain version on the same pre-gossip leaves and degraded weights; round
    ``ELASTIC_PROFILE_ROUND`` runs under torch.profiler (busy, idle share,
    launches, syncs: ``profile_dsgd``'s numbers for an elastic round) and
    stays out of the steady round's mean. Then
    a fault-free ``--elastic`` run with main_dsgd's exact arguments has to
    give main_dsgd's losses and consensus errors bitwise (the reference's
    contract, ``repro/dsgd/elastic.py:13-16``)."""
    from repro_torch import kernels
    from repro_torch.dsgd import elastic
    from repro_torch.launch import train

    real_mix, real_run = elastic.gossip_mix_batched, elastic.ElasticRuntime._run
    real_round = elastic.ElasticRuntime.round
    first: list = []
    executions = [0]
    mixed_with: dict = {}
    prof: dict = {}

    def checked_mix(x, nbr_idx, weights):
        out = real_mix(x, nbr_idx, weights)
        if len(first) < SMOLLM_LEAVES:
            first.append(_first_gossip({0: out}, {0: x}, nbr_idx, weights)[0])
            mixed_with.update(deg=int(nbr_idx.shape[1]))
            if len(first) == SMOLLM_LEAVES:     # the check's scratch stays out of the peak
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
        return out

    def counted_run(self, state, batch, es, alive, link_up, mix):
        executions[0] += 1
        if "W_eff" not in mixed_with:
            from repro_torch.dsgd.chaos import degrade_matrix
            mixed_with["W_eff"] = degrade_matrix(es.W, mix, link_up)
            mixed_with["W"] = es.W
        return real_run(self, state, batch, es, alive, link_up, mix)

    def profiled_round(self, state, es, batch):
        if int(state.step) != ELASTIC_PROFILE_ROUND:
            return real_round(self, state, es, batch)
        out = []
        prof.update(_profiled(lambda: out.append(real_round(self, state, es, batch)),
                              match=("gossip_mix",)))
        return out[0]

    last = {}
    elastic.gossip_mix_batched, elastic.ElasticRuntime._run = checked_mix, counted_run
    elastic.ElasticRuntime.round = profiled_round
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = train.main(DSGD_ARGS + ELASTIC_ARGS + ["--topo-cache", str(TOPO_CACHE)],
                         on_step=lambda s, state, m: last.update(state=state))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        elastic.gossip_mix_batched, elastic.ElasticRuntime._run = real_mix, real_run
        elastic.ElasticRuntime.round = real_round
    peak = torch.cuda.max_memory_allocated()
    hist, el = res["history"], res["elastic"]
    losses = [h["loss"] for h in hist]
    frozen = {e["step"] for e in el["log"] if e["attempts"] > 1 and not np.isfinite(
        hist[e["step"]]["loss"])}
    busy = {e["step"] for e in el["events"] if e["event"] in ("reopt", "keep_incumbent")}
    steady = [ms for s, ms in enumerate(res["step_ms"])
              if s >= 2 and s not in busy and s != ELASTIC_PROFILE_ROUND]
    timing = _elastic_step_timings(_leaves(last["state"].params), mixed_with["W_eff"],
                                   mixed_with["W"])
    del last
    torch.cuda.empty_cache()

    # the fault-free elastic run with main_dsgd's arguments: bitwise its curve
    kernels.reset_launch_counts()
    clean = train.main(DSGD_ARGS + ["--elastic", "--topo-cache", str(TOPO_CACHE)])
    clean_launches = kernels.launch_counts()
    torch.cuda.empty_cache()
    keys = ("loss", "loss_max", "consensus_err")
    ref = [tuple(h[k] for k in keys) for h in dsgd_run["history"]]
    got = [tuple(h[k] for k in keys) for h in clean["history"]]
    errs = [e for e, _, _ in first]
    out = dict(arch=res["arch"], workers=DSGD_WORKERS, batch=4, seq=256, steps=len(hist),
               argv=ELASTIC_ARGS, topology=res["topology"], losses=losses,
               consensus_err=[h["consensus_err"] for h in hist],
               n_alive=[h["n_alive"] for h in hist], log=el["log"], events=el["events"],
               reopts=el["reopts"], adopted=el["adopted"], drops=el["drops"],
               final_topology=el["final_topology"],
               time_to_reopt_s=[e["time_to_reopt_s"] for e in el["events"]
                                if e["event"] == "reopt"],
               step_executions=executions[0], step_ms=res["step_ms"],
               steady_step_ms=float(np.mean(steady)),
               main_dsgd_steady_step_ms=dsgd_run["steady_step_ms"],
               max_memory_allocated_bytes=peak,
               main_dsgd_max_memory_allocated_bytes=dsgd_run["peak_bytes"],
               first_gossip_vs_plain=dict(deg=mixed_with["deg"], max_abs_err=max(errs),
                                          within=all(ok for _, ok, _ in first),
                                          equal_to_witness=all(eq for _, _, eq in first)),
               profiled_round=dict(step=ELASTIC_PROFILE_ROUND, **prof),
               wall_s=wall_s, launches=launches, kernel_timing=timing,
               fault_free_bitwise_to_main_dsgd=got == ref,
               fault_free_launches=clean_launches["gossip_mix_batched"])
    emit("main_elastic", **out)
    assert all(np.isfinite(h["loss"]) for s, h in enumerate(hist) if s not in frozen), losses
    assert el["adopted"] >= 1 and any(e["event"] == "reopt" for e in el["events"]), el["events"]
    assert launches["gossip_mix_batched"] == SMOLLM_LEAVES * executions[0], \
        (launches, executions[0])
    missing = [k for k in PATH_KERNELS["elastic"] if launches[k] == 0]
    assert not missing, f"main_elastic: kernels never launched on the path: {missing}"
    assert mixed_with["deg"] == DSGD_WORKERS - 1
    assert len(first) == SMOLLM_LEAVES and all(ok for _, ok, _ in first), \
        f"first elastic gossip differs from the plain mix: {first}"
    assert all(eq for _, _, eq in first), f"first elastic gossip is not the witness's: {first}"
    assert got == ref, f"fault-free --elastic is not main_dsgd's curve: {got} vs {ref}"
    return dict(timing, max_abs_err=max(errs), launches=launches["gossip_mix_batched"])


# ---------------------------------------------------------------------------
# phase 11c: a SIGKILLed elastic run resumed from its checkpoint, bitwise
# ---------------------------------------------------------------------------

RESUME_ARGS = ["--arch", "smollm-135m", "--workers", "4", "--topo", "ba", "--r", "8",
               "--optimizer", "sgd", "--batch", "4", "--seq", "256", "--steps", "6",
               "--log-every", "1", "--seed", "0", "--device", "cuda", "--elastic",
               "--drift-step", "4", "--ckpt-every", "3", "--topo-cache", str(TOPO_CACHE)]
RESUME_DIR = ROOT / "build" / "chip_smoke" / "elastic_resume"


def phase_elastic_resume() -> dict:
    """The launcher in subprocesses on the card at smollm-135m's full width
    (cut for disk and time: 4 workers, 6 steps, two 3.23 GB checkpoints):
    an uninterrupted elastic
    run with the NICs collapsing at step 4 (a re-solve on the card, adopted
    at step 5) and, beside it on the same card, the same run SIGKILLed
    before step 4 (``--kill-at-step``), before its re-solve; then that run
    continued with ``--resume`` from its step-4 checkpoint (the re-solve
    and the adoption in the resumed run), started as soon as the killed
    run has died, while the uninterrupted one still runs (cut for time:
    the killed run used to run the re-solve too, and the resumed run to
    wait for the uninterrupted one).
    Every logged step of the resumed run has the uninterrupted run's loss
    and consensus error bitwise (the history's floats are shortest
    round-trip reprs)."""
    import os
    import shutil
    import signal

    from repro_torch.launch import steps

    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    RESUME_DIR.mkdir(parents=True)
    steps.topology_for(4, "ba", 8, 0, device="cuda", cache_path=TOPO_CACHE)
    ck = RESUME_DIR / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}

    procs: list = []

    def start(extra: list) -> tuple:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train"] + RESUME_ARGS + extra, env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        return time.perf_counter(), procs[-1]

    def finish(tag: str, started: tuple) -> subprocess.CompletedProcess:
        t0, proc = started
        out, err = proc.communicate(timeout=600)
        runs[tag] = dict(rc=proc.returncode, wall_s=time.perf_counter() - t0)
        return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)

    def history(path) -> dict:
        with open(path) as f:
            return {h["step"]: (h["loss"], h["consensus_err"]) for h in json.load(f)["history"]}

    try:
        free = shutil.disk_usage(RESUME_DIR).free
        # the uninterrupted and the killed run share the card, side by side;
        # the resumed run starts as soon as the killed one has died, beside
        # the uninterrupted one
        first = start(["--json-out", str(RESUME_DIR / "full.json")])
        killed = finish("killed", start(["--ckpt-dir", str(ck), "--kill-at-step", "4"]))
        survived = {f.name: f.stat().st_size for f in sorted(ck.iterdir())}
        third = start(["--ckpt-dir", str(ck), "--resume",
                       "--json-out", str(RESUME_DIR / "resumed.json")])
        full, resumed = finish("uninterrupted", first), finish("resumed", third)
        assert full.returncode == 0, full.stdout[-3000:] + full.stderr[-3000:]
        assert resumed.returncode == 0, resumed.stdout[-3000:] + resumed.stderr[-3000:]
        written = {f.name: f.stat().st_size for f in sorted(ck.iterdir())}
        ref, got = history(RESUME_DIR / "full.json"), history(RESUME_DIR / "resumed.json")
        with open(RESUME_DIR / "full.json") as f:
            events = json.load(f)["elastic"]["events"]
    finally:
        for proc in procs:              # none outlives the phase, whatever failed
            proc.kill()
            proc.wait()
        shutil.rmtree(RESUME_DIR, ignore_errors=True)
    equal = {s: got[s] == ref.get(s) for s in got}
    out = dict(argv=RESUME_ARGS, runs=runs, disk_free_bytes=free,
               killed_returncode=killed.returncode, checkpoints_after_kill=survived,
               checkpoints_after_resume=written,
               resumed_line=[ln for ln in resumed.stdout.splitlines() if "resumed" in ln],
               uninterrupted=ref, resumed=got, bitwise_equal=equal, events=events)
    emit("elastic_resume", **out)
    assert killed.returncode == -signal.SIGKILL, f"killed run: returncode {killed.returncode}"
    assert survived, "no checkpoint survived the kill"
    assert sorted(got) == list(range(max(int(k[5:-4]) for k in survived), 6)), sorted(got)
    assert all(equal.values()), f"resumed curve differs: {equal}"
    assert any(e["event"] == "adopt" for e in events), events
    return out


# ---------------------------------------------------------------------------
# phase 12: serving — the two serving kernels against their plain versions
# ---------------------------------------------------------------------------

def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at |x| (zero for float32, whose bound is the
    float32 summation bound alone)."""
    if dtype == torch.float32:
        return torch.zeros_like(x)
    _, e = torch.frexp(x)
    return torch.ldexp(torch.full_like(x, torch.finfo(dtype).eps), e - 1)


def _decode_check(q, k, v, valid, cap) -> tuple[float, float, bool]:
    """Max |kernel − plain|, its largest share of the tolerance, and whether
    it is within: the float32 bound of ``decode_attention_bound`` plus, for
    a bf16 or fp16 output, one ulp at the larger result."""
    from repro_torch.kernels.decode_attention import ops as dec

    got = dec.decode_attention(q, k, v, valid, attn_softcap=cap).float()
    want = dec.decode_attention_plain(q, k, v, valid, attn_softcap=cap).float()
    tol = dec.decode_attention_bound(q, k, v, valid, attn_softcap=cap)
    tol = tol + _ulp(torch.maximum(got.abs(), want.abs()), q.dtype)
    err = (got - want).abs()
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max()), bool((err <= tol).all())


DECODE_LAYERS = 4


def _decode_case(B, C, Hq, Hkv, hd, dtype, cap, valid, gen) -> dict:
    """The kernel held against the plain version on layer 0 of a stacked
    (4, B, C, Hkv, hd) cache, as decode_step hands a layer over. Times: warm
    (one layer's slice replayed, L2-resident where it fits) and cold (the
    four layers in turn, 107 MB at main_serve_dense's shape, so each call
    reads from HBM); SDPA timed both ways at the shapes without softcap."""
    from repro_torch.kernels.decode_attention import ops as dec

    L = DECODE_LAYERS
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").to(dtype)
    ks = torch.randn((L, B, C, Hkv, hd), generator=gen, device="cuda").to(dtype)
    vs = torch.randn((L, B, C, Hkv, hd), generator=gen, device="cuda").to(dtype)
    err, share, ok = _decode_check(q, ks[0], vs[0], valid, cap)
    kern = [lambda i=i: dec.decode_attention(q, ks[i], vs[i], valid, attn_softcap=cap)
            for i in range(L)]
    library = None
    if not cap:
        mask = valid[None, None, None, :]
        library = [lambda i=i: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ks[i].transpose(1, 2), vs[i].transpose(1, 2), attn_mask=mask,
            enable_gqa=True) for i in range(L)]       # one PyTorch call of the same function
    n_valid = int(valid.sum())
    size = q.element_size()
    # q read and the output written once, K and V of the valid keys read once
    # (a masked key's values are not needed), the mask read once; the
    # q·k and p·v products are 4·hd flops per (query head, valid key)
    nbytes = 2 * B * Hq * hd * size + 2 * B * n_valid * Hkv * hd * size + C
    flops = 4 * B * Hq * n_valid * hd
    k0, v0 = ks[0], vs[0]
    warm = timings(kern[0], lambda: dec.decode_attention_plain(q, k0, v0, valid, attn_softcap=cap),
                   None if library is None else library[0])
    ms = device_ms(rotating(kern), launches=400)
    library_ms = None if library is None else device_ms(rotating(library), launches=400)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / FP32_OP_PER_S
    plan = dec.decode_plan(B, Hq, Hkv, hd, C, size,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    del ks, vs
    return dict(kernel="decode_attention", B=B, C=C, Hq=Hq, Hkv=Hkv, hd=hd,
                dtype=str(dtype).replace("torch.", ""), softcap=cap, valid_keys=n_valid,
                plan=plan._asdict(), max_abs_err=err, share_of_tol=share, within=ok,
                ms=ms, ms_warm=warm["ms"], plain_ms=warm["plain_ms"], library_ms=library_ms,
                library_ms_warm=warm["library_ms"], call_ms=warm["call_ms"],
                plain_call_ms=warm["plain_call_ms"], timed_layers=L,
                bound_ms=1e3 * max(bytes_s, ops_s),
                bound_by="operations" if ops_s > bytes_s else "bytes")


def _ssd_check(args) -> tuple[float, float, bool]:
    from repro_torch.kernels.ssd_scan import ops as ssd

    y, st = ssd.ssd_intra_chunk(*args)
    wy, wst = ssd.ssd_intra_chunk_plain(*args)
    by, bst = ssd.ssd_intra_chunk_bound(*args)
    ey, est = (y - wy).abs(), (st - wst).abs()
    share = max(float((ey / by.clamp_min(1e-30)).max()), float((est / bst.clamp_min(1e-30)).max()))
    return (max(float(ey.max()), float(est.max())), share,
            bool((ey <= by).all() and (est <= bst).all()))


def _ssd_work(Bsz, nc, Q, H, P, N, size) -> tuple[float, float, float]:
    """Bytes (inputs read once, outputs written once), the float32 FMA
    design's operations (the causal half of G and of M·x) and the
    tensor-core design's operations (G's causal half once, y and the states
    three times each: the three bf16 terms) of one call."""
    tri = Q * (Q + 1) // 2
    nbytes = (Bsz * nc * (Q * H * P * size + 2 * Q * H * 4 + 2 * Q * N * size)
              + Bsz * nc * (Q * H * P + H * P * N) * 4)
    flops = Bsz * nc * (2 * tri * N + H * (2 * tri * P + 4 * tri) + H * (2 * Q * P * N + Q * N))
    tc_ops = Bsz * nc * (2 * tri * N + 3 * H * 2 * tri * P + 3 * H * 2 * Q * P * N)
    return nbytes, flops, tc_ops


def _ssd_witness(x, dt, la, Bm, Cm):
    """The same function by cuBLAS and elementwise ops in float32 (TF32 off):
    ``torch.bmm`` for G, the masked M, ``torch.matmul`` for y and the
    states. A yardstick of what the library does with these products, not a
    single library call."""
    Bsz, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    BC = Bsz * nc
    Cf, Bf = Cm.float().reshape(BC, Q, N), Bm.float().reshape(BC, Q, N)
    G = torch.bmm(Cf, Bf.transpose(1, 2))                             # (BC, Q, Q)
    laT = la.reshape(BC, Q, H).transpose(1, 2)                        # (BC, H, Q)
    dtT = dt.reshape(BC, Q, H).transpose(1, 2)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = torch.where(causal, G[:, None] * torch.exp(laT[..., :, None] - laT[..., None, :])
                    * dtT[..., None, :], 0.0)
    xh = x.float().reshape(BC, Q, H, P).transpose(1, 2)               # (BC, H, Q, P)
    y = torch.matmul(M, xh)
    w = torch.exp(laT[..., -1:] - laT) * dtT                          # (BC, H, Q)
    st = torch.matmul((xh * w[..., None]).transpose(2, 3), Bf[:, None])
    return y, st


def _ssd_registers(dtype) -> list:
    """``nvcc -Xptxas -v`` of the kernel the dtype's route launches."""
    from repro_torch.kernels import build

    want = "tc_kernel" if dtype == torch.bfloat16 else \
        {torch.float32: "kernelIfE", torch.float16: "kernelI6__halfE"}[dtype]
    return [dict(r, kernel=r["kernel"][-60:]) for r in
            build.parse_ptxas(build.ptxas_logs.get("ssd_scan", "")) if want in r["kernel"]]


def _ssd_case(Bsz, Q, H, P, N, dtype, gen, strided: bool, nc: int = 1) -> dict:
    """``nc`` chunks of a sequence in one call, as the model calls the
    kernel (one launch a layer). With ``strided`` x, B and C are column
    slices of one (B, nc·Q + Q, d_inner + 2N) conv output, as in
    mamba2_forward."""
    from repro_torch.kernels.ssd_scan import ops as ssd

    di = H * P
    xbc = torch.randn((Bsz, nc * Q + Q, di + 2 * N), generator=gen, device="cuda").to(dtype)
    chunk = xbc[:, :nc * Q].unflatten(1, (nc, Q))
    if not strided:
        chunk = chunk.contiguous()
    x = chunk[..., :di].unflatten(-1, (H, P))
    Bm, Cm = chunk[..., di:di + N], chunk[..., di + N:]
    dt = torch.nn.functional.softplus(torch.randn((Bsz, nc, Q, H), generator=gen,
                                                  device="cuda"))
    A = -torch.rand(H, generator=gen, device="cuda") - 0.05
    la = torch.cumsum(A * dt, dim=2)
    if not strided:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    args = (x, dt, la, Bm, Cm)
    err, share, ok = _ssd_check(args)
    plan = ssd.kernel_plan(Q, H, P, N, dtype)
    nbytes, flops, tc_ops = _ssd_work(Bsz, nc, Q, H, P, N, x.element_size())
    big = nc * Q * H >= 4096
    t = (large_timings if big else timings)(lambda: ssd.ssd_intra_chunk(*args),
                                            lambda: ssd.ssd_intra_chunk_plain(*args))
    if big:                       # the kernel itself from a CUDA graph
        t["ms"] = device_ms(lambda: ssd.ssd_intra_chunk(*args), launches=200 // nc)
        t["witness_ms"] = large_timings(lambda: _ssd_witness(*args), None)["ms"]
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = (tc_ops / BF16_OP_PER_S if plan["route"] == "tensor_core"
             else flops / FP32_OP_PER_S)
    return dict(kernel="ssd_intra_chunk", B=Bsz, nc=nc, Q=Q, H=H, P=P, N=N,
                dtype=str(dtype).replace("torch.", ""), strided=strided,
                route=plan["route"], plan=plan, ptxas=_ssd_registers(dtype),
                max_abs_err=err, share_of_tol=share, within=ok, **t,
                bound_ms=1e3 * max(bytes_s, ops_s),
                bound_by="operations" if ops_s > bytes_s else "bytes",
                bytes_bound_ms=1e3 * bytes_s, ops_bound_ms=1e3 * ops_s,
                fp32_fma_bound_ms=1e3 * flops / FP32_OP_PER_S, flops=flops,
                tc_ops=tc_ops, bytes=nbytes)


def phase_serve_kernels() -> tuple[dict, dict]:
    """decode_attention at main_serve_dense's shape (B 16, C 2184, 9/3 heads,
    hd 64, bf16, the valid keys of decode step 64), with a valid key only in
    the last slot, at gemma2-9b's shape (B 4, C 4224, 16/8 heads, hd 256,
    softcap 50, a 4,096 window that masks the early positions) in bf16 and
    fp32, and at a ring-cache mask; ssd_intra_chunk at main_serve_ssm's shape
    (B 8, Q 256, H 48, P 64, N 128, bf16: the tensor-core route) as the
    model hands it over (column slices) and contiguous, its four chunks in
    one launch, in fp32 (the CUDA-core route), at the reduced shape (Q 32,
    H 8, P 32, N 16, fp32, three chunks) and ragged (Q 50, P 30, N 18,
    bf16). Then each serving family's shapes, with the valid keys of decode
    step 64: decode_attention at granite-moe-1b-a400m's (B 16, C 1,096,
    16/8 heads, hd 64, bf16), internvl2-1b's (B 16, C 1,096, 14/2 heads: a
    group of 7, bf16), whisper-tiny's (B 16, C 200, 6/6 heads, fp32) and
    zamba2-2.7b's (B 8, C 1,096, 32/32 heads, hd 80, bf16; and in fp32), and
    ssd_intra_chunk at zamba2's prefill (B 8, Q 256, H 80, P 64, N 64,
    bf16, its four chunks in one launch, column slices). Returns the
    main-shape case per kernel, and the families' cases by path."""
    from repro_torch.models.attention import decode_valid

    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = [
        _decode_case(16, 2184, 9, 3, 64, torch.bfloat16, 0.0,
                     decode_valid(2184, 2048 + 64, device="cuda"), gen),
        _decode_case(16, 2184, 9, 3, 64, torch.bfloat16, 0.0,
                     torch.arange(2184, device="cuda") == 2183, gen),
        _decode_case(4, 4224, 16, 8, 256, torch.bfloat16, 50.0,
                     decode_valid(4224, 4200, 4096, device="cuda"), gen),
        _decode_case(4, 4224, 16, 8, 256, torch.float32, 50.0,
                     decode_valid(4224, 4200, 4096, device="cuda"), gen),
        _decode_case(4, 4096, 16, 8, 256, torch.bfloat16, 50.0,
                     decode_valid(4096, 2500, ring=True, device="cuda"), gen),
        _ssd_case(8, 256, 48, 64, 128, torch.bfloat16, gen, strided=True),
        _ssd_case(8, 256, 48, 64, 128, torch.bfloat16, gen, strided=False),
        _ssd_case(8, 256, 48, 64, 128, torch.bfloat16, gen, strided=True, nc=4),
        _ssd_case(2, 32, 8, 32, 16, torch.float32, gen, strided=True, nc=3),
        _ssd_case(2, 50, 5, 30, 18, torch.bfloat16, gen, strided=False, nc=3),
        _ssd_case(8, 256, 48, 64, 128, torch.float32, gen, strided=True),
    ]
    families = {
        "serve_moe": _decode_case(16, 1096, 16, 8, 64, torch.bfloat16, 0.0,
                                  decode_valid(1096, 1024 + 64, device="cuda"), gen),
        "serve_vlm": _decode_case(16, 1096, 14, 2, 64, torch.bfloat16, 0.0,
                                  decode_valid(1096, 1024 + 64, device="cuda"), gen),
        "serve_audio": _decode_case(16, 200, 6, 6, 64, torch.float32, 0.0,
                                    decode_valid(200, 64 + 64, device="cuda"), gen),
        "serve_hybrid": _decode_case(8, 1096, 32, 32, 80, torch.bfloat16, 0.0,
                                     decode_valid(1096, 1024 + 64, device="cuda"), gen),
        "serve_hybrid_ssd": _ssd_case(8, 256, 80, 64, 64, torch.bfloat16, gen, strided=True,
                                      nc=4),
    }
    cases += list(families.values()) + [
        _decode_case(8, 1096, 32, 32, 80, torch.float32, 0.0,
                     decode_valid(1096, 1024 + 64, device="cuda"), gen)]
    torch.cuda.synchronize()
    emit("serve_kernel_checks", cases=cases,
         library_note="decode_attention: torch.nn.functional.scaled_dot_product_attention("
                      "enable_gqa=True, boolean mask), at the shapes without softcap; ms and "
                      "library_ms cold (4 layer slices of one stacked cache in turn), "
                      "ms_warm and library_ms_warm one slice replayed; "
                      "ssd_intra_chunk: no single PyTorch call computes it; witness_ms is "
                      "torch.bmm for G, the masked M, torch.matmul for y and the states "
                      "(float32 cuBLAS), a yardstick; bound: the larger of bytes at 3.35 TB/s "
                      "and the route's operations (tensor_core: G once, y and states three "
                      "times, at 989 TFLOP/s bf16; cuda_core: float32 FMA at 67 TFLOP/s)")
    bad = [c for c in cases if not c["within"]]
    assert not bad, f"serving kernels outside their tolerance: {bad}"
    return {"decode_attention": cases[0], "ssd_intra_chunk": cases[5]}, families


# ---------------------------------------------------------------------------
# phase 13: serving at full width through the launcher
# ---------------------------------------------------------------------------

SERVE_DENSE_ARGS = ["--arch", "smollm-135m", "--batch", "16", "--prompt-len", "2048",
                    "--max-new", "128", "--seed", "0", "--device", "cuda"]
SERVE_SSM_ARGS = ["--arch", "mamba2-780m", "--batch", "8", "--prompt-len", "1024",
                  "--max-new", "64", "--seed", "0", "--device", "cuda"]


def _serve(label: str, argv: list, path: str, expected: dict, checked: dict) -> dict:
    """One launcher run with every kernel count from 0: each kernel of
    ``expected`` launched exactly that many times, every kernel of
    ``PATH_KERNELS[path]`` at least once, the tokens in [0, vocab).
    ``checked`` holds each kernel's first launch, held against the plain
    version on the same inputs (the checks' own calls are not counted)."""
    from repro_torch import kernels
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    toks = np.array(res["tokens"])
    batch, new = int(argv[argv.index("--batch") + 1]), int(argv[argv.index("--max-new") + 1])
    vocab = res["vocab_size"]
    out = {k: res[k] for k in ("arch", "param_count", "cache_len", "prefill_ms",
                               "steady_step_ms", "tokens_per_s", "decode_tokens_per_s",
                               "max_memory_allocated_bytes", "wall_s")}
    out.update(batch=batch, generated_per_request=res["generated_per_request"],
               step_ms_min=min(res["step_ms"]), step_ms_max=max(res["step_ms"]),
               first_tokens=toks[:2, :8].tolist(), launches=launches, wall_s_outer=wall_s,
               first_launch_vs_plain=checked)
    emit(label, **out)
    assert toks.shape == (batch, new) and (toks >= 0).all() and (toks < vocab).all(), \
        f"{label}: tokens of shape {toks.shape} outside [0, {vocab})"
    for kernel, per_run in expected.items():
        assert launches[kernel] == per_run, f"{label}: {kernel} launched {launches[kernel]} " \
                                            f"times, expected {per_run}"
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    assert not missing, f"{label}: kernels never launched on the path: {missing}"
    for kernel, record in checked.items():
        assert record.get("within"), f"{label}: the first {kernel} launch is outside " \
                                     f"its tolerance: {record}"
    return dict(res=res, launches=launches)


@contextlib.contextmanager
def _first_launch_checked(owner, attr: str, name: str, check):
    """For the block, ``owner.<attr>`` (the kernel's ops module as a model
    module holds it) becomes a namespace whose ``name`` launches the kernel
    and, on its first call only, records ``check(*args, **kw)``: the kernel
    held against its plain version on the path's own inputs, that check's
    launch taken off the count. Yields the record."""
    ops = getattr(owner, attr)
    real = getattr(ops, name)
    record: dict = {}

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        if not record:
            n = real.launches
            record.update(check(*args, **kw))
            real.launches = n
        return out

    setattr(owner, attr, types.SimpleNamespace(**{name: wrapped}))
    try:
        yield record
    finally:
        setattr(owner, attr, ops)


def _decode_first_check(q, k, v, valid, *, attn_softcap=0.0) -> dict:
    err, share, ok = _decode_check(q, k, v, valid, attn_softcap)
    return dict(max_abs_err=err, share_of_tol=share, within=ok, C=int(k.shape[1]),
                valid_keys=int(valid.sum()), hd=int(q.shape[-1]))


def _ssd_first_check(*args) -> dict:
    err, share, ok = _ssd_check(args)
    # the check's own scratch (the plain version's Q×Q×H blocks) stays out
    # of the serving peak: the later chunks and layers reach the same peak
    # as this one
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return dict(max_abs_err=err, share_of_tol=share, within=ok,
                x_strides=list(args[0].stride()))


def _serve_checked(label: str, argv: list, path: str, expected: dict) -> dict:
    """:func:`_serve` with the first launch of each expected kernel held
    against its plain version on the path's own inputs."""
    from repro_torch.models import attention, ssm

    hooks = {"decode_attention": (attention, "_dec_ops", _decode_first_check),
             "ssd_intra_chunk": (ssm, "_ssd_ops", _ssd_first_check)}
    with contextlib.ExitStack() as stack:
        checked = {kernel: stack.enter_context(_first_launch_checked(
            hooks[kernel][0], hooks[kernel][1], kernel, hooks[kernel][2]))
            for kernel in expected}
        return _serve(label, argv, path, expected, checked)


def phase_serve_dense() -> dict:
    """smollm-135m at full width: 30 decode_attention launches per decode
    step, 127 steps. The first launch (layer 0 of the first decode step, on
    the real cache) is also held against the plain version."""
    return _serve_checked("main_serve_dense", SERVE_DENSE_ARGS, "serve_dense",
                          {"decode_attention": 30 * 127})


#: main_serve_ssm's time to first token with the CUDA-core SSD kernel
#: launched once per chunk (an earlier run, NVIDIA H100 80GB HBM3, 700 W),
#: printed beside this run's; the two runs are on different machines.
SSM_TTFT_MS_BEFORE = 371.4


def phase_serve_ssm() -> dict:
    """mamba2-780m at full width: one ssd_intra_chunk launch per layer of
    the prefill over its four chunks, 48 in all. The first launch (layer 0,
    the model's strided slices) is also held against the plain version, and
    the peak memory is counted from just after that check."""
    out = _serve_checked("main_serve_ssm", SERVE_SSM_ARGS, "serve_ssm",
                         {"ssd_intra_chunk": 48})
    emit("serve_ssm_ttft", ttft_ms=out["res"]["prefill_ms"],
         ttft_ms_one_launch_per_chunk=SSM_TTFT_MS_BEFORE,
         note="the second from an earlier run on another machine")
    return out


#: The four other families served at full width through the launcher:
#: label → (path, launcher arguments, exact launches of each path kernel).
#: decode_attention runs once a self-attention layer a decode step (the
#: first token comes from the prefill): granite 24 layers and internvl2 24
#: over 63 steps, whisper's decoder 4 over 127, zamba2's shared block 9
#: times (54 / 6) over 63; zamba2's prefill launches ssd_intra_chunk once
#: a Mamba-2 layer (its four chunks' float32 outputs, ~52 MB, fit one call).
SERVE_FAMILY_RUNS = {
    "main_serve_moe": ("serve_moe", ["--arch", "granite-moe-1b-a400m", "--batch", "16",
                                     "--prompt-len", "1024", "--max-new", "64"],
                       {"decode_attention": 24 * 63}),
    "main_serve_vlm": ("serve_vlm", ["--arch", "internvl2-1b", "--batch", "16",
                                     "--prompt-len", "768", "--max-new", "64"],
                       {"decode_attention": 24 * 63}),
    "main_serve_audio": ("serve_audio", ["--arch", "whisper-tiny", "--batch", "16",
                                         "--prompt-len", "64", "--max-new", "128"],
                         {"decode_attention": 4 * 127}),
    "main_serve_hybrid": ("serve_hybrid", ["--arch", "zamba2-2.7b", "--batch", "8",
                                           "--prompt-len", "1024", "--max-new", "64"],
                          {"decode_attention": 9 * 63, "ssd_intra_chunk": 54}),
}


def phase_serve_family(label: str) -> dict:
    """One of the moe, vlm, audio and hybrid families at full width through
    the launcher (random weights from seed 0, the stub frontends' embeddings
    from the prompts' generator), every first kernel launch held against its
    plain version; then, on the launcher's own weights, one prefill and one
    decode step under torch.profiler, each after an unprofiled warm-up."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    path, args, expected = SERVE_FAMILY_RUNS[label]
    made = {}
    real = transformer.init_params

    def keep(seed, cfg):
        made.update(params=real(seed, cfg), cfg=cfg)
        return made["params"]

    transformer.init_params = keep
    try:
        out = _serve_checked(label, args + ["--seed", "0", "--device", "cuda"], path, expected)
    finally:
        transformer.init_params = real
    torch.cuda.empty_cache()
    cfg, params = made["cfg"], tree_map(lambda t: t.cuda(), made.pop("params"))
    B, S, new = (int(args[args.index(f) + 1]) for f in ("--batch", "--prompt-len", "--max-new"))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))).cuda()}
    extra = serve.stub_frontend(cfg, rng, B)
    if extra:
        batch["embeds"] = torch.from_numpy(extra["embeds"]).cuda()
    cap = serve.default_cache_len(cfg, S, new)
    state = {}

    def prefill():
        logits, state["caches"] = transformer.prefill(params, cfg, batch, cache_cap=cap)
        state["tok"] = logits[:, -1].argmax(-1)[:, None]
        return state["tok"].cpu()                        # the first token, on the host

    def step(pos):
        logits, _ = transformer.decode_step(params, cfg, state["tok"], state["caches"], pos)
        return logits[:, -1].argmax(-1).cpu()

    match = ("decode_attention", "ssd_intra_chunk", "gemm")
    prefill()
    prof_prefill = _profiled(prefill, match=match)
    pos = S + (cfg.frontend_tokens if cfg.arch_type == "vlm" else 0)
    step(pos)
    prof_step = _profiled(lambda: step(pos + 1), match=match)
    emit("profile_" + label.removeprefix("main_"), arch=cfg.name, batch=B, prompt=S,
         cache_len=cap, prefill=prof_prefill, decode_step=prof_step)
    del params, state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: serving on the card against the CPU
# ---------------------------------------------------------------------------

SERVE_CARD_VS_CPU = (("smollm-135m", False, 24), ("gemma2-9b", True, 24),
                     ("mamba2-780m", False, 70), ("granite-moe-1b-a400m", False, 24),
                     ("internvl2-1b", False, 24), ("whisper-tiny", False, 24),
                     ("zamba2-2.7b", False, 70))


def phase_serve_card_vs_cpu() -> None:
    """Reduced fp32 models of the six families — smollm, gemma2 (long
    context: every layer windowed, a ring cache of the 16-token window under
    a 24-token prompt), mamba2, granite-moe, internvl2 (8 stub patch
    embeddings), whisper (8 stub frames) and zamba2 — with the same weights,
    prompts and embeddings on the card (kernels) and on the CPU (plain
    versions). The four later families get a cache of the positions plus 8,
    so the decode steps append. Prefill logits and the logits of 8 decode
    steps agree within 1e-5 relative to their largest magnitude, and the
    greedy tokens are equal. With the CPU against the JAX package
    (tests/test_torch_serve.py, test_torch_ssm.py, test_torch_families.py)
    this closes the chain JAX ⇄ port (CPU) ⇄ port (card)."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.launch.serve import stub_frontend
    from repro_torch.models import transformer

    rows = []
    for arch, long_context, S in SERVE_CARD_VS_CPU:
        cfg = reduced_for_smoke(get_arch(arch))
        params = transformer.init_params(0, cfg)
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, S)).astype(np.int64))
        extra = stub_frontend(cfg, rng, 2)
        prefix = cfg.frontend_tokens if cfg.arch_type == "vlm" else 0
        cache_cap = None if cfg.arch_type in ("dense", "ssm") else S + prefix + 8
        runs = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev), params)
            batch = {"tokens": prompts.to(dev)}
            if extra:
                batch["embeds"] = torch.from_numpy(extra["embeds"]).to(dev)
            kernels.reset_launch_counts()
            logits, caches = transformer.prefill(p, cfg, batch, cache_cap=cache_cap,
                                                 long_context=long_context)
            seq, toks = [logits.float().cpu()], []
            for t in range(8):
                tok = logits[:, -1].argmax(-1)[:, None]
                toks.append(tok.cpu())
                logits, caches = transformer.decode_step(p, cfg, tok, caches, S + prefix + t,
                                                         long_context=long_context)
                seq.append(logits.float().cpu())
            runs[dev] = (seq, torch.cat(toks, 1), kernels.launch_counts())
        (gseq, gtok, glaunch), (cseq, ctok, _) = runs["cuda"], runs["cpu"]
        rel = max(float((g - c).abs().max()) / float(c.abs().max()) for g, c in zip(gseq, cseq))
        rows.append(dict(arch=cfg.name, family=cfg.arch_type, long_context=long_context,
                         prompt=S, logits_max_rel_diff=rel,
                         tokens_equal=bool(torch.equal(gtok, ctok)), tokens=gtok.tolist(),
                         launches_cuda={k: v for k, v in glaunch.items() if v}))
    emit("serve_card_vs_cpu", rows=rows)
    for r in rows:
        assert r["logits_max_rel_diff"] <= 1e-5, f"serve card vs CPU {r['arch']}: {r}"
        assert r["tokens_equal"], f"serve card vs CPU {r['arch']}: tokens differ"
        path = {"ssm": "serve_ssm", "hybrid": "serve_hybrid"}.get(r["family"], "serve_dense")
        for kernel in PATH_KERNELS[path]:
            assert r["launches_cuda"].get(kernel, 0) > 0, f"{r['arch']}: {kernel} never launched"


# ---------------------------------------------------------------------------
# phase 15: where a full-width decode step's time goes
# ---------------------------------------------------------------------------

def phase_profile_serve() -> None:
    """One decode step of main_serve_dense (smollm-135m, B 16, a 2,184-slot
    cache filled by a 2,048-token prefill) under torch.profiler, after one
    unprofiled warm-up step."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer

    cfg = get_arch("smollm-135m")
    params = tree_map(lambda t: t.cuda(), transformer.init_params(0, cfg))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (16, 2048)).astype(np.int64)).cuda()
    logits, caches = transformer.prefill(params, cfg, {"tokens": prompts}, cache_cap=2184)
    tok = logits[:, -1].argmax(-1)[:, None]
    logits, caches = transformer.decode_step(params, cfg, tok, caches, 2048)
    tok = logits[:, -1].argmax(-1)[:, None]
    prof = _profiled(lambda: transformer.decode_step(params, cfg, tok, caches, 2049),
                     match=("decode_attention",))
    emit("profile_serve", arch=cfg.name, batch=16, cache_len=2184, pos=2049, step=prof)


def phase_profile_prefill() -> None:
    """One mamba2-780m prefill at main_serve_ssm's width (batch 8, 1,024-token
    prompts) under torch.profiler, after one unprofiled warm-up prefill:
    busy and idle share, launches, top kernels, and ssd_intra_chunk's share
    of the device time."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer

    cfg = get_arch("mamba2-780m")
    params = tree_map(lambda t: t.cuda(), transformer.init_params(0, cfg))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (8, 1024)).astype(np.int64)).cuda()

    def prefill():
        logits, _ = transformer.prefill(params, cfg, {"tokens": prompts})
        return logits[:, -1].argmax(-1).cpu()          # the first token, on the host

    prefill()
    prof = _profiled(prefill, match=("ssd_intra_chunk",))
    emit("profile_prefill", arch=cfg.name, batch=8, prompt=1024, prefill=prof)
    del params


# ---------------------------------------------------------------------------
# phase 15b: DSGD training of the moe, vlm, audio, ssm and hybrid families
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
#: label → (path, arch, workers, layers kept (None: all)). n = 8 where the
#: workers fit one card, else 4; where 4 do not fit at full depth the depth
#: is cut and the run drives the launcher's ``init_dsgd_state`` /
#: ``dsgd_train_step`` on the cut config itself (the launcher has no depth
#: flag). Peaks on an NVIDIA H100 80GB HBM3 (700 W, 85.0 GB): granite 12
#: layers 50.8 GB, 16 layers 67.3 GB once and out of memory in another run
#: (22.7 GiB of the cache reserved but unallocated); mamba2 16 layers 55.9
#: GB, 24 out of memory; zamba2 6 layers 45.3 GB, 12 out of memory (whole
#: groups of 6 Mamba-2 layers and the shared block); internvl2 20 layers
#: 67.3 GB, full depth 79.3 GB. Each cut leaves the allocator ~17 GB or
#: more. internvl2 runs last: its 151,655-word bigram table takes longest.
TRAIN_FAMILY_RUNS = {
    "main_train_moe": ("train_moe", "granite-moe-1b-a400m", 4, 12),
    "main_train_audio": ("train_audio", "whisper-tiny", 8, None),
    "main_train_ssm": ("train_ssm", "mamba2-780m", 4, 16),
    "main_train_hybrid": ("train_hybrid", "zamba2-2.7b", 4, 6),
    "main_train_vlm": ("train_vlm", "internvl2-1b", 4, 20),
}
#: The vocabularies whose bigram tables the training phases read (smollm's,
#: then the five families'), each built in a process of its own from the
#: start of the run, the largest first.
TABLE_VOCABS = (151655, 49152, 49155, 51865, 50280, 32000)
_TABLE_BUILDS: dict = {}
_TABLE_WALLS: dict = {}


def start_table_builds(vocabs=TABLE_VOCABS) -> None:
    """One process a vocabulary, at the lowest CPU priority (the phases'
    host work comes first), each writing its table under build/bigram
    (atomically) and printing its wall as JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import json, os, sys, time; os.nice(19); t = time.perf_counter(); "
            "from repro_torch.data.pipeline import bigram_table, TABLE_STATS; "
            "v = int(sys.argv[1]); bigram_table(v, 0); "
            "print(json.dumps(dict(vocab=v, wall_s=time.perf_counter() - t, "
            "**TABLE_STATS[(v, 0)])))")
    for v in vocabs:
        _TABLE_BUILDS[v] = subprocess.Popen([sys.executable, "-c", code, str(v)], cwd=ROOT,
                                            env=env, stdout=subprocess.PIPE, text=True)


def await_table(vocab: int) -> dict:
    """Wait for the vocabulary's build process; its wall, and how long this
    run waited for it (started here if no build of it runs)."""
    if vocab not in _TABLE_WALLS:
        if vocab not in _TABLE_BUILDS:
            start_table_builds((vocab,))
        t0 = time.perf_counter()
        proc = _TABLE_BUILDS.pop(vocab)
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"bigram table {vocab}: exit {proc.returncode}"
        _TABLE_WALLS[vocab] = dict(json.loads(out.strip().splitlines()[-1]),
                                   waited_s=time.perf_counter() - t0,
                                   ready_at_s=time.perf_counter() - T0)
        emit("bigram_table", **_TABLE_WALLS[vocab])
    return _TABLE_WALLS[vocab]


def stop_table_builds() -> None:
    for proc in _TABLE_BUILDS.values():
        proc.kill()
        proc.wait()
    _TABLE_BUILDS.clear()


def _train_batches(cfg, n: int, batch: int, seq: int, step: int) -> dict:
    from repro_torch.data import DataConfig, lm_batch_numpy

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch, seed=0,
                    frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)
    per = [lm_batch_numpy(dc, step, node=i) for i in range(n)]
    return {k: torch.from_numpy(np.stack([b[k] for b in per])).cuda() for k in per[0]}


def _loss_on(cfg, params, batch) -> float:
    """The workers' mean ``train_loss`` on ``batch`` (one per worker), with
    no gradient."""
    from repro_torch.models import transformer

    with torch.no_grad():
        fn = torch.func.vmap(lambda p, b: transformer.train_loss(p, cfg, b))
        return float(fn(params, batch).mean())


def _train_cut(cfg, n: int, on_step) -> dict:
    """The launcher's loop (BA topology, SGD, warmup-cosine, one synced step
    at a time) on a depth-cut config, which the launcher has no flag for."""
    from repro_torch.dsgd import dsgd_train_step, init_dsgd_state
    from repro_torch.launch import steps
    from repro_torch.optim import make_optimizer, warmup_cosine

    topo = steps.topology_for(n, "ba", 2 * n, 0, device="cuda", cache_path=TOPO_CACHE)
    init, upd = make_optimizer("sgd", warmup_cosine(0.05, max(TRAIN_STEPS // 20, 1),
                                                    TRAIN_STEPS))
    step = dsgd_train_step(cfg, topo, upd, device="cuda")
    state = init_dsgd_state(0, cfg, n, init, device="cuda")
    history, step_ms = [], []
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, _train_batches(cfg, n, 4, 256, s))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        on_step(s, state, metrics)
        history.append({k: float(v) for k, v in metrics.items()})
    return dict(history=history, step_ms=step_ms, topology=topo.name, edges=len(topo.edges))


def _ssd_backward_check(args, gen) -> dict:
    """``ssd_intra_chunk_backward`` against autograd through the plain
    version on the path's inputs, in float32 (the gradients before their
    cast to the inputs' dtypes), with unit-normal cotangents: each gradient
    within 1e-4 of its largest magnitude."""
    from repro_torch.kernels.ssd_scan import ops as ssd

    f32 = [a.float() for a in args]
    y, st = ssd.ssd_intra_chunk_plain(*f32)
    gy = torch.randn(y.shape, generator=gen, device="cuda")
    gst = torch.randn(st.shape, generator=gen, device="cuda")
    del y, st
    got = ssd.ssd_intra_chunk_backward(*f32, gy, gst)
    leaves = [a.clone().requires_grad_() for a in f32]
    with torch.enable_grad():
        y, st = ssd.ssd_intra_chunk_plain(*leaves)
        want = torch.autograd.grad((y * gy).sum() + (st * gst).sum(), leaves)
    share = {name: float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30) / 1e-4
             for name, g, w in zip(("x", "dt", "la", "B", "C"), got, want)}
    return dict(share_of_tol=share, within=all(s <= 1.0 for s in share.values()),
                grad_tol="1e-4 of each gradient's largest magnitude, float32")


def _ssd_train_case(args) -> dict:
    """The kernel, its plain version and the backward at the training shape
    (the first launch's own inputs: the workers folded into B), timed by
    CUDA events over 10 eager calls, with the forward's bounds."""
    from repro_torch.kernels.ssd_scan import ops as ssd

    x = args[0]
    Bsz, nc, Q, H, P = x.shape
    N = args[3].shape[-1]
    plan = ssd.kernel_plan(Q, H, P, N, x.dtype)
    nbytes, flops, tc_ops = _ssd_work(Bsz, nc, Q, H, P, N, x.element_size())
    f32 = [a.float() for a in args]
    y, st = ssd.ssd_intra_chunk_plain(*f32)
    gy, gst = torch.ones_like(y), torch.ones_like(st)
    leaves = [a.clone().requires_grad_() for a in f32]

    def plain_backward():
        with torch.enable_grad():
            yy, ss = ssd.ssd_intra_chunk_plain(*leaves)
            return torch.autograd.grad((yy * gy).sum() + (ss * gst).sum(), leaves)

    n = ssd.ssd_intra_chunk.launches
    t = large_timings(lambda: ssd.ssd_intra_chunk(*args),
                      lambda: ssd.ssd_intra_chunk_plain(*args))
    bw = large_timings(lambda: ssd.ssd_intra_chunk_backward(*f32, gy, gst), plain_backward)
    ssd.ssd_intra_chunk.launches = n
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = (tc_ops / BF16_OP_PER_S if plan["route"] == "tensor_core"
             else flops / FP32_OP_PER_S)
    return dict(B=Bsz, nc=nc, Q=Q, H=H, P=P, N=N, dtype=str(x.dtype).replace("torch.", ""),
                route=plan["route"], ms=t["ms"], plain_ms=t["plain_ms"], library_ms=None,
                call_ms=t["call_ms"], backward_ms=bw["ms"], backward_plain_ms=bw["plain_ms"],
                bound_ms=1e3 * max(bytes_s, ops_s),
                bound_by="operations" if ops_s > bytes_s else "bytes")


def phase_train_family(label: str) -> dict:
    """One family at full width, 6 DSGD steps, ``--topo ba --r 2n
    --optimizer sgd --batch 4 --seq 256``: through the launcher at full
    depth, else the launcher's loop on the depth-cut config. Every kernel
    count from 0: ``gossip_mix_batched`` exactly once a dtype a step, and
    ``ssd_intra_chunk`` once a Mamba-2 layer a step (the vmap rule folds the
    workers into one launch; the backward launches nothing). The first
    gossip and the first ``ssd_intra_chunk`` (forward and backward) are held
    against their plain versions on the path's own inputs, the gossip also
    bitwise against the first-cut witness kernel. The losses are
    finite, and the first step's batch has a lower loss under the final
    weights than under the first (each step's own loss is on a fresh batch:
    over 6 steps their spread exceeds what the model learns, and the
    first step's batch enters every update through the momentum). Then
    both kernels at the run's shapes."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.graph import weight_matrix_from_weights
    from repro_torch.dsgd import trainer
    from repro_torch.dsgd.gossip import padded_neighbors
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import steps, train
    from repro_torch.models import param_count

    path, arch, n, cut = TRAIN_FAMILY_RUNS[label]
    cfg = get_arch(arch)
    full_layers = cfg.num_layers
    if cut:
        cfg = dataclasses.replace(cfg, num_layers=cut)
    table = await_table(cfg.vocab_size)
    mix, launch = trainer.gossip_sim_tree, ssd._launch
    first: dict = {}

    def checked_mix(tree, W, *, use_kernel=True, nbr=None):
        out = mix(tree, W, use_kernel=use_kernel, nbr=nbr)
        if "gossip" not in first:
            first["gossip"] = _first_gossip(_leaves(out), _leaves(tree), *nbr)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return out

    def kept_launch(*args):
        if "ssd_args" not in first:
            first["ssd_args"] = [a.detach().clone() for a in args]
        return launch(*args)

    last: dict = {}

    def keep(s, state, metrics):
        last.update(state=state)

    trainer.gossip_sim_tree, ssd._launch = checked_mix, kept_launch
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if cut:
            res = _train_cut(cfg, n, keep)
        else:
            res = train.main(["--arch", arch, "--workers", str(n), "--topo", "ba", "--r",
                              str(2 * n), "--optimizer", "sgd", "--batch", "4", "--seq",
                              "256", "--steps", str(TRAIN_STEPS), "--log-every", "1",
                              "--seed", "0", "--device", "cuda", "--topo-cache",
                              str(TOPO_CACHE)],
                             on_step=keep)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        trainer.gossip_sim_tree, ssd._launch = mix, launch
    peak = torch.cuda.max_memory_allocated()
    state = last.pop("state")
    losses = [h["loss"] for h in res["history"]]
    n_leaves = len(_leaves(state.params))
    mamba = cfg.num_layers if cfg.arch_type in ("ssm", "hybrid") else 0
    steady = float(np.mean(res["step_ms"][2:]))
    gossip_first = first.pop("gossip")
    out = dict(arch=cfg.name, family=cfg.arch_type, workers=n, layers=cfg.num_layers,
               full_layers=full_layers, depth_cut=bool(cut), batch=4, seq=256,
               steps=len(res["step_ms"]), via="dsgd_train_step" if cut else "launcher",
               param_count_per_worker=param_count(state.params) // n, leaves=n_leaves,
               step_ms=res["step_ms"], steady_step_ms=steady, losses=losses,
               first_loss=losses[0], last_loss=losses[-1],
               consensus_err=[h["consensus_err"] for h in res["history"]],
               peak_gb=peak / 1e9, max_memory_allocated_bytes=peak, wall_s=wall_s,
               bigram_table=table, launches={k: v for k, v in launches.items() if v},
               first_gossip_vs_plain=_first_summary(gossip_first))
    topo = steps.topology_for(n, "ba", 2 * n, 0, device="cuda", cache_path=TOPO_CACHE)
    if mamba:
        args = first.pop("ssd_args")
        err, share, ok = _ssd_check(args)
        out["first_ssd_vs_plain"] = dict(
            max_abs_err=err, share_of_tol=share, within=ok, x_shape=list(args[0].shape),
            backward=_ssd_backward_check(args, torch.Generator(device="cuda").manual_seed(0)))
    out["first_batch_loss_at_end"] = _loss_on(cfg, state.params,
                                              _train_batches(cfg, n, 4, 256, 0))
    ssd.ssd_intra_chunk.launches = launches["ssd_intra_chunk"]
    emit(label, **out)
    assert all(np.isfinite(losses)), f"{label}: losses {losses} not finite"
    assert out["first_batch_loss_at_end"] < losses[0], \
        f"{label}: the first step's batch has loss {out['first_batch_loss_at_end']} at the " \
        f"end, not below its {losses[0]} at the start"
    assert launches["gossip_mix_batched"] == _dtypes(state.params) * TRAIN_STEPS, launches
    assert launches["ssd_intra_chunk"] == mamba * TRAIN_STEPS, launches
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    assert not missing, f"{label}: kernels never launched on the path: {missing}"
    assert out["first_gossip_vs_plain"]["within"], f"{label}: first gossip: {gossip_first}"
    assert out["first_gossip_vs_plain"]["equal_to_witness"], \
        f"{label}: the first gossip is not the witness's: {gossip_first}"
    W = torch.tensor(weight_matrix_from_weights(topo.n, topo.edges, topo.g),
                     dtype=torch.float32, device="cuda")
    shapes = dict(gossip=dict(_gossip_step_case(state.params, W, *padded_neighbors(W)),
                              path=label,
                              launches=launches["gossip_mix_batched"],
                              max_abs_err=out["first_gossip_vs_plain"]["max_abs_err"]))
    if mamba:
        first_ssd = out["first_ssd_vs_plain"]
        assert first_ssd["within"] and first_ssd["backward"]["within"], \
            f"{label}: the first ssd_intra_chunk is outside its tolerance: {first_ssd}"
        shapes["ssd"] = dict(_ssd_train_case(args), path=label,
                             launches=launches["ssd_intra_chunk"],
                             max_abs_err=first_ssd["max_abs_err"])
        del args
    emit(label.replace("main_", "") + "_kernels", **shapes)
    del state
    torch.cuda.empty_cache()
    return dict(out, shapes=shapes)


#: (arch) of the reduced card-vs-CPU training rows: every trained family.
TRAIN_CARD_VS_CPU = ("granite-moe-1b-a400m", "mixtral-8x22b", "internvl2-1b", "whisper-tiny",
                     "mamba2-780m", "zamba2-2.7b")


def phase_train_card_vs_cpu() -> None:
    """Reduced fp32 models of the five trained families (and mixtral), n =
    4 on a ring, 3 steps from the same weights and batches (vlm and audio
    with their stub embeddings) on the card and on the CPU: the losses
    agree within 1e-4 relative (main_dsgd's check), the card's gossip and
    SSD counted. With the CPU against the JAX package
    (tests/test_torch_train_families.py) this closes the chain JAX ⇄ port
    (CPU) ⇄ port (card)."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.core.topologies import make_baseline
    from repro_torch.data import DataConfig, lm_batch_numpy
    from repro_torch.dsgd import dsgd_train_step, init_dsgd_state
    from repro_torch.optim import make_optimizer, warmup_cosine

    rows = []
    n, n_steps = 4, 3
    for arch in TRAIN_CARD_VS_CPU:
        cfg = reduced_for_smoke(get_arch(arch))
        init, upd = make_optimizer("sgd", warmup_cosine(0.05, 1, n_steps))
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4, seed=0,
                        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)
        runs = {}
        for dev in ("cuda", "cpu"):
            state = init_dsgd_state(0, cfg, n, init, device=dev)
            step = dsgd_train_step(cfg, make_baseline("ring", n), upd, device=dev)
            kernels.reset_launch_counts()
            losses = []
            for s in range(n_steps):
                per = [lm_batch_numpy(dc, s, node=i) for i in range(n)]
                bt = {k: torch.from_numpy(np.stack([b[k] for b in per])).to(dev)
                      for k in per[0]}
                state, m = step(state, bt)
                losses.append(float(m["loss"]))
            runs[dev] = (losses, kernels.launch_counts())
        (gl, glaunch), (cl, _) = runs["cuda"], runs["cpu"]
        rows.append(dict(arch=cfg.name, family=cfg.arch_type, losses_cuda=gl, losses_cpu=cl,
                         loss_max_rel_diff=max(abs(a - b) / abs(b) for a, b in zip(gl, cl)),
                         launches_cuda={k: v for k, v in glaunch.items() if v}))
    emit("train_card_vs_cpu", workers=n, steps=n_steps, rows=rows)
    for r in rows:
        assert r["loss_max_rel_diff"] <= 1e-4, f"train card vs CPU {r['arch']}: {r}"
        assert r["launches_cuda"].get("gossip_mix_batched", 0) > 0, r
        if r["family"] in ("ssm", "hybrid"):
            assert r["launches_cuda"].get("ssd_intra_chunk", 0) > 0, r


# ---------------------------------------------------------------------------
# phase 16: the §VI-B evaluation (dsgd/sim.py) on the card
# ---------------------------------------------------------------------------

SIM_N = 16
SIM_BUDGETS = (16, 24, 32)        # bench_training_time's homo edge budgets
SIM_TARGET = 0.8                  # bench_training_time's accuracy target
SIM_LEAVES = 4                    # w1, b1, w2, b2 of the 2-layer MLP
NODE_BW_16 = np.array([9.76] * 8 + [3.25] * 8)     # §VI-A2 node bandwidths, GB/s


def _sim_data(n: int, seed: int = 0):
    """bench_training_time's task: 10 classes × 400 samples at dim 64, a test
    split of 64 a class (noise seed 10,001), class-balanced over n workers."""
    from repro_torch.data import class_balanced_partition, make_classification_data

    X, y = make_classification_data(num_classes=10, dim=64, samples_per_class=400, seed=seed)
    Xte, yte = make_classification_data(num_classes=10, dim=64, samples_per_class=64,
                                        seed=seed, noise_seed=seed + 10_001)
    return X, y, class_balanced_partition(y, n, seed=seed), Xte, yte


def _paper_baselines(n: int) -> list:
    """The comparison set of benchmarks/common.py ``paper_baselines``: ring,
    grid and torus (square n), exponential, U-EquiStatic for M = 2, 3."""
    from repro_torch.core.topologies import make_baseline

    out = [make_baseline("ring", n), make_baseline("exponential", n)]
    if int(np.sqrt(n)) ** 2 == n:
        out.insert(1, make_baseline("grid", n))
        out.insert(2, make_baseline("torus", n))
    for M in (2, 3):
        try:
            t = make_baseline("equistatic", n, M=M)
        except ValueError:
            continue
        t.meta["label"] = f"u-equistatic(r={len(t.edges)})"
        out.append(t)
    return out


def _ba_topo(n: int, r: int, sa_iters: int, **request):
    """One BA-Topo solve on the card with benchmarks/common.py's config."""
    from repro_torch.core import BATopoConfig, TopologyRequest, solve_topology

    cfg = BATopoConfig(seed=0, sa_iters=sa_iters, restarts=1)
    t = solve_topology(TopologyRequest(n=n, r=r, **request), cfg=cfg).topology
    t.meta["label"] = f"ba-topo(r={len(t.edges)})"
    return t


def _ba_topos(n: int, rs, sa_iters: int) -> list:
    """BA-Topo at each budget on the card with benchmarks/common.py's
    config, the budgets as ONE batched ``solve_topologies`` call (one
    warm start a budget, one ADMM solve for all)."""
    from repro_torch.core import BATopoConfig, TopologyRequest
    from repro_torch.core.anytime import solve_topologies

    cfg = BATopoConfig(seed=0, sa_iters=sa_iters, restarts=1)
    topos = [res.topology for res in
             solve_topologies([TopologyRequest(n=n, r=r) for r in rs], cfg=cfg)]
    for t in topos:
        t.meta["label"] = f"ba-topo(r={len(t.edges)})"
    return topos


def _label(t) -> str:
    return t.meta.get("label", t.name)


def phase_main_sim():
    """bench_training_time's homo setup at n=16 on the card: the paper's
    baselines and BA-Topo at r ∈ {16, 24, 32} (solved on the card in one
    batched call: cut for time from three solves in turn), all
    trained by one ``accuracy_curves`` call (30 epochs, batch 32, lr 0.05,
    momentum 0.9, hidden 128), every step's gossip one
    ``gossip_mix_batched`` launch for all four leaves and all topologies;
    the call is timed cold (its first run in the process) and warm. Checks:
    the first gossip within the plain version's tolerance and bitwise the
    first-cut witness kernel's; the warm call repeats the curves bitwise;
    the same call on the CPU within 0.005 accuracy at every epoch; the host
    oracle on the card within 1e-6 for two topologies."""
    from repro_torch import kernels
    from repro_torch.core.bandwidth import homo_edge_bandwidth, min_edge_bandwidth, t_epoch
    from repro_torch.dsgd import sim
    from repro_torch.dsgd.sim import DSGDSimConfig, accuracy_curve_host, accuracy_curves

    n = SIM_N
    data = _sim_data(n)
    t0 = time.perf_counter()
    topos = _paper_baselines(n) + _ba_topos(n, SIM_BUDGETS, 600)
    topo_s = time.perf_counter() - t0
    Ws = np.stack([t.W for t in topos]).astype(np.float32)
    cfg = DSGDSimConfig(epochs=30, batch=32, lr=0.05, momentum=0.9, hidden=128, seed=0)
    mix, first = sim.gossip_mix_batched_leaves, {}

    def checked_mix(xs, nbr_idx, weights):
        out = mix(xs, nbr_idx, weights)
        if not first:
            first.update(_first_gossip(dict(zip(sim.LEAVES, out)), dict(zip(sim.LEAVES, xs)),
                                       nbr_idx, weights))
        return out

    sim.gossip_mix_batched_leaves = checked_mix
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        accs, iters = accuracy_curves(Ws, *data, cfg)      # ends in the host read
        wall_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        sim.gossip_mix_batched_leaves = mix
    t0 = time.perf_counter()
    again, _ = accuracy_curves(Ws, *data, cfg)             # warm: torch's kernels loaded
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu, _ = accuracy_curves(Ws, *data, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    drift = float(np.abs(accs - cpu).max())
    host_err = {}
    for k in (0, len(topos) - 1):                          # ring and BA-Topo r=32
        host, _ = accuracy_curve_host(Ws[k], *data, cfg)
        host_err[_label(topos[k])] = float(np.abs(host - accs[k]).max())
    rows = []
    for t, a in zip(topos, accs):
        epoch_ms = t_epoch(min_edge_bandwidth(homo_edge_bandwidth(t)), iters)
        hit = np.nonzero(a >= SIM_TARGET)[0]
        rows.append(dict(topology=_label(t), edges=len(t.edges), r_asym=float(t.r_asym()),
                         final_acc=float(a[-1]),
                         first_epoch_at_target=int(hit[0]) + 1 if hit.size else None,
                         epoch_ms=epoch_ms,
                         t_target_s=float((hit[0] + 1) * epoch_ms / 1e3) if hit.size else None))
    inf = float("inf")
    best_ba = min((r["t_target_s"] or inf for r in rows if "ba-topo" in r["topology"]),
                  default=inf)
    best_other = min((r["t_target_s"] or inf for r in rows
                      if "ba-topo" not in r["topology"]), default=inf)
    expected = cfg.epochs * iters              # one launch a step for all SIM_LEAVES leaves
    emit("main_sim", n=n, topologies=len(topos), epochs=cfg.epochs, iters=iters,
         batch=cfg.batch, rows=rows, best_ba_t_target_s=best_ba,
         best_baseline_t_target_s=best_other,
         speedup=best_other / best_ba if np.isfinite(best_ba) else None,
         topology_build_s=topo_s, curves_wall_s=wall_s, curves_wall_s_warm=warm_s,
         cpu_curves_wall_s=cpu_s,
         card_vs_cpu_max_acc_drift=drift, host_vs_curves_max_err=host_err,
         launches=launches, expected_gossip_launches=expected,
         first_gossip_vs_plain=_first_summary(first))
    assert accs.shape == (len(topos), cfg.epochs) and np.all(np.isfinite(accs))
    assert len(first) == SIM_LEAVES and _first_summary(first)["within"], first
    assert _first_summary(first)["equal_to_witness"], f"main_sim: not the witness's bits: {first}"
    assert np.array_equal(again, accs), "main_sim: a second call gave other curves"
    assert launches["gossip_mix_batched"] == expected, launches
    missing = [k for k in PATH_KERNELS["sim"] if launches[k] == 0]
    assert not missing, f"main_sim: kernels never launched on the path: {missing}"
    assert drift <= 0.005, f"main_sim: card vs CPU accuracy drift {drift} > 0.005"
    assert max(host_err.values()) <= 1e-6, f"main_sim: host oracle differs: {host_err}"
    return topos, data, Ws, accs, launches


def phase_sim_kernel(Ws, data) -> dict:
    """``gossip_mix_batched`` at the sim's fp32 shape: the four MLP leaves
    stacked to (T·n, M) rows (9 × 16 = 144) over main_sim's block-diagonal
    table, each against its plain version and bitwise against the first-cut
    witness kernel, timed in a CUDA graph beside the witness and
    ``torch.bmm`` of the stacked (T, n, n) W over the (T, n, M) view — the
    one PyTorch call for the same function; then the four leaves in one
    launch, as a step mixes them. Bound: x read once, the output written
    once, and the table, at the card's memory rate. Then one profiled epoch
    of main_sim's call. Returns the w1 row, with the step's."""
    from repro_torch.dsgd import sim
    from repro_torch.dsgd.dynamic import stack_cycles
    from repro_torch.kernels.gossip_mix import ops as gm

    T, n, _ = Ws.shape
    Wc, lens = stack_cycles([W[None] for W in Ws])
    idx, w = sim._Tables(Wc.astype(np.float32), lens, 1, "cuda").at(0)
    Wd = torch.from_numpy(Ws).cuda()
    p0 = sim.init_mlp(0, 64, 128, 10)
    gen = torch.Generator().manual_seed(1)
    leaves = {}
    for k in sim.LEAVES:
        shape = (T * n,) + tuple(p0[k].shape)
        leaves[k] = (torch.rand(shape, generator=gen, dtype=torch.float32) - 0.5).cuda()
    cases = []
    for k, x in leaves.items():
        got = gm.gossip_mix_batched(x, idx, w)
        err, ok = _batched_check(got, x, idx, w)
        same = torch.equal(got, gm.gossip_mix_batched_witness(x, idx, w))
        xv = x.view(T, n, -1)
        t = timings(lambda: gm.gossip_mix_batched(x, idx, w),
                    lambda: gm.gossip_mix_batched_plain(x, idx, w),
                    lambda: torch.bmm(Wd, xv))
        t["witness_ms"] = device_ms(lambda: gm.gossip_mix_batched_witness(x, idx, w))
        nbytes = 2 * x.numel() * x.element_size() + _table_bytes(idx, w)
        cases.append(dict(leaf=k, shape=list(x.shape), dtype="float32", deg=int(idx.shape[1]),
                          max_abs_err=err, within=ok, equal_to_witness=same, **t,
                          bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes"))
        assert ok, f"gossip_mix_batched at the sim shape, {k}: outside the tolerance"
        assert same, f"gossip_mix_batched at the sim shape, {k}: not the witness's bits"
    xs = list(leaves.values())
    step_t = timings(lambda: gm.gossip_mix_batched_leaves(xs, idx, w),
                     lambda: [gm.gossip_mix_batched_plain(x, idx, w) for x in xs],
                     lambda: [torch.bmm(Wd, x.view(T, n, -1)) for x in xs])
    step_t["witness_ms"] = device_ms(lambda: [gm.gossip_mix_batched_witness(x, idx, w)
                                              for x in xs])
    step_bytes = sum(2 * x.numel() * 4 for x in xs) + _table_bytes(idx, w)
    # one epoch of main_sim's call (its set-up included), under the profiler
    one = sim.DSGDSimConfig(epochs=1, batch=32, lr=0.05, momentum=0.9, hidden=128, seed=0)
    sim.accuracy_curves(Ws, *data, one)
    prof = _profiled(lambda: sim.accuracy_curves(Ws, *data, one), match=("gossip_mix",))
    iters = min(len(p) for p in data[2]) // one.batch
    emit("sim_kernel_checks", rows=T * n, topologies=T, cases=cases,
         whole_step=dict(**step_t, bound_ms=1e3 * step_bytes / HBM_BYTES_PER_S,
                         bound_by="bytes", bytes=step_bytes),
         profiled_epoch=dict(**prof, steps=iters,
                             launches_per_step=(prof["device_launches"] / iters
                                                if prof["device_launches"] else None)),
         library_note="torch.bmm(W (T, n, n), x.view(T, n, M)): the stacked dense Eq. 1")
    return dict(next(c for c in cases if c["leaf"] == "w1"),
                whole_step=dict(**step_t, bound_ms=1e3 * step_bytes / HBM_BYTES_PER_S,
                                bound_by="bytes"))


# ---------------------------------------------------------------------------
# phase 17: the cross-product and chaos engines on the card
# ---------------------------------------------------------------------------

def phase_main_sim_cross(topos, data, accs) -> dict:
    """bench_dynamic's and bench_compression's defaults on main_sim's
    topologies: static and round-robin cycles (the directed exponential
    graph has none) × {dense, top-k 10 %, random-k 10 %}, 6 epochs, one
    ``train_curves_cross`` call per compressor; then
    ``consensus_curves_cross`` at dim 256 (float32) for 300 iterations over
    bench_compression's compressor families and γ grid. Checks: the static
    dense runs equal main_sim's first 6 epochs within 1e-7 (the batch order
    of epoch e does not depend on the run's length); random-k 10 % CHOCO
    diverges, as the reference's does (its 1/frac scaling sets e ← (1 −
    1/frac)·e on every kept entry): every training run ends below twice
    chance accuracy and every consensus run ends non-finite or above its
    starting error."""
    from repro_torch import kernels
    from repro_torch.dsgd.compression import choco_gamma
    from repro_torch.dsgd.dynamic import cycle_tensor, static_cycle
    from repro_torch.dsgd.sim import CommSpec, DSGDSimConfig, consensus_curves_cross
    from repro_torch.dsgd.sim import train_curves_cross

    cfg = DSGDSimConfig(epochs=6, batch=32, lr=0.05, momentum=0.9, hidden=128, seed=0)
    runs = [(_label(t), "static", static_cycle(t.W)) for t in topos]
    runs += [(_label(t), "round_robin", cycle_tensor(t)) for t in topos
             if not t.meta.get("directed")]
    cycles = [c for _, _, c in runs]
    specs = ((CommSpec(), 1.0), (CommSpec("top_k", 0.10), 0.4), (CommSpec("random_k", 0.10), 0.1))
    train, walls, launches = {}, {}, {}
    for spec, gamma in specs:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        a, iters = train_curves_cross(cycles, np.full(len(cycles), gamma), spec, *data, cfg)
        walls[spec.name] = time.perf_counter() - t0
        launches[spec.name] = kernels.launch_counts()["gossip_mix_batched"]
        train[spec.name] = a
        # one launch a step for all leaves: dense mixes x, CHOCO mixes x̂
        assert launches[spec.name] == cfg.epochs * iters, launches
    static_err = float(np.abs(train["dense"][:len(topos)] - accs[:, :cfg.epochs]).max())
    # consensus: bench_compression's families and γ grid, one call a family
    x0 = np.random.default_rng(0).normal(size=(SIM_N, 256)).astype(np.float32)
    families = ((CommSpec(), ("static",)), (CommSpec("top_k", 0.25), ("static",)),
                (CommSpec("top_k", 0.10), ("static", "round_robin")),
                (CommSpec("random_k", 0.10), ("static",)))
    consensus = []
    for spec, modes in families:
        crun = []
        for (label, mode, cyc), t in zip(runs, topos + [t for t in topos
                                                         if not t.meta.get("directed")]):
            if mode not in modes:
                continue
            lam2 = 1.0 - float(np.sort(np.abs(np.linalg.eigvals(t.W)))[-2])
            grid = [1.0] if not spec.choco else [choco_gamma(t, lam2), 0.2, 0.4, 0.6, 0.8]
            crun += [(label, mode, g, cyc) for g in grid]
        t0 = time.perf_counter()
        errs = consensus_curves_cross([c for *_, c in crun], [g for _, _, g, _ in crun], spec,
                                      x0, 300, seed=0)
        wall = time.perf_counter() - t0
        assert errs.shape == (len(crun), 301) and errs.dtype == np.float32
        best, diverged = {}, 0
        for (label, mode, g, _), e in zip(crun, errs):
            diverged += int(not np.isfinite(e[-1]) or e[-1] > e[0])
            rel = float(e[-1] / e[0]) if np.isfinite(e[-1]) else None
            key = f"{label}/{mode}"
            if rel is not None and (key not in best or rel < best[key][1]):
                best[key] = (g, rel)
        consensus.append(dict(compressor=spec.name, runs=len(crun), wall_s=wall,
                              diverged=diverged, best_gamma_and_final_rel_error=best))
    emit("main_sim_cross", runs=[dict(topology=lb, mode=m) for lb, m, _ in runs],
         epochs=cfg.epochs, gammas={s.name: g for s, g in specs},
         final_acc={k: [float(v) for v in a[:, -1]] for k, a in train.items()},
         curves_wall_s=walls, gossip_launches=launches,
         static_dense_vs_main_sim_max_err=static_err, consensus_dim=256, consensus_iters=300,
         consensus=consensus)
    assert all(np.all(np.isfinite(a)) for a in train.values())
    assert static_err <= 1e-7, f"static dense cross vs accuracy_curves: {static_err}"
    chance = 1.0 / (int(np.asarray(data[1]).max()) + 1)
    rand = next(c for c in consensus if c["compressor"] == "rand10%")
    assert np.all(train["rand10%"][:, -1] < 2 * chance), train["rand10%"][:, -1]
    assert rand["diverged"] == rand["runs"], rand
    return launches, _choco_step_case(cycles)


def _choco_step_case(cycles) -> dict:
    """A CHOCO step's gossip at main_sim_cross's shape: the four x̂ leaves
    stacked to (runs·n, M) rows (17 × 16 = 272) over step 0's block-diagonal
    table with (W − I)'s weights, in one launch as the step mixes them,
    against the plain version and bitwise against the first-cut witness
    kernel; timed beside the witness (a launch a leaf), the tiled kernel a
    launch a leaf (each leaf alone), the plain version and ``torch.bmm`` of
    the (runs, n, n) W − I over the (runs, n, M) views, with the byte bound.
    The timing calls leave the launch count as it was."""
    from repro_torch.dsgd import sim
    from repro_torch.dsgd.compression import choco_weights
    from repro_torch.dsgd.dynamic import stack_cycles
    from repro_torch.kernels.gossip_mix import ops as gm

    Wc, lens = stack_cycles(cycles)
    tables = sim._Tables(Wc.astype(np.float32), lens, 1, "cuda")
    idx, w = tables.at(0)
    w = choco_weights(w)
    B, n = tables.B, tables.n
    A = tables.Wc.index_select(0, tables.sel[0])
    A = A - torch.eye(n, device=A.device)
    p0 = sim.init_mlp(0, 64, 128, 10)
    gen = torch.Generator().manual_seed(2)
    xs = [(torch.rand((B * n,) + tuple(p0[k].shape), generator=gen) - 0.5).cuda()
          for k in sim.LEAVES]
    before = gm.gossip_mix_batched.launches
    got = gm.gossip_mix_batched_leaves(xs, idx, w)
    err, ok, same = 0.0, True, True
    for g, x in zip(got, xs):
        e, o = _batched_check(g, x, idx, w)
        err, ok = max(err, e), ok and o
        same = same and torch.equal(g, gm.gossip_mix_batched_witness(x, idx, w))
    t = timings(lambda: gm.gossip_mix_batched_leaves(xs, idx, w),
                lambda: [gm.gossip_mix_batched_plain(x, idx, w) for x in xs],
                lambda: [torch.bmm(A, x.view(B, n, -1)) for x in xs])
    t["witness_ms"] = device_ms(lambda: [gm.gossip_mix_batched_witness(x, idx, w) for x in xs])
    t["leaf_by_leaf_ms"] = device_ms(lambda: [gm.gossip_mix_batched(x, idx, w) for x in xs])
    gm.gossip_mix_batched.launches = before
    nbytes = sum(2 * x.numel() * 4 for x in xs) + _table_bytes(idx, w)
    case = dict(rows=B * n, runs=B, deg=int(idx.shape[1]), leaves=[list(x.shape) for x in xs],
                dtype="float32", max_abs_err=err, within=ok, equal_to_witness=same, **t,
                bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes", bytes=nbytes,
                library_note="torch.bmm(W − I (runs, n, n), x̂.view(runs, n, M)) a leaf")
    emit("choco_step_gossip", **case)
    assert ok, "gossip_mix_batched at main_sim_cross's CHOCO step: outside the tolerance"
    assert same, "gossip_mix_batched at main_sim_cross's CHOCO step: not the witness's bits"
    return case


#: Steps from drift detection to the re-optimized topology taking over in
#: main_sim_chaos: a fixed lag, so the curves do not depend on the host's
#: clock (bench_chaos derives its lag from a modeled 500 ms).
REOPT_LAG_STEPS = 4


def _piecewise_cycle(W_before, W_after, steps: int, t_switch: int) -> np.ndarray:
    """(T, n, n) cycle switching topologies at ``t_switch`` (bench_chaos's
    ``piecewise_cycle``): with one slot a step, the cycle is a script."""
    cyc = np.empty((steps,) + np.shape(W_before))
    cyc[:t_switch] = W_before
    cyc[t_switch:] = W_after
    return cyc


def phase_main_sim_chaos() -> dict:
    """bench_chaos's defaults on the card: the node-hetero BA-Topo at n=16,
    r=32 (solved on the card, sa_iters 400), 6 epochs under a fault spec
    with one churn window of node 5 from the drift step (a quarter of the
    run) for a sixth of the run, p_drop 0.03, straggler probability 0.05
    (×3), and the four fast NICs collapsing to 1 GB/s at the drift step.
    bench_chaos's re-optimized run: the ``DriftDetector`` walks the spec, and
    ``reoptimize_topology`` re-solves on the card from the incumbent under
    B(t_detect) and alive(t_detect); its topology takes over
    ``REOPT_LAG_STEPS`` after detection. Static, round-robin and
    re-optimized, dense, in one ``train_curves_chaos`` call; then 120
    iterations of ``consensus_curves_chaos``. Check: a ``no_chaos`` spec
    reproduces ``train_curves_cross`` bitwise."""
    from repro_torch import kernels
    from repro_torch.core import BATopoConfig, check_invariants
    from repro_torch.core.reopt import DriftDetector, DriftPolicy, reoptimize_topology
    from repro_torch.dsgd.chaos import drift_profile, make_chaos, no_chaos
    from repro_torch.dsgd.dynamic import cycle_tensor, static_cycle
    from repro_torch.dsgd.sim import CommSpec, DSGDSimConfig, consensus_curves_chaos
    from repro_torch.dsgd.sim import train_curves_chaos, train_curves_cross

    n = SIM_N
    topo = _ba_topo(n, 32, 400, scenario="node", node_bandwidths=NODE_BW_16)
    data = _sim_data(n)
    cfg = DSGDSimConfig(epochs=6, batch=32, lr=0.05, momentum=0.9, hidden=128, seed=0)
    iters = min(len(p) for p in data[2]) // cfg.batch

    def spec_for(steps):
        drift = max(int(steps * 0.25), 1)
        churn = [(5, drift, min(drift + max(steps // 6, 2), steps))]
        return make_chaos(steps, n, seed=0, churn=churn, p_drop=0.03, straggler_prob=0.05,
                          straggler_mult=3.0,
                          bandwidth=drift_profile(steps, n, drift, NODE_BW_16, 4, 1.0))

    steps = cfg.epochs * iters
    chaos = spec_for(steps)
    det = DriftDetector.from_profile(chaos.bandwidth[0], chaos.alive[0],
                                     DriftPolicy(cooldown_steps=steps))
    t_detect, why = next((t, w) for t in range(1, steps)
                         if (w := det.check(t, chaos.bandwidth[t], chaos.alive[t])) is not None)
    kernels.reset_launch_counts()
    reopt = reoptimize_topology(topo, scenario="node", node_bandwidths=chaos.bandwidth[t_detect],
                                alive=chaos.alive[t_detect], cfg=BATopoConfig(seed=0, sa_iters=400))
    reopt_launches = kernels.launch_counts()
    assert check_invariants(reopt.topology) is None
    assert not _missing("reopt", reopt_launches), \
        f"main_sim_chaos reopt: kernels never launched: {_missing('reopt', reopt_launches)}"
    t_act = min(t_detect + REOPT_LAG_STEPS, steps)
    cycles = [static_cycle(topo.W), cycle_tensor(topo)]
    runs = cycles + [_piecewise_cycle(topo.W, reopt.topology.W, steps, t_act)]
    ones = np.ones(len(cycles))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    accs, _ = train_curves_chaos(runs, np.ones(len(runs)), CommSpec(), chaos, *data, cfg)
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()["gossip_mix_batched"]
    x0 = np.random.default_rng(0).normal(size=(n, 16))
    c_chaos = spec_for(120)
    t0 = time.perf_counter()
    errs = consensus_curves_chaos(cycles, ones, CommSpec(), c_chaos, x0, 120)
    cons_s = time.perf_counter() - t0
    bitwise = {}
    for spec, gamma in ((CommSpec(), 1.0), (CommSpec("top_k", 0.10), 0.4)):
        g = np.full(len(cycles), gamma)
        ref, _ = train_curves_cross(cycles, g, spec, *data, cfg)
        got, _ = train_curves_chaos(cycles, g, spec, no_chaos(cfg.epochs * iters, n), *data, cfg)
        bitwise[spec.name] = bool(np.array_equal(got, ref))
    emit("main_sim_chaos", topology=_label(topo), r_asym=float(topo.r_asym()), epochs=cfg.epochs,
         steps=cfg.epochs * iters, churn=chaos.meta["churn"], p_drop=0.03,
         dead_worker_steps=int((chaos.alive == 0).sum()),
         dropped_links=int((chaos.link_up == 0).sum() // 2),
         final_acc={"static": float(accs[0, -1]), "round_robin": float(accs[1, -1]),
                    "reopt": float(accs[2, -1])},
         reopt=dict(t_detect=t_detect, reason=why, t_activate=t_act,
                    reoptimized=reopt.reoptimized, attempts=reopt.attempts,
                    fallback_reason=reopt.fallback_reason, r_asym_before=reopt.r_asym_before,
                    r_asym_after=reopt.r_asym_after, time_to_reopt_s=reopt.time_to_reopt_s,
                    launches=reopt_launches),
         accs=accs.tolist(), curves_wall_s=wall_s, gossip_launches=launches,
         consensus_iters=120, consensus_final_rel_error=[float(e[-1] / e[0]) for e in errs],
         consensus_wall_s=cons_s, no_chaos_bitwise_equal_to_cross=bitwise)
    assert np.all(np.isfinite(accs)) and np.all(np.isfinite(errs))
    assert launches == steps, launches               # dense: one launch a step
    assert all(bitwise.values()), f"no_chaos differs from the cross engine: {bitwise}"
    return launches


def phase_topo_cli() -> dict:
    """``python -m repro_torch.launch.topo`` on the card, through its
    ``main``: the node scenario at n=16, r=32 (the default config). Check:
    a finite r_asym below 1, every solve kernel launched."""
    from repro_torch import kernels
    from repro_torch.launch import topo as topo_cli

    argv = ["--n", "16", "--r", "32", "--scenario", "node", "--bandwidths", "9.76x8,3.25x8"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = topo_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    emit("topo_cli", argv=argv, wall_s=wall_s, launches=launches,
         **{k: report[k] for k in ("name", "edges", "r_asym", "quality_tier", "complete",
                                   "max_degree", "b_min_GBs", "t_iter_ms")})
    assert np.isfinite(report["r_asym"]) and report["r_asym"] < 1.0, report["r_asym"]
    assert not _missing("topo_cli", launches), \
        f"topo_cli: kernels never launched: {_missing('topo_cli', launches)}"
    return report


KERNEL_INFO = {
    "edge_laplacian": dict(route="cuda", source="src/repro_torch/csrc/edge_laplacian.cu",
                           replaces="src/repro/kernels/edge_laplacian/kernel.py:62"),
    "edge_laplacian_blocks": dict(route="cuda", source="src/repro_torch/csrc/edge_laplacian.cu",
                                  replaces="src/repro/kernels/edge_laplacian/kernel.py:62"),
    "edge_quadform": dict(route="cuda", source="src/repro_torch/csrc/edge_laplacian.cu",
                          replaces="src/repro/kernels/edge_laplacian/kernel.py:87"),
    "edge_adjoint": dict(route="cuda", source="src/repro_torch/csrc/edge_laplacian.cu",
                         replaces="src/repro/kernels/edge_laplacian/kernel.py:87"),
    "edge_schur_matvec": dict(route="cuda", source="src/repro_torch/csrc/edge_laplacian.cu",
                              replaces="src/repro/kernels/edge_laplacian/kernel.py:87"),
    # the windowed forms of the edge-partitioned ADMM (core/shard.py); the
    # reference's sharded layer windows with a jnp gather (ref.py:21)
    "edge_laplacian_window": dict(route="cuda", source="src/repro_torch/csrc/edge_laplacian.cu",
                                  replaces="src/repro/kernels/edge_laplacian/kernel.py:62"),
    "edge_adjoint_window": dict(route="cuda", source="src/repro_torch/csrc/edge_laplacian.cu",
                                replaces="src/repro/kernels/edge_laplacian/kernel.py:87"),
    "hop_step": dict(route="cuda", source="src/repro_torch/csrc/hop_bfs.cu",
                     replaces="src/repro/kernels/hop_bfs/kernel.py:54"),
    "gossip_mix_batched": dict(route="cuda", source="src/repro_torch/csrc/gossip_mix.cu",
                               replaces="src/repro/kernels/gossip_mix/kernel.py:50"),
    "gossip_mix": dict(route="cuda", source="src/repro_torch/csrc/gossip_mix.cu",
                       replaces="src/repro/kernels/gossip_mix/kernel.py:82"),
    "decode_attention": dict(route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
                             replaces="src/repro/kernels/decode_attention/kernel.py:71"),
    "ssd_intra_chunk": dict(route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
                            replaces="src/repro/kernels/ssd_scan/kernel.py:60"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    try:
        return _main()
    finally:
        stop_table_builds()
        for proc in _CHILDREN:
            proc.kill()
            proc.wait()


def _main() -> int:
    phase_device_and_build()
    start_table_builds()
    timing = phase_kernels()
    batched_timing = phase_batched_kernels()

    from repro_torch.core import TopologyRequest, bcube_constraints

    res64, launches, restarts = phase_main_n64()
    phase_main_barrier(res64)
    phase_solve("main_bcube", TopologyRequest(
        n=16, r=48, scenario="constraint", cs=bcube_constraints(p=4, k=2)))
    phase_card_vs_cpu()
    phase_consensus(res64.topology)
    phase_profile()
    main_restarts = phase_main_restarts(restarts)
    phase_main_restarts_f64()
    timing.update(phase_main_sharded(restarts, main_restarts))
    kkt_solve = phase_main_xstep_backends(restarts)["solves"]["scan/kkt_bicgstab"]["launches"]
    for name in ("edge_laplacian_blocks", "edge_adjoint"):
        timing[name]["kkt_route"] = dict(path="main_xstep_backends, scan/kkt_bicgstab",
                                         launches=kkt_solve[name],
                                         edge_schur_matvec=kkt_solve["edge_schur_matvec"])
    sweep_launches, _ = phase_main_sweep()
    phase_sweep_card_vs_cpu()
    phase_main_service()
    for name in BATCHED_FORMS:
        timing[name]["batched"] = dict(batched_timing[name], launches=sweep_launches[name])

    await_table(49152)
    state, topo, dsgd_launches, step1_err, dsgd_run = phase_main_dsgd()
    timing.update(phase_gossip_kernels(state, topo))
    timing["gossip_mix_batched"]["max_abs_err"] = step1_err
    timing["gossip_mix_batched"]["deg"] = phase_gossip_deg()
    row_launches = phase_rowloop(state, topo)
    phase_profile_dsgd(state, topo)
    del state
    torch.cuda.empty_cache()
    phase_dsgd_card_vs_cpu()
    timing["gossip_mix_batched"]["dynamic"] = phase_main_dsgd_dynamic(dsgd_run)
    torch.cuda.empty_cache()
    phase_main_sharded_dsgd()
    phase_main_tp_dsgd()
    timing["gossip_mix_batched"]["elastic"] = phase_main_elastic(dsgd_run)
    phase_elastic_resume()

    serve_timing, family_cases = phase_serve_kernels()
    timing.update(serve_timing)
    dense = phase_serve_dense()
    ssm_run = phase_serve_ssm()
    family_runs = {label: phase_serve_family(label) for label in SERVE_FAMILY_RUNS}
    phase_serve_card_vs_cpu()
    phase_profile_serve()
    phase_profile_prefill()
    trained = {label: phase_train_family(label) for label in TRAIN_FAMILY_RUNS
               if label != "main_train_vlm"}

    topos, sim_data, Ws, sim_accs, sim_launches = phase_main_sim()
    timing["gossip_mix_batched"]["sim"] = dict(
        phase_sim_kernel(Ws, sim_data), launches=sim_launches["gossip_mix_batched"])
    _, timing["gossip_mix_batched"]["sim"]["choco_step"] = phase_main_sim_cross(
        topos, sim_data, sim_accs)
    phase_main_sim_chaos()
    phase_topo_cli()
    phase_train_card_vs_cpu()
    trained["main_train_vlm"] = phase_train_family("main_train_vlm")

    path_launches = {"gossip_mix_batched": dsgd_launches["gossip_mix_batched"],
                     "gossip_mix": row_launches["gossip_mix"],
                     "decode_attention": dense["launches"]["decode_attention"],
                     "ssd_intra_chunk": ssm_run["launches"]["ssd_intra_chunk"]}
    # each serving family's kernel shape with its launches on its path
    for label, (path, _, expected) in SERVE_FAMILY_RUNS.items():
        for name in expected:
            case = family_cases[path + ("_ssd" if name == "ssd_intra_chunk" else "")]
            timing[name].setdefault("serve_shapes", []).append(dict(
                path=label, launches=family_runs[label]["launches"][name],
                **{k: case.get(k) for k in ("B", "C", "Hq", "Hkv", "hd", "nc", "Q", "H", "P",
                                            "N", "dtype", "max_abs_err", "ms", "ms_warm",
                                            "plain_ms", "bound_ms", "bound_by", "library_ms",
                                            "library_ms_warm", "call_ms") if k in case}))
    # each trained family's shapes with their launches on its path
    for label, run in trained.items():
        timing["gossip_mix_batched"].setdefault("train_shapes", []).append(run["shapes"]["gossip"])
        if "ssd" in run["shapes"]:
            timing["ssd_intra_chunk"].setdefault("train_shapes", []).append(run["shapes"]["ssd"])
    rows = []
    for name, info in KERNEL_INFO.items():
        t = timing[name]
        rows.append(dict(
            name=name, **info,
            launches=t.get("path_launches", path_launches.get(name, launches.get(name))),
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], call_ms=t["call_ms"],
            **{k: t[k] for k in ("ms_warm", "library_ms_warm", "witness_ms", "sim", "batched",
                                 "elastic", "dynamic", "kkt_route", "deg", "serve_shapes",
                                 "train_shapes") if k in t}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
