"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at its path's shapes and times it,
and drives the port's four paths on ``cuda``:

- the topology solve (``solve_topology`` at n=64, r=128 and the n=16 BCube
  scenario; every CG matvec A·Aᵀλ in one ``edge_schur_matvec`` launch, the
  right-hand side's ``A_op`` in one ``edge_laplacian_blocks`` launch and
  the last ``AT_op`` in one ``edge_adjoint`` launch), checked against the
  CPU at n=16, evaluated by consensus simulation, with short profiled
  windows of its device stages;
- DSGD training of smollm-135m at full width through the launcher
  (``repro_torch.launch.train``): n=8 workers on one card, BA topology
  (r=16) solved on the card, 10 steps, every gossip through the
  ``gossip_mix_batched`` kernel; then the row-loop oracle of one-worker
  ``gossip_mix`` kernels on the trained leaves, reduced smollm card vs CPU,
  and one profiled full-width train step;
- serving through the launcher (``repro_torch.launch.serve``): smollm-135m
  at full width (batch 16, 2,048-token prompts, 128 new tokens), every
  attention decode through the ``decode_attention`` kernel, and
  mamba2-780m at full width (batch 8, 1,024-token prompts, 64 new tokens),
  every layer's SSD chunks of its prefill through one ``ssd_intra_chunk``
  launch (the bf16 tensor-core route); then both kernels at their serving
  shapes and at gemma2-9b's, reduced smollm, gemma2 (long context) and
  mamba2 card vs CPU, one profiled full-width decode step and one profiled
  mamba2-780m prefill;
- the §VI-B evaluation (``repro_torch.dsgd.sim``): bench_training_time's
  homo setup at n=16 (the paper's baselines and BA-Topo at r = 16, 24, 32,
  solved on the card) trained by one ``accuracy_curves`` call, 30 epochs,
  every step's gossip one ``gossip_mix_batched`` launch per leaf for all
  nine topologies, checked against the CPU and the host oracle; the kernel
  at that fp32 shape beside ``torch.bmm``, one profiled epoch; the
  cross-product engine ({static, round-robin} × {dense, top-k, random-k})
  and bench_compression's consensus curves; the chaos engine at
  bench_chaos's defaults, with a fault-free spec held bitwise to the cross
  engine.

Every phase prints one JSON line; any failure raises and the script exits
non-zero. Each path's kernel launches are counted from 0 over that path
alone, and every kernel the path must run has to have launched. The line
before the last lists every kernel with its launches on its path, its
error against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero without one. It imports only torch,
numpy and ``repro_torch`` (from ``src/`` beside this file).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
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
    "rowloop": ("gossip_mix",),
    "serve_dense": ("decode_attention",),
    "serve_ssm": ("ssd_intra_chunk",),
    "sim": ("gossip_mix_batched",),
}

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
INT8_OP_PER_S = 1.979e15        # H100 SXM dense int8 tensor-core rate
BF16_OP_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
FP32_OP_PER_S = 67e12           # H100 SXM float32 rate outside the tensor cores
TIMED_LAUNCHES = 1000
WARMUP_LAUNCHES = 50


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


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
    once unprofiled to warm up: 60 ADMM steps (pipeline stack; the
    ``edge_schur_matvec`` launches count its CG matvecs, the
    ``edge_laplacian_blocks`` and ``edge_adjoint`` launches its right-hand
    sides and last adjoints; no ``edge_quadform`` may launch there), 100 SA
    moves, 100 polish iterations."""
    from repro_torch.core import BATopoConfig, HomogeneousADMM
    from repro_torch.core.anneal import greedy_degree_graph
    from repro_torch.core.api import _pack_warm
    from repro_torch.core.warmstart import anneal_topology_batched
    from repro_torch.core.weights import metropolis_weights, polish_weights_batched

    n, r = 64, 128
    edges = greedy_degree_graph(n, np.full(n, 4), np.random.default_rng(0))
    g0, _, lam0 = _pack_warm(n, edges)
    cfg = BATopoConfig()
    admm_cfg = dataclasses.replace(cfg.admm, max_iters=60, device="cuda")
    solver = HomogeneousADMM(n, r, admm_cfg)
    stages = {
        "admm_60_steps": lambda: solver.solve(g0=g0, lam0=lam0),
        "sa_100_moves": lambda: anneal_topology_batched(n, [edges], None, iters=100,
                                                        seeds=[0]),
        "polish_100_iters": lambda: polish_weights_batched(
            n, [edges], [metropolis_weights(n, edges)], iters=100),
    }
    admm_kernels = ("edge_schur_matvec", "edge_adjoint", "edge_laplacian_blocks",
                    "edge_quadform")
    out = {}
    for name, fn in stages.items():
        fn()
        out[name] = _profiled(fn, match=admm_kernels if name.startswith("admm") else ())
    emit("profile", n=n, r=r, stages=out)
    matched = out["admm_60_steps"].get("matched")
    assert matched is not None, "the profiler saw no device activity in the ADMM steps"
    assert matched["edge_schur_matvec"]["launches"] > 0 and \
        matched["edge_quadform"]["launches"] == 0, f"ADMM steps' kernels: {matched}"


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
    from repro_torch.kernels.gossip_mix import ops as gm

    want = gm.gossip_mix_batched_plain(x, nbr_idx, weights)
    terms = gm.gossip_mix_batched_plain(x.abs().float(), nbr_idx, weights.abs())
    return _within(got, want, terms, int(nbr_idx.shape[1]))


def phase_main_dsgd():
    """The launcher's run at full width on the card: the BA topology solved
    on the card (a fresh cache file), 10 steps with every gossip through
    ``gossip_mix_batched``. The first gossip (step 1) is also mixed by the
    plain version from the same pre-gossip leaves and held against the
    kernel's, by wrapping the trainer's ``gossip_sim_tree``."""
    from repro_torch import kernels
    from repro_torch.dsgd import trainer
    from repro_torch.launch import steps, train

    TOPO_CACHE.unlink(missing_ok=True)
    mix = trainer.gossip_sim_tree
    step1: dict = {}

    def checked_mix(tree, W, *, use_kernel=True, nbr=None):
        out = mix(tree, W, use_kernel=use_kernel, nbr=nbr)
        if not step1:
            mixed = _leaves(out)
            for name, x in _leaves(tree).items():
                step1[name] = _batched_check(mixed[name], x, *nbr)
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
         step1_gossip_vs_plain={k: dict(max_abs_err=e, within=ok) for k, (e, ok) in step1.items()},
         max_memory_allocated_bytes=peak, wall_s=wall_s, launches=launches)
    assert res["param_count_per_worker"] == SMOLLM_PARAMS, res["param_count_per_worker"]
    assert len(hist) == n_steps == 10 and all(np.isfinite(losses)) and all(np.isfinite(cons))
    assert abs(losses[0] - np.log(49152)) <= 0.5, f"first loss {losses[0]} vs ln 49152"
    assert launches["gossip_mix_batched"] == SMOLLM_LEAVES * n_steps, launches
    missing = [k for k in PATH_KERNELS["dsgd"] if launches[k] == 0]
    assert not missing, f"main_dsgd: kernels never launched on the path: {missing}"
    assert len(step1) == SMOLLM_LEAVES and all(ok for _, ok in step1.values()), \
        f"step-1 gossip differs from the plain mix: {step1}"
    return last["state"], topo, launches, max(e for e, _ in step1.values())


# ---------------------------------------------------------------------------
# phase 8: both gossip kernels at smollm-135m's leaf shapes, and their times
# ---------------------------------------------------------------------------

def _table_bytes(idx, w) -> int:
    return idx.numel() * idx.element_size() + w.numel() * w.element_size()


def phase_gossip_kernels(state, topo) -> dict:
    """Each kernel against its plain version on the trained leaves: the
    embedding (bf16 and fp32), ``layers.mlp.w_gate``, ``layers.attn.wk``
    and a norm leaf, n = 8, with the BA topology's neighbour table and with
    deg = 7 (every other worker). Times: kernel, plain, the dense
    ``torch.matmul(W, x)`` of ``gossip_sim`` as the library call, and the
    bound 2·n·M·size bytes (x read once, the output written once). Also the
    whole step's gossip (all 11 leaves) and the one-worker kernel at the
    embedding. Returns the rows of the kernels line."""
    from repro_torch.core.graph import weight_matrix_from_weights
    from repro_torch.dsgd.gossip import gossip_sim_tree, padded_neighbors
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
                del got
                Wx = Wd.to(dtype)
                big = x.numel() * x.element_size() > 64 << 20
                t = (large_timings if big else timings)(
                    lambda: gm.gossip_mix_batched(x, idx, w),
                    lambda: gm.gossip_mix_batched_plain(x, idx, w),
                    lambda: torch.matmul(Wx, x.view(n, -1)))
                nbytes = 2 * x.numel() * x.element_size() + _table_bytes(idx, w)
                cases.append(dict(kernel="gossip_mix_batched", leaf=name, shape=list(x.shape),
                                  dtype=str(dtype).replace("torch.", ""), table=tag,
                                  deg=int(idx.shape[1]), max_abs_err=err, within=ok, **t,
                                  bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes"))
                assert ok, f"gossip_mix_batched {name} {dtype} {tag}: outside the tolerance"
            del x
    # the whole step's gossip: the 11 leaves of the main path, BA table
    (idx, w), _ = tables["ba"]
    step_t = large_timings(
        lambda: gossip_sim_tree(state.params, W, nbr=(idx, w)),
        lambda: [gm.gossip_mix_batched_plain(x, idx, w) for x in leaves.values()],
        lambda: [torch.matmul(W.to(x.dtype), x.view(n, -1)) for x in leaves.values()])
    step_bytes = sum(2 * x.numel() * x.element_size() + _table_bytes(idx, w)
                     for x in leaves.values())
    step_row = dict(**step_t, bound_ms=1e3 * step_bytes / HBM_BYTES_PER_S, bound_by="bytes",
                    bytes=step_bytes)
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
                      "(the dense Eq. 1 of gossip_sim); gossip_mix: torch.addmv")
    return {"gossip_mix_batched": step_row, "gossip_mix": one_row}


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
    assert glaunch["gossip_mix_batched"] == SMOLLM_LEAVES * n_steps
    assert loss_rel <= 1e-4, f"DSGD card vs CPU: losses differ by {loss_rel} relative"


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


def phase_serve_kernels() -> dict:
    """decode_attention at main_serve_dense's shape (B 16, C 2184, 9/3 heads,
    hd 64, bf16, the valid keys of decode step 64), with a valid key only in
    the last slot, at gemma2-9b's shape (B 4, C 4224, 16/8 heads, hd 256,
    softcap 50, a 4,096 window that masks the early positions) in bf16 and
    fp32, and at a ring-cache mask; ssd_intra_chunk at main_serve_ssm's shape
    (B 8, Q 256, H 48, P 64, N 128, bf16: the tensor-core route) as the
    model hands it over (column slices) and contiguous, its four chunks in
    one launch, in fp32 (the CUDA-core route), at the reduced shape (Q 32,
    H 8, P 32, N 16, fp32, three chunks) and ragged (Q 50, P 30, N 18,
    bf16). Returns the main-shape case per kernel."""
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
    return {"decode_attention": cases[0], "ssd_intra_chunk": cases[5]}


# ---------------------------------------------------------------------------
# phase 13: serving at full width through the launcher
# ---------------------------------------------------------------------------

SERVE_DENSE_ARGS = ["--arch", "smollm-135m", "--batch", "16", "--prompt-len", "2048",
                    "--max-new", "128", "--seed", "0", "--device", "cuda"]
SERVE_SSM_ARGS = ["--arch", "mamba2-780m", "--batch", "8", "--prompt-len", "1024",
                  "--max-new", "64", "--seed", "0", "--device", "cuda"]


def _serve(label: str, argv: list, kernel: str, per_run: int, checked: dict) -> dict:
    """One launcher run with every kernel count from 0; ``checked`` collects
    the path's first launch, held against the plain version on the same
    inputs (the check's own calls are not counted)."""
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
    vocab = {"smollm-135m": 49152, "mamba2-780m": 50280}[res["arch"]]
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
    assert launches[kernel] == per_run, f"{label}: {kernel} launched {launches[kernel]} " \
                                        f"times, expected {per_run}"
    path = "serve_dense" if kernel == "decode_attention" else "serve_ssm"
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    assert not missing, f"{label}: kernels never launched on the path: {missing}"
    assert checked.get("within"), f"{label}: the first {kernel} launch is outside " \
                                  f"its tolerance: {checked}"
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


def phase_serve_dense() -> dict:
    """smollm-135m at full width: 30 decode_attention launches per decode
    step, 127 steps. The first launch (layer 0 of the first decode step, on
    the real cache) is also held against the plain version."""
    from repro_torch.models import attention

    def check(q, k, v, valid, *, attn_softcap=0.0):
        err, share, ok = _decode_check(q, k, v, valid, attn_softcap)
        return dict(max_abs_err=err, share_of_tol=share, within=ok, C=int(k.shape[1]),
                    valid_keys=int(valid.sum()))

    with _first_launch_checked(attention, "_dec_ops", "decode_attention", check) as rec:
        return _serve("main_serve_dense", SERVE_DENSE_ARGS, "decode_attention", 30 * 127, rec)


#: main_serve_ssm's time to first token with the CUDA-core SSD kernel
#: launched once per chunk (an earlier run, NVIDIA H100 80GB HBM3, 700 W),
#: printed beside this run's; the two runs are on different machines.
SSM_TTFT_MS_BEFORE = 371.4


def phase_serve_ssm() -> dict:
    """mamba2-780m at full width: one ssd_intra_chunk launch per layer of
    the prefill over its four chunks, 48 in all. The first launch (layer 0,
    the model's strided slices) is also held against the plain version, and
    the peak memory is counted from just after that check."""
    from repro_torch.models import ssm

    def check(*args):
        err, share, ok = _ssd_check(args)
        # the check's own scratch (the plain version's Q×Q×H blocks) stays
        # out of the serving peak: the later chunks and layers reach the
        # same peak as this one
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return dict(max_abs_err=err, share_of_tol=share, within=ok,
                    x_strides=list(args[0].stride()))

    with _first_launch_checked(ssm, "_ssd_ops", "ssd_intra_chunk", check) as rec:
        out = _serve("main_serve_ssm", SERVE_SSM_ARGS, "ssd_intra_chunk", 48, rec)
    emit("serve_ssm_ttft", ttft_ms=out["res"]["prefill_ms"],
         ttft_ms_one_launch_per_chunk=SSM_TTFT_MS_BEFORE,
         note="the second from an earlier run on another machine")
    return out


# ---------------------------------------------------------------------------
# phase 14: serving on the card against the CPU
# ---------------------------------------------------------------------------

def phase_serve_card_vs_cpu() -> None:
    """Reduced fp32 smollm, gemma2 (long context: every layer windowed, a
    ring cache of the 16-token window under a 24-token prompt) and mamba2:
    the same weights and prompts on the card (kernels) and on the CPU (plain
    versions). Prefill logits and the logits of 8 decode steps agree within
    1e-5 relative to their largest magnitude, and the greedy tokens are
    equal. With the CPU against the JAX package (tests/test_torch_serve.py,
    tests/test_torch_ssm.py) this closes the chain JAX ⇄ port (CPU) ⇄ port
    (card)."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.models import transformer

    rows = []
    for arch, long_context, S in (("smollm-135m", False, 24), ("gemma2-9b", True, 24),
                                  ("mamba2-780m", False, 70)):
        cfg = reduced_for_smoke(get_arch(arch))
        params = transformer.init_params(0, cfg)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (2, S)).astype(np.int64))
        runs = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev), params)
            kernels.reset_launch_counts()
            logits, caches = transformer.prefill(p, cfg, {"tokens": prompts.to(dev)},
                                                 long_context=long_context)
            seq, toks = [logits.float().cpu()], []
            for t in range(8):
                tok = logits[:, -1].argmax(-1)[:, None]
                toks.append(tok.cpu())
                logits, caches = transformer.decode_step(p, cfg, tok, caches, S + t,
                                                         long_context=long_context)
                seq.append(logits.float().cpu())
            runs[dev] = (seq, torch.cat(toks, 1), kernels.launch_counts())
        (gseq, gtok, glaunch), (cseq, ctok, _) = runs["cuda"], runs["cpu"]
        rel = max(float((g - c).abs().max()) / float(c.abs().max()) for g, c in zip(gseq, cseq))
        rows.append(dict(arch=cfg.name, long_context=long_context, prompt=S,
                         logits_max_rel_diff=rel, tokens_equal=bool(torch.equal(gtok, ctok)),
                         tokens=gtok.tolist(), launches_cuda={k: v for k, v in glaunch.items()
                                                              if v}))
    emit("serve_card_vs_cpu", rows=rows)
    for r in rows:
        assert r["logits_max_rel_diff"] <= 1e-5, f"serve card vs CPU {r['arch']}: {r}"
        assert r["tokens_equal"], f"serve card vs CPU {r['arch']}: tokens differ"
        kernel = "ssd_intra_chunk" if r["arch"].startswith("mamba2") else "decode_attention"
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


def _label(t) -> str:
    return t.meta.get("label", t.name)


def phase_main_sim():
    """bench_training_time's homo setup at n=16 on the card: the paper's
    baselines and BA-Topo at r ∈ {16, 24, 32} (solved on the card), all
    trained by one ``accuracy_curves`` call (30 epochs, batch 32, lr 0.05,
    momentum 0.9, hidden 128), every step's gossip one
    ``gossip_mix_batched`` launch per leaf for all topologies; the call is
    timed cold (its first run in the process) and warm. Checks: the warm
    call repeats the curves bitwise; the same call on the CPU within 0.005
    accuracy at every epoch; the host oracle on the card within 1e-6 for
    two topologies."""
    from repro_torch import kernels
    from repro_torch.core.bandwidth import homo_edge_bandwidth, min_edge_bandwidth, t_epoch
    from repro_torch.dsgd.sim import DSGDSimConfig, accuracy_curve_host, accuracy_curves

    n = SIM_N
    data = _sim_data(n)
    t0 = time.perf_counter()
    topos = _paper_baselines(n) + [_ba_topo(n, r, 600) for r in SIM_BUDGETS]
    topo_s = time.perf_counter() - t0
    Ws = np.stack([t.W for t in topos]).astype(np.float32)
    cfg = DSGDSimConfig(epochs=30, batch=32, lr=0.05, momentum=0.9, hidden=128, seed=0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    accs, iters = accuracy_curves(Ws, *data, cfg)          # ends in the host read
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
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
    expected = cfg.epochs * iters * SIM_LEAVES
    emit("main_sim", n=n, topologies=len(topos), epochs=cfg.epochs, iters=iters,
         batch=cfg.batch, rows=rows, best_ba_t_target_s=best_ba,
         best_baseline_t_target_s=best_other,
         speedup=best_other / best_ba if np.isfinite(best_ba) else None,
         topology_build_s=topo_s, curves_wall_s=wall_s, curves_wall_s_warm=warm_s,
         cpu_curves_wall_s=cpu_s,
         card_vs_cpu_max_acc_drift=drift, host_vs_curves_max_err=host_err,
         launches=launches, expected_gossip_launches=expected)
    assert accs.shape == (len(topos), cfg.epochs) and np.all(np.isfinite(accs))
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
    table, each against its plain version, timed in a CUDA graph beside
    ``torch.bmm`` of the stacked (T, n, n) W over the (T, n, M) view — the
    one PyTorch call for the same function. Bound: x read once, the output
    written once, and the table, at the card's memory rate. Then one
    profiled epoch of main_sim's call. Returns the w1 row."""
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
        xv = x.view(T, n, -1)
        t = timings(lambda: gm.gossip_mix_batched(x, idx, w),
                    lambda: gm.gossip_mix_batched_plain(x, idx, w),
                    lambda: torch.bmm(Wd, xv))
        nbytes = 2 * x.numel() * x.element_size() + _table_bytes(idx, w)
        cases.append(dict(leaf=k, shape=list(x.shape), dtype="float32", deg=int(idx.shape[1]),
                          max_abs_err=err, within=ok, **t,
                          bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes"))
        assert ok, f"gossip_mix_batched at the sim shape, {k}: outside the tolerance"
    xs = list(leaves.values())
    step_t = timings(lambda: [gm.gossip_mix_batched(x, idx, w) for x in xs],
                     lambda: [gm.gossip_mix_batched_plain(x, idx, w) for x in xs],
                     lambda: [torch.bmm(Wd, x.view(T, n, -1)) for x in xs])
    step_bytes = sum(2 * x.numel() * 4 + _table_bytes(idx, w) for x in xs)
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
    return next(c for c in cases if c["leaf"] == "w1")


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
        assert launches[spec.name] == cfg.epochs * iters * SIM_LEAVES, launches
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
    return launches


def phase_main_sim_chaos() -> dict:
    """bench_chaos's defaults on the card: the node-hetero BA-Topo at n=16,
    r=32 (solved on the card, sa_iters 400), 6 epochs under a fault spec
    with one churn window of node 5 from the drift step (a quarter of the
    run) for a sixth of the run, p_drop 0.03, straggler probability 0.05
    (×3), and the four fast NICs collapsing to 1 GB/s at the drift step;
    static and round-robin, dense, in one ``train_curves_chaos`` call; then
    120 iterations of ``consensus_curves_chaos``. Check: a ``no_chaos`` spec
    reproduces ``train_curves_cross`` bitwise. (bench_chaos's re-optimized
    run needs ``core/reopt.py``, not ported.)"""
    from repro_torch import kernels
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

    chaos = spec_for(cfg.epochs * iters)
    cycles = [static_cycle(topo.W), cycle_tensor(topo)]
    ones = np.ones(len(cycles))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    accs, _ = train_curves_chaos(cycles, ones, CommSpec(), chaos, *data, cfg)
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
         final_acc={"static": float(accs[0, -1]), "round_robin": float(accs[1, -1])},
         accs=accs.tolist(), curves_wall_s=wall_s, gossip_launches=launches,
         consensus_iters=120, consensus_final_rel_error=[float(e[-1] / e[0]) for e in errs],
         consensus_wall_s=cons_s, no_chaos_bitwise_equal_to_cross=bitwise)
    assert np.all(np.isfinite(accs)) and np.all(np.isfinite(errs))
    assert launches == cfg.epochs * iters * SIM_LEAVES, launches
    assert all(bitwise.values()), f"no_chaos differs from the cross engine: {bitwise}"
    return launches


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
    phase_device_and_build()
    timing = phase_kernels()

    from repro_torch.core import TopologyRequest, bcube_constraints

    res64, launches = phase_solve("main_n64", TopologyRequest(n=64, r=128, restarts=4))
    phase_solve("main_bcube", TopologyRequest(
        n=16, r=48, scenario="constraint", cs=bcube_constraints(p=4, k=2)))
    phase_card_vs_cpu()
    phase_consensus(res64.topology)
    phase_profile()

    state, topo, dsgd_launches, step1_err = phase_main_dsgd()
    timing.update(phase_gossip_kernels(state, topo))
    timing["gossip_mix_batched"]["max_abs_err"] = step1_err
    row_launches = phase_rowloop(state, topo)
    phase_profile_dsgd(state, topo)
    del state
    torch.cuda.empty_cache()
    phase_dsgd_card_vs_cpu()

    timing.update(phase_serve_kernels())
    dense = phase_serve_dense()
    ssm_run = phase_serve_ssm()
    phase_serve_card_vs_cpu()
    phase_profile_serve()
    phase_profile_prefill()

    topos, sim_data, Ws, sim_accs, sim_launches = phase_main_sim()
    timing["gossip_mix_batched"]["sim"] = dict(
        phase_sim_kernel(Ws, sim_data), launches=sim_launches["gossip_mix_batched"])
    phase_main_sim_cross(topos, sim_data, sim_accs)
    phase_main_sim_chaos()

    path_launches = {"gossip_mix_batched": dsgd_launches["gossip_mix_batched"],
                     "gossip_mix": row_launches["gossip_mix"],
                     "decode_attention": dense["launches"]["decode_attention"],
                     "ssd_intra_chunk": ssm_run["launches"]["ssd_intra_chunk"]}
    rows = []
    for name, info in KERNEL_INFO.items():
        t = timing[name]
        rows.append(dict(
            name=name, **info, launches=path_launches.get(name, launches[name]),
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], call_ms=t["call_ms"],
            **{k: t[k] for k in ("ms_warm", "library_ms_warm", "sim") if k in t}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
