"""The port on the card: each CUDA kernel against its plain version, and
the card's solver stages against the same stages on the CPU.

Every test here needs an NVIDIA card and skips without one (the ``cuda``
fixture decides at run time). On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py

This file imports no JAX, so it also runs where JAX is not installed.
Tolerances: L(g) within 1e-12 (fp64) or 1e-5 × the largest row sum
(fp32); the quadratic form bitwise; the hop and its counts exactly; one
float64 ADMM step card vs CPU within 1e-9 (the bit-packed hop also around
the 32-column word boundaries, past the plan that holds all of adj's
columns in one block, on directed graphs and on uint8 bytes > 1);
``aspl_matmul`` bit-equal to
``graph.aspl``; the gossip kernels within one ulp of the output dtype (none
for fp32) plus the float32 summation bound (deg+2)·2⁻²⁴·Σ|w·x| of their
plain versions, which sum the neighbour terms in another order; the row
loop of one-worker kernels and the first-cut witness kernel bitwise equal
to the tiled batched kernel (the same products added in the same order)
at n from 1 to 144, deg 1 to 7 with padded slots, rows aligned, misaligned,
narrower than a tile and of 1,000,003 elements, x off a 16-byte boundary,
and a group of leaves of three dtypes in one launch a dtype; the row limit
raising and an index out of range trapping; three DSGD steps of reduced smollm,
card vs CPU, within 1e-4 relative in the losses; ``decode_attention``
within the float32 bound of ``decode_attention_bound`` plus one output ulp,
one launch a call, at one split and many, at a cache shorter than a tile,
through each way of bringing a tile in, and after two calls in a row and a
CUDA-graph replay (the fused merge leaves its tickets at zero);
``ssd_intra_chunk`` within the float32 bounds of ``ssd_intra_chunk_bound``
on both routes (bfloat16 on the tensor cores, four chunks in one launch);
``edge_laplacian_blocks`` and the fused ``A_op`` bitwise equal to the L-only
kernel followed by the torch ops; ``edge_adjoint``'s edge entries bitwise
equal to the torch composition and its −tr P + tr Q within
2n·u·(Σ|P_ii| + Σ|Q_ii|) of ``torch.trace``'s; ``edge_schur_matvec`` and
the engine's ``schur_matvec`` bitwise equal to ``edge_laplacian_blocks``
fed ``edge_adjoint``'s output; the four ADMM-path forms with a batch axis
one launch for the batch and bitwise per instance against their unbatched
launches, and the batched ADMM against its sequential solves (float64:
λ̃ within 1e-9) and the CPU;
reduced fp32 serving of the six families (smollm, gemma2 and mixtral long
context, mamba2, granite-moe, internvl2 and whisper with stub embeddings,
zamba2 also long context), card vs CPU, within 1e-5 relative in the
logits of the prefill and 8 decode steps, with equal greedy tokens;
``decode_attention`` at zamba2's head dim 80 (16 lanes a key in bf16, 32
in fp32), internvl2's group of 7 and whisper's fp32 MHA, and
``ssd_intra_chunk`` at zamba2's N 64, H 80, and under ``vmap(grad)`` one
launch for four workers with gradients equal to a loop over them (within
1e-5 of their largest magnitude); three DSGD steps of each reduced trained
family card vs CPU within 1e-4 relative in the losses; the elastic mix over ``deg_cap = n − 1`` tables with
weights gathered from a degraded W within the gossip tolerance, and with no
faults bitwise the max-degree table's mix; a bfloat16 checkpoint restored
bit for bit onto the card; the ``kkt_bicgstab`` X-step, card vs CPU within
1e-8 (two ``edge_laplacian_blocks`` and two ``edge_adjoint`` launches an
iteration, no ``edge_schur_matvec``), and the per-iteration driver with it
and with the scipy ILU within 1e-8 in λ̃; the ``--sync dynamic`` step's mix
over each matching's deg-1 table within the gossip tolerance and bitwise
the witness kernel's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as t_graph  # noqa: E402
from repro_torch.core.anneal import greedy_degree_graph  # noqa: E402
from repro_torch.core.warmstart import anneal_topology_batched, aspl_matmul  # noqa: E402
from repro_torch.kernels.edge_laplacian import ops as tel  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as tgm  # noqa: E402
from repro_torch.kernels.hop_bfs import ops as thop  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _edges(n):
    iu = np.triu_indices(n, 1)
    return iu[0].astype(np.int64), iu[1].astype(np.int64)


def _random_adj(n, p, rng):
    up = np.triu(rng.random((n, n)) < p, 1)
    return up | up.T


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 9, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_laplacian_kernel_on_card(cuda, n, dtype):
    g = torch.rand(n * (n - 1) // 2, dtype=dtype, device=cuda)
    before = tel.edge_laplacian.launches
    got = tel.edge_laplacian(g, n)
    want = tel.edge_laplacian_plain(g, tel.packed_edge_index(n, "cuda"))
    torch.cuda.synchronize()
    assert tel.edge_laplacian.launches == before + 1
    tol = 1e-12 if dtype == torch.float64 else 1e-5 * float(want.diagonal().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 9, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_quadform_kernel_bitwise_on_card(cuda, n, dtype):
    ei, ej = (torch.from_numpy(a).to(cuda) for a in _edges(n))
    P = torch.randn(n, n, dtype=dtype, device=cuda)
    got = tel.edge_quadform(P, ei, ej)
    want = tel.edge_quadform_plain(P, ei, ej)
    torch.cuda.synchronize()
    as_int = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(as_int), want.view(as_int))


def _adjoint_operands(n, dtype, hetero, device, seed=0):
    rng = np.random.default_rng(seed + n)
    P, Q = (torch.from_numpy(rng.standard_normal((n, n))).to(device=device, dtype=dtype)
            for _ in range(2))
    w = torch.from_numpy(rng.standard_normal(n)).to(device=device, dtype=dtype)
    v = (torch.from_numpy(rng.standard_normal(n * (n - 1) // 2)).to(device=device, dtype=dtype)
         if hetero else None)
    return P, Q, w, v


def _trace_tol(P, Q):
    u = torch.finfo(P.dtype).eps / 2
    return 2 * P.shape[0] * u * float(P.diagonal().abs().sum() + Q.diagonal().abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hetero", [False, True])
def test_edge_adjoint_kernel_on_card(cuda, n, dtype, hetero):
    """One launch; the edge entries bitwise equal to the torch composition
    on the card, −tr P + tr Q within 2n·u·(Σ|P_ii| + Σ|Q_ii|)."""
    P, Q, w, v = _adjoint_operands(n, dtype, hetero, cuda)
    m = n * (n - 1) // 2
    before = tel.edge_adjoint.launches
    got = tel.edge_adjoint(P, Q, w, v)
    assert tel.edge_adjoint.launches == before + 1
    want = tel.edge_adjoint_plain(P, Q, w, v)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    torch.cuda.synchronize()
    assert tuple(got.shape) == (m + 1,)
    assert torch.equal(got[:m].view(bits), want[:m].view(bits))
    assert abs(float(got[m] - want[m])) <= _trace_tol(P, Q)

@pytest.mark.cuda
@pytest.mark.parametrize("R,n", [(1, 5), (4, 64), (3, 100), (4, 256)])
def test_hop_step_kernel_on_card(cuda, R, n):
    rng = np.random.default_rng(n)
    adj = np.stack([_random_adj(n, 4.0 / n, rng) for _ in range(R)])
    reach = torch.from_numpy(adj | np.eye(n, dtype=bool)[None]).to(cuda)
    adj_t = torch.from_numpy(adj).to(cuda)
    for _ in range(3):
        got, got_rows = thop.hop_step(reach, adj_t)
        want, want_rows = thop.hop_step_plain(reach, adj_t)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_rows, want_rows)
        reach = got


@pytest.mark.cuda
@pytest.mark.parametrize("R,n", [(1, 31), (1, 32), (1, 33), (2, 63), (1, 64), (3, 65),
                                 (1, 127), (4, 129), (4, 256), (1, 1000), (1, 2000)])
@pytest.mark.parametrize("kind", ["symmetric", "directed", "uint8"])
def test_hop_step_bits_bitwise_on_card(cuda, R, n, kind):
    """The bit-packed hop, three hops deep, bitwise against the plain
    version: around the 32-column word boundaries, at n = 1,000 and past
    n = 1,300 (where one block no longer holds all of adj's columns), on
    directed graphs (adj not symmetric) and on uint8 inputs whose nonzero
    bytes are not all 1."""
    rng = np.random.default_rng(1000 * R + n)
    p = min(1.0, 3.0 / n)
    if kind == "directed":
        adj = rng.random((R, n, n)) < p
    else:
        adj = np.stack([_random_adj(n, p, rng) for _ in range(R)])
    reach = adj | np.eye(n, dtype=bool)[None]
    if kind == "uint8":
        scale = rng.integers(1, 256, (R, n, n)).astype(np.uint8)
        reach_t = torch.from_numpy(reach.astype(np.uint8) * scale).to(cuda)
        adj_t = torch.from_numpy(adj.astype(np.uint8) * scale).to(cuda)
    else:
        reach_t, adj_t = torch.from_numpy(reach).to(cuda), torch.from_numpy(adj).to(cuda)
    before = thop.hop_step.launches
    for _ in range(3):
        got, got_rows = thop.hop_step(reach_t, adj_t)
        want, want_rows = thop.hop_step_plain(reach_t, adj_t)
        torch.cuda.synchronize()
        assert got.dtype == reach_t.dtype
        assert torch.equal(got, want) and torch.equal(got_rows, want_rows)
        reach_t = got
    assert thop.hop_step.launches == before + 3


def _a_op_composition(spec, X, L):
    """A_op's blocks as the engine composed them before the fused form."""
    x, S, y, T = X[:4]
    g, lam = x[:-1], x[-1]
    blocks = [(L - lam * spec.I + S).reshape(-1), (L + lam * spec.I + T).reshape(-1),
              torch.diagonal(L) + y]
    if spec.hetero:
        z, nu, s = X[4], X[5], X[6]
        r4 = spec.M @ z
        if not spec.equality:
            r4 = r4 + s
        blocks += [r4, g - z + nu]
    return torch.cat(blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lam", [0.37, -0.7])
def test_edge_laplacian_blocks_bitwise_on_card(cuda, n, dtype, lam):
    """One launch writes A_op's three dense blocks bit-equal to the L-only
    kernel followed by the torch ops (λ·I's signed zeros included)."""
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.random(n * (n - 1) // 2)).to(device=cuda, dtype=dtype)
    S, T = (torch.from_numpy(rng.standard_normal((n, n))).to(device=cuda, dtype=dtype)
            for _ in range(2))
    y = torch.from_numpy(rng.standard_normal(n)).to(device=cuda, dtype=dtype)
    lam_t = torch.tensor(lam, dtype=dtype, device=cuda)
    out = torch.full((2 * n * n + n + 5,), 7.0, dtype=dtype, device=cuda)
    before = tel.edge_laplacian_blocks.launches
    tel.edge_laplacian_blocks(g, lam_t, S, T, y, out)
    assert tel.edge_laplacian_blocks.launches == before + 1
    L = tel.edge_laplacian(g, n)
    I = torch.eye(n, dtype=dtype, device=cuda)
    want = torch.cat([(L - lam_t * I + S).reshape(-1), (L + lam_t * I + T).reshape(-1),
                      torch.diagonal(L) + y])
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    torch.cuda.synchronize()
    assert torch.equal(out[:2 * n * n + n].view(bits), want.view(bits))
    assert bool((out[2 * n * n + n:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_a_op_fused_form_bitwise_on_card(cuda, hetero, dtype):
    """A_op on the card: one edge_laplacian_blocks launch (and no other of
    the port's kernels), the heterogeneous rows written into slices of the
    same output, bit-equal to the composition with the L-only kernel."""
    from repro_torch.core.constraints import bcube_constraints

    cfg = te.ADMMConfig(device="cuda", dtype=dtype)
    if hetero:
        cs = bcube_constraints(p=4, k=2)
        spec = te.make_hetero_spec(16, 48, cs.M, cs.e_cap, cfg, equality=False,
                                   edge_ok=cs.edge_ok)
    else:
        spec = te.make_homo_spec(64, 128, cfg)
    st = te.init_state(spec, np.random.default_rng(spec.n).random(spec.m) * 0.3, 0.5)
    st, _ = te.step(spec, st)
    kernels.reset_launch_counts()
    got = te.A_op(spec, st.X)
    counts = kernels.launch_counts()
    assert counts["edge_laplacian_blocks"] == 1 and sum(counts.values()) == 1, counts
    want = _a_op_composition(spec, st.X, te._L_of_g(spec, st.X[0][:-1]))
    bits = torch.int32 if dtype == "float32" else torch.int64
    torch.cuda.synchronize()
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hetero", [False, True])
def test_edge_schur_matvec_bitwise_on_card(cuda, n, dtype, hetero):
    """One launch writes the matvec's dense blocks (and the adjoint on
    request) bit-equal to ``edge_laplacian_blocks`` fed ``edge_adjoint``'s
    output, leaving the rest of ``out`` alone; against the plain torch
    composition (L's degrees and the traces summed in another order) within
    2n·u·(max row Σ|xg| + Σ|P_ii| + Σ|Q_ii|) + 2u·max|out|."""
    P, Q, w, v = _adjoint_operands(n, dtype, hetero, cuda, seed=7)
    m, k = n * (n - 1) // 2, 2 * n * n + n
    out = torch.full((k + 5,), 7.0, dtype=dtype, device=cuda)
    x_adj = torch.empty(m + 1, dtype=dtype, device=cuda)
    before = tel.edge_schur_matvec.launches
    tel.edge_schur_matvec(P, Q, w, out, v=v, x_adj=x_adj)
    assert tel.edge_schur_matvec.launches == before + 1
    x = tel.edge_adjoint(P, Q, w, v)
    want = torch.empty(k, dtype=dtype, device=cuda)
    tel.edge_laplacian_blocks(x[:-1], x[-1], P, Q, w, want)
    plain = tel.edge_schur_matvec_plain(P, Q, w, torch.empty(k, dtype=dtype, device=cuda), v)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    torch.cuda.synchronize()
    assert torch.equal(out[:k].view(bits), want.view(bits))
    assert torch.equal(x_adj.view(bits), x.view(bits))
    assert bool((out[k:] == 7.0).all())
    G = torch.cat([x[:-1].abs(), x.new_zeros(1)])[tel.packed_edge_index(n, "cuda")]
    u = torch.finfo(dtype).eps / 2
    tol = (2 * n * u * float(G.sum(dim=1).max()) + _trace_tol(P, Q)
           + 2 * u * float(plain.abs().max()))
    assert float((out[:k] - plain).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["homo", "bcube_eq", "bcube_ineq"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schur_matvec_fused_bitwise_on_card(cuda, scenario, dtype):
    """The engine's CG matvec on the card: one edge_schur_matvec launch and
    no other of the port's kernels, bit-equal to ``A_op(AT_op(λ))`` through
    ``edge_adjoint`` and ``edge_laplacian_blocks`` (the heterogeneous rows
    by the same torch ops); ``AT_op`` is one edge_adjoint launch."""
    from repro_torch.core.constraints import bcube_constraints

    cfg = te.ADMMConfig(device="cuda", dtype=dtype)
    if scenario == "homo":
        spec = te.make_homo_spec(64, 128, cfg)
    else:
        cs = bcube_constraints(p=4, k=2)
        spec = te.make_hetero_spec(16, 48, cs.M, cs.e_cap, cfg,
                                   equality=scenario == "bcube_eq", edge_ok=cs.edge_ok)
    lam = torch.from_numpy(np.random.default_rng(spec.n).standard_normal(
        sum(te.lam_sizes(spec)))).to(device=cuda, dtype=getattr(torch, dtype))
    kernels.reset_launch_counts()
    got = te.schur_matvec(spec, lam)
    counts = kernels.launch_counts()
    assert counts["edge_schur_matvec"] == 1 and sum(counts.values()) == 1, counts
    kernels.reset_launch_counts()
    X = te.AT_op(spec, lam)
    counts = kernels.launch_counts()
    assert counts["edge_adjoint"] == 1 and sum(counts.values()) == 1, counts
    want = te.A_op(spec, X)
    bits = torch.int32 if dtype == "float32" else torch.int64
    torch.cuda.synchronize()
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
def test_adjoint_wrappers_raise_instead_of_falling_back(cuda):
    P, Q, w = (torch.rand(4, 4, dtype=torch.float16, device=cuda),
               torch.rand(4, 4, dtype=torch.float16, device=cuda),
               torch.rand(4, dtype=torch.float16, device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        tel.edge_adjoint(P, Q, w)
    with pytest.raises(TypeError, match="float32 or float64"):
        tel.edge_schur_matvec(P, Q, w, torch.empty(36, dtype=torch.float16, device=cuda))
    P = torch.rand(4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tel.edge_adjoint(P.t(), P, torch.rand(4, device=cuda))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tel.edge_schur_matvec(P, P, torch.rand(4, device=cuda), torch.empty(36))

@pytest.mark.cuda
def test_kernel_wrappers_raise_instead_of_falling_back(cuda):
    g = torch.rand(6, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        tel.edge_laplacian(g, 4)
    P = torch.rand(4, 4, device=cuda)
    with pytest.raises(TypeError, match="int64"):
        tel.edge_quadform(P, torch.zeros(2, dtype=torch.int32, device=cuda),
                          torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tel.edge_quadform(P.t(), torch.zeros(2, dtype=torch.int64, device=cuda),
                          torch.zeros(2, dtype=torch.int64, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("hetero", [False, True])
def test_admm_step_card_matches_cpu(cuda, hetero):
    from repro_torch.core.constraints import bcube_constraints

    n, r = (16, 48) if hetero else (12, 24)
    rng = np.random.default_rng(n)
    g0 = rng.random(n * (n - 1) // 2) * 0.3
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = te.ADMMConfig(device=dev)
        if hetero:
            cs = bcube_constraints(p=4, k=2)
            spec = te.make_hetero_spec(n, r, cs.M, cs.e_cap, cfg, equality=False,
                                       edge_ok=cs.edge_ok)
        else:
            spec = te.make_homo_spec(n, r, cfg)
        st = te.init_state(spec, g0, 0.5)
        kernels.reset_launch_counts()
        for _ in range(3):
            st, res = te.step(spec, st)
        out[dev] = (st, float(res), kernels.launch_counts())
    (cpu, cpu_res, _), (gpu, gpu_res, counts) = out["cpu"], out["cuda"]
    # each step: A_op of the right-hand side, the CG matvecs and the last
    # AT_op in one launch each; the standalone quadratic form not at all
    assert counts["edge_laplacian_blocks"] == 3 and counts["edge_adjoint"] == 3, counts
    assert counts["edge_schur_matvec"] >= 3 and counts["edge_quadform"] == 0, counts
    for a, b in zip(gpu.X + gpu.Y + gpu.D, cpu.X + cpu.Y + cpu.D):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-9)
    assert abs(gpu_res - cpu_res) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(16, 0.3), (64, 0.07), (40, 0.02)])
def test_aspl_matmul_on_card_bit_equals_graph_aspl(cuda, n, p):
    rng = np.random.default_rng(n)
    up = np.triu(rng.random((n, n)) < p, 1)
    edges = [(int(i), int(j)) for i, j in zip(*np.nonzero(up))]
    kernels.reset_launch_counts()
    got = aspl_matmul(up | up.T)
    want = t_graph.aspl(n, edges)
    assert got == want or (np.isinf(got) and np.isinf(want))
    assert kernels.launch_counts()["hop_step"] > 0 or np.isinf(want)


@pytest.mark.cuda
def test_device_sa_on_card_keeps_invariants(cuda):
    n = 32
    rng = np.random.default_rng(0)
    starts = [greedy_degree_graph(n, np.full(n, 4), rng) for _ in range(3)]
    outs = anneal_topology_batched(n, starts, None, iters=100, seeds=[0, 1, 2])
    for e0, e1 in zip(starts, outs):
        d0 = np.bincount(np.asarray(e0).reshape(-1), minlength=n)
        d1 = np.bincount(np.asarray(e1).reshape(-1), minlength=n)
        assert (d0 == d1).all() and t_graph.is_connected(n, e1)
        assert t_graph.aspl(n, e1) <= t_graph.aspl(n, e0)


def _gossip_table(n, deg, rng):
    """A padded neighbour table of max degree ``deg``: row i's first k_i ≤
    deg slots are distinct other rows, the rest point at i with weight 0."""
    idx = np.empty((n, deg), np.int32)
    w = np.zeros((n, deg + 1), np.float32)
    for i in range(n):
        others = [j for j in range(n) if j != i]
        k = min(deg, len(others), int(rng.integers(1, deg + 1)) if i % 2 and deg else deg)
        pick = rng.choice(others, size=k, replace=False) if k else []
        idx[i, :k] = pick
        idx[i, k:] = i
        ws = rng.random(k + 1)
        w[i, :k + 1] = ws / ws.sum()
    return idx, w


def _gossip_tol(got, want, terms, deg, dtype):
    """Per element: one ulp of ``dtype`` at the larger result (0 for fp32)
    plus the float32 summation bound over the terms Σ|w·x|."""
    bound = (deg + 2) * 2.0 ** -24 * terms
    if dtype == torch.float32:
        return bound
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    return bound + torch.ldexp(torch.full_like(bound, torch.finfo(dtype).eps), e - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,shape,deg", [(8, (130,), 3), (4, (4, 7), 1), (8, (8, 130), 7),
                                         (3, (1000003,), 2), (6, (64, 64), 5), (1, (5,), 1),
                                         (8, (17280,), 5)])
def test_gossip_mix_batched_kernel_on_card(cuda, dtype, n, shape, deg):
    rng = np.random.default_rng(n * 31 + deg)
    idx_np, w_np = _gossip_table(n, deg, rng)
    idx, w = torch.from_numpy(idx_np).to(cuda), torch.from_numpy(w_np).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n,) + shape).astype(np.float32)).to(cuda, dtype)
    before = tgm.gossip_mix_batched.launches
    got = tgm.gossip_mix_batched(x, idx, w)
    want = tgm.gossip_mix_batched_plain(x, idx, w)
    torch.cuda.synchronize()
    assert tgm.gossip_mix_batched.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    terms = tgm.gossip_mix_batched_plain(x.double().abs(), idx, w.abs()).float()
    err = (got.float() - want.float()).abs()
    assert bool((err <= _gossip_tol(got.float(), want.float(), terms, deg, dtype)).all())
    # the row loop of one-worker kernels: the same sums in the same order
    rows = torch.stack([tgm.gossip_mix(x[i], x[idx[i].long()], w[i].contiguous())
                        for i in range(n)])
    torch.cuda.synchronize()
    assert torch.equal(rows, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,deg", [(130, 0), (7, 1), (4099, 5), (1 << 20, 7)])
def test_gossip_mix_one_worker_kernel_on_card(cuda, dtype, M, deg):
    rng = np.random.default_rng(M + deg)
    x = torch.from_numpy(rng.standard_normal(M).astype(np.float32)).to(cuda, dtype)
    nbrs = torch.from_numpy(rng.standard_normal((deg, M)).astype(np.float32)).to(cuda, dtype)
    w_np = rng.random(deg + 1).astype(np.float32)
    w = torch.from_numpy(w_np / w_np.sum()).to(cuda)
    before = tgm.gossip_mix.launches
    got = tgm.gossip_mix(x, nbrs, w)
    want = tgm.gossip_mix_plain(x, nbrs, w)
    torch.cuda.synchronize()
    assert tgm.gossip_mix.launches == before + 1
    terms = tgm.gossip_mix_plain(x.double().abs(), nbrs.double().abs(), w.abs()).float()
    err = (got.float() - want.float()).abs()
    assert bool((err <= _gossip_tol(got.float(), want.float(), terms, deg, dtype)).all())


@pytest.mark.cuda
def test_gossip_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((4, 6), device=cuda)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    w = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.gossip_mix_batched(torch.zeros((6, 4), device=cuda).t(), idx, w)
    with pytest.raises(TypeError, match="int32"):
        tgm.gossip_mix_batched(x, idx.long(), w)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tgm.gossip_mix_batched(x.double(), idx, w)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tgm.gossip_mix_batched(x, idx.cpu(), w)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.gossip_mix(x[:, 0], torch.zeros((2, 4), device=cuda), torch.zeros(3, device=cuda))


def _tiled_vs_witness(x, idx, w):
    """The tiled kernel's mix of x against the first-cut kernel's and the
    row loop of one-worker kernels: the same products added in the same
    order, so all three bitwise equal."""
    got = tgm.gossip_mix_batched(x, idx, w)
    wit = tgm.gossip_mix_batched_witness(x, idx, w)
    rows = torch.stack([tgm.gossip_mix(x[i], x[idx[i].long()], w[i].contiguous())
                        for i in range(x.shape[0])])
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, wit) and torch.equal(got, rows)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("deg", [0, 1, 3, 4, 6, 7, 8, 12])
@pytest.mark.parametrize("n", [1, 3, 4, 8, 144])
def test_gossip_tiled_kernel_bitwise_witness_and_rowloop_on_card(cuda, n, deg, dtype):
    """Every table of max degree ``deg`` (rows with fewer neighbours padded
    with weight-0 slots) at an aligned row, one launch: deg 0…7 take the
    unrolled slot loops, 8 and 12 the runtime one."""
    rng = np.random.default_rng(n * 101 + deg)
    idx_np, w_np = _gossip_table(n, deg, rng)
    idx, w = torch.from_numpy(idx_np).to(cuda), torch.from_numpy(w_np).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, 3, 1000)).astype(np.float32)).to(cuda, dtype)
    before = tgm.gossip_mix_batched.launches
    _tiled_vs_witness(x, idx, w)
    assert tgm.gossip_mix_batched.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [4096, 4099, 5, 1_000_003])
@pytest.mark.parametrize("n,deg", [(8, 4), (3, 2), (144, 6)])
def test_gossip_tiled_kernel_row_lengths_on_card(cuda, n, deg, M, dtype):
    """Rows aligned, with M·size % 16 ≠ 0, narrower than one tile, and of
    1,000,003 elements (many tiles and a ragged last one)."""
    rng = np.random.default_rng(M + n)
    idx_np, w_np = _gossip_table(n, deg, rng)
    idx, w = torch.from_numpy(idx_np).to(cuda), torch.from_numpy(w_np).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, M)).astype(np.float32)).to(cuda, dtype)
    _tiled_vs_witness(x, idx, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_gossip_tiled_kernel_reads_misaligned_rows_on_card(cuda, dtype):
    """x one element past a 16-byte boundary: its rows come in element by
    element, the output (fresh) is stored 16 bytes at a time."""
    n, deg, M = 8, 4, 4096
    rng = np.random.default_rng(5)
    idx_np, w_np = _gossip_table(n, deg, rng)
    idx, w = torch.from_numpy(idx_np).to(cuda), torch.from_numpy(w_np).to(cuda)
    buf = torch.from_numpy(rng.standard_normal(n * M + 1).astype(np.float32)).to(cuda, dtype)
    x = buf[1:].view(n, M)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _tiled_vs_witness(x, idx, w)


@pytest.mark.cuda
def test_gossip_leaves_one_launch_per_dtype_on_card(cuda):
    """Leaves of mixed sizes and dtypes over one table: one launch per
    dtype, each leaf bitwise its own one-leaf mix and the witness's."""
    n, deg = 8, 5
    rng = np.random.default_rng(9)
    idx_np, w_np = _gossip_table(n, deg, rng)
    idx, w = torch.from_numpy(idx_np).to(cuda), torch.from_numpy(w_np).to(cuda)
    shapes = [(130,), (4, 7), (49, 4096), (1,), (3, 1000), (10,), (2, 50_001)]
    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float16, torch.float32,
              torch.bfloat16, torch.float32]
    xs = [torch.from_numpy(rng.standard_normal((n,) + s).astype(np.float32)).to(cuda, dt)
          for s, dt in zip(shapes, dtypes)]
    before = tgm.gossip_mix_batched.launches
    got = tgm.gossip_mix_batched_leaves(xs, idx, w)
    torch.cuda.synchronize()
    assert tgm.gossip_mix_batched.launches == before + len(set(dtypes))
    for g, x in zip(got, xs):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, tgm.gossip_mix_batched_witness(x, idx, w))
        assert torch.equal(g, tgm.gossip_mix_batched(x, idx, w))


@pytest.mark.cuda
def test_gossip_tiled_kernel_raises_past_the_row_limit(cuda):
    deg = 6
    n = tgm.max_rows(deg) + 1
    idx = torch.zeros((n, deg), dtype=torch.int32, device=cuda)
    w = torch.zeros((n, deg + 1), device=cuda)
    before = tgm.gossip_mix_batched.launches
    with pytest.raises(ValueError, match="rows at deg 6"):
        tgm.gossip_mix_batched(torch.zeros((n, 64), device=cuda), idx, w)
    assert tgm.gossip_mix_batched.launches == before


@pytest.mark.cuda
def test_gossip_tiled_kernel_traps_an_index_out_of_range(cuda):
    """A neighbour index outside [0, n) traps; the trap leaves the context
    unusable, so the launch runs in a child process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    code = ("import torch\n"
            "from repro_torch.kernels.gossip_mix import ops\n"
            "idx = torch.tensor([[1], [2], [3]], dtype=torch.int32, device='cuda')\n"
            "w = torch.full((3, 2), 0.5, device='cuda')\n"
            "x = torch.ones((3, 64), device='cuda')\n"
            "ops.gossip_mix_batched(x, idx, w)\n"
            "torch.cuda.synchronize()\n"
            "print('no trap')\n")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "no trap" not in r.stdout, (r.stdout, r.stderr)


@pytest.mark.cuda
@pytest.mark.parametrize("hetero", [False, True])
def test_kkt_bicgstab_step_card_matches_cpu(cuda, hetero):
    """Three float64 ADMM steps by ``kkt_bicgstab``: two
    ``edge_laplacian_blocks`` and two ``edge_adjoint`` launches a Bi-CGSTAB
    iteration and one more of each for its first residual, no
    ``edge_schur_matvec``; every block within 1e-8 of the CPU's (each solve
    stops at the relative tolerance 1e-11, the CPU's dots in another order)."""
    from repro_torch.core.constraints import bcube_constraints

    n, r = (16, 48) if hetero else (12, 24)
    rng = np.random.default_rng(n)
    g0 = rng.random(n * (n - 1) // 2) * 0.3
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = te.ADMMConfig(device=dev)
        if hetero:
            cs = bcube_constraints(p=4, k=2)
            spec = te.make_hetero_spec(n, r, cs.M, cs.e_cap, cfg, equality=False,
                                       edge_ok=cs.edge_ok)
        else:
            spec = te.make_homo_spec(n, r, cfg)
        st = te.init_state(spec, g0, 0.5)
        kernels.reset_launch_counts()
        for _ in range(3):
            st, res = te.step(spec, st, "kkt_bicgstab")
        out[dev] = (st, float(res), kernels.launch_counts())
    (cpu, cpu_res, _), (gpu, gpu_res, counts) = out["cpu"], out["cuda"]
    assert counts["edge_schur_matvec"] == 0 and counts["edge_quadform"] == 0, counts
    assert counts["edge_laplacian_blocks"] == counts["edge_adjoint"] >= 9, counts
    assert counts["edge_laplacian_blocks"] % 2 == 1, counts        # 3 starts + 2 an iteration
    assert int(gpu.cg) == 0
    for a, b in zip(gpu.X + gpu.Y + gpu.D, cpu.X + cpu.Y + cpu.D):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-8)
    assert abs(gpu_res - cpu_res) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["kkt_bicgstab", "kkt_bicgstab_ilu"])
def test_python_driver_card_matches_cpu(cuda, solver):
    """60 float64 iterations by the per-iteration driver (``kkt_bicgstab``,
    or the scipy ILU with the projections on the device): the same history
    cadence and support, λ̃ within 1e-8 of the CPU's."""
    from repro_torch.core.admm import HomogeneousADMM

    g0 = np.random.default_rng(8).random(28) * 0.3
    res = {dev: HomogeneousADMM(8, 12, te.ADMMConfig(max_iters=60, driver="python",
                                                     solver=solver, device=dev)
                                ).solve(g0=g0, lam0=0.4) for dev in ("cpu", "cuda")}
    a, b = res["cuda"], res["cpu"]
    assert [h[0] for h in a.history] == [h[0] for h in b.history]
    assert abs(a.lam_tilde - b.lam_tilde) <= 1e-8
    assert np.array_equal(a.g > 1e-6, b.g > 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_step_mix_on_card(cuda, dtype, monkeypatch):
    """Three ``--sync dynamic`` steps of reduced smollm over the 5-ring's
    three matchings: each step's mix one ``gossip_mix_batched`` launch a
    dtype over the deg-1 table of slot ``step mod 3``, within the gossip
    tolerance of the plain version and bitwise the witness kernel's; the
    losses within 1e-4 relative of the CPU's (float32)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.core.topologies import make_baseline
    from repro_torch.data import DataConfig, lm_batch_numpy
    from repro_torch.dsgd import init_dsgd_state, trainer
    from repro_torch.dsgd.dynamic import cycle_weight_matrices, round_robin_schedules
    from repro_torch.dsgd.gossip import padded_neighbors
    from repro_torch.launch import train
    from repro_torch.optim import make_optimizer, warmup_cosine

    cfg = dataclasses.replace(reduced_for_smoke(get_arch("smollm-135m")), dtype=dtype)
    n, topo = 5, make_baseline("ring", 5)
    Wc = cycle_weight_matrices(round_robin_schedules(topo))
    init, upd = make_optimizer("sgd", warmup_cosine(0.05, 1, 3))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=2, seed=0)
    mix = trainer.gossip_sim_tree
    seen = []

    def checked(tree, W, *, use_kernel=True, nbr=None):
        out = mix(tree, W, use_kernel=use_kernel, nbr=nbr)
        if W.is_cuda:
            seen.append((tree, out, nbr))
        return out

    monkeypatch.setattr(trainer, "gossip_sim_tree", checked)
    losses = {}
    for dev in ("cpu", "cuda"):
        state = init_dsgd_state(0, cfg, n, init, device=dev)
        step, rounds = train._dynamic_step(cfg, topo, upd, device=dev)
        assert rounds == 3
        kernels.reset_launch_counts()
        losses[dev] = []
        for s in range(3):
            per = [lm_batch_numpy(dc, s, node=i) for i in range(n)]
            batch = {k: torch.from_numpy(np.stack([b[k] for b in per])).to(dev) for k in per[0]}
            state, m = step(state, batch)
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            dtypes = {x.dtype for x in torch.utils._pytree.tree_leaves(state.params)}
            assert kernels.launch_counts()["gossip_mix_batched"] == 3 * len(dtypes)
    for t, (tree, out, (idx, w)) in enumerate(seen):
        want_idx, want_w = padded_neighbors(Wc[t % 3].astype(np.float32))
        assert torch.equal(idx.cpu(), want_idx) and torch.equal(w.cpu(), want_w)
        for x, got in zip(torch.utils._pytree.tree_leaves(tree),
                          torch.utils._pytree.tree_leaves(out)):
            want = tgm.gossip_mix_batched_plain(x, idx, w)
            terms = tgm.gossip_mix_batched_plain(x.double().abs(), idx, w.abs()).float()
            err = (got.float() - want.float()).abs()
            assert bool((err <= _gossip_tol(got.float(), want.float(), terms, 1,
                                            x.dtype)).all())
            assert torch.equal(got, tgm.gossip_mix_batched_witness(x, idx, w))
    if dtype == "float32":
        for a, b in zip(losses["cuda"], losses["cpu"]):
            assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.cuda
def test_dsgd_steps_card_match_cpu(cuda):
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.core.topologies import make_baseline
    from repro_torch.data import DataConfig, lm_batch_numpy
    from repro_torch.dsgd import dsgd_train_step, init_dsgd_state
    from repro_torch.optim import make_optimizer, warmup_cosine

    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    n = 4
    init, upd = make_optimizer("sgd", warmup_cosine(0.05, 1, 3))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=2, seed=0)
    losses = {}
    for dev in ("cpu", "cuda"):
        state = init_dsgd_state(0, cfg, n, init, device=dev)
        step = dsgd_train_step(cfg, make_baseline("ring", n), upd, device=dev)
        kernels.reset_launch_counts()
        losses[dev] = []
        for s in range(3):
            per = [lm_batch_numpy(dc, s, node=i) for i in range(n)]
            batch = {k: torch.from_numpy(np.stack([b[k] for b in per])).to(dev) for k in per[0]}
            state, m = step(state, batch)
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":       # all leaves in one launch a step: one dtype
            assert kernels.launch_counts()["gossip_mix_batched"] == 3 * len(
                {x.dtype for x in torch.utils._pytree.tree_leaves(state.params)})
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b)


def _ulp(x, dtype):
    if dtype == torch.float32:
        return torch.zeros_like(x)
    _, e = torch.frexp(x)
    return torch.ldexp(torch.full_like(x, torch.finfo(dtype).eps), e - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Hq,Hkv,hd,dtype,cap,mask", [
    (16, 2184, 9, 3, 64, torch.bfloat16, 0.0, "linear"),       # smollm-135m serving
    (4, 4224, 16, 8, 256, torch.bfloat16, 50.0, "window"),     # gemma2-9b local layer
    (4, 4224, 16, 8, 256, torch.float32, 50.0, "window"),
    (4, 4096, 16, 8, 256, torch.bfloat16, 50.0, "ring"),
    (2, 700, 8, 2, 128, torch.float16, 0.0, "last"),           # minitron head dim
    (2, 40, 4, 1, 32, torch.float32, 0.0, "none"),             # reduced configs
    (3, 129, 12, 2, 64, torch.bfloat16, 0.0, "linear"),        # group 6: two head chunks
    (8, 1096, 32, 32, 80, torch.bfloat16, 0.0, "linear"),      # zamba2-2.7b: hd 80, 16 lanes
    (8, 1096, 32, 32, 80, torch.float32, 0.0, "linear"),       # hd 80 in fp32: 32 lanes
    (2, 300, 4, 2, 80, torch.float16, 50.0, "window"),         # hd 80, group 2, softcap
    (16, 1096, 14, 2, 64, torch.bfloat16, 0.0, "linear"),      # internvl2-1b: a group of 7
    (16, 200, 6, 6, 64, torch.float32, 0.0, "linear"),         # whisper-tiny: fp32 MHA
    (16, 1096, 16, 8, 64, torch.bfloat16, 0.0, "linear"),      # granite-moe-1b-a400m
])
def test_decode_attention_kernel_on_card(cuda, B, C, Hq, Hkv, hd, dtype, cap, mask):
    """Within the float32 bound of decode_attention_bound plus one output ulp."""
    from repro_torch.kernels.decode_attention import ops as tdec
    from repro_torch.models.attention import decode_valid

    gen = torch.Generator(device="cuda").manual_seed(C)
    valid = {"linear": decode_valid(C, C - 20, device=cuda),
             "window": decode_valid(C, C - 24, 4096, device=cuda),
             "ring": decode_valid(C, 2500, ring=True, device=cuda),
             "last": torch.arange(C, device=cuda) == C - 1,
             "none": torch.zeros(C, dtype=torch.bool, device=cuda)}[mask]
    q = torch.randn((B, Hq, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, C, Hkv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, C, Hkv, hd), generator=gen, device=cuda).to(dtype)
    before = tdec.decode_attention.launches
    got = tdec.decode_attention(q, k, v, valid, attn_softcap=cap)
    want = tdec.decode_attention_plain(q, k, v, valid, attn_softcap=cap)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == before + 1 and got.dtype == dtype
    got, want = got.float(), want.float()
    tol = tdec.decode_attention_bound(q, k, v, valid, attn_softcap=cap)
    tol = tol + _ulp(torch.maximum(got.abs(), want.abs()), dtype)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Hq,Hkv,hd,dtype", [
    (2, 20, 6, 2, 64, torch.bfloat16),        # C shorter than one 32-key tile, group 3
    (1, 100, 1, 1, 64, torch.float32),        # one split
    (2, 300, 12, 2, 64, torch.float16),       # group 6: two chunks of 3 heads, many splits
    (1, 3000, 8, 1, 128, torch.bfloat16),     # one KV head, many splits
    (2, 10, 2, 2, 80, torch.bfloat16),        # hd 80, C shorter than a tile
    (1, 2000, 7, 1, 80, torch.float32),       # hd 80 fp32, a group of 7, many splits
])
def test_decode_attention_plans_on_card(cuda, B, C, Hq, Hkv, hd, dtype):
    """One launch per call and within the float32 bound plus one output ulp,
    with one split and with many (the fused merge), at a C shorter than a
    tile and at groups of 1, 3, 6 and 8."""
    from repro_torch.kernels.decode_attention import ops as tdec
    from repro_torch.models.attention import decode_valid

    gen = torch.Generator(device="cuda").manual_seed(B * C + Hq)
    valid = decode_valid(C, C - 3, device=cuda)
    q = torch.randn((B, Hq, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, C, Hkv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, C, Hkv, hd), generator=gen, device=cuda).to(dtype)
    before = tdec.decode_attention.launches
    got = tdec.decode_attention(q, k, v, valid)
    want = tdec.decode_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == before + 1
    got, want = got.float(), want.float()
    tol = tdec.decode_attention_bound(q, k, v, valid)
    tol = tol + _ulp(torch.maximum(got.abs(), want.abs()), dtype)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
def test_decode_attention_merge_resets_its_tickets(cuda):
    """The fused split merge leaves its tickets at zero: two calls in a row
    give the same bits, and a CUDA graph of one call, replayed with new
    queries written into its input, gives the plain version's answer each
    time (a ticket left behind would merge too early or never)."""
    from repro_torch.kernels.decode_attention import ops as tdec
    from repro_torch.models.attention import decode_valid

    B, C, Hq, Hkv, hd = 16, 2184, 9, 3, 64
    assert tdec.decode_plan(B, Hq, Hkv, hd, C, 2, torch.cuda.get_device_properties(
        0).multi_processor_count).splits > 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    valid = decode_valid(C, 2100, device=cuda)
    q = torch.randn((B, Hq, hd), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, C, Hkv, hd), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, C, Hkv, hd), generator=gen, device=cuda).to(torch.bfloat16)
    first = tdec.decode_attention(q, k, v, valid)
    second = tdec.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdec.decode_attention(q, k, v, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdec.decode_attention(q, k, v, valid)
    for _ in range(3):
        q.copy_(torch.randn((B, Hq, hd), generator=gen, device=cuda).to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        want = tdec.decode_attention_plain(q, k, v, valid).float()
        got = out.float()
        tol = tdec.decode_attention_bound(q, k, v, valid)
        tol = tol + _ulp(torch.maximum(got.abs(), want.abs()), torch.bfloat16)
        assert bool(((got - want).abs() <= tol).all())
    again = tdec.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.cuda
def test_decode_attention_copy_modes_agree(cuda):
    """The three ways the kernel brings a tile in — one copy of keys × all
    heads (a contiguous slice), one copy a key (a head subset of a wider
    cache) and one a key and head (heads strided) — give the same bits."""
    from repro_torch.kernels.decode_attention import ops as tdec

    gen = torch.Generator(device="cuda").manual_seed(11)
    B, C, Hkv, hd = 2, 500, 2, 64
    wide = torch.randn((B, C, 2 * Hkv, hd), generator=gen, device=cuda).to(torch.float16)
    heads_first = torch.randn((B, Hkv, C, hd), generator=gen, device=cuda).to(torch.float16)
    q = torch.randn((B, 6, hd), generator=gen, device=cuda).to(torch.float16)
    valid = torch.arange(C, device=cuda) < 480
    for kv in (wide[:, :, :Hkv], heads_first.transpose(1, 2)):
        strided = tdec.decode_attention(q, kv, kv, valid)
        dense = tdec.decode_attention(q, kv.contiguous(), kv.contiguous(), valid)
        torch.cuda.synchronize()
        assert torch.equal(strided, dense)


@pytest.mark.cuda
def test_decode_attention_reads_a_stacked_cache_slice(cuda):
    """A layer's slice of a stacked (L, B, C, Hkv, hd) cache, as decode_step
    hands it over, gives what the same keys give contiguous."""
    from repro_torch.kernels.decode_attention import ops as tdec

    stack = torch.randn((3, 2, 300, 2, 64), device=cuda, dtype=torch.bfloat16)
    vstack = torch.randn((3, 2, 300, 2, 64), device=cuda, dtype=torch.bfloat16)
    q = torch.randn((2, 6, 64), device=cuda, dtype=torch.bfloat16)
    valid = torch.arange(300, device=cuda) < 250
    a = tdec.decode_attention(q, stack[1], vstack[1], valid)
    b = tdec.decode_attention(q, stack[1].contiguous(), vstack[1].contiguous(), valid)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,nc,Q,H,P,N,dtype,strided", [
    (8, 1, 256, 48, 64, 128, torch.bfloat16, True),           # mamba2-780m prefill
    (8, 4, 256, 48, 64, 128, torch.bfloat16, True),           # its four chunks, one launch
    (2, 1, 32, 8, 32, 16, torch.float32, True),               # the reduced config
    (2, 3, 50, 5, 30, 18, torch.float32, False),              # ragged against every tile
    (1, 2, 256, 3, 64, 128, torch.float16, False),
    (8, 4, 256, 80, 64, 64, torch.bfloat16, True),            # zamba2-2.7b prefill, one launch
    (2, 2, 64, 80, 64, 64, torch.float32, False),             # N 64, H 80 on the CUDA cores
])
def test_ssd_intra_chunk_kernel_on_card(cuda, Bsz, nc, Q, H, P, N, dtype, strided):
    """Within the float32 bounds of ssd_intra_chunk_bound."""
    from repro_torch.kernels.ssd_scan import ops as tssd

    gen = torch.Generator(device="cuda").manual_seed(Q * H)
    di = H * P
    xbc = torch.randn((Bsz, nc, Q + 3, di + 2 * N), generator=gen, device=cuda).to(dtype)
    xbc = xbc[:, :, :Q] if strided else xbc[:, :, :Q].contiguous()
    x = xbc[..., :di].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    if not strided:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = torch.nn.functional.softplus(torch.randn((Bsz, nc, Q, H), generator=gen, device=cuda))
    la = torch.cumsum(-(torch.rand(H, generator=gen, device=cuda) + 0.05) * dt, dim=2)
    before = tssd.ssd_intra_chunk.launches
    y, st = tssd.ssd_intra_chunk(x, dt, la, Bm, Cm)
    wy, wst = tssd.ssd_intra_chunk_plain(x, dt, la, Bm, Cm)
    torch.cuda.synchronize()
    assert tssd.ssd_intra_chunk.launches == before + 1
    by, bst = tssd.ssd_intra_chunk_bound(x, dt, la, Bm, Cm)
    assert bool(((y - wy).abs() <= by).all()) and bool(((st - wst).abs() <= bst).all())


@pytest.mark.cuda
def test_serving_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.decode_attention import ops as tdec
    from repro_torch.kernels.ssd_scan import ops as tssd

    q = torch.zeros((2, 4, 48), device=cuda)
    kv = torch.zeros((2, 8, 2, 48), device=cuda)
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tdec.decode_attention(q, kv, kv, valid)
    q = torch.zeros((2, 4, 64), device=cuda)
    kv = torch.zeros((2, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="bool"):
        tdec.decode_attention(q, kv, kv, valid.int())
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tdec.decode_attention(q, kv, kv, valid.cpu())
    with pytest.raises(ValueError, match="head dimension must be contiguous"):
        tdec.decode_attention(q, kv.transpose(2, 3).contiguous().transpose(2, 3), kv, valid)
    x = torch.zeros((1, 1, 8, 2, 4), device=cuda)
    dt = torch.zeros((1, 1, 8, 2), device=cuda)
    bc = torch.zeros((1, 1, 8, 3), device=cuda)
    with pytest.raises(ValueError, match="dense past"):
        tssd.ssd_intra_chunk(x.transpose(3, 4).contiguous().transpose(3, 4), dt, dt, bc, bc)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tssd.ssd_intra_chunk(x, dt.cpu(), dt, bc, bc)
    with pytest.raises(ValueError, match="shared memory"):
        z = torch.zeros((1, 1, 8192, 1, 64), device=cuda)
        tssd.ssd_intra_chunk(z, z[..., 0], z[..., 0], torch.zeros((1, 1, 8192, 128), device=cuda),
                             torch.zeros((1, 1, 8192, 128), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,long_context", [
    ("smollm-135m", False), ("gemma2-9b", True), ("mamba2-780m", False),
    ("granite-moe-1b-a400m", False), ("mixtral-8x22b", True), ("internvl2-1b", False),
    ("whisper-tiny", False), ("zamba2-2.7b", False), ("zamba2-2.7b", True)])
def test_reduced_serving_card_matches_cpu(cuda, arch, long_context):
    """Prefill and 8 greedy decode steps of a reduced fp32 model (vlm and
    audio with stub embeddings): logits within 1e-5 relative to their
    largest magnitude, tokens equal."""
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.launch.serve import stub_frontend
    from repro_torch.models import transformer

    cfg = reduced_for_smoke(get_arch(arch))
    params = transformer.init_params(0, cfg)
    S = 70 if cfg.arch_type in ("ssm", "hybrid") else 24
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, S)))
    extra = stub_frontend(cfg, rng, 2)
    prefix = cfg.frontend_tokens if cfg.arch_type == "vlm" else 0
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": prompts.to(dev)}
        if extra:
            batch["embeds"] = torch.from_numpy(extra["embeds"]).to(dev)
        kernels.reset_launch_counts()
        logits, caches = transformer.prefill(p, cfg, batch, long_context=long_context)
        out, toks = [logits.cpu()], []
        for t in range(8):
            tok = logits[:, -1].argmax(-1)[:, None]
            toks.append(tok.cpu())
            logits, caches = transformer.decode_step(p, cfg, tok, caches, S + prefix + t,
                                                     long_context=long_context)
            out.append(logits.cpu())
        runs[dev] = (out, torch.cat(toks, 1), kernels.launch_counts())
    on_path = {"ssm": ("ssd_intra_chunk",), "hybrid": ("decode_attention", "ssd_intra_chunk")}
    for kernel in on_path.get(cfg.arch_type, ("decode_attention",)):
        assert runs["cuda"][2][kernel] > 0 and runs["cpu"][2][kernel] == 0
    assert torch.equal(runs["cuda"][1], runs["cpu"][1])
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        assert float((g - c).abs().max()) <= 1e-5 * float(c.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,Q,H,P,N,dtype", [
    (4, 256, 48, 64, 128, torch.bfloat16),                  # mamba2-780m's training shape
    (2, 32, 8, 32, 16, torch.float32),                      # the reduced config
])
def test_ssd_intra_chunk_vmap_one_launch_for_all_workers(cuda, Bsz, Q, H, P, N, dtype):
    """``vmap(grad)`` of a loss through ``ssd_intra_chunk`` over four
    workers launches the kernel once, on the workers folded into B; its
    gradients equal a loop over the workers (four launches) within 1e-5 of
    each gradient's largest magnitude (the backward's einsums may pick other
    cuBLAS algorithms at 4·B than at B), and the forward outputs bit for
    bit (each (batch, chunk) is one block's work either way)."""
    from repro_torch.kernels.ssd_scan import ops as tssd

    n = 4
    gen = torch.Generator(device="cuda").manual_seed(H)
    x = torch.randn((n, Bsz, 1, Q, H, P), generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((n, Bsz, 1, Q, H), generator=gen,
                                                  device=cuda))
    la = torch.cumsum(-(torch.rand(H, generator=gen, device=cuda) + 0.05) * dt, dim=3)
    Bm = torch.randn((n, Bsz, 1, Q, N), generator=gen, device=cuda).to(dtype)
    Cm = torch.randn((n, Bsz, 1, Q, N), generator=gen, device=cuda).to(dtype)
    gy = torch.randn((n, Bsz, 1, Q, H, P), generator=gen, device=cuda)

    def loss(x, dt, la, Bm, Cm, gy):
        y, st = tssd.ssd_intra_chunk(x, dt, la, Bm, Cm)
        return (y * gy).sum() + st.square().sum(), (y, st)

    fn = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)
    before = tssd.ssd_intra_chunk.launches
    grads, outs = torch.func.vmap(fn)(x, dt, la, Bm, Cm, gy)
    torch.cuda.synchronize()
    assert tssd.ssd_intra_chunk.launches == before + 1
    for i in range(n):
        gi, oi = fn(x[i], dt[i], la[i], Bm[i], Cm[i], gy[i])
        assert all(torch.equal(a[i], b) for a, b in zip(outs, oi)), i
        for a, b in zip(grads, gi):
            assert float((a[i].float() - b.float()).abs().max()) \
                <= 1e-5 * float(b.float().abs().max()), i
    assert tssd.ssd_intra_chunk.launches == before + 1 + n


@pytest.mark.cuda
def test_ssd_intra_chunk_refuses_float64_on_the_card(cuda):
    from repro_torch.kernels.ssd_scan import ops as tssd

    x = torch.zeros((1, 1, 8, 2, 4), dtype=torch.float64, device=cuda)
    dt = torch.zeros((1, 1, 8, 2), dtype=torch.float64, device=cuda)
    bc = torch.zeros((1, 1, 8, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tssd.ssd_intra_chunk(x, dt, dt, bc, bc)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b", "internvl2-1b",
                                  "whisper-tiny", "mamba2-780m", "zamba2-2.7b"])
def test_reduced_training_card_matches_cpu(cuda, arch):
    """Three DSGD steps of a reduced fp32 model of each trained family, n = 4
    on a ring (vlm and audio with the launcher's stub embeddings): losses
    within 1e-4 relative card vs CPU; the card gossips every leaf through
    ``gossip_mix_batched`` and runs each Mamba-2 layer's SSD through one
    ``ssd_intra_chunk`` launch a step for all four workers."""
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.core.topologies import make_baseline
    from repro_torch.data import DataConfig, lm_batch_numpy
    from repro_torch.dsgd import dsgd_train_step, init_dsgd_state
    from repro_torch.optim import make_optimizer, warmup_cosine

    cfg = reduced_for_smoke(get_arch(arch))
    n, steps = 4, 3
    init, upd = make_optimizer("sgd", warmup_cosine(0.05, 1, steps))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=2, seed=0,
                    frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)
    losses = {}
    for dev in ("cpu", "cuda"):
        state = init_dsgd_state(0, cfg, n, init, device=dev)
        step = dsgd_train_step(cfg, make_baseline("ring", n), upd, device=dev)
        kernels.reset_launch_counts()
        losses[dev] = []
        for s in range(steps):
            per = [lm_batch_numpy(dc, s, node=i) for i in range(n)]
            batch = {k: torch.from_numpy(np.stack([b[k] for b in per])).to(dev) for k in per[0]}
            state, m = step(state, batch)
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            counts = kernels.launch_counts()
            dtypes = {x.dtype for x in torch.utils._pytree.tree_leaves(state.params)}
            assert counts["gossip_mix_batched"] == steps * len(dtypes)   # a launch a dtype
            mamba = cfg.num_layers if cfg.arch_type in ("ssm", "hybrid") else 0
            assert counts["ssd_intra_chunk"] == steps * mamba
    assert all(np.isfinite(losses["cuda"]))
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b)


# --- the §VI-B evaluation engines (repro_torch.dsgd.sim) on the card ------------

def _sim_dataset(n):
    from repro_torch.data import class_balanced_partition, make_classification_data

    X, y = make_classification_data(num_classes=6, dim=24, samples_per_class=80, seed=0)
    Xte, yte = make_classification_data(num_classes=6, dim=24, samples_per_class=24, seed=0,
                                        noise_seed=10_001)
    return X, y, class_balanced_partition(y, n, seed=0), Xte, yte


def _sim_topologies(n):
    from repro_torch.core.topologies import make_baseline

    topos = [make_baseline(k, n) for k in ("ring", "grid", "torus", "exponential")]
    topos += [make_baseline("equistatic", n, M=M) for M in (2, 3)]
    topos += [make_baseline("random", n, r=r, seed=0) for r in (16, 24, 32)
              if r <= n * (n - 1) // 2]
    return topos


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8192, 128, 1280, 10])
def test_gossip_mix_batched_at_the_sim_shape_on_card(cuda, M):
    """fp32 (144, M): 9 topologies × 16 workers over the engines'
    block-diagonal table, within the float32 summation bound."""
    from repro_torch.dsgd import sim as tsim
    from repro_torch.dsgd.dynamic import stack_cycles

    Wc, R = stack_cycles([t.W[None] for t in _sim_topologies(16)])
    idx, w = tsim._Tables(Wc.astype(np.float32), R, 1, cuda).at(0)
    assert idx.shape[0] == 144 and idx.dtype == torch.int32
    x = torch.from_numpy(np.random.default_rng(M).standard_normal((144, M))
                         .astype(np.float32)).to(cuda)
    before = tgm.gossip_mix_batched.launches
    got = tgm.gossip_mix_batched(x, idx, w)
    want = tgm.gossip_mix_batched_plain(x, idx, w)
    torch.cuda.synchronize()
    assert tgm.gossip_mix_batched.launches == before + 1
    terms = tgm.gossip_mix_batched_plain(x.double().abs(), idx, w.abs()).float()
    deg = int(idx.shape[1])
    assert bool(((got - want).abs() <= _gossip_tol(got, want, terms, deg, torch.float32)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_top_k_threshold_and_degrade_bitwise_on_card(cuda, dtype):
    from repro_torch.dsgd import chaos as tchaos
    from repro_torch.dsgd import compression as tcomp

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((144, 8192))).to(dtype)
    x[1, 1] = x[1, 2]
    k = 820
    absx = x.abs()
    cpu = tcomp._kth_largest_bitselect(absx, k)
    card = tcomp._kth_largest_bitselect(absx.to(cuda), k)
    top = torch.topk(absx.to(cuda), k, dim=1).values[:, k - 1:k]
    assert torch.equal(card, top) and torch.equal(card.cpu(), cpu)
    assert torch.equal(tcomp.compress_top_k(x.to(cuda), 0.1).cpu(),
                       tcomp.compress_top_k(x, 0.1))
    W = torch.from_numpy(_sim_topologies(16)[3].W).to(dtype)
    ch = tchaos.make_chaos(20, 16, seed=3, churn=[(1, 2, 9)], p_drop=0.3)
    a, l_up = torch.from_numpy(ch.alive), torch.from_numpy(ch.link_up)
    assert torch.equal(tchaos.degrade_matrix(W.to(cuda), a.to(cuda), l_up.to(cuda)).cpu(),
                       tchaos.degrade_matrix(W, a, l_up))


@pytest.mark.cuda
def test_sim_engines_on_card(cuda):
    """accuracy_curves on the card: one gossip_mix_batched launch a step for
    all leaves and runs, within one test sample of the CPU, 1e-6 of the
    host oracle, and bitwise equal to the static dense cross run; the
    fault-free chaos engine bitwise equal to the cross engine."""
    from repro_torch.dsgd import sim as tsim
    from repro_torch.dsgd.chaos import no_chaos
    from repro_torch.dsgd.dynamic import cycle_tensor, static_cycle

    n = 8
    data = _sim_dataset(n)
    topos = _sim_topologies(n)[:3]
    Ws = np.stack([t.W for t in topos]).astype(np.float32)
    cfg = tsim.DSGDSimConfig(epochs=2, batch=16, hidden=32)
    kernels.reset_launch_counts()
    card, iters = tsim.accuracy_curves(Ws, *data, cfg)
    assert kernels.launch_counts()["gossip_mix_batched"] == cfg.epochs * iters   # all 4 leaves
    cpu, _ = tsim.accuracy_curves(Ws, *data, cfg, device="cpu")
    assert np.abs(card - cpu).max() <= 1.0 / 144 + 1e-12
    host, _ = tsim.accuracy_curve_host(Ws[1], *data, cfg)
    np.testing.assert_allclose(card[1], host, rtol=0, atol=1e-6)
    cross, _ = tsim.train_curves_cross([static_cycle(Ws[2])], [1.0], tsim.CommSpec(), *data, cfg)
    np.testing.assert_array_equal(cross[0], card[2])
    cycles = [static_cycle(topos[0].W), cycle_tensor(topos[0])]
    for spec in (tsim.CommSpec(), tsim.CommSpec("top_k", 0.1), tsim.CommSpec("random_k", 0.1)):
        ref, _ = tsim.train_curves_cross(cycles, [0.5, 0.5], spec, *data, cfg)
        got, _ = tsim.train_curves_chaos(cycles, [0.5, 0.5], spec,
                                         no_chaos(cfg.epochs * iters, n), *data, cfg)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("compressor,frac", [("dense", 1.0), ("top_k", 0.1)])
def test_consensus_curves_card_match_cpu(cuda, compressor, frac):
    from repro_torch.dsgd import sim as tsim
    from repro_torch.dsgd.chaos import make_chaos
    from repro_torch.dsgd.dynamic import cycle_tensor, static_cycle

    t = _sim_topologies(16)[2]
    cycles = [static_cycle(t.W), cycle_tensor(t)]
    x0 = np.random.default_rng(0).normal(size=(16, 256))
    spec = tsim.CommSpec(compressor, frac)
    ch = make_chaos(60, 16, seed=1, churn=[(5, 10, 30)], p_drop=0.03)
    for run in (lambda d: tsim.consensus_curves_cross(cycles, [0.4, 0.4], spec, x0, 60,
                                                      device=d),
                lambda d: tsim.consensus_curves_chaos(cycles, [0.4, 0.4], spec, ch, x0, 60,
                                                      device=d)):
        card, cpu = run("cuda"), run("cpu")
        for b in range(2):
            np.testing.assert_allclose(card[b], cpu[b], rtol=0, atol=1e-6 * cpu[b, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 64, 256])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hetero", [False, True])
def test_batched_edge_forms_on_card(cuda, n, B, dtype, hetero):
    """The four ADMM-path forms with the batch axis, λ's blocks views of one
    (B, K) matrix as the engine lays them out: one launch each for the
    batch; every instance bitwise its unbatched launch; against the plain
    versions L(g) within 1e-12 (fp64) or 1e-5 × the largest row sum, A_op's
    blocks within L's error plus 4u·(max L_aa + |λ| + max|P, Q, w|) (only
    the degree's summing order differs, then two roundings), the adjoint's
    edge entries bitwise and its trace within 2n·u·(Σ|P_ii| + Σ|Q_ii|), the
    CG matvec within the bound of ``test_edge_schur_matvec_bitwise_on_card``."""
    rng = np.random.default_rng(n + B)
    m, k = n * (n - 1) // 2, 2 * n * n + n
    flat = torch.from_numpy(rng.standard_normal((B, k + m))).to(device=cuda, dtype=dtype)
    P, Q = flat[:, :n * n].view(B, n, n), flat[:, n * n:2 * n * n].view(B, n, n)
    w, v = flat[:, 2 * n * n:k], (flat[:, k:] if hetero else None)
    x = torch.from_numpy(rng.random((B, m + 1))).to(device=cuda, dtype=dtype)
    g, lam = x[:, :-1], x[:, -1]
    kernels.reset_launch_counts()
    L = tel.edge_laplacian(g, n)
    blocks = tel.edge_laplacian_blocks(g, lam, P, Q, w, torch.empty(B, k, dtype=dtype, device=cuda))
    adj = tel.edge_adjoint(P, Q, w, v)
    out = torch.full((B, k + 2), 7.0, dtype=dtype, device=cuda)
    x_adj = torch.empty(B, m + 1, dtype=dtype, device=cuda)
    tel.edge_schur_matvec(P, Q, w, out, v=v, x_adj=x_adj)
    counts = kernels.launch_counts()
    assert all(counts[f] == 1 for f in ("edge_laplacian", "edge_laplacian_blocks",
                                        "edge_adjoint", "edge_schur_matvec")), counts
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    u = torch.finfo(dtype).eps / 2
    torch.cuda.synchronize()
    for b in range(B):
        Pb, Qb, wb = P[b].contiguous(), Q[b].contiguous(), w[b].contiguous()
        vb = None if v is None else v[b].contiguous()
        assert torch.equal(L[b].view(bits), tel.edge_laplacian(g[b].contiguous(), n).view(bits))
        one = tel.edge_laplacian_blocks(g[b].contiguous(), lam[b].contiguous(), Pb, Qb, wb,
                                        torch.empty(k, dtype=dtype, device=cuda))
        assert torch.equal(blocks[b].view(bits), one.view(bits))
        assert torch.equal(adj[b].view(bits), tel.edge_adjoint(Pb, Qb, wb, vb).view(bits))
        ob = torch.empty(k, dtype=dtype, device=cuda)
        xb = torch.empty(m + 1, dtype=dtype, device=cuda)
        tel.edge_schur_matvec(Pb, Qb, wb, ob, v=vb, x_adj=xb)
        assert torch.equal(out[b, :k].view(bits), ob.view(bits))
        assert torch.equal(x_adj[b].view(bits), xb.view(bits))
        assert bool((out[b, k:] == 7.0).all())
        Lp = tel.edge_laplacian_plain(g[b], tel.packed_edge_index(n, "cuda"))
        tol = 1e-12 if dtype == torch.float64 else 1e-5 * float(Lp.diagonal().abs().max())
        err_L = float((L[b] - Lp).abs().max())
        assert err_L <= tol
        bp = tel.edge_laplacian_blocks_plain(g[b], lam[b], Pb, Qb, wb,
                                             torch.empty(k, dtype=dtype, device=cuda))
        tol = err_L + 4 * u * (float(Lp.diagonal().abs().max()) + abs(float(lam[b]))
                               + max(float(Pb.abs().max()), float(Qb.abs().max()),
                                     float(wb.abs().max())))
        assert float((blocks[b] - bp).abs().max()) <= tol
        plain = tel.edge_adjoint_plain(Pb, Qb, wb, vb)
        assert torch.equal(adj[b, :m].view(bits), plain[:m].view(bits))
        assert abs(float(adj[b, m] - plain[m])) <= _trace_tol(Pb, Qb)
        G = torch.cat([adj[b, :m].abs(), adj.new_zeros(1)])[tel.packed_edge_index(n, "cuda")]
        pm = tel.edge_schur_matvec_plain(Pb, Qb, wb, torch.empty(k, dtype=dtype, device=cuda), vb)
        tol = (2 * n * u * float(G.sum(dim=1).max()) + _trace_tol(Pb, Qb)
               + 2 * u * float(pm.abs().max()))
        assert float((out[b, :k] - pm).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_admm_on_card_matches_sequential_and_cpu(cuda, dtype):
    """Three restarts at n=16, r=32 in one batched solve on the card: every
    step launches each edge form once for the batch; each restart against
    its sequential solve on the card (float64: the same support and λ̃
    within 1e-9; float32: the same support) and the float64 batch against
    the CPU's batch within 1e-9 in λ̃."""
    from repro_torch.core.admm import HomogeneousADMM

    rng = np.random.default_rng(3)
    g0s, lam0s = rng.random((3, 120)) * 0.3, np.array([0.5, 0.4, 0.6])
    solver = HomogeneousADMM(16, 32, te.ADMMConfig(device="cuda", dtype=dtype, max_iters=100))
    kernels.reset_launch_counts()
    batched = solver.solve_batched(g0s, lam0s)
    counts = kernels.launch_counts()
    assert counts["edge_laplacian"] == 1 and counts["edge_laplacian_blocks"] == 100, counts
    assert counts["edge_adjoint"] == 100, counts
    seq = [solver.solve(g0=g0, lam0=lam0) for g0, lam0 in zip(g0s, lam0s)]
    for a, b in zip(batched, seq):
        assert (np.nonzero(a.g > 1e-6)[0] == np.nonzero(b.g > 1e-6)[0]).all()
        if dtype == "float64":
            assert abs(a.lam_tilde - b.lam_tilde) <= 1e-9 and a.iters == b.iters
    if dtype == "float64":
        cpu = HomogeneousADMM(16, 32, te.ADMMConfig(device="cpu", max_iters=100)).solve_batched(
            g0s, lam0s)
        for a, b in zip(batched, cpu):
            assert abs(a.lam_tilde - b.lam_tilde) <= 1e-9


@pytest.mark.cuda
def test_nan_rho_guarded_attempt_on_card_stops_after_one_chunk(cuda):
    """A NaN ρ on the card: ``_eigh_clip``'s non-finite path and
    ``abort_nonfinite`` stop the solve after its first chunk, as on the CPU;
    the guard classifies it ``non_finite`` and the ladder falls through its
    ρ-jittered retries to the classic rung."""
    import dataclasses

    from repro_torch.core import api as t_api
    from repro_torch.core import guard as t_guard
    from repro_torch.core.topologies import ring

    n, r = 8, 12
    admm = te.ADMMConfig(max_iters=120, check_every=30, rho=float("nan"))
    cfg = t_api.BATopoConfig(sa_iters=50, polish_iters=50, admm=admm, device="cuda")
    warm = t_api._pack_warm(n, ring(n).edges)
    solver = t_api._make_solver(n, r, "homo", None, cfg)
    assert solver.spec.I.device.type == "cuda"
    kernels.reset_launch_counts()
    res = solver.solve(g0=warm[0], lam0=warm[2])
    assert res.iters == admm.check_every
    assert kernels.launch_counts()["edge_laplacian_blocks"] == admm.check_every
    assert t_guard.classify_result(res) is t_guard.SolveOutcome.NON_FINITE
    rungs = t_guard.jittered_warm_rungs(n, r, "homo", None, cfg, warm, "t",
                                        t_guard.GuardPolicy(warm_retries=2))
    rungs.append(("classic", lambda: t_guard.classic_fallback(n, r)))
    lad = t_guard.run_ladder(rungs)
    assert lad.rung == "classic" and lad.attempts == 4
    assert [rep.outcome for rep in lad.reports] == ["non_finite"] * 3 + ["ok"]
    assert t_guard.check_invariants(lad.topology) is None
    ok = dataclasses.replace(cfg, admm=dataclasses.replace(admm, rho=5.0))
    assert t_guard.run_ladder(t_guard.jittered_warm_rungs(
        n, r, "homo", None, ok, warm, "t", t_guard.GuardPolicy())).rung == "warm"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_elastic_gossip_at_deg_cap_on_card(cuda, dtype):
    """The elastic step's mix: weights gathered on the card from a degraded
    W over ``deg_cap = n − 1`` tables (padded slots weigh 0), one launch
    per leaf, within the gossip tolerance of the plain version; with no
    faults it is bitwise the max-degree table's mix."""
    from repro_torch.core.topologies import make_baseline
    from repro_torch.dsgd.chaos import degrade_matrix
    from repro_torch.dsgd.gossip import (elastic_neighbor_tables, gather_neighbor_weights,
                                         padded_neighbors)

    n = 8
    topo = make_baseline("exponential", n)
    W = torch.tensor(topo.W, dtype=torch.float32, device=cuda)
    idx, mask = elastic_neighbor_tables(W)
    assert tuple(idx.shape) == (n, n - 1) and idx.device.type == "cuda"
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 3, 1000))
                         .astype(np.float32)).to(cuda, dtype)
    alive = torch.ones(n, device=cuda)
    alive[3] = 0.0
    link = torch.ones(n, n, device=cuda)
    link[0, 1] = link[1, 0] = 0.0
    for a, lk in ((torch.ones(n, device=cuda), torch.ones(n, n, device=cuda)), (alive, link)):
        w = gather_neighbor_weights(degrade_matrix(W, a, lk), idx, mask)
        before = tgm.gossip_mix_batched.launches
        got = tgm.gossip_mix_batched(x, idx, w)
        torch.cuda.synchronize()
        assert tgm.gossip_mix_batched.launches == before + 1
        want = tgm.gossip_mix_batched_plain(x, idx, w)
        terms = tgm.gossip_mix_batched_plain(x.double().abs(), idx, w.abs()).float()
        assert bool(((got.float() - want.float()).abs()
                     <= _gossip_tol(got, want, terms, n - 1, dtype)).all())
    pidx, pw = padded_neighbors(W)
    full = gather_neighbor_weights(W, idx, mask)
    assert torch.equal(tgm.gossip_mix_batched(x, idx, full), tgm.gossip_mix_batched(x, pidx, pw))


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_a_card_template(cuda, tmp_path):
    """A bfloat16 leaf comes back bit for bit onto the template's card."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    tree = {"embed": torch.randn(64, 32, device=cuda).to(torch.bfloat16),
            "opt": {"m": torch.randn(64, 32, device=cuda)}, "step": torch.tensor(3, device=cuda)}
    save_checkpoint(str(tmp_path / "c.npz"), tree, step=3)
    got, step = load_checkpoint(str(tmp_path / "c.npz"), tree_map(torch.zeros_like, tree))
    assert step == 3 and got["embed"].device.type == "cuda"
    assert got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["embed"].view(torch.int16), tree["embed"].view(torch.int16))
    assert torch.equal(got["opt"]["m"], tree["opt"]["m"]) and int(got["step"]) == 3


def _windows(m, world):
    """(first, count) of each rank's window, the last padded."""
    m_loc = -(-m // world)
    return [(min(k * m_loc, m), max(0, min(m_loc, m - k * m_loc))) for k in range(world)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 64, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("world", [2, 3])
def test_edge_window_kernels_on_card(cuda, n, dtype, world):
    """The windowed ``edge_laplacian`` against its plain version (L's
    tolerance) and summed over the windows against the full call; the
    windowed ``edge_adjoint`` one launch, its entries bitwise the full
    launch's slice and the trace entry the full launch's bits (the same
    block reduction); with v on every second world."""
    m = n * (n - 1) // 2
    g = torch.rand(m, dtype=dtype, device=cuda)
    P, Q, w, v = _adjoint_operands(n, dtype, world == 3, cuda)
    full_L = tel.edge_laplacian(g, n)
    full_x = tel.edge_adjoint(P, Q, w, v)
    lidx = tel.packed_edge_index(n, "cuda")
    total = torch.zeros_like(full_L)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for first, count in _windows(m, world):
        gw = g[first:first + count]
        before = (tel.edge_laplacian.launches, tel.edge_adjoint.launches)
        L = tel.edge_laplacian(gw, n, first)
        x = tel.edge_adjoint(P, Q, w, None if v is None else v[first:first + count],
                             first, count)
        assert (tel.edge_laplacian.launches, tel.edge_adjoint.launches) == \
            (before[0] + 1, before[1] + 1)
        want = tel.edge_laplacian_window_plain(gw, lidx, first)
        torch.cuda.synchronize()
        tol = 1e-12 if dtype == torch.float64 else 1e-5 * max(float(want.diagonal().max()), 1.0)
        assert float((L - want).abs().max()) <= tol
        total += L
        assert torch.equal(x[:count].view(bits), full_x[first:first + count].view(bits))
        assert torch.equal(x[count:].view(bits), full_x[m:].view(bits))
    tol = 1e-12 if dtype == torch.float64 else 1e-5 * float(full_L.diagonal().max())
    assert float((total - full_L).abs().max()) <= tol


@pytest.mark.cuda
def test_one_rank_nccl_sharded_solve_is_the_unsharded_one_on_card(cuda, tmp_path):
    """``solve_spec_sharded`` in a process group of one rank on NCCL (every
    collective runs, with nothing to exchange) against ``solve_spec`` on the
    card at n=64, float64, eigh, exact CG: the window is the whole list and
    its kernels are the full launches, so g, λ̃, the counts and the
    history's λ̃ are the same bits (the residual sums its leaves in another
    order)."""
    import torch.distributed as dist

    from repro_torch.core import shard
    from repro_torch.core.api import _pack_warm

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        cfg = te.ADMMConfig(dtype="float64", max_iters=20, check_every=10)
        spec = te.make_homo_spec(64, 128, cfg)
        edges = greedy_degree_graph(64, np.full(64, 4), np.random.default_rng(0))
        g0, _, lam0 = _pack_warm(64, edges)
        st = te.init_state(spec, g0, lam0)
        want = te.solve_spec(spec, st, cfg)
        before = (tel.edge_laplacian.launches, tel.edge_schur_matvec.launches)
        got = shard.solve_spec_sharded(spec, st, cfg)
        assert tel.edge_laplacian.launches > before[0]
        assert tel.edge_schur_matvec.launches == before[1]
    finally:
        dist.destroy_process_group()
    assert want.lam_tilde > 0.0
    assert got.g.tobytes() == want.g.tobytes() and got.lam_tilde == want.lam_tilde
    assert (got.iters, got.cg_iters) == (want.iters, want.cg_iters)
    assert [h[::2] for h in got.history] == [h[::2] for h in want.history]
    assert abs(got.residual - want.residual) <= 1e-12 * abs(want.residual)


# ---------------------------------------------------------------------------
# tensor parallelism inside a worker, on DTensor
# ---------------------------------------------------------------------------

#: against the same step on the card's plain tensors, as chip_smoke's
#: main_tp_dsgd holds its steps: the weights within 8 bf16 ulps at the
#: leaf's largest magnitude, the leaves that start at zero (norm scales,
#: biases: −lr·m after one step) and the float32 momentum within 5 % by
#: ‖Δ‖/‖x‖ (bf16 partial sums all-reduced in another order)
TP_ULPS = 8
TP_REL = 0.05


def _tp_cfg(dtype: str):
    import dataclasses

    from repro_torch.configs import get_arch, reduced_for_smoke

    return dataclasses.replace(reduced_for_smoke(get_arch("qwen1.5-0.5b")), dtype=dtype)


def _tp_batch(n: int, vocab: int, dev) -> dict:
    tok = torch.from_numpy(np.random.default_rng(28).integers(0, vocab, (n, 4, 33)))
    return {"tokens": tok[..., :-1].int().to(dev), "labels": tok[..., 1:].int().to(dev)}


def _tp_pins(got: dict, want: dict, zero_start: set) -> dict:
    """Leaf by leaf over flat {name: (n, ...)} trees: the weights in bf16
    ulps, the zero-start leaves and the momentum by ‖Δ‖/‖x‖."""
    out = {}
    for what in ("params", "momentum"):
        for k, a in got[what].items():
            a, b = a.float(), want[what][k].to(a.device).float()
            rel = float((a - b).norm() / b.norm())
            if what == "params" and k not in zero_start:
                _, ex = torch.frexp(b.abs().max())
                out[(what, k)] = float((a - b).abs().max()) / float(2.0 ** (int(ex) - 8))
                assert out[(what, k)] <= TP_ULPS, (what, k, out[(what, k)])
            else:
                out[(what, k)] = rel
                assert rel <= TP_REL, (what, k, rel)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.cuda
def test_one_rank_nccl_tp_step_is_the_cpus_on_card(cuda, tmp_path):
    """``make_tp_train_step`` on a 1 × 1 DTensor mesh of one NCCL rank (every
    placement local, nothing to exchange) on the card against the same step
    on the CPU's plain tensors: reduced qwen1.5 in float32, 2 microbatches,
    2 steps; the losses within 1e-5 relative, params and momentum within
    1e-4 of each leaf's largest magnitude (the card's and the CPU's float32
    reductions differ)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dsgd import init_dsgd_state, make_tp_train_step, trainer
    from repro_torch.dsgd.tensor_parallel import full_value, place_tree
    from repro_torch.launch.sharding import DistPlan, batch_specs, tree_param_specs
    from repro_torch.optim import sgd_momentum

    cfg = _tp_cfg("float32")
    opt_init, upd = sgd_momentum(0.05)

    def one(dev):
        st = init_dsgd_state(0, cfg, 1, opt_init, device=dev)
        return trainer.DSGDState(tree_map(lambda x: x[0], st.params),
                                 tree_map(lambda x: x[0], st.opt), st.step)

    batches = [{k: v[0] for k, v in _tp_batch(1, cfg.vocab_size, "cpu").items()}
               for _ in range(2)]
    step = make_tp_train_step(cfg, upd, accum_steps=2)
    want, losses = one("cpu"), []
    for b in batches:
        want, m = step(want, b)
        losses.append(float(m["loss"]))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        plan = DistPlan((), ("data", "model"), ("data",), 1)
        st = one(cuda)
        st = trainer.DSGDState(place_tree(st.params, mesh, tree_param_specs(st.params, plan, mesh)),
                               place_tree(st.opt, mesh, tree_param_specs(st.opt, plan, mesh)),
                               st.step)
        got = []
        for b in batches:
            b = {k: v.to(cuda) for k, v in b.items()}
            st, m = step(st, place_tree(b, mesh, batch_specs(cfg, plan, mesh,
                                                             {k: tuple(v.shape) for k, v in
                                                              b.items()})))
            got.append(float(m["loss"]))
        gp = {k: full_value(v).cpu() for k, v in _flat(st.params).items()}
        gm = {k: full_value(v).cpu() for k, v in _flat(st.opt.momentum).items()}
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    for g, w in ((gp, _flat(want.params)), (gm, _flat(want.opt.momentum))):
        for k in w:
            scale = float(w[k].abs().max()) or 1.0
            assert float((g[k] - w[k]).abs().max()) <= 1e-4 * scale, k


TP_CARD_WORKER = r'''
import datetime, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

sys.path.insert(0, sys.argv[5])
import test_torch_cuda as t
from repro_torch import kernels
from repro_torch.core.graph import Topology
from repro_torch.device import resolve_device
from repro_torch.dsgd import (gossip, init_dsgd_state, make_matmul_gossip_train_step,
                              make_sharded_train_step, make_tp_train_step,
                              schedule_from_topology, trainer)
from repro_torch.dsgd.tensor_parallel import full_value, place_tree
from repro_torch.launch.sharding import DistPlan, batch_specs, tree_param_specs
from repro_torch.optim import sgd_momentum

dev = resolve_device("cuda")
cfg = t._tp_cfg("bfloat16")
opt_init, upd = sgd_momentum(0.05)
batch = t._tp_batch(2, cfg.vocab_size, dev)
topo = Topology(2, [(0, 1)], np.array([0.5]), "pair")
start = init_dsgd_state(0, cfg, 2, opt_init, device=dev)
staged = []
orig = gossip._to_device
gossip._to_device = lambda *a: staged.append(1) or orig(*a)
kernels.reset_launch_counts()
full = lambda s: dict(params={k: full_value(v).cpu() for k, v in t._flat(s.params).items()},
                      momentum={k: full_value(v).cpu() for k, v in t._flat(s.opt.momentum).items()})
out = {}
# the rank-per-worker step on data=2 x model=1: one worker a rank, staged gossip
mesh = DeviceMesh("cuda", torch.arange(2).reshape(2, 1), mesh_dim_names=("data", "model"))
mine = trainer.DSGDState(tree_map(lambda x: x[rank:rank + 1], start.params),
                         tree_map(lambda x: x[rank:rank + 1], start.opt), start.step)
s, m = make_sharded_train_step(cfg, schedule_from_topology(topo), upd, mesh)(
    mine, {k: v[rank:rank + 1] for k, v in batch.items()})
parts = [None, None]
dist.all_gather_object(parts, tree_map(lambda x: x.cpu(), dict(params=t._flat(s.params),
                                                                momentum=t._flat(s.opt.momentum))))
out["sharded"] = {w: {k: torch.cat([p[w][k] for p in parts]) for k in parts[0][w]}
                  for w in ("params", "momentum")}
out["staged"] = len(staged)
# the TP step of one worker over data=1 x model=2
mesh = DeviceMesh("cuda", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
plan = DistPlan((), ("data", "model"), ("data",), 1)
one = trainer.DSGDState(tree_map(lambda x: x[0], start.params), tree_map(lambda x: x[0], start.opt),
                        start.step)
b1 = {k: v[0] for k, v in batch.items()}
placed = trainer.DSGDState(place_tree(one.params, mesh, tree_param_specs(one.params, plan, mesh)),
                           place_tree(one.opt, mesh, tree_param_specs(one.opt, plan, mesh)), one.step)
s, m = make_tp_train_step(cfg, upd, accum_steps=2)(
    placed, place_tree(b1, mesh, batch_specs(cfg, plan, mesh, {k: tuple(v.shape) for k, v in b1.items()})))
out["tp"] = {w: {k: v.unsqueeze(0) for k, v in d.items()} for w, d in full(s).items()}
# the W-matmul step over pod=2 x data=1 x model=1
mesh = DeviceMesh("cuda", torch.arange(2).reshape(2, 1, 1), mesh_dim_names=("pod", "data", "model"))
plan = DistPlan(("pod",), ("data", "model"), ("data",), 2)
placed = trainer.DSGDState(
    place_tree(start.params, mesh, tree_param_specs(start.params, plan, mesh, stacked=True)),
    place_tree(start.opt, mesh, tree_param_specs(start.opt, plan, mesh, stacked=True)), start.step)
s, m = make_matmul_gossip_train_step(cfg, topo, upd)(
    placed, place_tree(batch, mesh, batch_specs(cfg, plan, mesh, {k: tuple(v.shape) for k, v in
                                                                   batch.items()}, stacked=True)))
out["matmul"] = full(s)
out["launches"] = kernels.launch_counts()
if rank == 0:
    pickle.dump(out, open(f"{out_dir}/out.pkl", "wb"))
dist.destroy_process_group()
'''


@pytest.mark.cuda
def test_tp_dsgd_pins_at_reduced_width_on_two_gloo_ranks_on_card(cuda, tmp_path):
    """chip_smoke's main_tp_dsgd pins at reduced width (qwen1.5 reduced,
    bf16, 4 × 32 tokens a worker) on 2 gloo ranks sharing the card: the
    rank-per-worker step on data=2 × model=1 (its gossip staged through
    host memory) against the stacked ``dsgd_train_step``, the TP step of
    one worker over model=2 (DTensor's all-gathers rerouted through c10d)
    and the W-matmul step over pod=2 against the same steps on the card's
    plain tensors; no kernel launched in the ranks."""
    import os
    import pickle
    import subprocess
    import sys

    from repro_torch.dsgd import (dsgd_train_step, init_dsgd_state,
                                  make_matmul_gossip_train_step, make_tp_train_step, trainer)
    from repro_torch.core.graph import Topology
    from repro_torch.optim import sgd_momentum

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", TP_CARD_WORKER, str(r), "2", init,
                               str(tmp_path), here], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    cfg = _tp_cfg("bfloat16")
    opt_init, upd = sgd_momentum(0.05)
    topo = Topology(2, [(0, 1)], np.array([0.5]), "pair")
    start = init_dsgd_state(0, cfg, 2, opt_init, device=cuda)
    zero_start = {k for k, v in _flat(start.params).items() if not bool(v.any())}
    batch = _tp_batch(2, cfg.vocab_size, cuda)
    full = lambda s: dict(params={k: v.cpu() for k, v in _flat(s.params).items()},
                          momentum={k: v.cpu() for k, v in _flat(s.opt.momentum).items()})
    want = {"sharded": full(dsgd_train_step(cfg, topo, upd, device=cuda)(start, batch)[0]),
            "matmul": full(make_matmul_gossip_train_step(cfg, topo, upd)(start, batch)[0])}
    one = trainer.DSGDState(tree_map(lambda x: x[0], start.params),
                            tree_map(lambda x: x[0], start.opt), start.step)
    s, _ = make_tp_train_step(cfg, upd, accum_steps=2)(one, {k: v[0] for k, v in batch.items()})
    want["tp"] = {w: {k: v.unsqueeze(0) for k, v in d.items()} for w, d in full(s).items()}
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    got = pickle.loads((tmp_path / "out.pkl").read_bytes())
    for label in ("sharded", "tp", "matmul"):
        _tp_pins(got[label], want[label], zero_start)
    assert got["staged"] > 0, "gloo staging never ran"
    assert not any(got["launches"].values()), got["launches"]


#: the rank-per-worker steps with a "model" dim on 4 NCCL ranks, one a card,
#: against the stacked ``dsgd_train_step`` on cuda:0 (float32)
NCCL4_WORKER = r'''
import datetime, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

rank, init, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=init, rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

sys.path.insert(0, sys.argv[4])
import test_torch_cuda as t
from repro_torch.core.graph import Topology
from repro_torch.dsgd import (init_dsgd_state, make_elastic_sharded_train_step,
                              make_sharded_train_step, schedule_from_topology,
                              schedule_weight_arrays, trainer)
from repro_torch.dsgd.tensor_parallel import full_value
from repro_torch.optim import sgd_momentum

dev = torch.device("cuda", rank)
cfg = t._tp_cfg("float32")
opt_init, upd = sgd_momentum(0.05)
topo = Topology(2, [(0, 1)], np.array([0.3]), "pair")
sched = schedule_from_topology(topo)
start = init_dsgd_state(0, cfg, 2, opt_init, device=dev)
batch = t._tp_batch(2, cfg.vocab_size, dev)
mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
w = rank // 2
mine = trainer.DSGDState(tree_map(lambda x: x[w:w + 1], start.params),
                         tree_map(lambda x: x[w:w + 1], start.opt), start.step)
bw = {k: v[w:w + 1] for k, v in batch.items()}
out = {}
s, m = make_sharded_train_step(cfg, sched, upd, mesh)(mine, bw)
out["gossip"] = {k: full_value(v).cpu() for k, v in t._flat(s.params).items()}
ws, wr = (torch.from_numpy(a).to(dev) for a in schedule_weight_arrays(sched))
ones = torch.ones(2, device=dev)
s, m = make_elastic_sharded_train_step(cfg, sched, upd, mesh)(mine, bw, ones, ones, ws, wr)
out["elastic"] = {k: full_value(v).cpu() for k, v in t._flat(s.params).items()}
pickle.dump(out, open(f"{out_dir}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
'''


@pytest.mark.cuda
def test_tp_rank_steps_on_four_nccl_ranks_on_cards(cuda, tmp_path):
    """Where four cards are attached: ``make_sharded_train_step`` and the
    fault-free elastic step on data=2 × model=2, 4 NCCL ranks one a card
    (the gossip's sub-groups and DTensor's collectives on NCCL), against
    the stacked ``dsgd_train_step`` (dense gossip) on cuda:0: reduced
    qwen1.5 in float32, params within 1e-4 of each leaf's largest
    magnitude; the elastic step bitwise the plain one."""
    import os
    import pickle
    import subprocess
    import sys

    from repro_torch.core.graph import Topology
    from repro_torch.dsgd import dsgd_train_step, init_dsgd_state
    from repro_torch.optim import sgd_momentum

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", NCCL4_WORKER, str(r), init, str(tmp_path),
                               here], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    cfg = _tp_cfg("float32")
    opt_init, upd = sgd_momentum(0.05)
    topo = Topology(2, [(0, 1)], np.array([0.3]), "pair")
    start = init_dsgd_state(0, cfg, 2, opt_init, device=cuda)
    want = _flat(dsgd_train_step(cfg, topo, upd, use_kernel=False, device=cuda)(
        start, _tp_batch(2, cfg.vocab_size, cuda))[0].params)
    outs = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(4)]
    for r, o in enumerate(outs):
        for k, v in o["gossip"].items():
            ref = want[k][r // 2].cpu()
            assert float((v[0] - ref).abs().max()) <= 1e-4 * (float(ref.abs().max()) or 1.0), (r, k)
            assert torch.equal(v, o["elastic"][k]), (r, k)
