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
loop of one-worker kernels bitwise equal to the batched kernel (the same
products added in the same order); three DSGD steps of reduced smollm,
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
fed ``edge_adjoint``'s output;
reduced fp32 serving (smollm, gemma2 long context, mamba2), card vs CPU,
within 1e-5 relative in the logits of the prefill and 8 decode steps, with
equal greedy tokens.
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
        k = min(deg, len(others), int(rng.integers(1, deg + 1)) if i % 2 else deg)
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
        if dev == "cuda":
            assert kernels.launch_counts()["gossip_mix_batched"] == 3 * 11
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
@pytest.mark.parametrize("arch,long_context", [("smollm-135m", False), ("gemma2-9b", True),
                                               ("mamba2-780m", False)])
def test_reduced_serving_card_matches_cpu(cuda, arch, long_context):
    """Prefill and 8 greedy decode steps of a reduced fp32 model: logits
    within 1e-5 relative to their largest magnitude, tokens equal."""
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.models import transformer

    cfg = reduced_for_smoke(get_arch(arch))
    params = transformer.init_params(0, cfg)
    S = 70 if arch.startswith("mamba2") else 24
    prompts = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, S)))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        kernels.reset_launch_counts()
        logits, caches = transformer.prefill(p, cfg, {"tokens": prompts.to(dev)},
                                             long_context=long_context)
        out, toks = [logits.cpu()], []
        for t in range(8):
            tok = logits[:, -1].argmax(-1)[:, None]
            toks.append(tok.cpu())
            logits, caches = transformer.decode_step(p, cfg, tok, caches, S + t,
                                                     long_context=long_context)
            out.append(logits.cpu())
        runs[dev] = (out, torch.cat(toks, 1), kernels.launch_counts())
    kernel = "ssd_intra_chunk" if arch.startswith("mamba2") else "decode_attention"
    assert runs["cuda"][2][kernel] > 0 and runs["cpu"][2][kernel] == 0
    assert torch.equal(runs["cuda"][1], runs["cpu"][1])
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        assert float((g - c).abs().max()) <= 1e-5 * float(c.abs().max())


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
    """accuracy_curves on the card: one gossip_mix_batched launch per leaf
    per step for all runs, within one test sample of the CPU, 1e-6 of the
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
    assert kernels.launch_counts()["gossip_mix_batched"] == cfg.epochs * iters * 4
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
