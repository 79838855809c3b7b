"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as the JAX package's own kernel tests
do. Inputs are made with numpy from a seed and handed to both. Tolerances:
L(g) within 1e-12 (fp64) or 1e-5 × the largest row sum (fp32), since the
row sums are taken in another order; the quadratic form bitwise equal (adds
only, same order); the BFS hop and its counts exactly equal. The adjoint
forms against the reference's ``AT_op`` and ``A_op(AT_op(·))`` (Pallas pair
in interpret mode): the edge entries bitwise, −tr P + tr Q within
2n·u·(Σ|P_ii| + Σ|Q_ii|) (the diagonals summed in another order), the dense
blocks within 2n·u·(max row Σ|xg| + Σ|P_ii| + Σ|Q_ii|) (L's degrees too).

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.kernels.edge_laplacian import ops as jel  # noqa: E402
from repro.kernels.hop_bfs import ops as jhop  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdec  # noqa: E402
from repro_torch.kernels.edge_laplacian import ops as tel  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as tgm  # noqa: E402
from repro_torch.kernels.hop_bfs import ops as thop  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as tssd  # noqa: E402


def _edges(n):
    iu = np.triu_indices(n, 1)
    return iu[0].astype(np.int64), iu[1].astype(np.int64)


def _random_adj(n, p, rng):
    up = np.triu(rng.random((n, n)) < p, 1)
    return up | up.T


def _disconnected_adj(n, rng):
    """Two random components: nodes [0, n/2) and [n/2, n)."""
    adj = np.zeros((n, n), dtype=bool)
    h = n // 2
    adj[:h, :h] = _random_adj(h, 0.5, rng)
    adj[h:, h:] = _random_adj(n - h, 0.5, rng)
    return adj


@pytest.mark.parametrize("n", [2, 3, 9, 64])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_edge_laplacian_plain_matches_pallas(n, dtype):
    rng = np.random.default_rng(n)
    ei, ej = _edges(n)
    g = rng.random(ei.shape[0]).astype(dtype)
    want = np.asarray(jel.edge_laplacian(jnp.asarray(g), jnp.asarray(ei, jnp.int32),
                                         jnp.asarray(ej, jnp.int32), n,
                                         use_kernel=True))
    got = kernels.WRAPPERS["edge_laplacian"](torch.from_numpy(g), n)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (n, n)
    row_max = float(np.abs(np.diag(want)).max())
    tol = 1e-12 if dtype == "float64" else 1e-5 * row_max
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("n", [2, 3, 9, 64])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_edge_quadform_plain_bitwise_matches_pallas(n, dtype):
    rng = np.random.default_rng(100 + n)
    ei, ej = _edges(n)
    P = rng.standard_normal((n, n)).astype(dtype)
    want = np.asarray(jel.edge_quadform(jnp.asarray(P), jnp.asarray(ei, jnp.int32),
                                        jnp.asarray(ej, jnp.int32), use_kernel=True))
    got = tel.edge_quadform(torch.from_numpy(P), torch.from_numpy(ei),
                            torch.from_numpy(ej)).numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,kind", [(4, "random"), (16, "random"), (64, "random"),
                                    (16, "disconnected"), (64, "disconnected")])
def test_hop_step_plain_matches_pallas(n, kind):
    rng = np.random.default_rng(n)
    adj = _random_adj(n, 4.0 / n, rng) if kind == "random" else _disconnected_adj(n, rng)
    reach = np.eye(n, dtype=bool) | adj
    r_t, a_t = torch.from_numpy(reach)[None], torch.from_numpy(adj)[None]
    r_j, a_j = jnp.asarray(reach), jnp.asarray(adj)
    for _ in range(4):
        want, want_cnt = jhop.hop_step(r_j, a_j, use_kernel=True)
        got, got_rows = thop.hop_step(r_t, a_t)
        assert got.dtype == torch.bool
        assert (got[0].numpy() == np.asarray(want)).all()
        assert int(got_rows.sum()) == int(want_cnt)
        assert (got_rows[0].numpy() == np.asarray(want).sum(axis=1)).all()
        r_t, r_j = got, want


def test_hop_step_takes_the_restart_axis():
    rng = np.random.default_rng(7)
    adjs = np.stack([_random_adj(12, 0.3, rng) for _ in range(3)])
    reach = adjs | np.eye(12, dtype=bool)[None]
    new, rows = thop.hop_step(torch.from_numpy(reach), torch.from_numpy(adjs))
    for k in range(3):
        one, one_rows = thop.hop_step(torch.from_numpy(reach[k:k + 1]),
                                      torch.from_numpy(adjs[k:k + 1]))
        assert torch.equal(new[k], one[0]) and torch.equal(rows[k], one_rows[0])
    u8, u8_rows = thop.hop_step(torch.from_numpy(reach).to(torch.uint8),
                                torch.from_numpy(adjs).to(torch.uint8))
    assert u8.dtype == torch.uint8 and torch.equal(u8.bool(), new)
    assert torch.equal(u8_rows, rows)


@pytest.mark.parametrize("R,n", [(1, 5), (1, 16), (1, 31), (1, 64), (4, 64), (3, 100),
                                 (1, 129), (4, 256), (1, 1000), (1, 2000)])
def test_hop_plan_covers_every_output_word_once(R, n):
    """Every (row, 32-column word) of every restart lies in exactly one
    block; there are blocks for half a wave of 132 SMs where the shape has
    rows of four for it (a full wave where the columns must be split); the
    block's shared memory fits the card."""
    bm, cw = thop.hop_plan(R, n, 132)
    nw = -(-n // 32)
    bands, chunks = -(-n // bm), -(-nw // cw)
    seen = np.zeros((n, nw), dtype=int)
    for band in range(bands):
        for chunk in range(chunks):
            seen[band * bm:(band + 1) * bm, chunk * cw:(chunk + 1) * cw] += 1
    assert (seen == 1).all()
    assert thop.hop_smem_bytes(n, bm, cw) <= thop.SMEM_BYTES
    assert R * bands * chunks >= min(132 if chunks > 1 else 66, R * (n // 4))


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="complete edge list"):
        tel.edge_laplacian(torch.zeros(5, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="square"):
        tel.edge_quadform(torch.zeros(3, 4), torch.zeros(2, dtype=torch.int64),
                          torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="equal-length"):
        tel.edge_quadform(torch.zeros(3, 3), torch.zeros(2, dtype=torch.int64),
                          torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="bool or uint8"):
        thop.hop_step(torch.zeros(1, 3, 3, dtype=torch.int32),
                      torch.zeros(1, 3, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(R, n, n\)"):
        thop.hop_step(torch.zeros(3, 3, dtype=torch.bool),
                      torch.zeros(3, 3, dtype=torch.bool))


def test_cpu_path_never_counts_a_launch():
    kernels.reset_launch_counts()
    tel.edge_laplacian(torch.rand(6, dtype=torch.float64), 4)
    tel.edge_quadform(torch.rand(4, 4), torch.tensor([0, 1]), torch.tensor([2, 3]))
    thop.hop_step(torch.ones(1, 4, 4, dtype=torch.bool), torch.ones(1, 4, 4, dtype=torch.bool))
    tgm.gossip_mix_batched(torch.rand(3, 5), torch.zeros(3, 1, dtype=torch.int32),
                           torch.rand(3, 2))
    tgm.gossip_mix(torch.rand(5), torch.rand(2, 5), torch.rand(3))
    tdec.decode_attention(torch.rand(1, 2, 64), torch.rand(1, 3, 1, 64), torch.rand(1, 3, 1, 64),
                          torch.ones(3, dtype=torch.bool))
    tdec.decode_attention_partial(torch.rand(1, 2, 64), torch.rand(1, 3, 1, 64),
                                  torch.rand(1, 3, 1, 64), torch.ones(3, dtype=torch.bool))
    tssd.ssd_intra_chunk(torch.rand(1, 1, 4, 2, 4), torch.rand(1, 1, 4, 2),
                         -torch.rand(1, 1, 4, 2), torch.rand(1, 1, 4, 3), torch.rand(1, 1, 4, 3))
    tel.edge_laplacian_blocks(torch.rand(6), torch.tensor(0.5), torch.rand(4, 4),
                              torch.rand(4, 4), torch.rand(4), torch.empty(36))
    tel.edge_adjoint(torch.rand(4, 4), torch.rand(4, 4), torch.rand(4), torch.rand(6))
    tel.edge_schur_matvec(torch.rand(4, 4), torch.rand(4, 4), torch.rand(4), torch.empty(36),
                          v=torch.rand(6), x_adj=torch.empty(7))
    assert kernels.launch_counts() == {"edge_laplacian": 0, "edge_laplacian_blocks": 0,
                                       "edge_quadform": 0, "edge_adjoint": 0,
                                       "edge_schur_matvec": 0, "hop_step": 0,
                                       "gossip_mix_batched": 0, "gossip_mix": 0,
                                       "decode_attention": 0, "decode_attention_partial": 0,
                                       "ssd_intra_chunk": 0}
    assert set(kernels.WRAPPERS) == set(kernels.launch_counts())
    assert set(build.SOURCES) == {"edge_laplacian", "hop_bfs", "gossip_mix",
                                  "decode_attention", "ssd_scan"}


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_edge_laplacian_blocks_plain_is_the_a_op_composition(hetero, dtype):
    """A_op's dense blocks from ``edge_laplacian_blocks_plain`` (and the
    wrapper on the CPU) are bit-equal to the engine's composition, on a
    homogeneous and a heterogeneous spec, at λ > 0 and λ < 0 (λ·I's signed
    zeros); entries past 2n² + n are left alone."""
    from repro_torch.core import engine as te
    from repro_torch.core.constraints import bcube_constraints

    cfg = te.ADMMConfig(device="cpu", dtype=dtype)
    if hetero:
        cs = bcube_constraints(p=4, k=2)
        spec = te.make_hetero_spec(16, 48, cs.M, cs.e_cap, cfg, equality=False,
                                   edge_ok=cs.edge_ok)
    else:
        spec = te.make_homo_spec(12, 24, cfg)
    n = spec.n
    st = te.init_state(spec, np.random.default_rng(n).random(spec.m) * 0.3, 0.5)
    st, _ = te.step(spec, st)
    bits = torch.int32 if dtype == "float32" else torch.int64
    for lam_sign in (1.0, -1.0):
        x = st.X[0].clone()
        x[-1] = lam_sign * x[-1].abs()
        X = (x,) + tuple(st.X[1:])
        want = te.A_op(spec, X)[:2 * n * n + n]
        for fn in (tel.edge_laplacian_blocks_plain, tel.edge_laplacian_blocks):
            out = torch.full((2 * n * n + n + 3,), 7.0, dtype=want.dtype)
            got = fn(x[:-1], x[-1], X[1], X[3], X[2], out)
            assert got is out
            assert torch.equal(out[:2 * n * n + n].view(bits), want.view(bits))
            assert (out[2 * n * n + n:] == 7.0).all()


def _reference_spec(case, dtype):
    """(reference spec with the Pallas pair on, port spec) for n = 5 or 16
    homogeneous, or BCube(4, 2) heterogeneous (n = 16)."""
    from repro.core.constraints import bcube_constraints
    from repro_torch import convert

    cfg = _jax_engine.ADMMConfig(dtype=dtype, edge_kernel=True)
    if case == "bcube":
        cs = bcube_constraints(p=4, k=2)
        jspec = _jax_engine.make_hetero_spec(16, 48, cs.M.astype(dtype), cs.e_cap.astype(dtype),
                                             cfg, equality=cs.equality, edge_ok=cs.edge_ok)
    else:
        n = int(case[4:])
        jspec = _jax_engine.make_homo_spec(n, 2 * n, cfg)
    tspec = convert.spec_from_numpy(jax.tree.map(np.asarray, jspec), device="cpu")
    return jspec, tspec


@pytest.mark.parametrize("case", ["homo5", "homo16", "bcube"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_edge_adjoint_forms_plain_match_the_reference(case, dtype):
    """``edge_adjoint_plain`` (and its wrapper on the CPU) against the
    reference's ``AT_op``, ``edge_schur_matvec_plain`` against the dense
    blocks of ``A_op(AT_op(λ))``, and the engine's ``schur_matvec`` against
    the whole of it, both sides with the edge kernels on; tolerances in the
    module docstring, the whole vector's scaled by 1 + its largest entry
    (the heterogeneous rows are BLAS products summed in another order)."""
    from repro_torch.core import engine as te

    jspec, tspec = _reference_spec(case, dtype)
    n, m = tspec.n, tspec.m
    rng = np.random.default_rng(n + len(case))
    blocks = [rng.standard_normal(k).astype(dtype) for k in te.lam_sizes(tspec)]
    blocks[0], blocks[1] = blocks[0].reshape(n, n), blocks[1].reshape(n, n)
    j_adj = _jax_engine.AT_op(jspec, tuple(jnp.asarray(b) for b in blocks))
    want_x = np.asarray(j_adj[0])
    want_blocks = [np.asarray(b).reshape(-1) for b in _jax_engine.A_op(jspec, j_adj)]
    P, Q, w = (torch.from_numpy(b) for b in blocks[:3])
    v = torch.from_numpy(blocks[4]) if tspec.hetero else None

    u = np.finfo(dtype).eps / 2
    diag_sum = np.abs(np.diag(blocks[0])).sum() + np.abs(np.diag(blocks[1])).sum()
    for adjoint in (tel.edge_adjoint_plain, tel.edge_adjoint):
        got = adjoint(P, Q, w, v).numpy()
        assert got.dtype == want_x.dtype and got.shape == (m + 1,)
        assert got[:m].tobytes() == want_x[:m].tobytes()
        assert abs(got[m] - want_x[m]) <= 2 * n * u * diag_sum
    xg = got[:m]
    lidx = tel.packed_edge_index(n).numpy()
    row_abs = np.abs(np.concatenate([xg, [0.0]])[lidx]).sum(axis=1).max()
    tol = 2 * n * u * (row_abs + diag_sum)
    dense = np.concatenate(want_blocks[:3])
    for matvec in (tel.edge_schur_matvec_plain, tel.edge_schur_matvec):
        out = torch.full((2 * n * n + n + 2,), 7.0, dtype=P.dtype)
        x_adj = torch.empty(m + 1, dtype=P.dtype)
        assert matvec(P, Q, w, out, v=v, x_adj=x_adj) is out
        np.testing.assert_allclose(out[:2 * n * n + n].numpy(), dense, rtol=0, atol=tol)
        assert (out[2 * n * n + n:] == 7.0).all()
        assert x_adj.numpy().tobytes() == got.tobytes()
    full = te.schur_matvec(tspec, torch.from_numpy(np.concatenate([b.reshape(-1) for b in blocks])))
    np.testing.assert_allclose(full.numpy(), np.concatenate(want_blocks), rtol=0,
                               atol=tol * (1 + np.abs(np.concatenate(want_blocks)).max()))


@pytest.mark.parametrize("scenario", ["homo", "bcube_eq", "bcube_ineq"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schur_matvec_is_a_op_of_at_op_on_the_cpu(scenario, dtype):
    """The engine's one-launch matvec takes on the CPU exactly the values of
    the composition ``A_op(AT_op(λ))`` it replaced (the plain versions are
    that composition), and ``AT_op`` with the edge kernels on equals it
    with them off."""
    from repro_torch.core import engine as te
    from repro_torch.core.constraints import bcube_constraints

    cfg = te.ADMMConfig(device="cpu", dtype=dtype)
    if scenario == "homo":
        spec = te.make_homo_spec(12, 24, cfg)
    else:
        cs = bcube_constraints(p=4, k=2)
        spec = te.make_hetero_spec(16, 48, cs.M, cs.e_cap, cfg,
                                   equality=scenario == "bcube_eq", edge_ok=cs.edge_ok)
    lam = torch.from_numpy(np.random.default_rng(3).standard_normal(
        sum(te.lam_sizes(spec)))).to(getattr(torch, dtype))
    bits = torch.int32 if dtype == "float32" else torch.int64
    want = te.A_op(spec, te.AT_op(spec, lam))
    assert torch.equal(te.schur_matvec(spec, lam).view(bits), want.view(bits))
    plain = spec.replace(edge_kernel=False)
    assert torch.equal(te.schur_matvec(plain, lam).view(bits), want.view(bits))
    for a, b in zip(te.AT_op(spec, lam), te.AT_op(plain, lam)):
        assert torch.equal(a.view(bits), b.view(bits))


def test_edge_adjoint_forms_reject_bad_operands():
    P, Q, w = torch.zeros(4, 4), torch.zeros(4, 4), torch.zeros(4)
    with pytest.raises(ValueError, match=r"P and Q \(n, n\)"):
        tel.edge_adjoint(torch.zeros(4, 3), Q, w)
    with pytest.raises(ValueError, match=r"v \(m,\)"):
        tel.edge_adjoint(P, Q, w, torch.zeros(5))
    with pytest.raises(ValueError, match=r"P and Q \(n, n\)"):
        tel.edge_schur_matvec(P, Q, torch.zeros(3), torch.empty(36))
    with pytest.raises(ValueError, match=r"out \(≥ 2n²\+n,\)"):
        tel.edge_schur_matvec(P, Q, w, torch.empty(35))
    with pytest.raises(ValueError, match=r"x_adj \(m\+1,\)"):
        tel.edge_schur_matvec(P, Q, w, torch.empty(36), x_adj=torch.empty(6))
    with pytest.raises(TypeError, match="one dtype"):
        tel.edge_adjoint(P, Q.double(), w)
    with pytest.raises(TypeError, match="one dtype"):
        tel.edge_schur_matvec(P, Q, w, torch.empty(36, dtype=torch.float64))


def test_packed_edge_index_is_lexicographic():
    n = 7
    lidx = tel.packed_edge_index(n).numpy()
    ei, ej = _edges(n)
    assert (lidx[ei, ej] == np.arange(ei.shape[0])).all()
    assert (lidx == lidx.T).all() and (np.diag(lidx) == ei.shape[0]).all()


def test_parse_ptxas_reads_registers_smem_and_spills():
    log = """ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 20800 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 12 registers, 368 bytes cmem[0]
"""
    assert build.parse_ptxas(log) == [
        {"kernel": "_Z6kernelPf", "registers": 40, "smem_bytes": 20800,
         "spill_stores": 4, "spill_loads": 12},
        {"kernel": "_Z5otherv", "registers": 12, "smem_bytes": 0,
         "spill_stores": 0, "spill_loads": 0}]


def test_build_load_and_launch_failures_are_device_faults(monkeypatch, tmp_path):
    """No card, no ``nvcc``, a failed build, a library that does not load
    and a failed launch each raise ``DeviceFault``, which the guard ladders
    re-raise; it stays a ``RuntimeError``."""
    from repro_torch.device import DeviceFault, resolve_device
    from repro_torch.kernels import launch_util

    assert issubclass(DeviceFault, RuntimeError)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceFault, match="device='cpu'"):
        resolve_device("cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(DeviceFault, match="nvcc not found"):
        build._nvcc()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no card here'\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(DeviceFault, match="kernel build failed(.|\n)*no card here"):
        build.build(["hop_bfs"])
    bad = tmp_path / "bad.so"
    bad.write_text("not a shared library")
    monkeypatch.setattr(build, "build", lambda names: {name: bad for name in names})
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(DeviceFault, match="does not load"):
        build.load("hop_bfs", {})
    with pytest.raises(DeviceFault, match="hop_step kernel launch failed with CUDA error 700"):
        launch_util.raise_launch_error("hop_step", 700, 0)
