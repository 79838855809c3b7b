"""The port's ADMM engine against ``repro.core.engine`` on the CPU.

Both packages start from identical states, carried across with
``repro_torch.convert``, in float64. Tolerances: one ``step`` within 1e-9
on every block; ``pcg_solve`` within 1e-8 with the same iteration count; a
full ``solve_spec`` with the same support and λ̃ within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import linalg as jl  # noqa: E402
from repro.core.constraints import (  # noqa: E402
    bcube_constraints, intra_server_constraints, node_level_constraints)
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import linalg as tl  # noqa: E402
from repro_torch.core.admm import HeterogeneousADMM, HomogeneousADMM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _scenario(name, **cfg_kw):
    """(reference spec, port spec, warm start g0, z0) for a small scenario."""
    jcfg = je.ADMMConfig(**cfg_kw)
    rng = np.random.default_rng(len(name))
    if name == "homo":
        n, r = 8, 12
        jspec = je.make_homo_spec(n, r, jcfg)
        z0 = None
    else:
        if name == "node":
            n, r = 8, 12
            cs = node_level_constraints(n, np.full(n, 3), np.ones(n))
        elif name == "intra":
            n, r = 8, 12
            cs = intra_server_constraints(8)
        else:
            n, r = 16, 48
            cs = bcube_constraints(p=4, k=2)
        jspec = je.make_hetero_spec(n, r, cs.M.astype(np.float64),
                                    cs.e_cap.astype(np.float64), jcfg,
                                    equality=cs.equality, edge_ok=cs.edge_ok)
        z0 = (rng.random(jspec.m) < 0.3).astype(np.float64)
    g0 = rng.random(jspec.m) * 0.3
    tspec = convert.spec_from_numpy(_np_tree(jspec), device="cpu")
    return jspec, tspec, g0, z0


def _advanced_state(jspec, tspec, g0, z0, iters=4):
    """A state a few iterations in (duals and multipliers set), advanced by
    the port and carried to the reference with ``state_to_numpy``."""
    st = te.init_state(tspec, g0, 0.5, z=z0)
    for _ in range(iters):
        st, _ = te.step(tspec, st)
    leaves = convert.state_to_numpy(st)
    blocks = [tuple(jnp.asarray(b) for b in getattr(leaves, f))
              for f in ("X", "Y", "D", "lam")]
    return je.ADMMState(*blocks, res=jnp.asarray(leaves.res),
                        cg=jnp.asarray(leaves.cg))


def _assert_blocks(got, want, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("name,precond", [("homo", "none"), ("homo", "jacobi"),
                                          ("node", "none"), ("intra", "none"),
                                          ("bcube", "jacobi")])
def test_one_step_from_a_converted_state(name, precond):
    jspec, tspec, g0, z0 = _scenario(name, precond=precond)
    jst = _advanced_state(jspec, tspec, g0, z0)
    want, want_res = je._jit_step(jspec, jst, backend="schur_cg")
    got, got_res = te.step(tspec, convert.state_from_numpy(_np_tree(jst), tspec))
    got_np, want_np = convert.state_to_numpy(got), _np_tree(want)
    for field in ("X", "Y", "D", "lam"):
        _assert_blocks(getattr(got_np, field), getattr(want_np, field), 1e-9)
    assert abs(float(got_res) - float(want_res)) <= 1e-9
    assert int(got.cg) == int(want.cg)


def test_init_state_matches():
    jspec, tspec, g0, z0 = _scenario("intra")
    want = _np_tree(je.init_state(jspec, jnp.asarray(g0), 0.4, z=jnp.asarray(z0)))
    got = convert.state_to_numpy(te.init_state(tspec, g0, 0.4, z=z0))
    for field in ("X", "Y", "D", "lam"):
        _assert_blocks(getattr(got, field), getattr(want, field), 1e-15)


@pytest.mark.parametrize("name", ["homo", "bcube"])
def test_pcg_solve_matches(name):
    jspec, tspec, g0, z0 = _scenario(name)
    jst = _advanced_state(jspec, tspec, g0, z0)
    U = tuple(x + d / jspec.rho for x, d in zip(jst.X, jst.D))
    V = je._xstep_target(jspec, je._project_blocks(jspec, U), jst.D)
    jX, jlam, jit = jl.pcg_solve(lambda X: je.A_op(jspec, X),
                                 lambda L: je.AT_op(jspec, L), V,
                                 je.b_rhs(jspec), jst.lam, tol=1e-8, maxiter=500)
    tV = tuple(torch.from_numpy(np.array(v)) for v in V)
    lam0 = torch.cat([torch.from_numpy(np.array(b)).reshape(-1) for b in jst.lam])
    tX, tlam, tit = tl.pcg_solve(lambda X: te.A_op(tspec, X),
                                 lambda L: te.AT_op(tspec, L), tV,
                                 te.b_rhs(tspec), lam0, tol=1e-8, maxiter=500)
    assert int(tit) == int(jit)
    _assert_blocks([x.numpy() for x in tX], jX, 1e-8)
    _assert_blocks(convert.lam_to_numpy(tspec, tlam), jlam, 1e-8)


@pytest.mark.parametrize("name", ["homo", "bcube"])
def test_pcg_solve_with_the_fused_matvec_matches(name):
    """``pcg_solve`` with the engine's one-launch ``schur_matvec`` (the
    ``step``'s matvec) on the cases of ``test_pcg_solve_matches``: the same
    iterate within 1e-8 and the same count as the reference."""
    from functools import partial

    jspec, tspec, g0, z0 = _scenario(name)
    jst = _advanced_state(jspec, tspec, g0, z0)
    U = tuple(x + d / jspec.rho for x, d in zip(jst.X, jst.D))
    V = je._xstep_target(jspec, je._project_blocks(jspec, U), jst.D)
    jX, jlam, jit = jl.pcg_solve(lambda X: je.A_op(jspec, X),
                                 lambda L: je.AT_op(jspec, L), V,
                                 je.b_rhs(jspec), jst.lam, tol=1e-8, maxiter=500)
    tV = tuple(torch.from_numpy(np.array(v)) for v in V)
    lam0 = torch.cat([torch.from_numpy(np.array(b)).reshape(-1) for b in jst.lam])
    tX, tlam, tit = tl.pcg_solve(lambda X: te.A_op(tspec, X),
                                 lambda L: te.AT_op(tspec, L), tV,
                                 te.b_rhs(tspec), lam0, tol=1e-8, maxiter=500,
                                 matvec=partial(te.schur_matvec, tspec))
    assert int(tit) == int(jit)
    _assert_blocks([x.numpy() for x in tX], jX, 1e-8)
    _assert_blocks(convert.lam_to_numpy(tspec, tlam), jlam, 1e-8)


def test_pcg_solve_stops_at_maxiter_between_checks():
    """maxiter not a multiple of the check interval: the count stops exactly."""
    jspec, tspec, g0, z0 = _scenario("homo")
    st = te.init_state(tspec, g0, 0.5)
    V = te._xstep_target(tspec, te._project_blocks(
        tspec, tuple(x + d / tspec.rho for x, d in zip(st.X, st.D))), st.D)
    lam0 = torch.zeros(sum(te.lam_sizes(tspec)), dtype=torch.float64)
    _, _, it = tl.pcg_solve(lambda X: te.A_op(tspec, X), lambda L: te.AT_op(tspec, L),
                            V, te.b_rhs(tspec), lam0, tol=1e-30, maxiter=11)
    assert int(it) == 11


def _support(g, tol=1e-6):
    return tuple(np.nonzero(np.asarray(g) > tol)[0])


@pytest.mark.parametrize("name", ["homo", "bcube"])
def test_solve_spec_matches(name):
    cfg_kw = dict(max_iters=200)
    jspec, tspec, g0, z0 = _scenario(name, **cfg_kw)
    jst0 = je.init_state(jspec, jnp.asarray(g0), 0.5,
                         z=None if z0 is None else jnp.asarray(z0))
    want = je.solve_spec(jspec, jst0, je.ADMMConfig(**cfg_kw))
    got = te.solve_spec(tspec, te.init_state(tspec, g0, 0.5, z=z0),
                        te.ADMMConfig(device="cpu", **cfg_kw))
    assert _support(got.g) == _support(want.g)
    assert abs(got.lam_tilde - want.lam_tilde) <= 1e-6
    assert got.iters == want.iters
    assert [h[0] for h in got.history] == [h[0] for h in want.history]
    # the exact-mode CG tolerance (1e-11) sits at the float64 floor of the
    # residual, where another summation order moves a few stops by one
    assert abs(got.cg_iters - want.cg_iters) <= 0.01 * want.cg_iters
    if name == "bcube":
        assert (got.z == want.z).all()


def test_wrappers_match_the_reference_solvers():
    """Same configurations as ``test_solve_spec_matches``, so the reference's
    compiled driver is reused."""
    from repro.core.admm import HeterogeneousADMM as JHet
    from repro.core.admm import HomogeneousADMM as JHomo

    rng = np.random.default_rng(3)
    g0 = rng.random(28) * 0.3
    want = JHomo(8, 12, je.ADMMConfig(max_iters=200)).solve(g0=g0, lam0=0.4)
    got = HomogeneousADMM(8, 12, te.ADMMConfig(max_iters=200, device="cpu")).solve(
        g0=g0, lam0=0.4)
    np.testing.assert_allclose(got.g, want.g, rtol=0, atol=1e-9)
    cs = bcube_constraints(p=4, k=2)
    g0 = rng.random(120) * 0.3
    want = JHet(16, 48, cs.M, cs.e_cap, je.ADMMConfig(max_iters=200), equality=False,
                edge_ok=cs.edge_ok).solve(g0=g0, lam0=0.4)
    got = HeterogeneousADMM(16, 48, cs.M, cs.e_cap,
                            te.ADMMConfig(max_iters=200, device="cpu"),
                            equality=False, edge_ok=cs.edge_ok).solve(g0=g0, lam0=0.4)
    np.testing.assert_allclose(got.g, want.g, rtol=0, atol=1e-6)
    assert (got.z == want.z).all()


def test_make_spec_matches_the_reference():
    cs = bcube_constraints(p=4, k=2)
    jcfg = je.ADMMConfig(precond="jacobi")
    jspec = _np_tree(je.make_hetero_spec(16, 40, cs.M, cs.e_cap, jcfg,
                                         equality=False, edge_ok=cs.edge_ok))
    tspec = te.make_hetero_spec(16, 40, cs.M, cs.e_cap,
                                te.ADMMConfig(precond="jacobi", device="cpu"),
                                equality=False, edge_ok=cs.edge_ok)
    assert (tspec.n, tspec.m, tspec.q, tspec.hetero, tspec.equality) == \
        (jspec.n, jspec.m, jspec.q, jspec.hetero, jspec.equality)
    assert int(tspec.r) == int(jspec.r) and tspec.r.dtype == torch.int64
    for f in ("edge_ok", "c", "ei", "ej", "B0", "I", "M", "e_cap", "lidx"):
        np.testing.assert_array_equal(getattr(tspec, f).numpy(), getattr(jspec, f))
    np.testing.assert_array_equal(
        tspec.jd.numpy(), np.concatenate([b.reshape(-1) for b in jspec.jd]))


@pytest.mark.parametrize("r", [0, 3, 10, 27, 28, 40])
def test_proj_card_nonneg_matches(r):
    rng = np.random.default_rng(r)
    v = np.round(rng.standard_normal(28), 1)          # ties on purpose
    ok = rng.random(28) < 0.8
    want = np.asarray(je.proj_card_nonneg(jnp.asarray(v), jnp.asarray(r, jnp.int64),
                                          jnp.asarray(ok)))
    got = te.proj_card_nonneg(torch.from_numpy(v), torch.tensor(r), torch.from_numpy(ok))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r", [0, 5, 12, 28])
def test_proj_binary_topr_matches_with_signed_zero_ties(r):
    rng = np.random.default_rng(r)
    v = np.round(rng.standard_normal(28), 0)
    v[::5] = -0.0
    v[1::7] = 0.0
    ok = rng.random(28) < 0.9
    want = np.asarray(je.proj_binary_topr(jnp.asarray(v), jnp.asarray(r, jnp.int64),
                                          jnp.asarray(ok)))
    got = te.proj_binary_topr(torch.from_numpy(v), torch.tensor(r), torch.from_numpy(ok))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_psd_projections_match(sign):
    rng = np.random.default_rng(int(sign > 0))
    M = rng.standard_normal((12, 12))
    want = np.asarray(je.proj_psd(jnp.asarray(M), sign))
    np.testing.assert_allclose(te.proj_psd(torch.from_numpy(M), sign).numpy(), want,
                               rtol=0, atol=1e-12)
    want_ns = np.asarray(je.proj_psd_ns(jnp.asarray(M), sign, iters=30))
    np.testing.assert_allclose(te.proj_psd_ns(torch.from_numpy(M), sign, 30).numpy(),
                               want_ns, rtol=0, atol=1e-12)


def test_newton_schulz_step_matches():
    jspec, tspec, g0, z0 = _scenario("homo", psd_backend="newton_schulz")
    assert tspec.psd_backend == "newton_schulz"
    jst = _advanced_state(jspec, tspec, g0, z0, iters=2)
    want, _ = je._jit_step(jspec, jst, backend="schur_cg")
    got, _ = te.step(tspec, convert.state_from_numpy(_np_tree(jst), tspec))
    _assert_blocks(convert.state_to_numpy(got).X, _np_tree(want).X, 1e-9)


def test_float32_spec_keeps_float64_residuals():
    _, tspec, g0, _ = _scenario("homo", dtype="float32", cg_inexact=True)
    st, res = te.step(tspec, te.init_state(tspec, g0, 0.5))
    assert st.X[1].dtype == torch.float32 and res.dtype == torch.float64
    assert te._cg_tolerance(tspec, torch.tensor(float("inf"), dtype=torch.float64)) == \
        pytest.approx(te.INEXACT_CAP)
    assert float(te._cg_tolerance(tspec, torch.tensor(0.0, dtype=torch.float64))) == \
        te.FP32_TOL_FLOOR


def test_abort_nonfinite_stops_after_one_chunk():
    """A NaN reaches the residual (torch's eigh would raise on it, the
    reference's returns NaN) and the driver stops after the first chunk."""
    jspec, tspec, g0, _ = _scenario("homo")
    g0 = g0.copy()
    g0[0] = np.nan
    want = je.solve_spec(jspec, je.init_state(jspec, jnp.asarray(g0), 0.5),
                         je.ADMMConfig(max_iters=50, check_every=10))
    got = te.solve_spec(tspec, te.init_state(tspec, g0, 0.5),
                        te.ADMMConfig(max_iters=50, check_every=10, device="cpu"))
    assert got.iters == want.iters == 10
    assert not np.isfinite(got.residual) and not np.isfinite(want.residual)


def test_selectors_not_ported_raise_naming_the_roadmap_item():
    """Item 7a's partitions (ported) resolve as the reference's, one process
    resolving ``"auto"`` to ``"none"``; item 7c's tensor-parallel train step
    (ported) builds, serving the dense family over a mesh (item 7c′) is
    ported, and serving the ssm family there (item 7c″) raises naming the
    roadmap item; item 2's driver and backends (ported) run: a short solve
    by each on the CPU."""
    from repro_torch.dsgd.trainer import make_tp_train_step
    from repro_torch.launch.steps import build_step
    from repro_torch.optim import sgd_momentum

    assert te.resolve_partition("edges", 8) == "edges"
    assert te.resolve_partition("instances", 8, batch=2) == "instances"
    assert te.resolve_partition("auto", 4096) == "none"
    assert callable(make_tp_train_step(None, sgd_momentum(0.05)[1], accum_steps=2))
    with pytest.raises(NotImplementedError, match="Queue 1, item 7c″"):
        build_step("mamba2-780m", "prefill_32k", None)
    for kw in (dict(solver="kkt_bicgstab"), dict(driver="python"),
               dict(solver="kkt_bicgstab_ilu")):
        cfg = te.ADMMConfig(max_iters=5, check_every=5, device="cpu", **kw)
        te.check_solver(cfg)
        res = HomogeneousADMM(4, 3, cfg).solve()
        assert res.iters == 5 and np.isfinite(res.lam_tilde), kw
    with pytest.raises(ValueError, match="unknown driver"):
        te.check_solver(te.ADMMConfig(driver="scan2"))
    with pytest.raises(ValueError, match="unknown precond"):
        te.make_homo_spec(4, 3, te.ADMMConfig(precond="Jacobi", device="cpu"))


def test_psd_backend_auto_resolution():
    assert te.resolve_psd_backend("auto", 512, "cpu") == "eigh"
    assert te.resolve_psd_backend("auto", 64, "cuda") == "eigh"
    assert te.resolve_psd_backend("auto", 256, "cuda") == "newton_schulz"
    assert te.resolve_psd_backend("eigh", 4096, "cuda") == "eigh"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        te.make_homo_spec(4, 3, te.ADMMConfig())
    assert resolve_device("cpu") == torch.device("cpu")
