"""The ADMM's other X-step backends and the per-iteration driver of the port
against ``repro.core`` on the CPU.

- One X-step by ``schur_cg``, ``kkt_bicgstab`` and the scipy ILU from a
  converted state (homogeneous n = 6, r = 8; heterogeneous n = 8 with
  node-level degree rows), each against the reference's same backend:
  every block within 1e-9 in float64 and 2e-5 in float32 (a float32 step
  moves blocks of order 1 at a relative tolerance of 1e-6); the CG count
  equal in float64 and within one in float32. The Bi-CGSTAB dots are taken
  in the operands' dtype, as JAX's are: with float64 dots the float32
  solve drifted 4× further from JAX's at convergence.
- ``kkt_bicgstab_solve`` count for count against
  ``jax.scipy.sparse.linalg.bicgstab`` at maxiter = 1…6 and converged, in
  float64. Bi-CGSTAB on the indefinite KKT system amplifies rounding from
  the third iteration on, in JAX alone too: with V moved by one ulp, JAX's
  own iterate moves by 1e-13 at k = 3 and 1e-7 at k = 6 on these inputs. So
  each count is held to 1e-12 plus ten times that one-ulp spread, measured
  in the test.
- A batch of 3 through ``step(..., "kkt_bicgstab")`` equal to three single
  steps within 1e-9 (each instance stops on its own).
- ``build_sparse_A`` equal to the reference's matrix.
- ``solve_python`` at n = 8, r = 12, 60 iterations against the
  reference's: the same history cadence, λ̃ and g within 1e-9, residuals
  within 1e-8 relative.
- The ILU backend through ``HomogeneousADMM`` (float64) against the
  reference's, and the wrappers' refusals.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core.admm import ADMMConfig as JConfig  # noqa: E402
from repro.core.admm import HomogeneousADMM as JHomo  # noqa: E402
from repro.core.constraints import node_level_constraints  # noqa: E402
from repro.core.graph import all_edges  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import BATopoConfig, sweep_topologies  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import linalg as tl  # noqa: E402
from repro_torch.core.admm import HeterogeneousADMM, HomogeneousADMM  # noqa: E402

TOL = {"float64": 1e-9, "float32": 2e-5}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite's parallel
    workers share the host's cores, and these small solves only lose to
    oversubscribed thread pools; restored on the way out."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _specs(scenario, dtype, **cfg_kw):
    """(reference spec, port spec) for homo n = 6, r = 8 or hetero n = 8."""
    jcfg = je.ADMMConfig(dtype=dtype, **cfg_kw)
    if scenario == "homo":
        jspec = je.make_homo_spec(6, 8, jcfg)
    else:
        cs = node_level_constraints(8, np.full(8, 3), np.ones(8))
        jspec = je.make_hetero_spec(8, 12, cs.M.astype(np.float64),
                                    cs.e_cap.astype(np.float64), jcfg,
                                    equality=cs.equality, edge_ok=cs.edge_ok)
    return jspec, convert.spec_from_numpy(_np_tree(jspec), device="cpu")


def _state(jspec, seed=0, steps=3):
    """A reference state a few schur_cg steps in (duals and multipliers set)."""
    rng = np.random.default_rng(seed)
    g0 = jnp.asarray(rng.random(jspec.m) * 0.3)
    z0 = jnp.asarray((rng.random(jspec.m) < 0.3).astype(np.float64)) if jspec.hetero else None
    st = je.init_state(jspec, g0, 0.4, z=z0)
    for _ in range(steps):
        st, _ = je._jit_step(jspec, st, backend="schur_cg")
    return st


def _assert_state(got, want, atol):
    got_np, want_np = convert.state_to_numpy(got), _np_tree(want)
    for field in ("X", "Y", "D"):
        for a, b in zip(getattr(got_np, field), getattr(want_np, field)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("scenario", ["homo", "hetero"])
@pytest.mark.parametrize("backend", ["schur_cg", "kkt_bicgstab"])
def test_one_device_xstep_matches_reference(backend, scenario, dtype):
    jspec, tspec = _specs(scenario, dtype)
    jst = _state(jspec)
    want, want_res = je._jit_step(jspec, jst, backend=backend)
    got, got_res = te.step(tspec, convert.state_from_numpy(_np_tree(jst), tspec), backend)
    _assert_state(got, want, TOL[dtype])
    assert abs(float(got_res) - float(want_res)) <= TOL[dtype] * max(1.0, float(want_res))
    # kkt_bicgstab leaves the count alone; a float32 CG stopping at its
    # 1e-6 floor may take one iteration more or fewer than XLA's
    assert abs(int(got.cg) - int(want.cg)) <= (0 if dtype == "float64" else 1)


def test_one_ilu_xstep_matches_reference():
    jspec, tspec = _specs("homo", "float64")
    jst = _state(jspec)
    want, want_res = je.make_ilu_step(jspec)(jst)
    step = te.make_ilu_step(tspec)
    got, got_res = step(convert.state_from_numpy(_np_tree(jst), tspec))
    _assert_state(got, want, 1e-9)
    assert abs(float(got_res) - float(want_res)) <= 1e-9
    assert step.ilu.fallbacks == 0
    # the three backends agree on the X-step (the reference's own band)
    cg, _ = te.step(tspec, convert.state_from_numpy(_np_tree(jst), tspec), "schur_cg")
    kkt, _ = te.step(tspec, convert.state_from_numpy(_np_tree(jst), tspec), "kkt_bicgstab")
    for a, b, c in zip(cg.X, kkt.X, got.X):
        assert float((a - b).abs().max()) <= 1e-6 and float((a - c).abs().max()) <= 1e-6


@pytest.mark.parametrize("scenario", ["hetero"])
def test_ilu_step_refuses_what_the_reference_refuses(scenario):
    _, tspec = _specs(scenario, "float64")
    with pytest.raises(ValueError, match="homogeneous"):
        te.make_ilu_step(tspec)
    _, tspec32 = _specs("homo", "float32")
    with pytest.raises(ValueError, match="float64"):
        te.make_ilu_step(tspec32)


@pytest.fixture(scope="module")
def bicgstab_case():
    """The homogeneous n = 6 KKT system at an ADMM iterate's target V, from
    a random (X0, λ0), in both packages; JAX's bicgstab jitted once with
    maxiter traced."""
    jspec, tspec = _specs("homo", "float64")
    jst = _state(jspec)
    U = tuple(x + d / jspec.rho for x, d in zip(jst.X, jst.D))
    V = je._xstep_target(jspec, je._project_blocks(jspec, U), jst.D)
    rng = np.random.default_rng(1)
    X0 = tuple(jnp.asarray(rng.standard_normal(np.shape(x))) for x in jst.X)
    L0 = tuple(jnp.asarray(rng.standard_normal(np.shape(x))) for x in jst.lam)

    def matvec(XL):
        X, L = XL
        return (jax.tree.map(lambda x, a: x + a, X, je.AT_op(jspec, L)), je.A_op(jspec, X))

    @jax.jit
    def jsolve(V, maxiter):
        sol, _ = jax.scipy.sparse.linalg.bicgstab(matvec, (V, je.b_rhs(jspec)), x0=(X0, L0),
                                                  tol=1e-11, maxiter=maxiter)
        return sol

    def tsolve(maxiter):
        X, lam = tl.kkt_bicgstab_solve(
            lambda X: te.A_op(tspec, X), lambda L: te.AT_op(tspec, L),
            tuple(torch.from_numpy(np.array(v)) for v in V), te.b_rhs(tspec),
            tuple(torch.from_numpy(np.array(x)) for x in X0),
            torch.cat([torch.from_numpy(np.array(b)).reshape(-1) for b in L0]),
            tol=1e-11, maxiter=maxiter)
        return [x.numpy() for x in X] + list(convert.lam_to_numpy(tspec, lam))

    V_ulp = tuple(jnp.asarray(np.nextafter(np.asarray(v), np.inf)) for v in V)
    return jsolve, tsolve, V, V_ulp


def _flat(sol):
    X, L = sol
    return [np.asarray(a) for a in list(X) + list(L)]


@pytest.mark.parametrize("maxiter", [1, 2, 3, 4, 5, 6, 400])
def test_kkt_bicgstab_count_for_count_against_jax(bicgstab_case, maxiter):
    jsolve, tsolve, V, V_ulp = bicgstab_case
    want = _flat(jsolve(V, maxiter))
    spread = max(float(np.abs(a - b).max()) for a, b in zip(_flat(jsolve(V_ulp, maxiter)), want))
    got = tsolve(maxiter)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    assert err <= 1e-12 + 10 * spread, (maxiter, err, spread)
    if maxiter <= 2:
        assert err <= 1e-12


def test_batch_of_three_equals_three_single_steps():
    jspec, tspec = _specs("homo", "float64")
    singles = [convert.state_from_numpy(_np_tree(_state(jspec, seed=s)), tspec)
               for s in range(3)]
    batch = te.ADMMState(*(tuple(torch.stack(blk) for blk in zip(*(getattr(st, f)
                                                                    for st in singles)))
                           for f in ("X", "Y", "D", "lam")),
                         res=torch.stack([st.res for st in singles]),
                         cg=torch.stack([st.cg for st in singles]))
    got, res = te.step(tspec, batch, "kkt_bicgstab")
    for b, st in enumerate(singles):
        one, one_res = te.step(tspec, st, "kkt_bicgstab")
        for a, c in zip(got.X, one.X):
            assert float((a[b] - c).abs().max()) <= 1e-9
        assert abs(float(res[b]) - float(one_res)) <= 1e-9


def test_build_sparse_A_equals_reference():
    n = 6
    m = n * (n - 1) // 2
    want = je.build_sparse_A(n, m, all_edges(n)).toarray()
    got = te.build_sparse_A(n, m, all_edges(n)).toarray()
    assert np.array_equal(got, want)
    # its products are the port's A_op, on the column-major packing
    spec = te.make_homo_spec(n, 8, te.ADMMConfig(device="cpu"))
    rng = np.random.default_rng(0)
    X = tuple(torch.from_numpy(rng.standard_normal(s)) for s in ((m + 1,), (n, n), (n,), (n, n)))
    AX = te.A_op(spec, X)
    P, Q, w = te.split_lam(spec, AX)
    packed = np.concatenate([P.t().reshape(-1).numpy(), Q.t().reshape(-1).numpy(), w.numpy()])
    np.testing.assert_allclose(got @ te._pack_homo(X).numpy(), packed, rtol=0, atol=1e-12)
    back = te._unpack_homo(n, m, te._pack_homo(X))
    assert all(torch.equal(a, b) for a, b in zip(back, X))


@pytest.mark.parametrize("solver", ["schur_cg", "kkt_bicgstab"])
def test_solve_python_matches_reference(solver):
    n, r = 8, 12
    g0 = np.random.default_rng(3).random(n * (n - 1) // 2) * 0.3
    want = JHomo(n, r, JConfig(max_iters=60, driver="python", solver=solver)).solve(
        g0=g0, lam0=0.4)
    got = HomogeneousADMM(n, r, te.ADMMConfig(max_iters=60, driver="python", solver=solver,
                                              device="cpu")).solve(g0=g0, lam0=0.4)
    assert [h[0] for h in got.history] == [h[0] for h in want.history] == \
        [1] + list(range(10, 61, 10))
    assert got.iters == want.iters == 60 and got.cg_iters == want.cg_iters
    assert abs(got.lam_tilde - want.lam_tilde) <= 1e-9
    np.testing.assert_allclose(got.g, want.g, rtol=0, atol=1e-9)
    for (_, a, la), (_, b, lb) in zip(got.history, want.history):
        assert abs(a - b) <= 1e-8 * abs(b) and abs(la - lb) <= 1e-9


def test_ilu_through_homogeneous_admm_matches_reference():
    n, r = 6, 8
    g0 = np.random.default_rng(4).random(n * (n - 1) // 2) * 0.3
    cfg = dict(max_iters=40, solver="kkt_bicgstab_ilu")
    want = JHomo(n, r, JConfig(**cfg)).solve(g0=g0, lam0=0.4)
    solver = HomogeneousADMM(n, r, te.ADMMConfig(device="cpu", **cfg))
    got = solver.solve(g0=g0, lam0=0.4)
    assert [h[0] for h in got.history] == [h[0] for h in want.history]
    assert got.iters == want.iters and got.cg_iters == 0
    assert abs(got.lam_tilde - want.lam_tilde) <= 1e-9
    np.testing.assert_allclose(got.g, want.g, rtol=0, atol=1e-9)
    assert solver._ilu_step() is solver._ilu_step()          # built once a solver
    assert solver._ilu_step().ilu.fallbacks == 0


def test_wrappers_refuse_what_the_reference_refuses():
    ilu = te.ADMMConfig(solver="kkt_bicgstab_ilu", device="cpu", max_iters=20)
    with pytest.raises(ValueError, match="float64-only"):
        HomogeneousADMM(6, 8, te.ADMMConfig(solver="kkt_bicgstab_ilu", dtype="float32",
                                            device="cpu")).solve()
    m = 15
    with pytest.raises(ValueError, match="solve_batched needs a device backend"):
        HomogeneousADMM(6, 8, ilu).solve_batched(np.zeros((2, m)), np.full(2, 0.5))
    with pytest.raises(ValueError, match="sweep_topologies needs a device backend"):
        with pytest.warns(DeprecationWarning):
            sweep_topologies([6], [8], cfg=BATopoConfig(device="cpu", admm=ilu))
    with pytest.raises(ValueError, match="unknown solver"):
        te.check_solver(te.ADMMConfig(solver="ilu"))
    # a heterogeneous solver asked for ILU runs schur_cg, as the reference's
    cs = node_level_constraints(8, np.full(8, 3), np.ones(8))
    g0 = np.random.default_rng(5).random(28) * 0.3

    def hetero(solver):
        cfg = te.ADMMConfig(solver=solver, device="cpu", max_iters=20)
        return HeterogeneousADMM(8, 12, cs.M, cs.e_cap, cfg, equality=cs.equality,
                                 edge_ok=cs.edge_ok).solve(g0=g0, lam0=0.4)

    a, b = hetero("kkt_bicgstab_ilu"), hetero("schur_cg")
    assert a.lam_tilde == b.lam_tilde and np.array_equal(a.g, b.g) and a.cg_iters == b.cg_iters


def test_kkt_bicgstab_from_a_feasible_start_breaks_down_as_in_the_reference():
    """From ``init_state`` (A X₀ = b) the first Bi-CGSTAB iteration has
    α = 1 and ω = ⟨t, s⟩/⟨t, t⟩ = 0 (s has no X part), so JAX's bicgstab
    stops with k = −11 and returns X₀ + p: the X-step is V − Aᵀλ₀, not the
    KKT solution. The port returns the same iterate (within 1e-12 of the
    reference's), 0.19 from schur_cg's, with ‖A X − b‖∞ = 0.2 (a reference
    fault, ROADMAP.md Queue 3)."""
    from repro_torch.core.anneal import greedy_degree_graph
    from repro_torch.core.api import _pack_warm

    n, r = 8, 12
    g0, _, lam0 = _pack_warm(n, greedy_degree_graph(n, np.full(n, 4),
                                                    np.random.default_rng(0)))
    jspec = je.make_homo_spec(n, r, je.ADMMConfig())
    tspec = convert.spec_from_numpy(_np_tree(jspec), device="cpu")
    jst = je.init_state(jspec, jnp.asarray(g0), lam0)
    want, _ = je._jit_step(jspec, jst, backend="kkt_bicgstab")
    tst = convert.state_from_numpy(_np_tree(jst), tspec)
    got, _ = te.step(tspec, tst, "kkt_bicgstab")
    cg, _ = te.step(tspec, tst, "schur_cg")
    _assert_state(got, want, 1e-12)
    assert max(float((a - b).abs().max()) for a, b in zip(got.X, cg.X)) > 0.1
    assert float((te.A_op(tspec, got.X) - te.b_rhs(tspec)).abs().max()) > 0.1
