"""The port's batched ADMM (restarts and budget sweeps) against the JAX
package's vmapped drivers on the CPU, and the batch axis of its pieces.

Float64, exact CG, small n. The drivers are held to the reference's
batched calls at 300 iterations or on converged instances, never in the
middle of a run: the reference itself does not promise equal iterates
there (ROADMAP.md Queue 3). Per instance: the same support, λ̃ within 1e-6,
the same iteration count and history iterations, CG iterations within 1 %,
and the same z (the tolerances of ``test_torch_engine.py``'s
``test_solve_spec_matches``). The batch axis of the projections and of the
plain edge forms is held bitwise to row-by-row calls.

The warm starts are tie free (random weights), except the budget-20
instance of the sweep, which starts from ``test_engine_parity.py``'s
``_warm(8, 3)`` (Metropolis weights of a 3-regular graph) and converges at
iteration 190 in both packages. At budgets 10 and 14 that start ties
edge weights at the budget's threshold, and the reference moves with the
last bit of the start: perturbing g₀ by 1e-15 (relative) moves its λ̃ at
300 iterations by 0.038 (r = 10) and 9.4e-5 (r = 14). No comparison of two
implementations is meaningful there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import BATopoConfig as JaxConfig  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core.anneal import greedy_degree_graph  # noqa: E402
from repro.core.anytime import TopologyRequest as JaxRequest  # noqa: E402
from repro.core.anytime import solve_topologies as jax_solve_topologies  # noqa: E402
from repro.core.constraints import bcube_constraints  # noqa: E402
from repro.core.constraints import intra_server_constraints as jax_intra  # noqa: E402
from repro.core.graph import all_edges, edge_index  # noqa: E402
from repro.core.weights import metropolis_weights  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import BATopoConfig, TopologyRequest, check_invariants  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core.admm import HeterogeneousADMM, HomogeneousADMM  # noqa: E402
from repro_torch.core.anytime import solve_topologies  # noqa: E402
from repro_torch.core.constraints import intra_server_constraints  # noqa: E402
from repro_torch.kernels.edge_laplacian import ops as tel  # noqa: E402

ITERS = 300


def _warm(n, deg, seed=0):
    """``tests/test_engine_parity.py``'s warm start: Metropolis weights of a
    greedy ``deg``-regular graph."""
    edges = greedy_degree_graph(n, np.full(n, deg), np.random.default_rng(seed))
    eidx = edge_index(n)
    g0 = np.zeros(len(all_edges(n)))
    for k, e in enumerate(edges):
        g0[eidx[e]] = metropolis_weights(n, edges)[k]
    return g0


def _support(g, tol=1e-6):
    return tuple(np.nonzero(np.asarray(g) > tol)[0])


def _assert_same_solve(got, want):
    assert _support(got.g) == _support(want.g)
    assert abs(got.lam_tilde - want.lam_tilde) <= 1e-6
    assert got.iters == want.iters
    assert [h[0] for h in got.history] == [h[0] for h in want.history]
    assert abs(got.cg_iters - want.cg_iters) <= 0.01 * want.cg_iters
    if want.z is not None:
        assert (got.z == want.z).all()


def _homo_specs(n, r, **cfg_kw):
    jspec = je.make_homo_spec(n, r, je.ADMMConfig(**cfg_kw))
    return jspec, convert.spec_from_numpy(jax.tree.map(np.asarray, jspec), device="cpu")


def _sweep_starts():
    """Warm starts of the budgets (10, 14, 20) — see the module docstring."""
    rng = np.random.default_rng(8)
    g0s = np.stack([rng.random(28) * 0.3, rng.random(28) * 0.3, _warm(8, 3)])
    return g0s, np.array([0.4, 0.4, 0.4])


def _jax_states(jspec, g0s, lam0s, z0s=None):
    if z0s is None:
        return jax.vmap(lambda g, l: je.init_state(jspec, g, l))(jnp.asarray(g0s),
                                                                jnp.asarray(lam0s))
    return jax.vmap(lambda g, z, l: je.init_state(jspec, g, l, z=z))(
        jnp.asarray(g0s), jnp.asarray(z0s), jnp.asarray(lam0s))


@pytest.mark.parametrize("name", ["homo", "hetero"])
def test_solve_batched_spec_matches_jax(name):
    """Three distinct warm starts in one batch, 300 iterations: homogeneous
    n=8, r=12; heterogeneous BCube(4, 2), n=16, r=48 with inequality
    capacities (all three converge before 300 in both packages)."""
    rng = np.random.default_rng(19)
    jcfg = je.ADMMConfig(max_iters=ITERS)
    if name == "homo":
        jspec = je.make_homo_spec(8, 12, jcfg)
        z0s = None
    else:
        cs = bcube_constraints(p=4, k=2)
        jspec = je.make_hetero_spec(16, 48, cs.M.astype(np.float64),
                                    cs.e_cap.astype(np.float64), jcfg, equality=False,
                                    edge_ok=cs.edge_ok)
        z0s = (rng.random((3, jspec.m)) < 0.3).astype(np.float64)
    g0s = rng.random((3, jspec.m)) * 0.3
    lam0s = np.array([0.5, 0.4, 0.6])
    want = je.solve_batched_spec(jspec, _jax_states(jspec, g0s, lam0s, z0s), jcfg)
    tspec = convert.spec_from_numpy(jax.tree.map(np.asarray, jspec), device="cpu")
    got = te.solve_batched_spec(tspec, te.init_state(tspec, g0s, lam0s, z=z0s),
                                te.ADMMConfig(max_iters=ITERS, device="cpu"))
    assert len(got) == 3
    for g, w in zip(got, want):
        _assert_same_solve(g, w)


def test_solve_sweep_spec_matches_jax():
    """Budgets 10, 14 and 20 on the spec of budget 20, 300 iterations; the
    budget-20 instance converges at iteration 190 in both packages."""
    jspec, tspec = _homo_specs(8, 20, max_iters=ITERS)
    g0s, lam0s = _sweep_starts()
    rs = [10, 14, 20]
    want = je.solve_sweep_spec(jspec, np.asarray(rs), _jax_states(jspec, g0s, lam0s),
                               je.ADMMConfig(max_iters=ITERS))
    got = te.solve_sweep_spec(tspec, rs, te.init_state(tspec, g0s, lam0s),
                              te.ADMMConfig(max_iters=ITERS, device="cpu"))
    for r, g, w in zip(rs, got, want):
        _assert_same_solve(g, w)
        assert len(_support(g.g)) <= r
    assert got[2].iters == 190 and got[0].iters == got[1].iters == ITERS


def _instance(state, b):
    return state.map(lambda t: t[b])


def test_a_converged_instance_stops_and_matches_its_own_solve():
    """The sweep's batch against each instance solved alone (B = 1). On
    the CPU the two are not bitwise: a single row's CG inner products are
    ``torch.dot``, a batch's a row sum (``linalg._tdot``), so the batch is
    held to the two checks: every leaf within 1e-12 after 20 iterations, and
    at 300 the same support, λ̃ within 1e-9 and the same iteration count.
    The budget-20 instance converges at 190 and stays frozen on every leaf
    while the others run on."""
    _, tspec = _homo_specs(8, 20)
    g0s, lam0s = _sweep_starts()
    rs = [10, 14, 20]
    batch = te.init_state(tspec, g0s, lam0s)
    sweep_spec = tspec.replace(r=torch.tensor(rs))
    singles = [_instance(batch, b) for b in range(3)]
    for _ in range(20):
        batch, _ = te.step(sweep_spec, batch)
        singles = [te.step(tspec.replace(r=torch.tensor(r)), s)[0] for r, s in zip(rs, singles)]
    for b, single in enumerate(singles):
        got = _instance(batch, b)
        for field in ("X", "Y", "D", "lam"):
            for a, c in zip(getattr(got, field), getattr(single, field)):
                torch.testing.assert_close(a, c, rtol=0, atol=1e-12)
        assert abs(float(got.res) - float(single.res)) <= 1e-12
        assert int(got.cg) == int(single.cg)

    cfg = te.ADMMConfig(max_iters=ITERS, device="cpu")
    states = te.init_state(tspec, g0s, lam0s)
    got = te.solve_sweep_spec(tspec, rs, states, cfg)
    for b, r in enumerate(rs):
        alone = te.solve_spec(tspec.replace(r=torch.tensor(r)), _instance(states, b), cfg)
        assert _support(got[b].g) == _support(alone.g)
        assert abs(got[b].lam_tilde - alone.lam_tilde) <= 1e-9
        assert got[b].iters == alone.iters
    # frozen after its last chunk: one history entry per chunk it ran, and
    # what it returns is the state it converged with
    assert [h[0] for h in got[2].history] == list(range(10, 191, 10))
    assert got[2].residual < cfg.eps and got[2].residual == got[2].history[-1][1]


def test_a_nonfinite_instance_stops_after_one_chunk_and_its_neighbours_run_on():
    """A NaN start in the middle of a batch: that instance stops after the
    first chunk with a non-finite residual (``abort_nonfinite``), and its
    neighbours come out bitwise as the batch without it."""
    _, tspec = _homo_specs(8, 12)
    rng = np.random.default_rng(5)
    g0s = rng.random((3, 28)) * 0.3
    g0s[1, 3] = np.nan
    lam0s = np.array([0.5, 0.4, 0.6])
    cfg = te.ADMMConfig(max_iters=50, check_every=10, device="cpu")
    got = te.solve_batched_spec(tspec, te.init_state(tspec, g0s, lam0s), cfg)
    clean = te.solve_batched_spec(tspec, te.init_state(tspec, g0s[[0, 2]], lam0s[[0, 2]]), cfg)
    assert got[1].iters == 10 and len(got[1].history) == 1
    assert not np.isfinite(got[1].residual)
    for g, c in zip((got[0], got[2]), clean):
        assert g.iters == c.iters == 50
        assert g.g.tobytes() == c.g.tobytes() and g.lam_tilde == c.lam_tilde
        assert g.cg_iters == c.cg_iters and g.history == c.history


def test_solve_batched_runs_one_step_for_the_batch(monkeypatch):
    """``HomogeneousADMM.solve_batched`` is a batched solve: each ADMM step
    serves all B instances (60 steps for 3 restarts, not 180), and it gives
    what ``solve_batched_spec`` gives; the warm starts' shapes are checked."""
    calls = []
    step = te.step

    def counted(spec, state, *backend):
        calls.append(tuple(state.X[0].shape))
        return step(spec, state, *backend)

    monkeypatch.setattr(te, "step", counted)
    cfg = te.ADMMConfig(max_iters=60, device="cpu")
    solver = HomogeneousADMM(8, 12, cfg)
    rng = np.random.default_rng(2)
    g0s, lam0s = rng.random((3, 28)) * 0.3, np.array([0.5, 0.4, 0.6])
    got = solver.solve_batched(g0s, lam0s)
    assert calls == [(3, 29)] * 60
    want = te.solve_batched_spec(solver.spec, te.init_state(solver.spec, g0s, lam0s), cfg)
    assert [g.g.tobytes() for g in got] == [w.g.tobytes() for w in want]
    with pytest.raises(ValueError, match=r"g0s must have shape \(2, 28\)"):
        solver.solve_batched(g0s, lam0s[:2])


def test_heterogeneous_solve_batched_matches_its_spec_driver():
    cs = bcube_constraints(p=4, k=2)
    solver = HeterogeneousADMM(16, 48, cs.M, cs.e_cap, te.ADMMConfig(max_iters=20, device="cpu"),
                               equality=False, edge_ok=cs.edge_ok)
    rng = np.random.default_rng(4)
    g0s = rng.random((2, 120)) * 0.3
    z0s = (rng.random((2, 120)) < 0.3).astype(np.float64)
    lam0s = np.array([0.5, 0.4])
    got = solver.solve_batched(g0s, z0s, lam0s)
    want = te.solve_batched_spec(solver.spec, te.init_state(solver.spec, g0s, lam0s, z=z0s),
                                 solver.cfg)
    for g, w in zip(got, want):
        assert g.g.tobytes() == w.g.tobytes() and (g.z == w.z).all()


@pytest.mark.parametrize("fn", ["card", "binary"])
def test_projections_at_a_budget_per_row_equal_row_by_row_calls(fn):
    """Per-row budgets, r ≥ m included, against the 0-dim call on each row,
    bitwise (ties and signed zeros on purpose)."""
    rng = np.random.default_rng(7)
    v = np.round(rng.standard_normal((6, 28)), 1)
    v[:, ::5] = -0.0
    v[:, 1::7] = 0.0
    ok = torch.from_numpy(rng.random(28) < 0.85)
    rs = torch.tensor([0, 3, 12, 27, 28, 40])
    proj = te.proj_card_nonneg if fn == "card" else te.proj_binary_topr
    got = proj(torch.from_numpy(v), rs, ok)
    for b in range(6):
        want = proj(torch.from_numpy(v[b]), rs[b], ok)
        assert got[b].numpy().tobytes() == want.numpy().tobytes()
    shared = proj(torch.from_numpy(v), torch.tensor(12), ok)
    assert shared.numpy().tobytes() == np.stack(
        [proj(torch.from_numpy(v[b]), torch.tensor(12), ok).numpy() for b in range(6)]).tobytes()


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_plain_forms_equal_their_unbatched_calls(hetero, dtype):
    """The four ADMM-path forms with a batch axis on the CPU (their plain
    versions), row by row bitwise against the unbatched calls, the λ
    blocks as views of one (B, K) matrix as the engine lays them out."""
    n, B = 9, 4
    m, k = n * (n - 1) // 2, 2 * n * n + n
    rng = np.random.default_rng(n)
    flat = torch.from_numpy(rng.standard_normal((B, k + m))).to(dtype)
    P, Q = flat[:, :n * n].view(B, n, n), flat[:, n * n:2 * n * n].view(B, n, n)
    w, v = flat[:, 2 * n * n:k], (flat[:, k:] if hetero else None)
    x = torch.from_numpy(rng.random((B, m + 1))).to(dtype)
    g, lam = x[:, :-1], x[:, -1]
    L = tel.edge_laplacian(g, n)
    blocks = tel.edge_laplacian_blocks(g, lam, P, Q, w, torch.empty(B, k, dtype=dtype))
    adj = tel.edge_adjoint(P, Q, w, v)
    out, x_adj = torch.empty(B, k + 2, dtype=dtype), torch.empty(B, m + 1, dtype=dtype)
    tel.edge_schur_matvec(P, Q, w, out, v=v, x_adj=x_adj)
    for b in range(B):
        vb = None if v is None else v[b]
        assert torch.equal(L[b], tel.edge_laplacian(g[b], n))
        one = tel.edge_laplacian_blocks(g[b], lam[b], P[b], Q[b], w[b], torch.empty(k, dtype=dtype))
        assert one.numpy().tobytes() == blocks[b].numpy().tobytes()
        assert adj[b].numpy().tobytes() == tel.edge_adjoint(P[b], Q[b], w[b], vb).numpy().tobytes()
        o, xb = torch.empty(k, dtype=dtype), torch.empty(m + 1, dtype=dtype)
        tel.edge_schur_matvec(P[b], Q[b], w[b], o, v=vb, x_adj=xb)
        assert o.numpy().tobytes() == out[b, :k].numpy().tobytes()
        assert xb.numpy().tobytes() == x_adj[b].numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 64, 256])
def test_plain_adjoint_trace_is_torch_trace_at_every_batch_size(n, dtype):
    """The plain adjoint's −tr P + tr Q is bitwise ``torch.trace``'s, one
    matrix or a batch of them, so a single solve on the CPU keeps the bits
    of the unbatched composition (a diagonal ``sum`` moved a 60-step fp32
    solve at n=64 from 291 CG iterations to 287)."""
    rng = np.random.default_rng(n)
    B = 3
    P, Q = (torch.from_numpy(rng.standard_normal((B, n, n)) * 40).to(dtype) for _ in range(2))
    w = torch.zeros(B, n, dtype=dtype)
    batched = tel.edge_adjoint_plain(P, Q, w)[:, -1]
    for b in range(B):
        want = -torch.trace(P[b]) + torch.trace(Q[b])
        assert torch.equal(tel.edge_adjoint_plain(P[b], Q[b], w[b])[-1], want)
        assert torch.equal(batched[b], want)


def test_batched_forms_reject_mismatched_batch_axes():
    P, w = torch.zeros(2, 4, 4), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="same leading batch axis"):
        tel.edge_adjoint(P, P, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="same leading batch axis"):
        tel.edge_laplacian_blocks(torch.zeros(2, 6), torch.zeros(()), P, P, w,
                                  torch.empty(2, 36))
    with pytest.raises(ValueError, match="leading batch axis"):
        tel.edge_schur_matvec(P, P, w, torch.empty(36))
    with pytest.raises(ValueError, match="complete edge list"):
        tel.edge_laplacian(torch.zeros(2, 3, 6), 4)


def _support_of(topo):
    return sorted(tuple(sorted(e)) for e in topo.edges)


def _relabeled(a, b) -> bool:
    """Whether two weighted topologies are the same up to node labels, by
    their degree sequences and the spectra of their unweighted Laplacians
    and of their mixing matrices."""
    from repro_torch.core.graph import degrees, laplacian_from_weights

    def spectra(t):
        lap = laplacian_from_weights(t.n, t.edges, np.ones(len(t.edges)))
        return np.linalg.eigvalsh(lap), np.linalg.eigvalsh(t.W)

    (la, wa), (lb, wb) = spectra(a), spectra(b)
    return (sorted(degrees(a.n, a.edges)) == sorted(degrees(b.n, b.edges))
            and np.allclose(la, lb, rtol=0, atol=1e-9) and np.allclose(wa, wb, rtol=0, atol=1e-7))


def test_solve_topologies_matches_jax_with_host_sa_and_float64():
    """Two homogeneous budgets at n=12 (one batched sweep in each package)
    and an intra-server constraint request between them (through
    ``solve_topology``): the same sources, r_asym within 1e-7, the input
    order kept, every result release-valid, and the same supports — up to
    node labels where the ADMM's weights tie at the budget's threshold: at
    r = 24 the host SA's 4-regular start has Metropolis weights that tie,
    the two packages' λ̃ agree to 7e-15 and r_asym to 3.4e-12, and their
    roundings pick two labelings of one graph."""
    fast = dict(sa_iters=120, polish_iters=100, warmstart="host", polish_dtype="float64")
    jcfg = JaxConfig(**fast)
    jcfg = dataclasses.replace(jcfg, admm=dataclasses.replace(jcfg.admm, dtype="float64"))
    tcfg = BATopoConfig(device="cpu", **fast)
    tcfg = dataclasses.replace(tcfg, admm=dataclasses.replace(tcfg.admm, dtype="float64"))
    want = jax_solve_topologies([JaxRequest(n=12, r=24),
                                 JaxRequest(n=8, r=12, scenario="constraint", cs=jax_intra(8)),
                                 JaxRequest(n=12, r=18)], cfg=jcfg)
    reqs = [TopologyRequest(n=12, r=24),
            TopologyRequest(n=8, r=12, scenario="constraint", cs=intra_server_constraints(8)),
            TopologyRequest(n=12, r=18)]
    got = solve_topologies(reqs, cfg=tcfg)
    assert [g.request for g in got] == reqs
    for g, w in zip(got, want):
        assert g.ok and g.complete and check_invariants(g.topology) is None
        assert g.topology.meta.get("selected_from") == w.topology.meta.get("selected_from")
        assert abs(g.r_asym - w.r_asym) <= 1e-7
        assert len(g.topology.edges) <= g.request.r
        assert (_support_of(g.topology) == _support_of(w.topology)
                or _relabeled(g.topology, w.topology))
    assert _support_of(got[1].topology) == _support_of(want[1].topology)
    assert _support_of(got[2].topology) == _support_of(want[2].topology)
