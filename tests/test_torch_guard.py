"""The port's guard ladder and barrier pipeline against the JAX package's on
the CPU.

The same numpy warm starts go through ``guard.attempt_admm`` in both
packages (float64, 300 iterations, tie-free random starts): the same
support and r_asym within 1e-6. A NaN ρ is classified ``non_finite`` after
one chunk in both. The ladder's rung names, outcomes and ``reason`` strings
are the reference's character for character. The barrier engine on the four
paper scenarios (host SA, float64 ADMM and polish, 2 restarts batched, 20
iterations) picks
the reference's ``_optimize_request`` support within 1e-3 in r_asym (the
BCube polish band, ROADMAP Queue 3), and with the default device SA it picks
the port's own anytime support. Deviations pinned here: a device fault leaves
``run_ladder`` as itself, and the barrier engine applies the request's
``restarts``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import api as j_api  # noqa: E402
from repro.core import guard as j_guard  # noqa: E402
from repro.core.anytime import resolve_scenario as j_resolve  # noqa: E402
from repro.core.constraints import bcube_constraints as j_bcube  # noqa: E402
from repro.core.constraints import intra_server_constraints as j_intra  # noqa: E402
from repro.core.engine import ADMMConfig as JaxADMM  # noqa: E402
from repro.core.topologies import random_graph, ring  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import guard as t_guard  # noqa: E402
from repro_torch.core.anytime import TopologyRequest, resolve_scenario, solve_topology  # noqa: E402
from repro_torch.core.constraints import bcube_constraints, intra_server_constraints  # noqa: E402
from repro_torch.core.engine import ADMMConfig, ADMMResult  # noqa: E402
from repro_torch.core.graph import Topology  # noqa: E402
from repro_torch.core.weights import metropolis_weights  # noqa: E402
from repro_torch.device import DeviceFault  # noqa: E402

NODE_BW_8 = np.array([9.76] * 4 + [3.25] * 4)
NODE_BW_16 = np.array([9.76] * 8 + [3.25] * 8)
SCENARIOS = {
    "homo": dict(n=16, r=32, scenario="homo"),
    "node": dict(n=16, r=32, scenario="node", node_bandwidths=NODE_BW_16),
    "intra": dict(n=8, r=12, scenario="constraint", cs="intra"),
    "bcube": dict(n=16, r=48, scenario="constraint", cs="bcube"),
}
R_ASYM_BAND = {"homo": 1e-7, "node": 1e-7, "intra": 1e-7, "bcube": 1e-3}
FAST = dict(sa_iters=120, polish_iters=100, restarts=2)
#: The batched restarts are compared at 20 ADMM iterations: before the
#: reference's own mid-run transient, where batched and single solves agree
#: (ROADMAP Queue 3), and cheap on the CPU.
ADMM_ITERS = 20
NAN_RHO = float("nan")


def _support(topo):
    return sorted(tuple(sorted(e)) for e in topo.edges)


def _cfgs(admm_kw):
    jcfg = j_api.BATopoConfig(sa_iters=50, polish_iters=100, admm=JaxADMM(**admm_kw))
    tcfg = t_api.BATopoConfig(sa_iters=50, polish_iters=100, admm=ADMMConfig(**admm_kw),
                              device="cpu")
    return jcfg, tcfg


def _random_edges(n, r, seed):
    """The start of a homogeneous attempt: a random graph (from a ring's
    equal weights, n = 10, r = 20 stops at 300 iterations mid-transient,
    where the reference itself moves under a 1e-15 perturbation; ROADMAP
    Queue 3)."""
    return sorted(tuple(sorted(e)) for e in random_graph(n, r, seed=seed).edges)


# =========================================================================
# attempt_admm, classification
# =========================================================================

@pytest.mark.parametrize("n,r,scenario,bw", [(8, 12, "homo", None), (8, 12, "node", NODE_BW_8)],
                         ids=["homo", "node"])
def test_attempt_admm_matches_reference(n, r, scenario, bw):
    jcfg, tcfg = _cfgs(dict(max_iters=300, check_every=30))
    jcs = j_resolve(n, r, scenario, None, bw, context="reopt")[0]
    tcs = resolve_scenario(n, r, scenario, None, bw, context="reopt")[0]
    edges = _random_edges(n, r, 0) if scenario == "homo" else ring(n).edges
    warm = j_api._pack_warm(n, edges)
    for a, b in zip(warm, t_api._pack_warm(n, edges)):
        np.testing.assert_array_equal(a, b)
    want = j_guard.attempt_admm(n, r, scenario, jcs, jcfg, warm, "t")
    got = t_guard.attempt_admm(n, r, scenario, tcs, tcfg, warm, "t")
    assert _support(got) == _support(want)
    assert abs(got.r_asym() - want.r_asym()) <= 1e-6
    assert got.meta["admm_iters"] == want.meta["admm_iters"]
    assert t_guard.check_invariants(got) is None


def test_nan_rho_attempt_is_non_finite_after_one_chunk():
    n, r = 8, 12
    jcfg, tcfg = _cfgs(dict(max_iters=120, check_every=30, rho=NAN_RHO))
    warm = j_api._pack_warm(n, ring(n).edges)
    for api, guard, cfg in ((j_api, j_guard, jcfg), (t_api, t_guard, tcfg)):
        res = api._make_solver(n, r, "homo", None, cfg).solve(g0=warm[0], lam0=warm[2])
        assert guard.classify_result(res) is guard.SolveOutcome.NON_FINITE
        assert res.iters == cfg.admm.check_every
        with pytest.raises(guard.SolveFailure) as ei:
            guard.attempt_admm(n, r, "homo", None, cfg, warm, "t")
        assert ei.value.outcome is guard.SolveOutcome.NON_FINITE


def test_classify_result_reads_tensor_fields():
    """A result whose fields are tensors is classified as its numpy twin."""
    m = 6
    for g, residual, want in ((np.ones(m), 1e-9, "converged"), (np.ones(m), 5.0, "non_convergent"),
                              (np.full(m, np.nan), 1e-9, "non_finite")):
        host = ADMMResult(g=g, g_raw=g, lam_tilde=0.5, z=np.ones(m), iters=1, residual=residual)
        dev = ADMMResult(g=torch.as_tensor(g), g_raw=torch.as_tensor(g), lam_tilde=0.5,
                         z=torch.ones(m), iters=1, residual=torch.tensor(residual))
        assert t_guard.classify_result(host).value == want
        assert t_guard.classify_result(dev).value == want


# =========================================================================
# the ladder
# =========================================================================

def _ring_topo(pkg_topology, n=8):
    edges = [(i, (i + 1) % n) if i < (i + 1) % n else ((i + 1) % n, i) for i in range(n)]
    return pkg_topology(n, edges, metropolis_weights(n, edges), name="ring",
                        meta={"connected": True})


def _split_topo(pkg_topology):
    edges = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)]
    return pkg_topology(6, edges, metropolis_weights(6, edges), name="split",
                        meta={"connected": True})


def _rungs(guard, pkg_topology):
    def fail():
        raise guard.SolveFailure(guard.SolveOutcome.NON_FINITE, "injected")

    def explode():
        raise RuntimeError("boom")

    return [("nan", fail), ("empty", lambda: None), ("invalid", lambda: _split_topo(pkg_topology)),
            ("raise", explode), ("classic", lambda: _ring_topo(pkg_topology))]


def test_run_ladder_reports_match_reference():
    from repro.core.graph import Topology as JaxTopology

    want = j_guard.run_ladder(_rungs(j_guard, JaxTopology))
    got = t_guard.run_ladder(_rungs(t_guard, Topology))
    assert (got.rung, got.attempts) == (want.rung, want.attempts) == ("classic", 5)
    assert [dataclasses.astuple(r) for r in got.reports] == \
        [dataclasses.astuple(r) for r in want.reports]
    assert got.reason == want.reason
    assert [r.outcome for r in got.reports] == \
        ["non_finite", "none", "invalid:connected", "error:RuntimeError", "ok"]


def test_jittered_warm_rungs_match_reference_and_fall_through():
    n, r = 8, 12
    jcfg, tcfg = _cfgs(dict(max_iters=120, check_every=30, rho=NAN_RHO))
    warm = j_api._pack_warm(n, ring(n).edges)
    out = []
    for guard, cfg in ((j_guard, jcfg), (t_guard, tcfg)):
        rungs = guard.jittered_warm_rungs(n, r, "homo", None, cfg, warm, "t",
                                          guard.GuardPolicy(warm_retries=4, rho_jitter=0.5))
        rungs.append(("classic", lambda g=guard: g.classic_fallback(n, r)))
        out.append(([name for name, _ in rungs], guard.run_ladder(rungs)))
    (j_names, j_lad), (t_names, t_lad) = out
    assert t_names == j_names
    assert t_names[1:5] == ["warm-retry1(rho×0.667)", "warm-retry2(rho×1.5)",
                            "warm-retry3(rho×0.444)", "warm-retry4(rho×2.25)"]
    assert t_lad.reason == j_lad.reason
    assert t_lad.rung == "classic" and t_lad.attempts == 6
    assert all(rep.outcome == "non_finite" for rep in t_lad.reports[:-1])
    assert t_guard.check_invariants(t_lad.topology) is None


@pytest.mark.parametrize("fault", [DeviceFault("kernel build failed"),
                                   torch.AcceleratorError("CUDA error: an illegal memory access")],
                         ids=["DeviceFault", "AcceleratorError"])
def test_device_faults_leave_run_ladder(fault):
    """Deviation from the reference: a device fault is not a rung outcome.
    Rungs after it do not run; a plain RuntimeError and an out-of-memory
    error are still recorded."""
    ran = []

    def raising(exc):
        def thunk():
            ran.append(type(exc).__name__)
            raise exc
        return thunk

    lad = t_guard.run_ladder([("plain", raising(RuntimeError("x"))),
                              ("oom", raising(torch.OutOfMemoryError("too big"))),
                              ("classic", lambda: _ring_topo(Topology))])
    assert [r.outcome for r in lad.reports] == \
        ["error:RuntimeError", "error:OutOfMemoryError", "ok"]
    ran.clear()
    with pytest.raises(type(fault)):
        t_guard.run_ladder([("warm", raising(fault)), ("classic", lambda: ran.append("classic"))])
    assert ran == [type(fault).__name__]


# =========================================================================
# the barrier pipeline
# =========================================================================

def _requests(name):
    kw = dict(SCENARIOS[name])
    cs = kw.pop("cs", None)
    jax_cs = {"intra": j_intra(8), "bcube": j_bcube(p=4, k=2)}.get(cs)
    port_cs = {"intra": intra_server_constraints(8), "bcube": bcube_constraints(p=4, k=2)}.get(cs)
    return jax_cs, TopologyRequest(cs=port_cs, **kw)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_barrier_engine_matches_reference(name):
    jcs, req = _requests(name)
    jcfg = j_api.BATopoConfig(warmstart="host", polish_dtype="float64", **FAST)
    jcfg = dataclasses.replace(jcfg, admm=dataclasses.replace(jcfg.admm, dtype="float64",
                                                              max_iters=ADMM_ITERS))
    tcfg = t_api.BATopoConfig(warmstart="host", polish_dtype="float64", device="cpu", **FAST)
    tcfg = dataclasses.replace(tcfg, admm=dataclasses.replace(tcfg.admm, dtype="float64",
                                                              max_iters=ADMM_ITERS))
    want = j_api._optimize_request(req.n, req.r, req.scenario, cs=jcs,
                                   node_bandwidths=req.node_bandwidths, cfg=jcfg)
    prof: dict = {}
    got = solve_topology(req, cfg=tcfg, profile=prof, engine="barrier")
    assert got.complete and got.quality_tier == "full"
    assert t_guard.check_invariants(got.topology) is None
    assert _support(got.topology) == _support(want)
    assert got.topology.meta["selected_from"] == want.meta["selected_from"]
    assert abs(got.r_asym - float(want.meta["r_asym"])) <= R_ASYM_BAND[name]
    assert set(prof) == {"warm_s", "admm_s", "round_s", "polish_s", "eval_s"}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_barrier_engine_matches_own_anytime_with_device_sa(name):
    """ref ``tests/test_anytime.py:40``: the unbudgeted anytime engine (one
    SA call and one ADMM solve per restart) and the barrier engine (one
    batched SA call, one batched ADMM solve) pick the same support."""
    _, req = _requests(name)
    cfg = t_api.BATopoConfig(device="cpu", admm=t_api.large_n_admm_config(ADMM_ITERS), **FAST)
    anytime = solve_topology(req, cfg=cfg)
    barrier = solve_topology(req, cfg=cfg, engine="barrier")
    assert anytime.complete and barrier.complete
    assert _support(barrier.topology) == _support(anytime.topology)
    assert abs(barrier.r_asym - anytime.r_asym) <= 1e-3


def test_optimize_topology_warns_and_barrier_takes_the_request_restarts():
    cfg = t_api.BATopoConfig(sa_iters=40, polish_iters=40, device="cpu",
                             admm=t_api.large_n_admm_config(max_iters=60))
    with pytest.deprecated_call():
        legacy = t_api.optimize_topology(8, 12, cfg=dataclasses.replace(cfg, restarts=2))
    res = solve_topology(TopologyRequest(n=8, r=12, restarts=2), cfg=cfg, engine="barrier")
    assert _support(res.topology) == _support(legacy)
    assert res.r_asym == legacy.meta["r_asym"]
    with pytest.deprecated_call():
        swept = t_api.sweep_topologies([8], [12], cfg=cfg)
    assert t_guard.check_invariants(swept[(8, 12)]) is None


def test_large_n_admm_config_is_the_reference_stack():
    want = dataclasses.asdict(j_api.large_n_admm_config(300))
    got = dataclasses.asdict(t_api.large_n_admm_config(300))
    got.pop("device")
    assert got.pop("edge_kernel") and not want["edge_kernel"]  # kernels on (ROADMAP rules)
    assert got == {k: want[k] for k in got}
    assert t_api.large_n_admm_config() == t_api._pipeline_admm_default()

