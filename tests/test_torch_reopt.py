"""The port's online re-optimization (``core/reopt.py``) against the JAX
package's on the CPU.

The drift detector is numpy in both packages: on the same ``ChaosSpec``
arrays it fires at the same step for the same reason, and its state
round-trips. ``reoptimize_topology`` follows the reference's ladder from the
same incumbent (ref ``tests/test_chaos.py:251-284``): the warm rung's answer
(float64 ADMM, 100 iterations) has the reference's support and r_asym within
1e-6, a non-convergent warm rung falls to the cold barrier pipeline (host
SA, float64, 2 restarts batched at 20 iterations: the reference's support),
and a scenario with no connected support keeps the incumbent with the
reference's reason. Deviation pinned here: a device fault leaves the call
as that exception, where the reference would keep the incumbent.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import api as j_api  # noqa: E402
from repro.core import reopt as j_reopt  # noqa: E402
from repro.core.constraints import pod_boundary_constraints as j_pods  # noqa: E402
from repro.core.graph import Topology as JaxTopology  # noqa: E402
from repro.dsgd import chaos as j_chaos  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import reopt as t_reopt  # noqa: E402
from repro_torch.core.constraints import pod_boundary_constraints  # noqa: E402
from repro_torch.core.graph import Topology  # noqa: E402
from repro_torch.core.guard import check_invariants  # noqa: E402
from repro_torch.core.topologies import make_baseline  # noqa: E402
from repro_torch.device import DeviceFault  # noqa: E402
from repro_torch.dsgd import chaos as t_chaos  # noqa: E402
from repro_torch.core.weights import metropolis_weights  # noqa: E402

N = 12
DRIFTED_BW = np.array([1.0] * 3 + [9.76] * 3 + [3.25] * 6)


def _cfgs(iters, **kw):
    """Both packages' configs: host SA, float64 ADMM and polish at ``iters``
    ADMM iterations — the settings under which the two agree on supports."""
    out = []
    for api in (j_api, t_api):
        cfg = api.BATopoConfig(sa_iters=100, polish_iters=100, warmstart="host",
                               polish_dtype="float64", **kw)
        cfg = dataclasses.replace(cfg, admm=dataclasses.replace(cfg.admm, dtype="float64",
                                                                max_iters=iters))
        out.append(cfg if api is j_api else dataclasses.replace(cfg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def incumbents():
    """A torus on N nodes (24 edges), as each package's Topology."""
    edges = make_baseline("torus", N).edges
    g = metropolis_weights(N, edges)
    return (JaxTopology(N, edges, g, name="torus", meta={"connected": True}),
            Topology(N, edges, g, name="torus", meta={"connected": True}))


def _support(topo):
    return sorted(tuple(sorted(e)) for e in topo.edges)


# =========================================================================
# the drift detector
# =========================================================================

def _chaos(pkg):
    n, T = 4, 30
    bw = np.full((T, n), 10.0)
    bw[10:, 0] = 5.0                       # 50% drop at t=10
    return pkg.make_chaos(T, n, churn=[(2, 20, 25)], bandwidth=bw, p_drop=0.1, seed=3)


def test_drift_detector_matches_reference_on_the_same_chaos_arrays():
    jch, tch = _chaos(j_chaos), _chaos(t_chaos)
    np.testing.assert_array_equal(jch.bandwidth, tch.bandwidth)
    np.testing.assert_array_equal(jch.alive, tch.alive)
    assert t_reopt.first_drift(tch) == j_reopt.first_drift(jch) == (10, "bandwidth")
    for kw in (dict(bw_rel_threshold=0.9), dict(cooldown_steps=5), dict(churn_events=2)):
        assert t_reopt.first_drift(tch, t_reopt.DriftPolicy(**kw), start=2) == \
            j_reopt.first_drift(jch, j_reopt.DriftPolicy(**kw), start=2)
    jd = j_reopt.DriftDetector.from_profile(jch.bandwidth[0], jch.alive[0],
                                            j_reopt.DriftPolicy(cooldown_steps=8))
    td = t_reopt.DriftDetector.from_profile(tch.bandwidth[0], tch.alive[0],
                                            t_reopt.DriftPolicy(cooldown_steps=8))
    for t in range(1, tch.steps):
        assert td.check(t, tch.bandwidth[t], tch.alive[t]) == \
            jd.check(t, jch.bandwidth[t], jch.alive[t])
        if t == 12:
            td.rebase(tch.bandwidth[t], tch.alive[t])
            jd.rebase(jch.bandwidth[t], jch.alive[t])


def test_drift_detector_state_round_trips():
    ch = _chaos(t_chaos)
    det = t_reopt.DriftDetector.from_profile(ch.bandwidth[0], ch.alive[0])
    fresh = t_reopt.DriftDetector.from_state(det.to_state())
    assert fresh.last_trigger is None
    assert det.check(10, ch.bandwidth[10], ch.alive[10]) == "bandwidth"
    state = det.to_state()
    want = j_reopt.DriftDetector.from_profile(ch.bandwidth[0], ch.alive[0])
    want.check(10, ch.bandwidth[10], ch.alive[10])
    for k, v in want.to_state().items():
        np.testing.assert_array_equal(state[k], v)
        assert state[k].dtype == v.dtype
    back = t_reopt.DriftDetector.from_state(state, det.policy)
    assert back.last_trigger == 10
    np.testing.assert_array_equal(back.base_bandwidth, det.base_bandwidth)
    np.testing.assert_array_equal(back.base_alive, det.base_alive)


# =========================================================================
# the re-optimization ladder
# =========================================================================

def test_reopt_warm_rung_matches_reference(incumbents):
    jcfg, tcfg = _cfgs(100)
    kw = dict(scenario="node", node_bandwidths=DRIFTED_BW, alive=np.ones(N))
    want = j_reopt.reoptimize_topology(incumbents[0], cfg=jcfg, **kw)
    got = t_reopt.reoptimize_topology(incumbents[1], cfg=tcfg, **kw)
    assert got.reoptimized and want.reoptimized
    assert got.attempts == want.attempts == 1
    assert _support(got.topology) == _support(want.topology)
    assert abs(got.r_asym_after - want.r_asym_after) <= 1e-6
    assert got.r_asym_before == pytest.approx(want.r_asym_before, abs=1e-12)
    assert got.meta == want.meta
    assert got.time_to_reopt_s > 0 and check_invariants(got.topology) is None


def test_reopt_nonconvergent_falls_to_the_cold_barrier(incumbents):
    jcfg, tcfg = _cfgs(20, restarts=2)  # ≤ 20 batched iterations (ROADMAP Queue 3)
    want = j_reopt.reoptimize_topology(incumbents[0], cfg=jcfg,
                                       policy=j_reopt.DriftPolicy(max_residual=0.0))
    got = t_reopt.reoptimize_topology(incumbents[1], cfg=tcfg,
                                      policy=t_reopt.DriftPolicy(max_residual=0.0))
    assert got.attempts == want.attempts == 2
    assert got.reoptimized and got.fallback_reason is None
    assert _support(got.topology) == _support(want.topology)
    assert abs(got.r_asym_after - want.r_asym_after) <= 1e-6


def test_reopt_disconnected_keeps_incumbent_with_the_reference_reason(incumbents):
    jcfg, tcfg = _cfgs(20)
    want = j_reopt.reoptimize_topology(incumbents[0], scenario="constraint",
                                       cs=j_pods(N, pods=2, dci_cap_total=0), cfg=jcfg)
    got = t_reopt.reoptimize_topology(incumbents[1], scenario="constraint",
                                      cs=pod_boundary_constraints(N, pods=2, dci_cap_total=0),
                                      cfg=tcfg)
    assert not got.reoptimized and got.topology is incumbents[1]
    assert got.r_asym_after == got.r_asym_before
    assert got.fallback_reason == want.fallback_reason
    assert got.attempts == want.attempts


def test_reopt_requires_scenario_inputs(incumbents):
    with pytest.raises(ValueError, match="node_bandwidths"):
        t_reopt.reoptimize_topology(incumbents[1], scenario="node")
    with pytest.raises(ValueError, match="ConstraintSet"):
        t_reopt.reoptimize_topology(incumbents[1], scenario="constraint")


def test_device_fault_leaves_reoptimize_topology(incumbents, monkeypatch):
    """Deviation from the reference: with no card behind ``device="cuda"``
    the warm rung's solver raises ``DeviceFault``, and the call raises it
    instead of keeping the incumbent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceFault, match="device='cpu'"):
        t_reopt.reoptimize_topology(incumbents[1], cfg=t_api.BATopoConfig(sa_iters=20))
