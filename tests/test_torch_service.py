"""The port's topology service (``serve/topo_service.py``) on the CPU,
against the JAX package's service where both can run the same thing.

Admission rejections carry the reference's reasons character for
character; the LRU cache evicts and the drift detector invalidates as in
the reference; a bucket of misses is one batched sweep whose supports are
the one-shot barrier pipeline's and, with host SA and a float64 ADMM, the
reference service's; fault-injection hooks degrade to a valid topology
with the reference's reason trail. Deviations pinned here: no latency
priors are read from ``BENCH_admm.json`` (explicit rows still seed),
``pad_pow2`` is off by default and does not change a support, and a device
fault leaves ``drain``/``request`` from the bucket, the tier loop and the
anytime route. Batched solves are compared at 20 ADMM iterations, before
the reference's own mid-run transient (ROADMAP Queue 3).
"""
import dataclasses
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.api import BATopoConfig as JaxConfig  # noqa: E402
from repro.serve import topo_service as j_svc  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core.anytime import TopologyRequest, solve_topology  # noqa: E402
from repro_torch.core.graph import Topology  # noqa: E402
from repro_torch.core.guard import SolveFailure, SolveOutcome, check_invariants  # noqa: E402
from repro_torch.device import DeviceFault  # noqa: E402
from repro_torch.serve import topo_service as t_svc  # noqa: E402
from repro_torch.serve.topo_service import (ServiceHooks, ServicePolicy,  # noqa: E402
                                            TopologyService, TopoRequest, TopoResponse)

SVC_CFG = t_api.BATopoConfig(sa_iters=80, polish_iters=80, device="cpu",
                             admm=t_api.large_n_admm_config(max_iters=20))


def _support(topo):
    return sorted(tuple(sorted(e)) for e in topo.edges)


def _nan_topology(n: int) -> Topology:
    edges = [(i, (i + 1) % n) for i in range(n)]
    return Topology(n, edges, np.full(len(edges), np.nan), name="nan-stub",
                    meta={"connected": True})


def _f64(api_cfg):
    """Host SA and a float64 ADMM at 20 iterations: what the two packages
    agree on."""
    cfg = dataclasses.replace(api_cfg, warmstart="host", polish_dtype="float64")
    return dataclasses.replace(cfg, admm=dataclasses.replace(cfg.admm, dtype="float64",
                                                             max_iters=20))


# =========================================================================
# admission control
# =========================================================================

@pytest.mark.parametrize("kw", [
    dict(n=1, r=4), dict(n=8, r=3), dict(n=8, r=16, scenario="warp"),
    dict(n=8, r=16, scenario="node"),
    dict(n=8, r=16, scenario="node", node_bandwidths=np.full(8, np.nan)),
    dict(n=8, r=16, scenario="constraint"), dict(n=8, r=16, deadline_ms=-5.0),
], ids=["n", "r", "scenario", "no-bw", "nan-bw", "no-cs", "deadline"])
def test_malformed_specs_rejected_as_the_reference(kw):
    svc = TopologyService(cfg=SVC_CFG)
    out = svc.submit(TopoRequest(**kw))
    want = j_svc.TopologyService(cfg=JaxConfig(), bench_rows=[]).submit(j_svc.TopoRequest(**kw))
    assert isinstance(out, TopoResponse) and not out.ok
    assert out.reason == want.reason and out.reason.startswith("malformed")
    assert svc.stats["rejected_malformed"] == 1


def test_overload_burst_bounded_queue_rejection():
    svc = TopologyService(cfg=SVC_CFG, policy=ServicePolicy(max_queue=3))
    ref = j_svc.TopologyService(cfg=JaxConfig(), policy=j_svc.ServicePolicy(max_queue=3),
                                bench_rows=[])
    outs = [svc.submit(TopoRequest(n=8, r=16)) for _ in range(8)]
    wants = [ref.submit(j_svc.TopoRequest(n=8, r=16)) for _ in range(8)]
    assert [isinstance(o, int) for o in outs] == [isinstance(w, int) for w in wants] == \
        [True] * 3 + [False] * 5
    assert [o.reason for o in outs[3:]] == [w.reason for w in wants[3:]]
    assert svc.stats["rejected_overload"] == 5
    resps = svc.drain()
    assert len(resps) == 3 and svc.stats["bucketed_solves"] == 1
    assert all(r.ok and check_invariants(r.topology) is None for r in resps)


# =========================================================================
# cache
# =========================================================================

def test_cache_hit_is_the_one_shot_answer_and_lru_evicts():
    svc = TopologyService(cfg=SVC_CFG, policy=ServicePolicy(cache_capacity=1))
    miss = svc.request(8, 16)
    hit = svc.request(8, 16)
    assert miss.ok and not miss.cache_hit and miss.quality_tier == "full"
    assert hit.cache_hit and hit.quality_tier == "cache" and hit.topology is miss.topology
    one_shot = solve_topology(TopologyRequest(n=8, r=16), cfg=SVC_CFG, engine="barrier")
    assert _support(hit.topology) == _support(one_shot.topology)
    np.testing.assert_array_equal(np.asarray(hit.topology.W), np.asarray(one_shot.topology.W))
    for key in ("queue_s", "solve_s", "warm_s", "admm_s", "round_s", "polish_s", "eval_s"):
        assert key in miss.profile, key
    svc.request(10, 18)                       # evicts the n=8 entry
    assert len(svc._cache) == 1
    assert not svc.request(8, 16).cache_hit


def test_drift_invalidates_stale_entries_as_the_reference():
    bw0 = np.full(8, 10.0)
    drifted = bw0 * np.linspace(0.5, 1.0, 8)
    stats = []
    for mod in (t_svc, j_svc):
        pol = mod.ServicePolicy(bw_quant=10.0)
        svc = mod.TopologyService(cfg=SVC_CFG if mod is t_svc else JaxConfig(), policy=pol,
                                  bench_rows=[])
        req0 = mod.TopoRequest(n=8, r=16, scenario="node", node_bandwidths=bw0)
        key = svc._cache_key(req0)
        svc._cache_store(req0, key, _nan_topology(8))
        req1 = mod.TopoRequest(n=8, r=16, scenario="node", node_bandwidths=drifted)
        assert svc._cache_key(req1) == key
        assert svc._cache_lookup(req1, key) is None
        svc._cache_store(req0, key, _nan_topology(8))
        stats.append((svc.observe(bw0 * 1.05), svc.observe(bw0 * 2.0), len(svc._cache),
                      svc.stats["invalidations"]))
    assert stats[0] == stats[1] == (0, 1, 0, 2)


def test_cache_key_hashes_host_constraint_arrays():
    from repro_torch.core.constraints import intra_server_constraints

    svc = TopologyService(cfg=SVC_CFG)
    cs = intra_server_constraints(8)
    key = svc._cache_key(TopoRequest(n=8, r=12, scenario="constraint", cs=cs))
    want = j_svc.TopologyService(cfg=JaxConfig(), bench_rows=[])._cache_key(
        j_svc.TopoRequest(n=8, r=12, scenario="constraint", cs=cs))
    assert key == want and isinstance(key[-1], str)


# =========================================================================
# bucketed misses
# =========================================================================

@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "pow2"])
def test_bucket_is_one_solve_with_one_shot_supports(pad):
    """Default unpadded, and padded to 4 instances: the same supports as
    the one-shot barrier pipeline (padding never changes a support)."""
    svc = TopologyService(cfg=SVC_CFG, policy=ServicePolicy(pad_pow2=pad))
    for r in (18, 24, 30):
        assert isinstance(svc.submit(TopoRequest(n=12, r=r)), int)
    resps = svc.drain()
    assert svc.stats["bucketed_solves"] == 1
    for r, resp in zip((18, 24, 30), resps):
        assert resp.ok and resp.quality_tier == "full" and resp.profile["bucket_size"] == 3
        one_shot = solve_topology(TopologyRequest(n=12, r=r), cfg=SVC_CFG, engine="barrier")
        assert _support(resp.topology) == _support(one_shot.topology)
    assert not ServicePolicy().pad_pow2


def test_bucket_matches_the_reference_service():
    rs = (14, 18, 22)
    svc = TopologyService(cfg=_f64(SVC_CFG))
    ref = j_svc.TopologyService(cfg=_f64(JaxConfig(sa_iters=80, polish_iters=80)), bench_rows=[])
    for r in rs:
        svc.submit(TopoRequest(n=10, r=r))
        ref.submit(j_svc.TopoRequest(n=10, r=r))
    got, want = svc.drain(), ref.drain()
    assert svc.stats["bucketed_solves"] == ref.stats["bucketed_solves"] == 1
    for g, w in zip(got, want):
        assert g.quality_tier == w.quality_tier == "full"
        assert _support(g.topology) == _support(w.topology)
        assert abs(g.topology.r_asym() - w.topology.r_asym()) <= 1e-6


# =========================================================================
# deadline ladder + fault injection
# =========================================================================

def test_nan_solver_stub_degrades_as_the_reference():
    out = []
    for mod, cfg in ((t_svc, SVC_CFG), (j_svc, JaxConfig(sa_iters=80, polish_iters=80))):
        hooks = mod.ServiceHooks(full=lambda req, prof: _nan_topology(int(req.n)))
        out.append(mod.TopologyService(cfg=cfg, hooks=hooks, bench_rows=[]).request(8, 16))
    got, want = out
    assert got.ok and got.degraded and got.quality_tier == want.quality_tier == "warm"
    assert got.reason == want.reason == "full: invalid topology (finite violated)"
    assert got.topology.meta["ladder_rung"] == "warm"
    assert check_invariants(got.topology) is None


def test_raising_solver_stubs_never_escape_and_match_the_reference_trail():
    def explode(req, prof):
        raise SolveFailure(SolveOutcome.NON_FINITE, "injected")

    def j_explode(req, prof):
        from repro.core.guard import SolveFailure as JF, SolveOutcome as JO

        raise JF(JO.NON_FINITE, "injected")

    hooks = ServiceHooks(full=explode, warm=explode)
    got = TopologyService(cfg=SVC_CFG, hooks=hooks).request(8, 16)
    want = j_svc.TopologyService(cfg=JaxConfig(sa_iters=80, polish_iters=80), bench_rows=[],
                                 hooks=j_svc.ServiceHooks(full=j_explode, warm=j_explode)
                                 ).request(8, 16)
    assert got.ok and got.quality_tier == want.quality_tier == "sa_only"
    assert got.reason == want.reason
    assert check_invariants(got.topology) is None
    plain = TopologyService(cfg=SVC_CFG, hooks=ServiceHooks(
        full=lambda req, prof: (_ for _ in ()).throw(RuntimeError("boom")))).request(8, 16)
    assert plain.ok and plain.reason.startswith("full: RuntimeError: boom")


def test_expired_deadline_goes_straight_to_classic():
    svc = TopologyService(cfg=SVC_CFG)
    assert isinstance(svc.submit(TopoRequest(n=10, r=16, deadline_ms=1e-3)), int)
    time.sleep(0.01)                      # deadline passes while queued
    resp = svc.drain()[0]
    assert resp.ok and resp.quality_tier == "classic"
    assert check_invariants(resp.topology) is None


# =========================================================================
# latency priors
# =========================================================================

def test_default_service_seeds_no_latency_priors(monkeypatch):
    """Deviation from the reference: BENCH_admm.json's rows were taken on a
    TPU, so the port reads no file and seeds nothing by default."""
    def no_reads(self, *a, **kw):
        raise AssertionError(f"the service read {self}")

    monkeypatch.setattr(pathlib.Path, "read_text", no_reads)
    monkeypatch.setattr(pathlib.Path, "read_bytes", no_reads)
    svc = TopologyService(cfg=SVC_CFG)
    assert t_svc._load_bench_rows() is None
    assert svc.stats["ema_seeded"] == 0 and not svc._ema_ms and not svc._seed_profiles
    monkeypatch.undo()
    assert j_svc.TopologyService(cfg=JaxConfig()).stats["ema_seeded"] > 0


def test_ema_seeded_from_explicit_rows_as_the_reference():
    rows = [
        {"bench": "pipeline", "n": 64, "pipeline": "device", "restarts": 4,
         "total_s": 8.0, "warm_s": 0.6, "admm_s": 5.8, "round_s": 0.004,
         "polish_s": 1.6, "eval_s": 0.004},
        {"bench": "pipeline", "n": 64, "pipeline": "host", "total_s": 30.0},
        {"bench": "admm", "n": 16, "ms_per_iter": 1.0},
    ]
    svc = TopologyService(cfg=SVC_CFG, bench_rows=rows)
    ref = j_svc.TopologyService(cfg=JaxConfig(), bench_rows=rows)
    assert svc.stats["ema_seeded"] == ref.stats["ema_seeded"] == 1
    assert svc._ema_ms == ref._ema_ms == {("full", 64): pytest.approx(8000.0)}
    assert svc._seed_profiles[64].phases == ref._seed_profiles[64].phases
    off = TopologyService(cfg=SVC_CFG, policy=ServicePolicy(ema_seed=False), bench_rows=rows)
    assert off.stats["ema_seeded"] == 0 and not off._ema_ms


def test_deadlined_requests_learn_stage_estimates_and_skip_what_cannot_fit():
    """After one deadlined request at n, the service's seed profile for n
    holds that solve's per-invocation stage estimates (a deviation: the
    reference learns none live). A second deadlined request at n whose
    deadline is the learned ADMM estimate (× the 1.5 safety factor cannot
    fit) records its ADMM as skipped instead of running past the deadline."""
    cfg = t_api.BATopoConfig(sa_iters=40, polish_iters=80, device="cpu", restarts=1,
                             admm=t_api.large_n_admm_config(max_iters=100))
    svc = TopologyService(cfg=cfg)
    first = svc.request(12, 24, deadline_ms=60_000.0)
    assert first.ok and first.quality_tier == "full"
    learned = svc._seed_profiles[12].phases
    assert {"warm", "admm", "polish", "eval"} <= set(learned)
    assert learned["admm"] > 0.0
    second = svc.request(12, 26, deadline_ms=learned["admm"] * 1e3)
    assert second.ok and check_invariants(second.topology) is None
    assert "restart 0: skipped (admm est" in second.reason, second.reason


def test_a_bucket_solve_seeds_the_next_deadlined_request_at_its_n():
    """A bucket of two n=12 requests records its phase times and seeds the
    stage profile of n=12 per instance (the bucket's restarts), where the
    first deadlined request at n=12 used to find none; that request's
    anytime solve is seeded with it and records the ADMM it skips."""
    cfg = t_api.BATopoConfig(sa_iters=40, polish_iters=80, device="cpu", restarts=1,
                             admm=t_api.large_n_admm_config(max_iters=100))
    svc = TopologyService(cfg=cfg)
    for r in (20, 24):
        svc.submit(TopoRequest(n=12, r=r))
    bucket = svc.drain()
    assert svc.stats["bucketed_solves"] == 1 and all(b.quality_tier == "full" for b in bucket)
    phases = bucket[0].profile
    seeded = svc._seed_profiles[12].phases
    assert seeded == {k: phases[f"{k}_s"] / 2 for k in ("warm", "admm", "round", "polish",
                                                          "eval")}
    seen = []

    def spy(*a, **kw):
        seen.append(dict(kw["seed_profile"].phases))
        return solve_topology(*a, **kw)

    t_svc.solve_topology, real = spy, t_svc.solve_topology
    try:
        timed = svc.request(12, 26, deadline_ms=seeded["admm"] * 1e3)
    finally:
        t_svc.solve_topology = real
    assert seen == [seeded]
    assert timed.ok and check_invariants(timed.topology) is None
    assert "restart 0: skipped (admm est" in timed.reason, timed.reason


def test_a_full_tier_solve_seeds_its_n_and_an_unseen_n_scales_the_nearest():
    """The one-request full tier seeds its n per restart; an n with no
    profile takes the nearest learned n's (the larger on a tie), scaled by
    the ratio of candidate-edge counts and never scaled down."""
    cfg = dataclasses.replace(SVC_CFG, restarts=2)
    svc = TopologyService(cfg=cfg)
    resp = svc.request(10, 16)
    assert resp.quality_tier == "full"
    want = {k: resp.profile[f"{k}_s"] / 2 for k in ("warm", "admm", "round", "polish", "eval")}
    assert svc._seed_profiles[10].phases == want
    assert svc._seed_profile_for(10).phases == want
    assert svc._seed_profile_for(8).phases == want
    up = svc._seed_profile_for(16).phases
    assert up == {k: v * ((16 * 15) / (10 * 9)) for k, v in want.items()}
    svc._seed_profiles[12] = t_svc.PhaseProfile({"admm": 1.0})
    assert svc._seed_profile_for(11).phases == {"admm": 1.0}   # tie → 12, not scaled down
    assert TopologyService(cfg=cfg)._seed_profile_for(10) is None


# =========================================================================
# device faults propagate
# =========================================================================

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_fault_leaves_drain_from_the_bucket_and_the_anytime_route(no_card):
    """A service built for ``cuda`` with no card behind it: the reference
    would answer every request from the classic fallback."""
    cfg = dataclasses.replace(SVC_CFG, device="cuda")
    svc = TopologyService(cfg=cfg)
    for r in (16, 20):
        svc.submit(TopoRequest(n=8, r=r))
    with pytest.raises(DeviceFault, match="device='cpu'"):
        svc.drain()
    with pytest.raises(DeviceFault):
        TopologyService(cfg=cfg).request(8, 16, deadline_ms=60_000.0)
    with pytest.raises(DeviceFault):          # the warm tier's guarded ADMM
        TopologyService(cfg=cfg, hooks=ServiceHooks(
            full=lambda req, prof: _nan_topology(int(req.n)))).request(8, 16)


@pytest.mark.parametrize("fault", [DeviceFault("kernel library does not load"),
                                   torch.AcceleratorError("CUDA error: device-side assert")],
                         ids=["DeviceFault", "AcceleratorError"])
def test_device_fault_leaves_the_tier_loop(fault):
    def raising(req, prof):
        raise fault

    svc = TopologyService(cfg=SVC_CFG, hooks=ServiceHooks(full=raising))
    with pytest.raises(type(fault)):
        svc.request(8, 16)


# =========================================================================
# the CLI
# =========================================================================

def test_topo_cli_on_the_cpu(capsys):
    """``launch/topo.py`` prints the reference's report; ``--scenario
    bcube`` builds BCube(√n, 2) (the reference passes n as p, a
    256-server BCube for its own ``--n 16`` example)."""
    from repro_torch.launch import topo as topo_cli

    report = topo_cli.main(["--n", "16", "--r", "48", "--scenario", "bcube", "--sa-iters", "40",
                            "--device", "cpu"])
    assert set(report) >= {"name", "n", "edges", "r_asym", "quality_tier", "complete",
                           "max_degree", "b_min_GBs", "t_iter_ms", "meta", "edge_list", "weights"}
    assert report["edges"] <= 48 and 0.0 < report["r_asym"] < 1.0 and report["complete"]
    assert '"r_asym"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="p²"):
        topo_cli.main(["--n", "12", "--r", "24", "--scenario", "bcube", "--device", "cpu"])
