"""The port's elastic runtime (``repro_torch.dsgd.elastic``) against the JAX
package's, on the CPU: reduced smollm-135m (float32), N = 4 on a ring,
seq 16, batch 2, SGD with momentum. The reference's initial state comes
across by ``convert.dsgd_state_from_numpy``; batches are ``lm_batch_numpy``'s
numpy arrays, handed to both packages.

- Fault-free, ``ElasticRuntime.round`` is bitwise the port's
  ``dsgd_train_step`` over 3 rounds (params, optimizer state, every
  metric), with ``use_kernel`` True (the kernel's plain version on the CPU)
  and False.
- Under churn, a watchdog drop and link loss, the port's rounds follow the
  reference's ``ElasticRuntime``: losses within 1e-5 relative and params
  within 1e-4 (``tests/test_torch_dsgd.py``'s tolerances for
  ``dsgd_train_step``), ``dropped``, ``round_ms``, ``deadline_ms``,
  ``attempts`` and ``n_alive`` exactly; a dead worker is bitwise frozen.
- ``node_step_latency_ms`` and ``fault_free_round_ms`` equal the
  reference's exactly.
- The retry ladder gives the reference's rungs when it recovers and when it
  freezes the round.
- Reopt adoption gives the reference's events (step, reason, adopt step)
  and support (float64 ADMM, host SA: the settings of
  ``tests/test_torch_reopt.py``).
- ``to_extras``/``from_extras`` round-trips; a ``DeviceFault`` from the step
  or the re-solve leaves ``round()``; the sharded step refuses a tensor-parallel
  mesh dim naming item 7c.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import api as j_api  # noqa: E402
from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.core.reopt import DriftPolicy as JDriftPolicy  # noqa: E402
from repro.core.topologies import make_baseline as j_baseline  # noqa: E402
from repro.dsgd import chaos as j_chaos  # noqa: E402
from repro.dsgd import elastic as j_el  # noqa: E402
from repro.dsgd import trainer as jtrainer  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core.reopt import DriftPolicy  # noqa: E402
from repro_torch.core.topologies import make_baseline  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.device import DeviceFault  # noqa: E402
from repro_torch.dsgd import chaos as t_chaos  # noqa: E402
from repro_torch.dsgd import elastic as t_el  # noqa: E402
from repro_torch.dsgd import trainer as ttrainer  # noqa: E402
from repro_torch.kernels import WRAPPERS  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

N = 4
LOSS_REL, PARAM_ABS = 1e-5, 1e-4        # tests/test_torch_dsgd.py's tolerances


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    # one intra-op thread while this module runs: the suite's parallel
    # workers share the host's cores, and the reduced model's small ops
    # only lose to oversubscribed thread pools; restored on the way out
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(tdata, "TABLE_DIR", tmp_path_factory.mktemp("bigram"))
    mp.setattr(tdata, "_TABLES", {})
    jcfg = jreduced(jget_arch("smollm-135m"))
    tcfg = reduced_for_smoke(get_arch("smollm-135m"))
    j_init, j_upd = jopt.sgd_momentum(0.05)
    t_init, t_upd = topt.sgd_momentum(0.05)
    jstate = jtrainer.init_dsgd_state(jax.random.PRNGKey(0), jcfg, N, j_init)
    tstate = convert.dsgd_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    dc = tdata.DataConfig(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=2, seed=0)
    batches = []
    for s in range(6):
        per = [tdata.lm_batch_numpy(dc, s, node=i) for i in range(N)]
        batches.append({k: np.stack([b[k] for b in per]) for k in per[0]})
    yield dict(jcfg=jcfg, tcfg=tcfg, j_upd=j_upd, t_upd=t_upd, jstate=jstate, tstate=tstate,
               batches=batches, jtopo=j_baseline("ring", N), ttopo=make_baseline("ring", N),
               jstep=j_el.make_elastic_train_step(jcfg, j_upd),
               tsteps={k: t_el.make_elastic_train_step(tcfg, t_upd, use_kernel=k)
                       for k in (True, False)})
    mp.undo()
    torch.set_num_threads(threads)


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def chaos_pair(alive=None, link_up=None, straggler=None, bandwidth=None, steps=4):
    """The same fault arrays as each package's ChaosSpec."""
    ch = t_chaos.no_chaos(steps, N)
    arrays = dict(alive=ch.alive if alive is None else alive,
                  link_up=ch.link_up if link_up is None else link_up,
                  straggler=ch.straggler if straggler is None else straggler,
                  bandwidth=ch.bandwidth if bandwidth is None else bandwidth)
    return j_chaos.ChaosSpec(**arrays), t_chaos.ChaosSpec(**arrays)


def runtimes(s, jchaos, tchaos, use_kernel=True, jstep=None, tstep=None, cfgs=(None, None),
             drift=None, **spec):
    """Each package's ElasticRuntime on the same faults and policy."""
    jrt = j_el.ElasticRuntime(
        s["jcfg"], j_el.ElasticSpec(chaos=jchaos, topo_cfg=cfgs[0],
                                    drift=JDriftPolicy(**(drift or {})), **spec),
        s["jtopo"], s["j_upd"], step_fn=jstep or s["jstep"])
    trt = t_el.ElasticRuntime(
        s["tcfg"], t_el.ElasticSpec(chaos=tchaos, topo_cfg=cfgs[1],
                                    drift=DriftPolicy(**(drift or {})), **spec),
        s["ttopo"], s["t_upd"], use_kernel=use_kernel, step_fn=tstep or s["tsteps"][use_kernel],
        device="cpu")
    return jrt, trt


# --- fault-free: bitwise the plain trainer -----------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_fault_free_round_is_bitwise_dsgd_train_step(setup, use_kernel):
    s = setup
    legacy = ttrainer.dsgd_train_step(s["tcfg"], s["ttopo"], s["t_upd"],
                                      use_kernel=use_kernel, device="cpu")
    rt = t_el.ElasticRuntime(s["tcfg"], t_el.ElasticSpec(chaos=t_chaos.no_chaos(3, N),
                                                         reopt=False),
                             s["ttopo"], s["t_upd"], use_kernel=use_kernel,
                             step_fn=s["tsteps"][use_kernel], device="cpu")
    assert rt.topo_cfg.device == "cpu"
    es = rt.make_state(s["ttopo"])
    if use_kernel:
        assert tuple(es.nbr[0].shape) == (N, N - 1)       # deg_cap = n − 1 tables
    s1 = s2 = s["tstate"]
    for t in range(3):
        b = tb(s["batches"][t])
        s1, m1 = legacy(s1, b)
        before = WRAPPERS["gossip_mix_batched"].launches
        s2, m2, rep = rt.round(s2, es, b)
        assert WRAPPERS["gossip_mix_batched"].launches == before   # CPU: plain version
        for k in ("loss", "loss_max", "consensus_err"):
            assert torch.equal(m1[k], m2[k]), (t, k)
        assert bitwise(s1.params, s2.params) and bitwise(s1.opt, s2.opt)
        assert not rep.dropped.any() and rep.attempts == 1 and float(m2["n_alive"]) == N
    assert int(s2.step) == 3 and es.data_step == 3 and es.key.tolist() == [0, 3]


# --- faults: the reference's rounds ---------------------------------------------

def _faults():
    alive = np.ones((4, N), np.float32)
    alive[1:3, 1] = 0.0                          # node 1 leaves for rounds 1–2
    link = np.ones((4, N, N), np.float32)
    link[0, 0, 3] = link[0, 3, 0] = 0.0          # edge (0, 3) drops in round 0
    link[3, 2, 3] = link[3, 3, 2] = 0.0          # edge (2, 3) drops in round 3
    strag = np.ones((4, N))
    strag[0, 2] = 50.0                           # node 2 is 50× slow in round 0
    strag[2, 3] = 1.5                            # node 3 a little slow in round 2
    return chaos_pair(alive=alive, link_up=link, straggler=strag)


@pytest.fixture(scope="module")
def reference_faulty_run(setup):
    jchaos, _ = _faults()
    rt = j_el.ElasticRuntime(setup["jcfg"], j_el.ElasticSpec(chaos=jchaos, reopt=False,
                                                             deadline_factor=2.0),
                             setup["jtopo"], setup["j_upd"], step_fn=setup["jstep"])
    es = rt.make_state(setup["jtopo"])
    st, out = setup["jstate"], []
    for t in range(4):
        st, m, rep = rt.round(st, es, jb(setup["batches"][t]))
        out.append((float(m["loss"]), float(m["n_alive"]), rep))
    return jax.tree.map(np.asarray, st), out


@pytest.mark.parametrize("use_kernel", [True, False])
def test_faulty_rounds_follow_the_reference(setup, reference_faulty_run, use_kernel):
    jfinal, jrounds = reference_faulty_run
    _, tchaos = _faults()
    rt = t_el.ElasticRuntime(setup["tcfg"], t_el.ElasticSpec(chaos=tchaos, reopt=False,
                                                             deadline_factor=2.0),
                             setup["ttopo"], setup["t_upd"], use_kernel=use_kernel,
                             step_fn=setup["tsteps"][use_kernel], device="cpu")
    es = rt.make_state(setup["ttopo"])
    st = setup["tstate"]
    for t, (jloss, jn_alive, jrep) in enumerate(jrounds):
        st, m, rep = rt.round(st, es, tb(setup["batches"][t]))
        assert abs(float(m["loss"]) - jloss) <= LOSS_REL * abs(jloss), t
        assert float(m["n_alive"]) == jn_alive
        assert np.array_equal(rep.dropped, jrep.dropped) and np.array_equal(rep.alive, jrep.alive)
        assert (rep.round_ms, rep.deadline_ms, rep.attempts) == \
            (jrep.round_ms, jrep.deadline_ms, jrep.attempts), t
        if t == 0:                                # node 1 dies in rounds 1–2: frozen
            frozen = [x[1].clone() for x in leaves(st.params)]
            frozen_opt = [x[1].clone() for x in leaves(st.opt)]
        if t == 2:
            assert all(torch.equal(x[1], f) for x, f in zip(leaves(st.params), frozen))
            assert all(torch.equal(x[1], f) for x, f in zip(leaves(st.opt), frozen_opt))
    assert jrounds[0][2].dropped.tolist() == [False, False, True, False]
    assert (es.dropped_rounds, es.drops) == (1, 1)
    got = jax.tree_util.tree_flatten_with_path(convert.model_params_to_numpy(st.params))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jfinal.params)[0])
    assert len(got) == len(want)
    for path, v in got:
        assert np.abs(v - np.asarray(want[path], np.float32)).max() <= PARAM_ABS, path


def test_latency_model_equals_the_reference(setup):
    rng = np.random.default_rng(3)
    strag = np.where(rng.random((5, N)) < 0.4, 3.0, 1.0)
    bw = rng.uniform(0.5, 12.0, (5, N))
    alive = (rng.random((5, N)) < 0.8).astype(np.float32)
    jch, tch = chaos_pair(alive=alive, straggler=strag, bandwidth=bw, steps=5)
    for kind in ("ring", "exponential"):
        jt, tt = j_baseline(kind, N), make_baseline(kind, N)
        for t in range(5):
            assert np.array_equal(t_el.node_step_latency_ms(tt, tch, t),
                                  j_el.node_step_latency_ms(jt, jch, t))
            assert t_el.fault_free_round_ms(tt, bw[t]) == j_el.fault_free_round_ms(jt, bw[t])


# --- retry ladder ------------------------------------------------------------

@pytest.mark.parametrize("poisoned", [1, 2])
def test_retry_ladder_rungs_match_the_reference(setup, poisoned):
    """``poisoned`` attempts return a NaN loss: 1 recovers on the retry, 2
    exhausts the ladder and freezes the round."""
    calls = {"j": 0, "t": 0}

    def jflaky(st, b, *rest):
        calls["j"] += 1
        new, m = setup["jstep"](st, b, *rest)
        return new, (dict(m, loss=jnp.float32(np.nan)) if calls["j"] <= poisoned else m)

    def tflaky(st, b, *rest):
        calls["t"] += 1
        new, m = setup["tsteps"][True](st, b, *rest)
        return new, (dict(m, loss=torch.tensor(np.nan)) if calls["t"] <= poisoned else m)

    jch, tch = chaos_pair(steps=1)
    jrt, trt = runtimes(setup, jch, tch, jstep=jflaky, tstep=tflaky, reopt=False,
                        max_round_retries=1)
    _, jm, jrep = jrt.round(setup["jstate"], jrt.make_state(setup["jtopo"]),
                            jb(setup["batches"][0]))
    st, tm, trep = trt.round(setup["tstate"], trt.make_state(setup["ttopo"]),
                             tb(setup["batches"][0]))
    assert [(r.rung, r.outcome, r.detail) for r in trep.rungs] == \
        [(r.rung, r.outcome, r.detail) for r in jrep.rungs]
    assert trep.attempts == jrep.attempts == 2 and trep.round_ms == jrep.round_ms
    assert np.isnan(float(tm["loss"])) == np.isnan(float(jm["loss"])) == (poisoned == 2)
    assert bitwise(st.params, setup["tstate"].params) == (poisoned == 2)
    assert int(st.step) == 1


# --- drift → reopt → adoption ------------------------------------------------

def _reopt_cfgs():
    """Host SA, float64 ADMM and polish at 100 iterations: the settings under
    which the two packages agree on supports (tests/test_torch_reopt.py)."""
    out = []
    for api in (j_api, t_api):
        cfg = api.BATopoConfig(sa_iters=100, polish_iters=100, warmstart="host",
                               polish_dtype="float64")
        cfg = dataclasses.replace(cfg, admm=dataclasses.replace(cfg.admm, dtype="float64",
                                                                max_iters=100))
        out.append(cfg if api is j_api else dataclasses.replace(cfg, device="cpu"))
    return out


def test_reopt_adoption_gives_the_reference_events(setup):
    bw = j_chaos.drift_profile(6, N, 3, 9.76, 2, 1.0)
    arrays = j_chaos.make_chaos(6, N, seed=0, bandwidth=bw)
    jch, tch = chaos_pair(alive=arrays.alive, link_up=arrays.link_up,
                          straggler=arrays.straggler, bandwidth=arrays.bandwidth, steps=6)
    jrt, trt = runtimes(setup, jch, tch, cfgs=_reopt_cfgs(), activation_lag_steps=2,
                        drift=dict(cooldown_steps=6))
    jes, tes = jrt.make_state(setup["jtopo"]), trt.make_state(setup["ttopo"])
    jst, tst = setup["jstate"], setup["tstate"]
    swaps = []
    for t in range(6):
        jst, _, jrep = jrt.round(jst, jes, jb(setup["batches"][t]))
        tst, tm, trep = trt.round(tst, tes, tb(setup["batches"][t]))
        assert (trep.reopt_reason, trep.swapped) == (jrep.reopt_reason, jrep.swapped), t
        assert np.isfinite(float(tm["loss"]))
        swaps += [t] * trep.swapped
    assert swaps == [3 + 2]
    assert [(e["step"], e["event"], e.get("reason")) for e in tes.events
            if e["event"] != "adopt"] == \
        [(e["step"], e["event"], e.get("reason")) for e in jes.events if e["event"] != "adopt"]
    assert [e["step"] for e in tes.events if e["event"] == "adopt"] == \
        [e["step"] for e in jes.events if e["event"] == "adopt"] == [5]
    assert (tes.reopts, tes.adopted) == (jes.reopts, jes.adopted) == (1, 1)
    assert sorted(map(tuple, map(sorted, tes.topology.edges))) == \
        sorted(map(tuple, map(sorted, jes.topology.edges)))
    assert abs(tes.topology.r_asym() - jes.topology.r_asym()) <= 1e-6
    W = torch.tensor(tes.topology.W, dtype=torch.float32)
    assert torch.equal(tes.W, W) and tes.nbr[1].sum() == 2 * len(tes.topology.edges)


def test_reopt_budget_passes_the_references_budget_ms(setup, monkeypatch):
    """``reopt_budget`` (the reference's ``test_reopt_budget_window_passes_budget_ms``):
    None leaves the re-solve unbudgeted, ``"window"`` budgets it to lag ×
    the modeled fault-free round, a float passes through; each package hands
    ``reoptimize_topology`` the same ``budget_ms`` at the same trigger."""
    captured = {"j": [], "t": []}

    def capture(pkg, reopt_result):
        def reopt(incumbent, **kw):
            captured[pkg].append(kw)
            return reopt_result(topology=incumbent, reoptimized=False, attempts=1,
                                fallback_reason="stub", time_to_reopt_s=0.0,
                                r_asym_before=0.5, r_asym_after=0.5)
        return reopt

    monkeypatch.setattr(j_el, "reoptimize_topology", capture("j", j_el.ReoptResult))
    monkeypatch.setattr(t_el, "reoptimize_topology", capture("t", t_el.ReoptResult))
    jstep = lambda st, *a: (j_el.DSGDState(st.params, st.opt, st.step + 1),  # noqa: E731
                            {"loss": jnp.float32(1.0)})
    tstep = lambda st, *a: (t_el.DSGDState(st.params, st.opt, st.step + 1),  # noqa: E731
                            {"loss": torch.tensor(1.0)})
    bw = j_chaos.drift_profile(6, N, 3, 9.76, 2, 1.0)
    arrays = j_chaos.make_chaos(6, N, seed=0, bandwidth=bw)
    jch, tch = chaos_pair(alive=arrays.alive, link_up=arrays.link_up,
                          straggler=arrays.straggler, bandwidth=arrays.bandwidth, steps=6)
    for budget, lag in ((None, 1), ("window", 2), (123.5, 1)):
        jrt, trt = runtimes(setup, jch, tch, jstep=jstep, tstep=tstep,
                            drift=dict(cooldown_steps=6), reopt_budget=budget,
                            activation_lag_steps=lag)
        jes, tes = jrt.make_state(setup["jtopo"]), trt.make_state(setup["ttopo"])
        jst, tst = setup["jstate"], setup["tstate"]
        for _ in range(6):
            jst, _, _ = jrt.round(jst, jes, None)
            tst, _, _ = trt.round(tst, tes, None)
        assert tes.reopts == jes.reopts == 1
    got = [kw["budget_ms"] for kw in captured["t"]]
    assert got == [kw["budget_ms"] for kw in captured["j"]]
    assert got[0] is None and got[2] == 123.5
    bw3 = np.asarray(captured["t"][1]["node_bandwidths"])
    assert got[1] == 2 * t_el.fault_free_round_ms(setup["ttopo"], bw3) > 0


# --- resume payload, faults that propagate, the unported step -----------------

def test_extras_round_trip(setup):
    bw = t_chaos.drift_profile(8, N, 4, 9.76, 2, 1.0)
    tch = t_chaos.make_chaos(8, N, seed=0, bandwidth=bw)
    _, tcfg = _reopt_cfgs()
    rt = t_el.ElasticRuntime(setup["tcfg"], t_el.ElasticSpec(
        chaos=tch, activation_lag_steps=3, topo_cfg=tcfg), setup["ttopo"], setup["t_upd"],
        step_fn=lambda st, *a: (t_el.DSGDState(st.params, st.opt, st.step + 1),
                                {"loss": torch.tensor(1.0)}), device="cpu")
    es = rt.make_state(setup["ttopo"], seed=5)
    st = setup["tstate"]
    for t in range(5):                      # past the trigger, a pending adoption
        st, _, _ = rt.round(st, es, None)
    assert es.pending is not None
    es2 = rt.from_extras(rt.to_extras(es), name=es.topology.name)
    assert es2.data_step == es.data_step == 5 and es2.key.tolist() == es.key.tolist() == [5, 5]
    assert es2.pending[0] == es.pending[0] and es2.pending[1].edges == es.pending[1].edges
    assert np.array_equal(es2.pending[1].g, es.pending[1].g)
    assert es2.detector.last_trigger == es.detector.last_trigger == 4
    assert np.array_equal(es2.detector.base_bandwidth, es.detector.base_bandwidth)
    assert es2.topology.edges == es.topology.edges
    assert torch.equal(es2.W, es.W) and all(torch.equal(a, b) for a, b in zip(es2.nbr, es.nbr))
    assert (es2.reopts, es2.adopted, es2.dropped_rounds, es2.drops) == \
        (es.reopts, es.adopted, es.dropped_rounds, es.drops)


@pytest.mark.parametrize("where", ["step", "reopt"])
def test_device_fault_leaves_round(setup, where, monkeypatch):
    def broken(*a, **kw):
        raise DeviceFault("the card fell off the bus")

    bw = t_chaos.drift_profile(2, N, 1, 9.76, 2, 1.0)
    tch = t_chaos.make_chaos(2, N, seed=0, bandwidth=bw)
    ok_step = lambda st, *a: (t_el.DSGDState(st.params, st.opt, st.step + 1),  # noqa: E731
                              {"loss": torch.tensor(1.0)})
    if where == "reopt":
        monkeypatch.setattr(t_el, "reoptimize_topology", broken)
    rt = t_el.ElasticRuntime(setup["tcfg"], t_el.ElasticSpec(chaos=tch), setup["ttopo"],
                             setup["t_upd"], step_fn=broken if where == "step" else ok_step,
                             device="cpu")
    es = rt.make_state(setup["ttopo"])
    st = setup["tstate"]
    with pytest.raises(DeviceFault, match="bus"):
        for _ in range(2):
            st, _, _ = rt.round(st, es, None)


def test_runtime_refuses_cuda_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(DeviceFault, match="cuda"):
        t_el.ElasticRuntime(setup["tcfg"], t_el.ElasticSpec(chaos=t_chaos.no_chaos(1, N)),
                            setup["ttopo"], setup["t_upd"])


def test_sharded_step_is_not_ported_and_names_item_7():
    """The rank-per-worker elastic step is ported; what it cannot take yet,
    a mesh dim outside ``gossip_axes`` larger than 1 (tensor parallelism
    inside a worker), raises naming item 7c before it needs a process group
    (a stand-in mesh), as do the pjit steps still unported."""
    from types import SimpleNamespace

    from repro_torch.dsgd import schedule_from_topology, trainer

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), mesh=torch.arange(N * 2).reshape(N, 2))
    sched = schedule_from_topology(make_baseline("ring", N))
    with pytest.raises(NotImplementedError, match="Queue 1, item 7c"):
        t_el.make_elastic_sharded_train_step(None, sched, None, mesh)
    for fn in (trainer.make_matmul_gossip_train_step, trainer.make_tp_train_step):
        with pytest.raises(NotImplementedError, match="Queue 1, item 7c"):
            fn()
