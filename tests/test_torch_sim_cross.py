"""The port's cross-product engine ({static, round-robin} × {dense, top-k,
random-k CHOCO}) and what it imports — ``dsgd/schedule.py``,
``dsgd/dynamic.py``, ``dsgd/compression.py`` — against the JAX package's,
on the CPU. n = 4 workers on a ring and U-EquiStatic (M=2), each static
and as its round-robin cycle (lengths 1, 2, 1, 3); the same data, init and
batch order as ``test_torch_sim.py``; consensus from one float64 x0 (4, 24).

Tolerances:

- schedules, ``cycle_tensor``, ``stack_cycles``, the compressors' top-k
  threshold and kept set: bitwise;
- consensus curves (dense and top-k) against the reference, and every
  engine against its host oracle: 1e-6·e0 (float64 matmuls in another
  order; the reference's own scan-vs-host bound);
- training curves against the reference: one test sample (1/128); engine
  against host oracle: 1e-6; the static dense cross run against
  ``accuracy_curves``: 1e-7 (the reference's bound; the port meets it
  bitwise, both mixing over the same kernel table);
- random-k (its stream is a ``torch.Generator``, not the reference's): the
  kept fraction within 5 binomial standard deviations of frac, the kept
  entries scaled by exactly 1/frac, and the network mean kept to 1e-12.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.core.topologies import make_baseline as jmake_baseline  # noqa: E402
from repro.data import class_balanced_partition, make_classification_data  # noqa: E402
from repro.data import epoch_permutations  # noqa: E402
from repro.dsgd import chaos as jchaos  # noqa: E402
from repro.dsgd import compression as jcomp  # noqa: E402
from repro.dsgd import gossip as jgossip  # noqa: E402
from repro.dsgd import dynamic as jdyn  # noqa: E402
from repro.dsgd import schedule as jsched  # noqa: E402
from repro.dsgd import sim as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.topologies import make_baseline  # noqa: E402
from repro_torch.dsgd import chaos as tchaos  # noqa: E402
from repro_torch.dsgd import compression as tcomp  # noqa: E402
from repro_torch.dsgd import dynamic as tdyn  # noqa: E402
from repro_torch.dsgd import schedule as tsched  # noqa: E402
from repro_torch.dsgd import sim as tsim  # noqa: E402

N, DIM, HIDDEN, CLASSES = 4, 16, 16, 4
JCFG = jsim.DSGDSimConfig(epochs=2, batch=8, hidden=HIDDEN, seed=0)
TCFG = tsim.DSGDSimConfig(epochs=2, batch=8, hidden=HIDDEN, seed=0)
ACC_TOL = 1.0 / 128 + 1e-12
CPU = "cpu"
TOPOS = (("ring", {}), ("equistatic", {"M": 2}))


@pytest.fixture(scope="module")
def topologies():
    return [make_baseline(k, N, **kw) for k, kw in TOPOS]


@pytest.fixture(scope="module")
def cycles(topologies):
    out = []
    for t in topologies:
        out += [tdyn.static_cycle(t.W), tdyn.cycle_tensor(t)]
    return out


@pytest.fixture(scope="module")
def x0():
    return np.random.default_rng(0).normal(size=(N, 24))


@pytest.fixture(scope="module")
def dataset():
    X, y = make_classification_data(num_classes=CLASSES, dim=DIM, samples_per_class=64,
                                    seed=0)
    Xte, yte = make_classification_data(num_classes=CLASSES, dim=DIM, samples_per_class=32,
                                        seed=0, noise_seed=10_001)
    return X, y, class_balanced_partition(y, N, seed=0), Xte, yte


@pytest.fixture(scope="module")
def init():
    p0 = jsim.init_mlp(jax.random.PRNGKey(0), DIM, HIDDEN, CLASSES)
    return convert.mlp_params_from_numpy(jax.tree.map(np.asarray, p0))


def _jdata(dataset):
    X, y, parts, Xte, yte = dataset
    return jnp.asarray(X), jnp.asarray(y), parts, jnp.asarray(Xte), jnp.asarray(yte)


# --- schedules and cycle tensors (numpy, bitwise) ------------------------------

@pytest.mark.parametrize("kind,kw,n", [("ring", {}, 8), ("equistatic", {"M": 2}, 8),
                                       ("torus", {}, 16), ("equistatic", {"M": 3}, 16)])
def test_schedules_and_cycle_tensor_bitwise(kind, kw, n):
    jt, tt = jmake_baseline(kind, n, **kw), make_baseline(kind, n, **kw)
    fields = dataclasses.astuple
    assert fields(tsched.schedule_from_topology(tt)) == fields(jsched.schedule_from_topology(jt))
    assert tsched.edge_color(n, list(tt.edges)) == jsched.edge_color(n, list(jt.edges))
    assert [fields(s) for s in tdyn.round_robin_schedules(tt)] == \
        [fields(s) for s in jdyn.round_robin_schedules(jt)]
    np.testing.assert_array_equal(tdyn.cycle_tensor(tt), jdyn.cycle_tensor(jt))
    assert tdyn.cycle_contraction(tdyn.round_robin_schedules(tt)) == \
        jdyn.cycle_contraction(jdyn.round_robin_schedules(jt))
    s = tsched.schedule_from_topology(tt)
    assert tsched.bytes_per_sync(s, 4096) == jsched.bytes_per_sync(s, 4096)
    np.testing.assert_array_equal(tsched.reconstruct_weight_matrix(s),
                                  jsched.reconstruct_weight_matrix(s))


def test_stack_cycles_bitwise(cycles):
    Wc, R = tdyn.stack_cycles(cycles)
    jWc, jR = jdyn.stack_cycles(cycles)
    assert Wc.dtype == np.float64 and R.dtype == np.int32
    np.testing.assert_array_equal(Wc, jWc)
    np.testing.assert_array_equal(R, jR)
    assert list(R) == [1, 2, 1, 3]


def test_directed_and_shard_rules(monkeypatch):
    with pytest.raises(ValueError, match="asymmetric"):
        tdyn.round_robin_schedules(make_baseline("exponential", 8))
    # the dynamic shard gossip applies round ``step % R`` (a tensor step read
    # on the host) over a process group, and needs one
    scheds = tdyn.round_robin_schedules(make_baseline("ring", 8))
    picked = []
    with monkeypatch.context() as m:
        m.setattr(tdyn, "gossip_shard", lambda tree, sched, axis: picked.append(sched) or tree)
        for step in (0, 1, 2, torch.tensor(5), 7):
            tdyn.gossip_shard_dynamic({}, scheds, step, None)
    R = len(scheds)
    assert picked == [scheds[s % R] for s in (0, 1, 2, 5, 7)]
    with pytest.raises(RuntimeError, match="process group"):
        tdyn.gossip_shard_dynamic({"x": torch.zeros(2)}, scheds, 0, None)


# --- compressors ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape,frac", [((16, 512), 0.1), ((8, 130), 0.3), ((4, 7), 0.5)])
def test_kth_largest_bitselect_equals_topk_threshold(dtype, shape, frac):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(dtype)
    x[0, :3] = 0.0
    x[1, 1] = x[1, 2]                              # an exact tie
    x[2, 0] = -0.0
    k = max(int(np.ceil(frac * shape[1])), 1)
    absx = torch.from_numpy(x).abs()
    got = tcomp._kth_largest_bitselect(absx, k)
    assert got.dtype == absx.dtype and got.shape == (shape[0], 1)
    assert torch.equal(got[:, 0], torch.topk(absx, k, dim=1).values[:, k - 1])
    ref = np.asarray(jcomp._kth_largest_bitselect(jnp.abs(jnp.asarray(x)), k))
    np.testing.assert_array_equal(got.numpy(), ref)
    # compress_top_k (torch.topk's threshold) keeps the set the radix select
    # gives, in both packages
    a = tcomp.compress_top_k(torch.from_numpy(x), frac)
    assert torch.equal(a, torch.from_numpy(x) * (absx >= got))
    np.testing.assert_array_equal(a.numpy(), np.asarray(jcomp.compress_top_k(
        jnp.asarray(x), frac, method="bitselect")))


def test_random_k_band_and_scaling():
    frac, shape = 0.1, (16, 4096)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    gen = torch.Generator().manual_seed(1)
    q = tcomp.compress_random_k(x, frac, gen)
    kept = q != 0
    m = kept.numel()
    band = 5 * np.sqrt(m * frac * (1 - frac))
    assert abs(int(kept.sum()) - m * frac) <= band
    assert torch.equal(q[kept], x[kept] / frac)
    # the same generator state draws the same mask: the engines' draws repeat
    q2 = tcomp.compress_random_k(x, frac, torch.Generator().manual_seed(1))
    assert torch.equal(q, q2)


def test_choco_random_k_preserves_mean_on_cycles(cycles, x0):
    comp = tcomp.random_k_compressor(0.5)
    gen = torch.Generator().manual_seed(1)
    for cyc in cycles:
        state = tcomp.choco_gossip_init(torch.from_numpy(x0))
        for t in range(40):
            W = torch.from_numpy(cyc[t % len(cyc)])
            state = tcomp.choco_gossip_step(state, W, comp, 0.1, gen)
        np.testing.assert_allclose(state.x.mean(0).numpy(), x0.mean(0), rtol=0, atol=1e-12)


def test_choco_top_k_step_matches_reference(cycles, x0):
    W = cycles[3][1]
    state = tcomp.choco_gossip_init(torch.from_numpy(x0))
    jstate = jcomp.choco_gossip_init(jnp.asarray(x0))
    for _ in range(10):
        state = tcomp.choco_gossip_step(state, torch.from_numpy(W), tcomp.top_k_compressor(0.25),
                                        0.4, None)
        jstate = jcomp.choco_gossip_step(jstate, jnp.asarray(W), jcomp.top_k_compressor(0.25),
                                         0.4, jax.random.PRNGKey(0))
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(state.x_hat.numpy(), np.asarray(jstate.x_hat), rtol=0,
                               atol=1e-12)


def test_commspec_matches_reference():
    for args in [(), ("top_k", 0.1), ("random_k", 0.25)]:
        t, j = tsim.CommSpec(*args), jsim.CommSpec(*args)
        assert (t.choco, t.ratio, t.name) == (j.choco, j.ratio, j.name)
        assert t.to_compressor().name == j.to_compressor().name
    with pytest.raises(ValueError):
        tsim.CommSpec("sign")


# --- consensus curves ---------------------------------------------------------

@pytest.mark.parametrize("spec,gammas", [(tsim.CommSpec(), [1.0] * 4),
                                         (tsim.CommSpec("top_k", 0.25), [0.3, 0.5, 0.3, 0.5])])
def test_consensus_cross_matches_reference(cycles, x0, spec, gammas):
    got = tsim.consensus_curves_cross(cycles, gammas, spec, x0, 50, seed=0, device=CPU)
    ref = np.asarray(jsim.consensus_curves_cross(cycles, gammas, jsim.CommSpec(
        spec.compressor, spec.frac), x0, 50, seed=0))
    assert got.shape == (4, 51) and got.dtype == np.float64
    for b in range(4):
        np.testing.assert_allclose(got[b], ref[b], rtol=0, atol=1e-6 * ref[b, 0])


@pytest.mark.parametrize("spec,gammas", [(tsim.CommSpec(), [1.0] * 4),
                                         (tsim.CommSpec("top_k", 0.1), [0.3, 0.5, 0.3, 0.5]),
                                         (tsim.CommSpec("random_k", 0.5), [0.1, 0.2, 0.1, 0.2])])
def test_consensus_cross_matches_host(cycles, x0, spec, gammas):
    errs = tsim.consensus_curves_cross(cycles, gammas, spec, x0, 50, seed=0, device=CPU)
    for b, (c, g) in enumerate(zip(cycles, gammas)):
        if spec.compressor == "random_k" and b:    # the runs share one mask stream
            single = tsim.consensus_curves_cross([c], [g], spec, x0, 50, seed=0, device=CPU)
            np.testing.assert_allclose(errs[b], single[0], rtol=0, atol=1e-6 * errs[b, 0])
            continue
        host = tsim.consensus_curve_host_cross(c, g, spec, x0, 50, seed=0, device=CPU)
        np.testing.assert_allclose(errs[b], host, rtol=0, atol=1e-6 * host[0])
    if spec.compressor != "random_k":              # unbiased random-k need not contract
        assert np.all(errs[:, -1] < errs[:, 0])


def test_consensus_host_stop_rel(cycles, x0):
    errs = tsim.consensus_curve_host_cross(cycles[2], 1.0, tsim.CommSpec(), x0, 200,
                                           stop_rel=1e-3, device=CPU)
    assert errs[-1] <= 1e-3 * errs[0] and len(errs) < 201


# --- training curves ------------------------------------------------------------

def test_train_cross_dense_matches_reference(cycles, dataset, init):
    ref, it = jsim.train_curves_cross(cycles, np.ones(4), jsim.CommSpec(), *_jdata(dataset),
                                      JCFG)
    got, it2 = tsim.train_curves_cross(cycles, np.ones(4), tsim.CommSpec(), *dataset, TCFG,
                                       init=init, device=CPU)
    assert it == it2 and got.shape == (4, TCFG.epochs)
    assert np.abs(got - np.asarray(ref)).max() <= ACC_TOL


def test_train_cross_top_k_matches_reference(cycles, dataset, init):
    spec = ("top_k", 0.25)
    ref, _ = jsim.train_curves_cross(cycles[2:], np.full(2, 0.6), jsim.CommSpec(*spec),
                                     *_jdata(dataset), JCFG)
    got, _ = tsim.train_curves_cross(cycles[2:], np.full(2, 0.6), tsim.CommSpec(*spec),
                                     *dataset, TCFG, init=init, device=CPU)
    assert np.abs(got - np.asarray(ref)).max() <= ACC_TOL


@pytest.mark.parametrize("spec,gamma", [(tsim.CommSpec(), 1.0),
                                        (tsim.CommSpec("top_k", 0.25), 0.6),
                                        (tsim.CommSpec("random_k", 0.5), 0.6)])
def test_train_cross_matches_host(cycles, dataset, init, spec, gamma):
    accs, iters = tsim.train_curves_cross(cycles, np.full(4, gamma), spec, *dataset, TCFG,
                                          init=init, device=CPU)
    for b, c in enumerate(cycles):
        host, ih = tsim.accuracy_curve_host_cross(c, gamma, spec, *dataset, TCFG, init=init,
                                                  device=CPU)
        assert ih == iters
        np.testing.assert_allclose(accs[b], host, rtol=0, atol=1e-6)


def test_train_static_dense_cross_equals_accuracy_curves(topologies, dataset, init):
    W = topologies[1].W
    ref, _ = tsim.accuracy_curves(W, *dataset, TCFG, init=init, device=CPU)
    got, _ = tsim.train_curves_cross([tdyn.static_cycle(W)], [1.0], tsim.CommSpec(), *dataset,
                                     TCFG, init=init, device=CPU)
    np.testing.assert_allclose(got[0], ref, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[0], ref)


# --- the engine's step against the reference's, parameter by parameter -------------

def _reference_run(cycle, gamma, spec, jspec, p0, X, y, perm, fault):
    """20 steps of one run as the reference's cross/chaos engines take them:
    momentum SGD, W_t = cycle[t % R] in float32 (degraded under faults), the
    mix by ``repro.dsgd.sim._mix_pytree`` (CHOCO) or ``gossip_sim_tree``
    (dense), then ``_freeze_tree``."""
    grad_fn = jax.vmap(jax.grad(jsim.mlp_loss))
    lr, mom_c = TCFG.lr, TCFG.momentum
    gamma = jnp.float32(gamma)

    @jax.jit
    def jstep(params, mom, hat, xb, yb, W, alive_t, link_t):
        g = grad_fn(params, xb, yb)
        mom_new = jax.tree.map(lambda m, gg: mom_c * m + gg, mom, g)
        p_new = jax.tree.map(lambda p, m: p - lr * m, params, mom_new)
        W = jchaos.degrade_matrix(W, alive_t, link_t)
        if spec.choco:
            p_mix, hat_new = jsim._mix_pytree(jspec, p_new, hat, W, gamma,
                                              jax.random.PRNGKey(0))
        else:
            p_mix, hat_new = jgossip.gossip_sim_tree(p_new, W), hat
        return (jsim._freeze_tree(alive_t, p_mix, params),
                jsim._freeze_tree(alive_t, mom_new, mom),
                jsim._freeze_tree(alive_t, hat_new, hat))

    jp = jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a)[None], (N,) + a.shape), p0)
    jm = jax.tree.map(jnp.zeros_like, jp)
    jh = jax.tree.map(jnp.zeros_like, jp)
    for t, idx in enumerate(perm):
        W = jnp.asarray(cycle[t % len(cycle)], jnp.float32)
        jp, jm, jh = jstep(jp, jm, jh, jnp.asarray(X)[idx], jnp.asarray(y)[idx], W,
                           jnp.asarray(fault.alive[t], jnp.float32),
                           jnp.asarray(fault.link_up[t], jnp.float32))
    return jp


@pytest.mark.parametrize("spec,gamma,faulty", [(("top_k", 0.25), 0.4, False),
                                               (("top_k", 0.25), 0.4, True),
                                               ((), 1.0, True)],
                         ids=["top_k", "top_k-faults", "dense-faults"])
def test_params_after_20_steps_match_reference_step(cycles, dataset, init, spec, gamma,
                                                    faulty):
    """All four cycles stacked on the engine's block-diagonal tables (slot
    t % R_b per run), CHOCO's (W − I)x̂ through ``gossip_mix_batched``'s
    plain version with column 0 float32(W_ii − 1), and under faults the
    degraded weights gathered over the same tables and dead rows frozen:
    params within 1e-5 abs of the reference's dense mix after 20 steps."""
    X, y, parts, _, _ = dataset
    steps, B = 20, len(cycles)
    perm = epoch_permutations(parts, 3, 8, seed=0).reshape(-1, N, 8)[:steps]
    kw = dict(churn=[(1, 2, 9)], p_drop=0.2) if faulty else {}
    fault = tchaos.make_chaos(steps, N, seed=3, **kw)
    p0 = {k: v.numpy() for k, v in init.items()}
    tspec, jspec = tsim.CommSpec(*spec), jsim.CommSpec(*spec)
    Wc, lens = tdyn.stack_cycles(cycles)
    tables = tsim._Tables(Wc.astype(np.float32), lens, steps, CPU)
    alive, link = tsim._stack_chaos([fault] * B, B, steps, N, CPU)
    tp = tsim._stack_params([init], B, N, CPU)
    tm = {k: torch.zeros_like(v) for k, v in tp.items()}
    th = {k: torch.zeros_like(v) for k, v in tp.items()}
    step = tsim._make_step(tspec, TCFG, N, B, tsim._gammas([gamma] * B, B, N, CPU))
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).long()
    for t, idx in enumerate(perm):
        rows = torch.from_numpy(np.tile(idx, (B, 1)))
        tp, tm, th = step(tp, tm, th, Xt[rows], yt[rows], tables.at(t, alive[t], link[t]),
                          alive[t].reshape(B * N) > 0)
    for b, cyc in enumerate(cycles):
        jp = _reference_run(cyc, gamma, tspec, jspec, p0, X, y, perm, fault)
        for k in tsim.LEAVES:
            assert tp[k].dtype == torch.float32
            np.testing.assert_allclose(tp[k][b * N:(b + 1) * N].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-5)
    if faulty:                          # node 1 was down for steps 2..8 and froze
        assert not bool(alive[2:9, :, 1].any())
