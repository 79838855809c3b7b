"""The port's chaos engine and fault injection (``repro_torch.dsgd.chaos``,
``train_curves_chaos``, ``consensus_curves_chaos``) against the JAX
package's, on the CPU. n = 4 workers on a ring and U-EquiStatic (M=2),
static and round-robin; the same data, init and batch order as
``test_torch_sim.py``.

Tolerances:

- ``make_chaos``, ``no_chaos``, ``random_churn_windows``,
  ``drift_profile``, ``degrade_matrix`` (fp32 and fp64, with faults),
  ``elastic_neighbor_tables`` and ``gather_neighbor_weights``: bitwise;
- the fault-free chaos engine against the cross engine: bitwise (dense,
  top-k and random-k training; dense consensus);
- training under faults against the reference: one test sample (1/128);
  engine against host oracle: 1e-6;
- consensus under faults (dense and top-k) against the reference and
  against the host oracle: 1e-6·e0;
- a churned worker's params and momentum stay bit for bit what they were
  when it left, and it rejoins from them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.core.topologies import make_baseline as jmake_baseline  # noqa: E402
from repro.data import class_balanced_partition, make_classification_data  # noqa: E402
from repro.dsgd import chaos as jchaos  # noqa: E402
from repro.dsgd import gossip as jgossip  # noqa: E402
from repro.dsgd import sim as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.topologies import make_baseline  # noqa: E402
from repro_torch.dsgd import chaos as tchaos  # noqa: E402
from repro_torch.dsgd import dynamic as tdyn  # noqa: E402
from repro_torch.dsgd import gossip as tgossip  # noqa: E402
from repro_torch.dsgd import sim as tsim  # noqa: E402

N, DIM, HIDDEN, CLASSES = 4, 16, 16, 4
JCFG = jsim.DSGDSimConfig(epochs=2, batch=8, hidden=HIDDEN, seed=0)
TCFG = tsim.DSGDSimConfig(epochs=2, batch=8, hidden=HIDDEN, seed=0)
STEPS = 16                                # 2 epochs × 8 iterations
ACC_TOL = 1.0 / 128 + 1e-12
CPU = "cpu"


@pytest.fixture(scope="module")
def cycles():
    out = []
    for k, kw in (("ring", {}), ("equistatic", {"M": 2})):
        t = make_baseline(k, N, **kw)
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


def _faults(steps, seed=3):
    kw = dict(churn=[(1, 2, 9)], p_drop=0.2, straggler_prob=0.1)
    return tchaos.make_chaos(steps, N, seed=seed, **kw), jchaos.make_chaos(steps, N, seed=seed,
                                                                         **kw)


# --- fault specs (numpy, bitwise) ------------------------------------------------

@pytest.mark.parametrize("kw", [dict(churn=[(2, 3, 9)], p_drop=0.2),
                                dict(p_drop=0.05, straggler_prob=0.3, straggler_mult=2.0),
                                dict(bandwidth=np.linspace(1.0, 9.0, 6)),
                                dict(churn=[(0, 0, 20), (5, 10, 12)], p_drop=0.5)])
def test_make_chaos_bitwise(kw):
    t, j = tchaos.make_chaos(20, 6, seed=7, **kw), jchaos.make_chaos(20, 6, seed=7, **kw)
    for f in ("alive", "link_up", "straggler", "bandwidth"):
        got, want = getattr(t, f), getattr(j, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert t.meta == j.meta and t.faultless == j.faultless


def test_other_spec_builders_bitwise():
    assert tchaos.random_churn_windows(8, 60, 4, seed=2) == \
        jchaos.random_churn_windows(8, 60, 4, seed=2)
    np.testing.assert_array_equal(tchaos.drift_profile(30, 8, 10, np.full(8, 9.76), 3, 1.0),
                                  jchaos.drift_profile(30, 8, 10, np.full(8, 9.76), 3, 1.0))
    t, j = tchaos.no_chaos(12, 5), jchaos.no_chaos(12, 5)
    assert t.faultless and t.meta == j.meta
    for f in ("alive", "link_up", "straggler", "bandwidth"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    with pytest.raises(ValueError, match="out of range"):
        tchaos.make_chaos(10, 4, churn=[(4, 0, 3)])
    alive, link = t.device_leaves(CPU)
    assert alive.dtype == link.dtype == torch.float32 and link.shape == (12, 5, 5)


# --- degrade_matrix and the weight gather -----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,kw,n", [("ring", {}, 8), ("exponential", {}, 16),
                                       ("equistatic", {"M": 3}, 16)])
def test_degrade_matrix_bitwise(dtype, kind, kw, n):
    W = jmake_baseline(kind, n, **kw).W.astype(dtype)
    ch = jchaos.make_chaos(30, n, seed=3, churn=[(1, 2, 9)], p_drop=0.3)
    want = np.asarray(jchaos.degrade_matrix(jnp.asarray(W)[None], jnp.asarray(ch.alive),
                                            jnp.asarray(ch.link_up)))
    got = tchaos.degrade_matrix(torch.from_numpy(W)[None], torch.from_numpy(ch.alive),
                                torch.from_numpy(ch.link_up))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    clear = tchaos.no_chaos(1, n)
    same = tchaos.degrade_matrix(torch.from_numpy(W), torch.from_numpy(clear.alive[0]),
                                 torch.from_numpy(clear.link_up[0]))
    assert torch.equal(same, torch.from_numpy(W))


@pytest.mark.parametrize("kind", ["ring", "exponential"])
def test_neighbor_tables_and_weight_gather_bitwise(kind):
    n = 8
    W = jmake_baseline(kind, n).W.astype(np.float32)
    ch = jchaos.make_chaos(1, n, seed=1, churn=[(2, 0, 1)], p_drop=0.3)
    Wd = np.asarray(jchaos.degrade_matrix(jnp.asarray(W), jnp.asarray(ch.alive[0]),
                                          jnp.asarray(ch.link_up[0])))
    for cap in (None, 5):
        ji, jm = jgossip.elastic_neighbor_tables(W, cap)
        ti, tm = tgossip.elastic_neighbor_tables(W, cap)
        assert ti.dtype == torch.int32 and tm.dtype == torch.bool
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        want = np.asarray(jgossip.gather_neighbor_weights(jnp.asarray(Wd), ji, jm))
        got = tgossip.gather_neighbor_weights(torch.from_numpy(Wd), ti, tm)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="deg_cap"):
        tgossip.elastic_neighbor_tables(W, 1)


# --- fault-free: bit-equal to the cross engine --------------------------------------

@pytest.mark.parametrize("spec,gamma", [(tsim.CommSpec(), 1.0),
                                        (tsim.CommSpec("top_k", 0.5), 0.6),
                                        (tsim.CommSpec("random_k", 0.5), 0.6)])
def test_faultless_chaos_train_bit_equal_to_cross(cycles, dataset, init, spec, gamma):
    gammas = np.full(len(cycles), gamma)
    ref, it = tsim.train_curves_cross(cycles, gammas, spec, *dataset, TCFG, init=init,
                                      device=CPU)
    got, it2 = tsim.train_curves_chaos(cycles, gammas, spec, tchaos.no_chaos(STEPS, N),
                                       *dataset, TCFG, init=init, device=CPU)
    assert it == it2 and it * TCFG.epochs == STEPS
    np.testing.assert_array_equal(got, ref)


def test_faultless_chaos_consensus_bit_equal(cycles, x0):
    gammas = np.ones(len(cycles))
    ref = tsim.consensus_curves_cross(cycles, gammas, tsim.CommSpec(), x0, 40, device=CPU)
    got = tsim.consensus_curves_chaos(cycles, gammas, tsim.CommSpec(), tchaos.no_chaos(40, N),
                                      x0, 40, device=CPU)
    np.testing.assert_array_equal(got, ref)


# --- under faults ----------------------------------------------------------------

def test_chaos_train_matches_reference(cycles, dataset, init):
    tch, jch = _faults(STEPS)
    ref, _ = jsim.train_curves_chaos(cycles, np.ones(4), jsim.CommSpec(), jch,
                                     *_jdata(dataset), JCFG)
    got, _ = tsim.train_curves_chaos(cycles, np.ones(4), tsim.CommSpec(), tch, *dataset, TCFG,
                                     init=init, device=CPU)
    assert np.abs(got - np.asarray(ref)).max() <= ACC_TOL


@pytest.mark.parametrize("spec,gamma", [(tsim.CommSpec(), 1.0),
                                        (tsim.CommSpec("top_k", 0.25), 0.6)])
def test_chaos_train_matches_host(cycles, dataset, init, spec, gamma):
    tch, _ = _faults(STEPS)
    accs, _ = tsim.train_curves_chaos(cycles, np.full(4, gamma), spec, tch, *dataset, TCFG,
                                      init=init, device=CPU)
    for b, c in enumerate(cycles):
        host, _ = tsim.accuracy_curve_host_chaos(c, gamma, spec, tch, *dataset, TCFG,
                                                 init=init, device=CPU)
        np.testing.assert_allclose(accs[b], host, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spec,gamma", [(tsim.CommSpec(), 1.0),
                                        (tsim.CommSpec("top_k", 0.25), 0.4)])
def test_chaos_consensus_matches_reference_and_host(cycles, x0, spec, gamma):
    iters = 50
    tch = tchaos.make_chaos(iters, N, seed=4, churn=[(0, 10, 35)], p_drop=0.05)
    jch = jchaos.make_chaos(iters, N, seed=4, churn=[(0, 10, 35)], p_drop=0.05)
    gammas = np.full(len(cycles), gamma)
    got = tsim.consensus_curves_chaos(cycles, gammas, spec, tch, x0, iters, device=CPU)
    ref = np.asarray(jsim.consensus_curves_chaos(cycles, gammas, jsim.CommSpec(
        spec.compressor, spec.frac), jch, x0, iters))
    for b, c in enumerate(cycles):
        np.testing.assert_allclose(got[b], ref[b], rtol=0, atol=1e-6 * ref[b, 0])
        host = tsim.consensus_curve_host_chaos(c, gamma, spec, tch, x0, iters, device=CPU)
        np.testing.assert_allclose(got[b], host, rtol=0, atol=1e-6 * host[0])


def test_chaos_rejects_mismatched_specs(cycles, dataset):
    with pytest.raises(ValueError, match="covers"):
        tsim.train_curves_chaos(cycles, np.ones(4), tsim.CommSpec(), tchaos.no_chaos(3, N),
                                *dataset, TCFG, device=CPU)
    with pytest.raises(ValueError, match="ChaosSpecs"):
        tsim.train_curves_chaos(cycles, np.ones(4), tsim.CommSpec(),
                                [tchaos.no_chaos(STEPS, N)] * 3, *dataset, TCFG, device=CPU)


def test_churned_worker_freezes_and_rejoins(cycles, dataset, init):
    """The engine's step under a churn window: while worker k is dead its
    params and momentum stay bit for bit what they were when it left; after
    it rejoins it moves again, from those params."""
    X, y, parts, _, _ = dataset
    t0, t1, k = 3, 9, 2
    ch = tchaos.make_chaos(STEPS, N, churn=[(k, t0, t1)])
    tables = tsim._Tables(tdyn.stack_cycles(cycles[:1])[0].astype(np.float32),
                          np.ones(1, np.int32), STEPS, CPU)
    alive = torch.from_numpy(ch.alive)
    link = torch.from_numpy(ch.link_up)
    params = tsim._stack_params([init], 1, N, CPU)
    mom = {key: torch.zeros_like(v) for key, v in params.items()}
    step = tsim._make_step(tsim.CommSpec(), TCFG, N, 1, None)
    perm = tsim._perm(parts, TCFG).reshape(-1, N, TCFG.batch)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).long()
    left = None
    for t in range(STEPS):
        before = {key: v[k].clone() for key, v in params.items()}
        params, mom, _ = step(params, mom, None, Xt[perm[t]], yt[perm[t]],
                              tables.at(t, alive[t][None], link[t][None]), alive[t] > 0)
        if t == t0:
            left = ({key: v[k].clone() for key, v in params.items()},
                    {key: v[k].clone() for key, v in mom.items()})
            assert all(torch.equal(left[0][key], before[key]) for key in before)
        if t0 < t < t1:
            assert all(torch.equal(params[key][k], left[0][key]) for key in params)
            assert all(torch.equal(mom[key][k], left[1][key]) for key in mom)
        if t == t1:
            assert not torch.equal(params["w1"][k], left[0]["w1"])
