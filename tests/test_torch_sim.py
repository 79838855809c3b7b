"""The port's §VI-B accuracy engine (``repro_torch.dsgd.sim``) against the
JAX package's, on the CPU, at a small size: 4 classes × 64 samples at dim
16, hidden 16, n = 4 workers, three topologies (ring, exponential, grid),
2 epochs of 8 iterations. Both sides start from the reference's
``init_mlp`` (carried over by ``convert.mlp_params_from_numpy``) and read
the same numpy batch order.

Tolerances:

- params after 20 steps of the engine's step against a reference step built
  from ``repro.dsgd.sim.mlp_loss`` and ``repro.dsgd.gossip.gossip_sim_tree``:
  1e-5 abs (float32; the port mixes through ``gossip_mix_batched``'s plain
  version, the reference by a dense matmul, in another order);
- ``accuracy_curves`` / ``accuracy_curves_seeds`` / ``train_curve`` against
  the reference: one test sample (1/128) at every epoch;
- the batched engine against the host oracle, and stacked runs against
  single runs: 1e-6 (the reference's own scan-vs-host bound);
- no module of the slice imports ``jax`` or ``repro`` (an AST walk).
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.core.topologies import make_baseline  # noqa: E402
from repro.data import class_balanced_partition, epoch_permutations  # noqa: E402
from repro.data import make_classification_data  # noqa: E402
from repro.dsgd import gossip as jgossip  # noqa: E402
from repro.dsgd import sim as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dsgd import sim as tsim  # noqa: E402
from repro_torch.dsgd.gossip import padded_neighbors  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, DIM, HIDDEN, CLASSES = 4, 16, 16, 4
JCFG = jsim.DSGDSimConfig(epochs=2, batch=8, hidden=HIDDEN, seed=0)
TCFG = tsim.DSGDSimConfig(epochs=2, batch=8, hidden=HIDDEN, seed=0)
TOPOS = ("ring", "exponential", "grid")
ACC_TOL = 1.0 / 128 + 1e-12          # one test sample of 128
CPU = "cpu"


@pytest.fixture(scope="module")
def dataset():
    X, y = make_classification_data(num_classes=CLASSES, dim=DIM, samples_per_class=64,
                                    seed=0)
    Xte, yte = make_classification_data(num_classes=CLASSES, dim=DIM, samples_per_class=32,
                                        seed=0, noise_seed=10_001)
    return X, y, class_balanced_partition(y, N, seed=0), Xte, yte


@pytest.fixture(scope="module")
def Ws():
    return np.stack([make_baseline(t, N).W for t in TOPOS]).astype(np.float32)


def _p0(seed=0):
    return jax.tree.map(np.asarray, jsim.init_mlp(jax.random.PRNGKey(seed), DIM, HIDDEN,
                                                  CLASSES))


def _jdata(dataset):
    X, y, parts, Xte, yte = dataset
    return jnp.asarray(X), jnp.asarray(y), parts, jnp.asarray(Xte), jnp.asarray(yte)


@pytest.mark.parametrize("topo", TOPOS)
def test_params_after_20_steps_match_reference_step(dataset, Ws, topo):
    X, y, parts, _, _ = dataset
    W = Ws[TOPOS.index(topo)]
    perm = epoch_permutations(parts, 3, 8, seed=0).reshape(-1, N, 8)[:20]
    lr, mom_c = 0.05, 0.9
    grad_fn = jax.vmap(jax.grad(jsim.mlp_loss))

    @jax.jit
    def jstep(params, mom, xb, yb):
        g = grad_fn(params, xb, yb)
        mom = jax.tree.map(lambda m, gg: mom_c * m + gg, mom, g)
        params = jax.tree.map(lambda p, m: p - lr * m, params, mom)
        return jgossip.gossip_sim_tree(params, jnp.asarray(W)), mom

    p0 = _p0()
    jp = jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a)[None], (N,) + a.shape), p0)
    jm = jax.tree.map(jnp.zeros_like, jp)
    tp = tsim._stack_params([convert.mlp_params_from_numpy(p0)], 1, N, "cpu")
    tm = {k: torch.zeros_like(v) for k, v in tp.items()}
    step = tsim._make_step(tsim.CommSpec(), TCFG, N, 1, None)
    table = padded_neighbors(torch.from_numpy(W))
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).long()
    for idx in perm:
        jp, jm = jstep(jp, jm, jnp.asarray(X)[idx], jnp.asarray(y)[idx])
        tp, tm, _ = step(tp, tm, None, Xt[idx], yt[idx], table)
    for k in tsim.LEAVES:
        assert tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5)


def test_accuracy_curves_match_reference(dataset, Ws):
    ref, it = jsim.accuracy_curves(jnp.asarray(Ws), *_jdata(dataset), JCFG)
    got, it2 = tsim.accuracy_curves(Ws, *dataset, TCFG, init=convert.mlp_params_from_numpy(_p0()),
                                    device=CPU)
    assert it2 == it == 8 and got.shape == (len(TOPOS), TCFG.epochs)
    assert np.abs(got - np.asarray(ref)).max() <= ACC_TOL


def test_accuracy_curves_seeds_match_reference(dataset, Ws):
    seeds = [0, 3]
    ref, it = jsim.accuracy_curves_seeds(jnp.asarray(Ws[:2]), *_jdata(dataset), seeds, JCFG)
    inits = [convert.mlp_params_from_numpy(_p0(s)) for s in seeds]
    got, it2 = tsim.accuracy_curves_seeds(Ws[:2], *dataset, seeds, TCFG, init=inits,
                                          device=CPU)
    assert it2 == it and got.shape == (2, 2, TCFG.epochs)
    assert np.abs(got - np.asarray(ref)).max() <= ACC_TOL


def test_train_curve_matches_reference(dataset, Ws):
    X, y, parts, Xte, yte = dataset
    perm = epoch_permutations(parts, 2, 8, seed=5)
    ref = jsim.train_curve(jnp.asarray(Ws[1]), jnp.asarray(X), jnp.asarray(y),
                           jnp.asarray(Xte), jnp.asarray(yte), perm, JCFG)
    got = tsim.train_curve(Ws[1], X, y, Xte, yte, perm, TCFG,
                           init=convert.mlp_params_from_numpy(_p0()), device=CPU)
    assert np.abs(got - np.asarray(ref)).max() <= ACC_TOL


@pytest.mark.parametrize("topo", TOPOS)
def test_engine_matches_host_oracle(dataset, Ws, topo):
    init = convert.mlp_params_from_numpy(_p0())
    accs, it = tsim.accuracy_curves(Ws, *dataset, TCFG, init=init, device=CPU)
    host, ih = tsim.accuracy_curve_host(Ws[TOPOS.index(topo)], *dataset, TCFG, init=init,
                                        device=CPU)
    assert ih == it
    np.testing.assert_allclose(accs[TOPOS.index(topo)], host, rtol=0, atol=1e-6)


def test_stacked_runs_equal_single_runs(dataset, Ws):
    batched, _ = tsim.accuracy_curves(Ws, *dataset, TCFG, device=CPU)
    for t in range(len(TOPOS)):
        single, _ = tsim.accuracy_curves(Ws[t], *dataset, TCFG, device=CPU)
        assert single.shape == (TCFG.epochs,)
        np.testing.assert_allclose(batched[t], single, rtol=0, atol=1e-6)


def test_seed_stack_equals_per_seed_runs(dataset, Ws):
    seeds = [1, 2]
    got, _ = tsim.accuracy_curves_seeds(Ws, *dataset, seeds, TCFG, device=CPU)
    for i, s in enumerate(seeds):
        cfg = tsim.DSGDSimConfig(epochs=2, batch=8, hidden=HIDDEN, seed=s)
        one, _ = tsim.accuracy_curves(Ws, *dataset, cfg, device=CPU)
        np.testing.assert_allclose(got[i], one, rtol=0, atol=1e-6)


def test_training_learns_and_init_is_float32(dataset, Ws):
    p = tsim.init_mlp(0, DIM, HIDDEN, CLASSES)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in p.values())
    assert float(p["w1"].abs().max()) <= 1 / np.sqrt(DIM)
    assert torch.equal(p["w1"], tsim.init_mlp(0, DIM, HIDDEN, CLASSES)["w1"])
    accs, _ = tsim.accuracy_curves(Ws, *dataset, tsim.DSGDSimConfig(epochs=4, batch=8,
                                                                    hidden=HIDDEN), device=CPU)
    assert np.all(accs[:, -1] > 1.5 / CLASSES)


def test_default_device_is_cuda(dataset, Ws, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.accuracy_curves(Ws, *dataset, TCFG)


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("module", ["dsgd/sim.py", "dsgd/compression.py", "dsgd/chaos.py",
                                    "dsgd/dynamic.py", "dsgd/schedule.py", "dsgd/gossip.py",
                                    "dsgd/__init__.py", "convert.py"])
def test_slice_modules_never_import_jax_or_repro(module):
    names = _imports(ROOT / "src" / "repro_torch" / module)
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_sim_exports_the_reference_all():
    assert tsim.__all__ == jsim.__all__
    assert all(callable(getattr(tsim, name)) for name in tsim.__all__)
