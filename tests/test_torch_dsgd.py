"""The port's DSGD training path against the JAX package's, on the CPU.

- ``synthetic_lm_batch``: bit-identical tokens and labels at vocab 512 and
  4096 (the port's sparse, cached bigram table against the reference's
  dense one).
- The classification substrate (data, partition, batch orders)
  bit-identical.
- One ``sgd_momentum`` and one ``adamw`` update, ``clip_by_global_norm``
  and the schedules' values, within 1e-6 (float32 elementwise, rounding
  at other places).
- Three ``dsgd_train_step`` steps, n = 4, ring and exponential, both
  through their gossip kernels (``use_kernel=True``; the port's plain
  version on the CPU, the Pallas kernel in interpret mode in JAX), from the
  same weights and batches: losses and consensus error within 1e-5
  relative, parameters within 1e-4. The same for three ``--sync dynamic``
  steps on the ring (``launch.train._dynamic_step``: the port mixes each
  step's matching through its kernel's plain version, the reference by the
  dense W_c).
- The launcher's ``main()`` end to end on the CPU, writing ``--json-out``,
  and its BA solves (homogeneous and ``--node-bw``) into its own cache;
  ``--sync dynamic`` through it, and a dynamic run stopped after two steps
  and resumed from its checkpoint, bitwise the uninterrupted run.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.core.topologies import make_baseline  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.dsgd import trainer as jtrainer  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.dsgd import trainer as ttrainer  # noqa: E402
from repro_torch.kernels import WRAPPERS  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the suite's parallel workers share
    the host's cores, and the reduced model's small ops only lose to
    oversubscribed thread pools; restored on the way out."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def table_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "TABLE_DIR", tmp_path / "bigram")
    monkeypatch.setattr(tdata, "_TABLES", {})
    return tmp_path / "bigram"


@pytest.mark.parametrize("vocab", [512, 4096])
def test_synthetic_lm_batch_bit_identical(vocab, table_dir):
    jdc = jdata.DataConfig(vocab_size=vocab, seq_len=48, batch_size=3, seed=1)
    tdc = tdata.DataConfig(vocab_size=vocab, seq_len=48, batch_size=3, seed=1)
    for step, node in ((0, 0), (1, 3), (9, 2)):
        want = jdata.synthetic_lm_batch(jdc, step, node)
        got = tdata.synthetic_lm_batch(tdc, step, node)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (step, node, k)
    assert tdata.TABLE_STATS[(vocab, 1)]["source"] == "built"
    # a second process would read the table back from disk, bit for bit
    cols, cdf = tdata.bigram_table(vocab, 1)
    tdata._TABLES.clear()
    cols2, cdf2 = tdata.bigram_table(vocab, 1)
    assert tdata.TABLE_STATS[(vocab, 1)]["source"] == "disk"
    assert np.array_equal(cols, cols2) and np.array_equal(cdf, cdf2)


def test_bigram_table_is_the_reference_cdf(table_dir):
    ref = np.cumsum(jdata._bigram_table(512, 3), axis=1)
    cols, cdf = tdata.bigram_table(512, 3)
    assert np.all(np.diff(cols, axis=1) > 0)
    assert np.array_equal(np.take_along_axis(ref, cols.astype(np.int64), axis=1), cdf)
    assert (cdf[:, -1] < 1.0).any()        # the u ≥ cdf[-1] → token 0 edge case is live


def test_frontend_embeds_bit_identical(table_dir):
    jdc = jdata.DataConfig(vocab_size=512, seq_len=8, batch_size=2, seed=0,
                           frontend_tokens=4, d_model=16)
    tdc = tdata.DataConfig(vocab_size=512, seq_len=8, batch_size=2, seed=0,
                           frontend_tokens=4, d_model=16)
    want, got = jdata.synthetic_lm_batch(jdc, 2, 1), tdata.synthetic_lm_batch(tdc, 2, 1)
    assert np.array_equal(got["embeds"].numpy(), np.asarray(want["embeds"]))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}


def _tmap(f, tree):
    return {k: _tmap(f, v) if isinstance(v, dict) else f(v) for k, v in tree.items()}


def _assert_tree_close(got, want, tol):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_close(got[k], v, tol)
        else:
            assert np.abs(got[k].numpy() - np.asarray(v)).max() <= tol, k


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_one_optimizer_update_matches_jax(name):
    params, grads, state_seed = _tree(0), _tree(1), _tree(2)
    lr_j = jsched.warmup_cosine(0.05, 2, 10)
    lr_t = tsched.warmup_cosine(0.05, 2, 10)
    j_init, j_upd = jopt.make_optimizer(name, lr_j)
    t_init, t_upd = topt.make_optimizer(name, lr_t)
    jp, jg = _tmap(jnp.asarray, params), _tmap(jnp.asarray, grads)
    tp, tg = _tmap(torch.from_numpy, params), _tmap(torch.from_numpy, grads)
    jstate, tstate = j_init(jp), t_init(tp)
    # a non-zero starting state at step 3
    if name == "sgd":
        jstate = jopt.SGDState(_tmap(jnp.asarray, state_seed), jnp.int32(3))
        tstate = topt.SGDState(_tmap(torch.from_numpy, state_seed),
                               torch.tensor(3, dtype=torch.int32))
    else:
        nu = _tmap(np.abs, state_seed)
        jstate = jopt.AdamWState(_tmap(jnp.asarray, state_seed), _tmap(jnp.asarray, nu),
                                 jnp.int32(3))
        tstate = topt.AdamWState(_tmap(torch.from_numpy, state_seed), _tmap(torch.from_numpy, nu),
                                 torch.tensor(3, dtype=torch.int32))
    jup, jnew = j_upd(jg, jstate, jp)
    tup, tnew = t_upd(tg, tstate, tp)
    _assert_tree_close(tup, jup, 1e-6)
    for jt, tt in zip(jnew[:-1], tnew[:-1]):
        _assert_tree_close(tt, jt, 1e-6)
    assert int(tnew.step) == int(jnew.step) == 4
    _assert_tree_close(topt.apply_updates(tp, tup), jopt.apply_updates(jp, jup), 1e-6)


def test_schedules_match_jax():
    steps = np.arange(0, 40, dtype=np.int32)
    pairs = [(jsched.warmup_cosine(0.05, 3, 30), tsched.warmup_cosine(0.05, 3, 30)),
             (jsched.cosine_schedule(0.1, 20), tsched.cosine_schedule(0.1, 20)),
             (jsched.linear_warmup(0.2, 5), tsched.linear_warmup(0.2, 5)),
             (jsched.constant_schedule(0.3), tsched.constant_schedule(0.3))]
    for jf, tf in pairs:
        want = np.array([float(jf(jnp.int32(s))) for s in steps])
        got = np.array([float(tf(torch.tensor(int(s), dtype=torch.int32))) for s in steps])
        assert np.abs(got - want).max() <= 1e-6 * 0.3


@pytest.mark.parametrize("kind", ["ring", "exponential", "dynamic"])
def test_three_dsgd_steps_match_jax(kind, table_dir, one_thread):
    """``dynamic``: the ring's two matchings, one a step, through
    ``repro.launch.train._dynamic_step`` and the port's."""
    n, steps = 4, 3
    jcfg = jreduced(jget_arch("smollm-135m"))
    tcfg = reduced_for_smoke(get_arch("smollm-135m"))
    topo = make_baseline("ring" if kind == "dynamic" else kind, n)
    j_init, j_upd = jopt.make_optimizer("sgd", jsched.warmup_cosine(0.05, 1, steps))
    t_init, t_upd = topt.make_optimizer("sgd", tsched.warmup_cosine(0.05, 1, steps))
    jstate = jtrainer.init_dsgd_state(jax.random.PRNGKey(7), jcfg, n, j_init)
    tstate = convert.dsgd_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    if kind == "dynamic":
        from repro.launch import train as jtrain

        jstep, jrounds = jtrain._dynamic_step(jcfg, topo, j_upd)
        tstep, trounds = ttrain._dynamic_step(tcfg, topo, t_upd, device="cpu")
        assert trounds == jrounds == 2
    else:
        jstep = jtrainer.dsgd_train_step(jcfg, topo, j_upd, use_kernel=True)
        tstep = ttrainer.dsgd_train_step(tcfg, topo, t_upd, use_kernel=True, device="cpu")
    dc = tdata.DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, batch_size=2, seed=0)
    for s in range(steps):
        per = [tdata.lm_batch_numpy(dc, s, node=i) for i in range(n)]
        batch = {k: np.stack([b[k] for b in per]) for k in per[0]}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        before = WRAPPERS["gossip_mix_batched"].launches
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert WRAPPERS["gossip_mix_batched"].launches == before    # CPU: plain version
        for k in ("loss", "loss_max", "consensus_err"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (s, k)
    assert int(tstate.step) == int(jstate.step) == steps
    want = jax.tree.map(np.asarray, jstate)
    _assert_tree_close(tstate.params, want.params, 1e-4)
    _assert_tree_close(tstate.opt.momentum, want.opt.momentum, 1e-4)


def test_allreduce_step_averages_exactly(table_dir):
    n = 3
    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    init, upd = topt.make_optimizer("sgd", 0.05)
    state = ttrainer.init_dsgd_state(0, cfg, n, init, device="cpu")
    step = ttrainer.allreduce_train_step(cfg, n, upd, device="cpu")
    dc = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=0)
    per = [tdata.lm_batch_numpy(dc, 0, node=i) for i in range(n)]
    state, m = step(state, {k: torch.from_numpy(np.stack([b[k] for b in per])) for k in per[0]})
    assert float(m["consensus_err"]) <= 1e-5 and np.isfinite(float(m["loss"]))


def test_launcher_main_on_cpu(tmp_path, table_dir):
    out = tmp_path / "run.json"
    res = ttrain.main(["--arch", "smollm-135m", "--reduced", "--workers", "4", "--steps", "3",
                       "--device", "cpu", "--topo", "ring", "--seq", "32", "--log-every", "1",
                       "--json-out", str(out)])
    data = json.loads(out.read_text())
    assert data["history"] == res["history"] and len(data["history"]) == 3
    assert data["device"] == "cpu" and data["config"]["use_kernel"] is True
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["consensus_err"])
               for h in data["history"])
    assert abs(data["history"][0]["loss"] - np.log(512)) < 0.5
    assert data["param_count_per_worker"] == 344_704 and len(data["step_ms"]) == 3


def test_launcher_sync_dynamic_on_cpu(tmp_path, table_dir, capsys, one_thread):
    res = ttrain.main(["--arch", "smollm-135m", "--reduced", "--workers", "5", "--steps", "3",
                       "--device", "cpu", "--topo", "ring", "--seq", "16",
                       "--log-every", "1", "--sync", "dynamic"])
    assert "sync=dynamic[ring" in capsys.readouterr().out
    assert res["rounds"] == 3 and len(res["history"]) == 3     # an odd ring: three matchings
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    with pytest.raises(SystemExit):
        ttrain.parse_args(["--arch", "smollm-135m", "--sync", "dynamic", "--elastic"])


class _Stop(Exception):
    pass


def test_dynamic_resume_is_bitwise_the_uninterrupted_run(tmp_path, table_dir, one_thread):
    """Four dynamic steps over the 5-ring's three matchings against two
    steps, a stop, and ``--resume`` for the last two: the slot of step 2 is
    2 mod 3, read from the restored step (a counter restarted at 0 would mix
    by slot 0)."""
    argv = ["--arch", "smollm-135m", "--reduced", "--workers", "5", "--steps", "4",
            "--device", "cpu", "--topo", "ring", "--seq", "16", "--log-every", "1",
            "--sync", "dynamic"]
    states = {}

    def keep(tag):
        return lambda s, state, m: states.__setitem__(tag, state)

    whole = ttrain.main(argv, on_step=keep("whole"))

    def stop_after_two(s, state, m):
        if s == 2:
            raise _Stop

    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"]
    with pytest.raises(_Stop):
        ttrain.main(argv + ck, on_step=stop_after_two)
    resumed = ttrain.main(argv + ck + ["--resume"], on_step=keep("resumed"))
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    for a, b in zip(resumed["history"], whole["history"][2:]):
        assert all(a[k] == b[k] for k in ("loss", "loss_max", "consensus_err"))
    assert int(states["resumed"].step) == int(states["whole"].step) == 4
    for a, b in zip(tree_leaves(states["resumed"].params), tree_leaves(states["whole"].params)):
        assert torch.equal(a, b)


def test_launcher_solves_ba_on_cpu_into_its_own_cache(tmp_path, table_dir):
    cache = tmp_path / "topo_cache_torch.json"
    res = ttrain.main(["--arch", "smollm-135m", "--reduced", "--workers", "4", "--steps", "1",
                       "--device", "cpu", "--seq", "16", "--topo-cache", str(cache)])
    assert res["topology"].startswith("ba") or "ba" in res["topology"].lower()
    assert "n4_r8_s0" in json.loads(cache.read_text())
    assert np.isfinite(res["history"][-1]["loss"])


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])


def test_clip_by_global_norm_matches_jax():
    grads = _tree(4)
    for max_norm in (0.5, 100.0):                 # clipped, and left alone
        jg, jn = jopt.clip_by_global_norm(_tmap(jnp.asarray, grads), max_norm)
        tg, tn = topt.clip_by_global_norm(_tmap(torch.from_numpy, grads), max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        _assert_tree_close(tg, jg, 1e-6)


def test_classification_substrate_bit_identical():
    jX, jy = jdata.make_classification_data(num_classes=4, dim=8, samples_per_class=20, seed=3)
    tX, ty = tdata.make_classification_data(num_classes=4, dim=8, samples_per_class=20, seed=3)
    assert np.array_equal(jX, tX) and np.array_equal(jy, ty)
    jparts = jdata.class_balanced_partition(jy, 3, seed=1)
    tparts = tdata.class_balanced_partition(ty, 3, seed=1)
    assert all(np.array_equal(a, b) for a, b in zip(jparts, tparts))
    assert np.array_equal(jdata.epoch_permutations(jparts, 2, 4, seed=5),
                          tdata.epoch_permutations(tparts, 2, 4, seed=5))


def test_launcher_node_scenario_caches_under_its_bandwidths(tmp_path, table_dir):
    cache = tmp_path / "topo_cache_torch.json"
    res = ttrain.main(["--arch", "smollm-135m", "--reduced", "--workers", "4", "--steps", "1",
                       "--device", "cpu", "--seq", "16", "--r", "4", "--node-bw", "10,10,5,1",
                       "--topo-cache", str(cache)])
    assert "n4_r4_s0_bw10,10,5,1" in json.loads(cache.read_text())
    assert res["edges"] <= 4 and np.isfinite(res["history"][-1]["loss"])
