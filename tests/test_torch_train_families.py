"""The port's training of the moe, vlm, audio, ssm and hybrid families
against the JAX package's, on the CPU, at reduced sizes.

The same weights (the JAX package's init, carried by ``convert``) and the
same batches (numpy, from a seed; S = 64, so the reduced ssm and hybrid
cross their 32-token chunk boundary) go through both packages. The JAX side
trains ssm and hybrid on its einsum route, as its ``train_loss`` does; the
port takes the ``ssd_intra_chunk`` wrapper (its plain version on the CPU)
and that wrapper's hand-derived backward.

Tolerances, float32 throughout (matmul, softmax and scan sums in other
orders; the gradients also pass through two autodiff systems):
- ``train_loss`` within 1e-5 relative, with the MoE aux term at weights
  0.01 and 1 (measured: at most 1.6e-7);
- every gradient leaf within 1e-4 of the leaf's largest magnitude
  (measured: at most 4.3e-6, mamba2);
- two ``dsgd_train_step`` steps at n = 4 on a ring: losses and consensus
  error within 1e-5 relative, parameters and momentum within 1e-4;
- the MoE's ``vmap(grad_and_value)`` equal to a per-worker loop, bit for bit.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.core.topologies import make_baseline  # noqa: E402
from repro.dsgd import trainer as jtrainer  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.dsgd import trainer as ttrainer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

S = 64
LOSS_REL = 1e-5
GRAD_REL = 1e-4
ALL = ["granite-moe-1b-a400m", "mixtral-8x22b", "internvl2-1b", "whisper-tiny",
       "mamba2-780m", "zamba2-2.7b"]
FAMILIES = ["granite-moe-1b-a400m", "internvl2-1b", "whisper-tiny", "mamba2-780m",
            "zamba2-2.7b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the small ops lose to an oversubscribed pool
    when the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def table_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "TABLE_DIR", tmp_path / "bigram")
    monkeypatch.setattr(tdata, "_TABLES", {})
    return tmp_path / "bigram"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                                         else v, np.float64)
    return out


def _assert_leaves_close(got, want, rel):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * scale, f"{k}: max |err| {err} > {rel} × {scale}"


def _models(arch, seed=3):
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced_for_smoke(get_arch(arch))
    jparams = jax.jit(jtr.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.model_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, rng, lead=(2,)):
    toks = rng.integers(0, cfg.vocab_size, lead + (S,)).astype(np.int32)
    labels = np.concatenate([toks[..., 1:], np.full(lead + (1,), -100, np.int32)], axis=-1)
    batch = {"tokens": toks, "labels": labels}
    if cfg.frontend_tokens:
        batch["embeds"] = rng.standard_normal(
            lead + (cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_train_loss_and_grads_match_jax(arch):
    """``train_loss`` and every parameter's gradient against
    ``jax.value_and_grad(repro.models.train_loss)``. For the MoE the aux
    term counts at both weights (so a wrong aux cannot hide under 0.01)."""
    jcfg, tcfg, jparams, tparams = _models(arch)
    batch = _batch(jcfg, np.random.default_rng(11))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    weights = (0.01, 1.0) if jcfg.num_experts else (0.01,)
    jfn = jax.jit(jax.value_and_grad(lambda p, w: jtr.train_loss(p, jcfg, jb, aux_weight=w)))
    for w in weights:
        jloss, jgrad = jfn(jparams, w)
        tgrad, tloss = torch.func.grad_and_value(
            lambda p: ttr.train_loss(p, tcfg, tb, aux_weight=w))(tparams)
        assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss)), (w, tloss, jloss)
        _assert_leaves_close(tgrad, jax.tree.map(np.asarray, jgrad), GRAD_REL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_moe_aux_joins_the_loss(arch):
    """train_loss(aux_weight = w) − train_loss(0) = w · the stack's aux sum,
    and that sum is a positive float32 scalar."""
    _, tcfg, _, tparams = _models(arch)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, np.random.default_rng(2)).items()}
    _, aux, _, _ = ttr._forward_seq(tparams, tcfg, tb)
    assert aux.dtype == torch.float32 and aux.dim() == 0 and float(aux) > 0
    base = ttr.train_loss(tparams, tcfg, tb, aux_weight=0.0)
    for w in (0.01, 0.5):
        got = ttr.train_loss(tparams, tcfg, tb, aux_weight=w)
        assert abs(float(got - base) - w * float(aux)) <= 1e-6 * float(got)


def test_vlm_loss_skips_the_patch_positions():
    """internvl2's loss is the mean nll over the text positions only: the
    stub patches' hidden states are cut off before the unembedding."""
    _, tcfg, _, tparams = _models("internvl2-1b")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, np.random.default_rng(4)).items()}
    x, _, _, n_prefix = ttr._forward_seq(tparams, tcfg, tb)
    assert n_prefix == tcfg.frontend_tokens and x.shape[1] == S + n_prefix
    tot, cnt = ttr._nll_sum(tparams, x[:, n_prefix:], tb["labels"], tcfg)
    assert torch.equal(ttr.train_loss(tparams, tcfg, tb), tot / cnt)


# ---------------------------------------------------------------------------
# the vmapped gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_moe_vmapped_grads_equal_a_worker_loop_bitwise(arch):
    """The trainer's ``vmap(grad_and_value(train_loss))`` over three
    workers' own weights and batches equals the per-worker call bit for bit
    in float32: the dispatch's out-of-place ``index_put``, stable sort,
    ``cumsum``, ``gather`` and the combine's indexing all batch, and the
    capacity is each worker's own."""
    tcfg = reduced_for_smoke(get_arch(arch))
    n = 3
    per = [ttr.init_params(i, tcfg) for i in range(n)]
    params = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs), *per)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, rng, lead=(n, 2)).items()}
    fn = torch.func.grad_and_value(lambda p, b: ttr.train_loss(p, tcfg, b))
    grads, losses = torch.func.vmap(fn)(params, batch)
    for i in range(n):
        gi, li = fn(per[i], {k: v[i] for k, v in batch.items()})
        assert torch.equal(losses[i], li)
        for (k, a), b in zip(_flat(grads).items(), _flat(gi).values()):
            assert np.array_equal(a[i], b), (i, k)


# ---------------------------------------------------------------------------
# DSGD steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_two_dsgd_steps_match_jax(arch, table_dir):
    """Two ``dsgd_train_step`` steps at n = 4 on a ring from the same weights
    (the port's init, carried to JAX) and the launcher's batches (vlm and
    audio with their stub embeddings). The port gossips through its kernel
    wrapper (the plain version on the CPU), the JAX package by its dense W
    matmul: the Pallas kernel's interpret mode would double the compile,
    and ``test_torch_dsgd.py`` holds the two gossips to each other."""
    n, steps = 4, 2
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced_for_smoke(get_arch(arch))
    topo = make_baseline("ring", n)
    _, j_upd = jopt.make_optimizer("sgd", jsched.warmup_cosine(0.05, 1, steps))
    t_init, t_upd = topt.make_optimizer("sgd", tsched.warmup_cosine(0.05, 1, steps))
    tstate = ttrainer.init_dsgd_state(7, tcfg, n, t_init, device="cpu")
    to_j = lambda tree: jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)  # noqa: E731
    jstate = jtrainer.DSGDState(to_j(tstate.params),
                                jopt.SGDState(to_j(tstate.opt.momentum), to_j(tstate.opt.step)),
                                to_j(tstate.step))
    jstep = jtrainer.dsgd_train_step(jcfg, topo, j_upd)
    tstep = ttrainer.dsgd_train_step(tcfg, topo, t_upd, use_kernel=True, device="cpu")
    dc = tdata.DataConfig(vocab_size=tcfg.vocab_size, seq_len=S, batch_size=2, seed=0,
                          frontend_tokens=tcfg.frontend_tokens, d_model=tcfg.d_model)
    for s in range(steps):
        per = [tdata.lm_batch_numpy(dc, s, node=i) for i in range(n)]
        batch = {k: np.stack([b[k] for b in per]) for k in per[0]}
        assert ("embeds" in batch) == bool(tcfg.frontend_tokens)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "loss_max", "consensus_err"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (s, k)
    want = jax.tree.map(np.asarray, jstate)
    _assert_leaves_close(tstate.params, want.params, 1e-4)
    _assert_leaves_close(tstate.opt.momentum, want.opt.momentum, 1e-4)


@pytest.mark.parametrize("arch", ["mamba2-780m", "internvl2-1b"])
def test_launcher_trains_the_family_on_cpu(arch, tmp_path, table_dir):
    """``launch/train.py --arch <family> --reduced --device cpu``: finite
    losses that start near ln V, the per-worker parameter count of the
    reduced config, and ``--json-out`` equal to what ``main`` returns."""
    out = tmp_path / "run.json"
    res = ttrain.main(["--arch", arch, "--reduced", "--workers", "4", "--steps", "3",
                       "--device", "cpu", "--topo", "ring", "--seq", str(S), "--batch", "2",
                       "--log-every", "1", "--json-out", str(out)])
    data = json.loads(out.read_text())
    assert data["history"] == res["history"] and len(data["history"]) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["consensus_err"])
               for h in data["history"])
    assert abs(data["history"][0]["loss"] - np.log(512)) < 0.5
    cfg = reduced_for_smoke(get_arch(arch))
    assert data["param_count_per_worker"] == ttr.param_count(ttr.init_params(0, cfg))
