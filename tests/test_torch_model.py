"""The port's dense transformer against the JAX package's, on the CPU.

The same weights (the JAX package's init, carried by ``convert``) and the
same token batches (numpy, from a seed) go through both packages'
``train_loss`` and its gradient: the JAX side by ``jax.value_and_grad``,
the port by ``torch.func.grad_and_value``, as its trainer takes them.

Cases: reduced smollm-135m at S = 64 (``attend_full``), at S = 256
(``attend_chunked``) and with the loss taken over 16-token chunks; reduced
gemma2-9b at S = 64 and 256, which adds the attention and final-logit
softcaps, the alternating local/global windows and the √d embedding scale.
Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 × its largest magnitude (float32 throughout; the sums of matmuls and
softmaxes are taken in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

CASES = [("smollm-135m", 64, None), ("smollm-135m", 256, None), ("smollm-135m", 64, 16),
         ("gemma2-9b", 64, None), ("gemma2-9b", 256, None)]


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    labels[0, S // 3] = -100                     # an ignored position mid-sequence
    return toks, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,S,loss_chunk", CASES)
def test_train_loss_and_grads_match_jax(arch, S, loss_chunk):
    jcfg = jreduced(jget_arch(arch))
    tcfg = reduced_for_smoke(get_arch(arch))
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f) for f in jcfg.__dataclass_fields__})
    jparams = jtr.init_params(jax.random.PRNGKey(S), jcfg)
    toks, labels = _batch(jcfg, 2, S, seed=S)

    def jloss(p):
        return jtr.train_loss(p, jcfg, {"tokens": jax.numpy.asarray(toks),
                                        "labels": jax.numpy.asarray(labels)},
                              loss_chunk=loss_chunk)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    tparams = convert.model_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    grads, loss = torch.func.grad_and_value(
        lambda p: ttr.train_loss(p, tcfg, batch, loss_chunk=loss_chunk))(tparams)

    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = _flat(jax.tree.map(np.asarray, want_grads))
    got = _flat(grads)
    assert set(got) == set(want)
    for k, g in got.items():
        scale = float(np.abs(want[k]).max())
        assert np.abs(g.numpy() - want[k]).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-9b", "qwen1.5-0.5b", "minitron-8b"])
def test_init_layout_and_windows_match_jax(arch):
    """The same leaves, shapes and dtypes as the reference's init, and the
    same per-layer windows."""
    jcfg = jreduced(jget_arch(arch))
    tcfg = reduced_for_smoke(get_arch(arch))
    jshapes = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), jcfg))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(jshapes).items()}
    params = ttr.init_params(0, tcfg)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(params).items()}
    assert got == want
    assert ttr.param_count(params) == sum(int(np.prod(s)) for s, _ in want.values())
    assert ttr.layer_windows(tcfg) == [int(w) for w in jtr.layer_windows(jcfg)]
    assert ttr.loss_chunk_for(tcfg, 4) == jtr.loss_chunk_for(jcfg, 4)


def test_full_smollm_param_count():
    """134,515,008 parameters per worker in 11 leaves, from the shapes alone."""
    cfg = get_arch("smollm-135m")
    jshapes = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0),
                                                     jget_arch("smollm-135m")))
    leaves = _flat(jshapes)
    assert len(leaves) == 11
    assert sum(int(np.prod(v.shape)) for v in leaves.values()) == 134_515_008
    hd = cfg.resolved_head_dim
    per_layer = (2 * cfg.d_model + cfg.d_model * cfg.num_heads * hd * 2
                 + cfg.d_model * cfg.num_kv_heads * hd * 2 + 3 * cfg.d_model * cfg.d_ff)
    assert cfg.vocab_size * cfg.d_model + cfg.num_layers * per_layer + cfg.d_model \
        == 134_515_008


def test_configs_copied():
    from repro.configs import ARCHS as JARCHS

    assert ARCHS.keys() == JARCHS.keys()
    for name, cfg in ARCHS.items():
        assert cfg.__dict__ == JARCHS[name].__dict__


def test_attn_cache_raises():
    """A KV cache whose batch or head layout does not fit the keys is refused."""
    from repro_torch.models.attention import attn_forward, init_attn, init_kv_cache

    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    params = init_attn(torch.Generator().manual_seed(0), cfg, torch.float32)
    cache = init_kv_cache(2, 8, cfg.num_kv_heads, cfg.resolved_head_dim, torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        attn_forward(params, torch.zeros((1, 4, cfg.d_model)), cfg, cache=cache)


def test_bf16_weights_round_trip_through_convert():
    """bfloat16 leaves keep their bits from the JAX package to the port and
    come back as the same values in float32."""
    import dataclasses

    jcfg = dataclasses.replace(jreduced(jget_arch("smollm-135m")), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(1), jcfg))
    tparams = convert.model_params_from_numpy(jparams, "cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    back = _flat(convert.model_params_to_numpy(tparams))
    for k, v in _flat(jparams).items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v.astype(np.float32)), k
