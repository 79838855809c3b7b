"""The port's serving of the moe, vlm, audio and hybrid families against the
JAX package's, on the CPU, at reduced sizes.

The same weights (the JAX package's init, carried by ``convert``), the same
prompts and the same stub frontend embeddings (numpy, from a seed) go
through both packages. The JAX side runs its Pallas ``decode_attention``
kernel in interpret mode (``use_kernel=True``), as its own kernel tests
do; on the CPU the port's kernel wrappers take their plain versions.

Tolerances (those of ``tests/test_torch_serve.py``): prefill and decode
logits and caches of float32 models within 1e-5 relative to the largest
magnitude of the compared array (matmul and softmax sums in other orders);
greedy tokens equal; caches carried through ``convert`` bit for bit.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.launch import serve as jserve_cli  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import ServeConfig, ServingEngine  # noqa: E402

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the small ops lose to an oversubscribed pool
    when the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |err| {err} > {rel} × {scale}"


def _models(arch, seed=3):
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced_for_smoke(get_arch(arch))
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.model_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _prefix(cfg):
    return cfg.frontend_tokens if cfg.arch_type == "vlm" else 0


FIELDS = ("kv", "ssm", "shared_kv", "cross_kv")

MODEL_CASES = [("granite-moe-1b-a400m", False), ("mixtral-8x22b", False),
               ("internvl2-1b", False), ("whisper-tiny", False), ("zamba2-2.7b", False),
               ("zamba2-2.7b", True)]


@pytest.mark.parametrize("arch,long_context", MODEL_CASES)
def test_prefill_and_decode_match_jax(arch, long_context):
    """Prefill logits and every cache field, then 4 decode steps from the JAX
    prefill's caches carried across, and the caches after them. vlm and
    audio take 8 stub embeddings; mixtral windows every layer (16 of a
    28-slot cache); zamba2 with ``long_context`` writes its shared block's
    cache as a ring of the 20 prompt positions, which the decode wraps."""
    jcfg, tcfg, jparams, tparams = _models(arch)
    S = 20
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.frontend_tokens:
        emb = rng.standard_normal((2, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
        jbatch["embeds"], tbatch["embeds"] = jnp.asarray(emb), torch.from_numpy(emb)
    cap = None if long_context else S + _prefix(jcfg) + 8
    jlog, jcaches = jtr.prefill(jparams, jcfg, jbatch, cache_cap=cap, long_context=long_context)
    tlog, tcaches = ttr.prefill(tparams, tcfg, tbatch, cache_cap=cap, long_context=long_context)
    _close(tlog.numpy(), jlog)
    jnp_caches = jax.tree.map(np.asarray, jcaches)
    for name in FIELDS:
        want, got = getattr(jnp_caches, name), getattr(tcaches, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _close(g.numpy(), w)

    caches = convert.caches_from_numpy(jnp_caches, "cpu")
    tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1)[:, None].astype(np.int32)
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(
        p, jcfg, t, c, pos, long_context=long_context, use_kernel=True))
    pos0 = S + _prefix(jcfg)
    for pos in range(pos0, pos0 + 4):
        jl, jcaches = step(jparams, jnp.asarray(tok), jcaches, jnp.asarray(pos, jnp.int32))
        tl, caches = ttr.decode_step(tparams, tcfg, torch.from_numpy(tok), caches, pos,
                                     long_context=long_context)
        _close(tl.numpy(), jl)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None].astype(np.int32)
    for name in FIELDS:
        for g, w in zip(getattr(caches, name), getattr(jcaches, name)):
            _close(g.numpy(), w)


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-tiny"])
def test_engine_greedy_tokens_match_jax_with_extra_inputs(arch):
    """``ServingEngine.generate`` with the stub embeddings in ``extra_inputs``
    (numpy, as the reference takes them): the reference engine's greedy
    tokens; the vlm decode starts after the patch prefix."""
    jcfg, tcfg, jparams, tparams = _models(arch, seed=0)
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, jcfg.vocab_size, (2, 10)).astype(np.int32)
    extra = {"embeds": rng.standard_normal((2, jcfg.frontend_tokens, jcfg.d_model))
             .astype(np.float32)}
    kw = dict(batch_size=2, cache_len=10 + _prefix(jcfg) + 8, max_new_tokens=6)
    want = JServingEngine(jcfg, jparams, JServeConfig(use_kernel=True, **kw),
                          eos_id=-1).generate(prompts, extra_inputs=extra)
    got = ServingEngine(tcfg, tparams, ServeConfig(**kw), eos_id=-1).generate(
        prompts, extra_inputs=extra)
    assert got.dtype == np.int32 and np.array_equal(got, want)


def _reference_launcher_inputs(monkeypatch, argv) -> dict:
    """The prompts and stub embeddings the reference launcher hands its
    engine for ``argv`` (its engine replaced by a recorder)."""
    seen = {}

    class Recorder:
        def __init__(self, *a, **k):
            pass

        def generate(self, prompts, extra_inputs=None, seed=0):
            seen.update(prompts=prompts, extra=extra_inputs)
            return np.zeros((prompts.shape[0], 1), np.int32)

    monkeypatch.setattr(jserve_cli, "ServingEngine", Recorder)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve_cli.main()
    return seen


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-1b", "whisper-tiny",
                                  "zamba2-2.7b"])
def test_serve_cli_reduced_on_cpu(arch, monkeypatch):
    """The port's launcher serves each family reduced on the CPU: tokens in
    the vocabulary, and the prompts and stub embeddings it hands its engine
    are the arrays the reference launcher draws for the same seed."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8", "--max-new",
            "4", "--seed", "3"]
    seen = {}
    real = ServingEngine.generate

    def recording(self, prompts, extra_inputs=None, seed=0):
        seen.update(prompts=prompts, extra=extra_inputs)
        return real(self, prompts, extra_inputs=extra_inputs, seed=seed)

    monkeypatch.setattr(ServingEngine, "generate", recording)
    res = tserve_cli.main(argv + ["--device", "cpu"])
    toks = np.array(res["tokens"])
    cfg = reduced_for_smoke(get_arch(arch))
    assert toks.shape == (2, 4) and (toks >= 0).all() and (toks < cfg.vocab_size).all()
    assert res["vocab_size"] == cfg.vocab_size and len(res["step_ms"]) == 3
    want = _reference_launcher_inputs(monkeypatch, argv)
    assert np.array_equal(seen["prompts"], want["prompts"])
    if cfg.frontend_tokens:
        assert seen["extra"]["embeds"].shape == (2, cfg.frontend_tokens, cfg.d_model)
        assert np.array_equal(seen["extra"]["embeds"], want["extra"]["embeds"])
    else:
        assert seen["extra"] is None and want["extra"] is None


def test_vlm_default_cache_len_counts_the_patch_prefix():
    """A deviation from the reference: the launcher's default cache holds
    the prompt, the patch prefix, the new tokens and 8 spare. The
    reference's default (prompt + new + 8) leaves the prefix out, so at
    internvl2's 256 patches its prefill writes a ring cache of the last C
    positions."""
    full = get_arch("internvl2-1b")
    assert tserve_cli.default_cache_len(full, 768, 64) == 768 + 256 + 64 + 8
    assert tserve_cli.default_cache_len(get_arch("smollm-135m"), 768, 64) == 768 + 64 + 8
    res = tserve_cli.main(["--arch", "internvl2-1b", "--reduced", "--batch", "2",
                           "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    cfg = reduced_for_smoke(full)
    assert res["cache_len"] == 8 + cfg.frontend_tokens + 4 + 8
    # the reference's default at main_serve_vlm's width: 840 slots for 1,024
    # prefill positions
    reference_default = 768 + 64 + 8
    assert reference_default < 768 + full.frontend_tokens


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-tiny"])
def test_caches_round_trip_through_convert_keep_bf16_bits(arch):
    """Hybrid (ssm + shared_kv) and audio (kv + cross_kv) caches in bf16
    carried to the port and back, bit for bit."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), dtype="bfloat16")
    jc = jtr.init_caches(jcfg, 2, 8)
    rng = np.random.default_rng(0)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jc)
    tc = convert.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    back = convert.caches_to_numpy(tc)
    for name in FIELDS:
        want, got, port = getattr(jc, name), getattr(back, name), getattr(tc, name)
        assert len(port) == len(got) == len(want), name
        for t, g, w in zip(port, got, want):
            assert t.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32)
            assert np.array_equal(g, np.asarray(w, np.float32))
    assert len(tc.shared_kv if arch.startswith("zamba2") else tc.cross_kv) == 2


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-1b", "whisper-tiny",
                                  "zamba2-2.7b"])
def test_params_carry_every_family_leaf_bf16(arch):
    """``model_params_from_numpy`` takes the moe leaves, ``shared_attn``,
    ``enc_layers``/``enc_norm`` and ``frontend_proj`` bit for bit, into the
    layout the port's ``init_params`` builds."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), dtype="bfloat16")
    tcfg = dataclasses.replace(reduced_for_smoke(get_arch(arch)), dtype="bfloat16")
    jparams = jtr.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.model_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    own = ttr.init_params(0, tcfg)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(jflat) == len(torch.utils._pytree.tree_leaves(own))
    for path, leaf in jflat.items():
        keys = [p.key for p in path]
        got, mine = tparams, own
        for k in keys:
            got, mine = got[k], mine[k]
        assert got.dtype == mine.dtype and tuple(got.shape) == tuple(mine.shape) == leaf.shape
        assert np.array_equal(got.float().numpy(), np.asarray(leaf, np.float32))
    assert ttr.param_count(tparams) == ttr.param_count(own)
