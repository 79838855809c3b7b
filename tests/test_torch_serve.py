"""The port's serving path (dense family) against the JAX package's, on the CPU.

The same weights (the JAX package's init, carried by ``convert``), the same
prompts and the same inputs (numpy, from a seed) go through both packages.
The JAX side runs its Pallas ``decode_attention`` kernel in interpret mode
(``use_kernel=True``), as its own kernel tests do; on the CPU the port's
kernel wrapper takes its plain version.

Tolerances, and why:
- ``decode_attention``: float32 output within the first-order float32
  bound of ``decode_attention_bound`` (2⁻²⁴·(2·hd·A + C + hd)·Σ p|v|: the
  two sides take the score dot and the sums over keys in other orders);
  bfloat16 output within one bfloat16 ulp of the larger result plus that
  bound (a float32 difference below it can still flip one rounding).
- Layers, prefill and decode (float32 models): 1e-5 relative to the
  largest magnitude of the compared array (matmul and softmax sums in
  other orders).
- Greedy tokens: equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.kernels.decode_attention import ops as jdec  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.checkpoint import CheckpointError, save_checkpoint  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdec  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import (DecodeState, ServeConfig, ServingEngine,  # noqa: E402
                               greedy_sample, make_functional_serve_step)

REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |err| {err} > {rel} × {scale}"


def _cfgs(arch):
    return jreduced(jget_arch(arch)), reduced_for_smoke(get_arch(arch))


def _to_t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _bf16_ulp(x):
    _, e = torch.frexp(x)
    return torch.ldexp(torch.full_like(x, torch.finfo(torch.bfloat16).eps), e - 1)


# ---------------------------------------------------------------------------
# decode_attention: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _valid(kind, C, rng):
    idx = np.arange(C)
    if kind == "full":
        return np.ones(C, bool)
    if kind == "window":          # a window that masks the early positions
        return (idx <= C - 5) & (idx > C - 5 - 300)
    if kind == "ring":            # a wrapped ring buffer: slot 17, all valid
        return np.ones(C, bool) if C <= 64 else (idx <= 17) | (rng.random(C) < 0.5)
    if kind == "last_only":       # a valid key only in the last 512-key block
        return idx == C - 1
    raise ValueError(kind)


DEC_CASES = [("float32", 0.0, "full", 37), ("float32", 50.0, "window", 600),
             ("bfloat16", 0.0, "ring", 100), ("bfloat16", 50.0, "window", 700),
             ("float32", 0.0, "last_only", 520)]


@pytest.mark.parametrize("dtype,cap,kind,C", DEC_CASES)
def test_decode_attention_plain_matches_pallas(dtype, cap, kind, C):
    rng = np.random.default_rng(C)
    B, Hkv, group, hd = 2, 2, 3, 64
    q = rng.standard_normal((B, Hkv * group, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, hd)).astype(np.float32)
    valid = _valid(kind, C, rng)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    want = np.asarray(jdec.decode_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                            jnp.asarray(v, jd), jnp.asarray(valid),
                                            attn_softcap=cap, use_kernel=True)
                      .astype(jnp.float32))
    qt, kt, vt = _to_t(q, td), _to_t(k, td), _to_t(v, td)
    got = kernels.WRAPPERS["decode_attention"](qt, kt, vt, _to_t(valid), attn_softcap=cap)
    assert got.dtype == td and tuple(got.shape) == (B, Hkv * group, hd)
    got, want = got.float(), torch.from_numpy(want.copy())
    bound = tdec.decode_attention_bound(qt, kt, vt, _to_t(valid), attn_softcap=cap)
    if td == torch.bfloat16:
        bound = bound + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def test_decode_attention_with_no_valid_key_is_ref_py():
    """A row with no valid key is the plain average of its C values, as
    ``ref.py``'s softmax of an all −1e30 row gives. (The Pallas wrapper pads
    C to 512 with zero values first and so averages over 512 slots; serving
    never meets such a row, since a token always sees its own slot.)"""
    rng = np.random.default_rng(40)
    q = rng.standard_normal((2, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    valid = np.zeros(40, bool)
    want = np.asarray(jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(valid), use_kernel=False))
    got = tdec.decode_attention(_to_t(q), _to_t(k), _to_t(v), _to_t(valid))
    _close(got.numpy(), want)
    _close(got.numpy(), np.repeat(v.mean(axis=1), 2, axis=1))


def test_decode_attention_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        tdec.decode_attention(q, torch.zeros(2, 8, 3, 64), torch.zeros(2, 8, 3, 64),
                              torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match=r"valid must be \(C,\)"):
        tdec.decode_attention(q, torch.zeros(2, 8, 2, 64), torch.zeros(2, 8, 2, 64),
                              torch.ones(9, dtype=torch.bool))
    with pytest.raises(TypeError, match="one dtype"):
        tdec.decode_attention(q, torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16),
                              torch.zeros(2, 8, 2, 64), torch.ones(8, dtype=torch.bool))


def test_num_splits_fills_the_card_and_keeps_128_keys():
    """The plan's splits: one wave of 132 SMs at smollm's and gemma2's
    serving shapes (gemma2's hd 256 runs two blocks an SM), at least 128
    keys a split, one split where the blocks fill the card already."""
    smollm = tdec.decode_plan(16, 9, 3, 64, 2184, 2, 132)
    assert (smollm.splits, smollm.head_blocks) == (8, 1)                # 128 blocks
    gemma2 = tdec.decode_plan(4, 16, 8, 256, 4224, 2, 132)
    assert 4 * gemma2.head_blocks * gemma2.splits == 256                # two an SM
    assert smollm.span >= 128 and gemma2.span >= 128
    assert tdec.decode_plan(1, 1, 1, 64, 100, 2, 132).splits == 1       # short cache
    assert tdec.decode_plan(256, 8, 8, 128, 4096, 2, 132).splits == 1   # many blocks


@pytest.mark.parametrize("B,Hq,Hkv,hd,C,size", [
    (16, 9, 3, 64, 2184, 2), (4, 16, 8, 256, 4224, 2), (4, 16, 8, 256, 4224, 4),
    (4, 16, 8, 256, 4096, 2), (2, 8, 2, 128, 700, 2), (2, 4, 1, 32, 40, 4),
    (3, 12, 2, 64, 129, 2), (1, 1, 1, 64, 100, 2), (64, 8, 8, 128, 4096, 2),
    (2, 32, 1, 128, 512, 2), (1, 14, 2, 64, 300, 2), (2, 6, 2, 64, 20, 2),
    (8, 32, 32, 80, 1096, 2), (8, 32, 32, 80, 1096, 4), (2, 4, 2, 80, 10, 2),
    (16, 14, 2, 64, 1096, 2), (1, 7, 1, 80, 2000, 4), (16, 16, 8, 64, 1096, 2),
    (16, 6, 6, 64, 200, 4),
])
def test_decode_plan_covers_every_key_and_head_once(B, Hq, Hkv, hd, C, size):
    """Every key lies in exactly one split and every query head in exactly
    one unit of one head block, with no padded head (a group of 7 too); a
    key's lanes are a power of two that holds its row (hd 80: 16 lanes in
    bf16, 32 in fp32, the last ones idle); the blocks fill a wave
    of 132 SMs where 128-key splits allow it; the block fits the card."""
    p = tdec.decode_plan(B, Hq, Hkv, hd, C, size, 132)
    group = Hq // Hkv
    assert group % p.gn == 0 and p.gn <= 4
    keys = np.zeros(C, dtype=int)
    for s in range(p.splits):
        keys[s * p.span:min(C, (s + 1) * p.span)] += 1
    assert (keys == 1).all() and (p.splits - 1) * p.span < C
    heads = np.zeros(Hq, dtype=int)
    qcn = group // p.gn
    for hc in range(p.head_blocks):
        h0, qc0 = (hc // (qcn // p.qpb)) * p.hb, (hc % (qcn // p.qpb)) * p.qpb
        for u in range(p.hb * p.qpb):
            first = (h0 + u // p.qpb) * group + (qc0 + u % p.qpb) * p.gn
            heads[first:first + p.gn] += 1
    assert (heads == 1).all()
    lpk = tdec.lanes_per_key(hd, size)
    vectors = hd * size // 16                  # 16-byte vectors of a row: one a lane
    assert lpk & (lpk - 1) == 0 and vectors <= lpk < 2 * vectors or lpk == 32
    assert p.threads == p.hb * p.qpb * p.lgu * lpk and p.threads % 32 == 0
    assert p.threads <= (tdec.MAX_THREADS_256 if hd >= 256 else tdec.MAX_THREADS)
    assert p.kt == tdec.KPL * p.lgu
    assert 3 <= p.stages <= tdec.MAX_STAGES and p.smem <= tdec.SMEM_BYTES
    assert p.smem >= tdec.BAR_BYTES + p.span + p.stages * 2 * p.kt * p.hb * hd * size
    blocks = B * p.head_blocks * p.splits
    slots = 132 * (2 if hd >= 256 else 1)
    if B * p.head_blocks * -(-C // 128) >= slots:
        assert blocks / (-(-blocks // slots) * slots) >= 0.9   # the last wave 90 % full


# ---------------------------------------------------------------------------
# attention with a cache
# ---------------------------------------------------------------------------

def _attn_setup(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    jp = jattn.init_attn(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("C", [24, 10])       # linear (C ≥ S) and ring (C < S) writes
def test_attn_forward_cache_write_matches_jax(C):
    jcfg, tcfg, jp, tp = _attn_setup("gemma2-9b", C)
    S, hd = 20, tcfg.resolved_head_dim
    x = np.random.default_rng(C).standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    jcache = jattn.init_kv_cache(2, C, jcfg.num_kv_heads, hd, jnp.float32)
    jout, jnew = jattn.attn_forward(jp, jnp.asarray(x), jcfg, window=jcfg.sliding_window,
                                    cache=jcache)
    tcache = tattn.init_kv_cache(2, C, tcfg.num_kv_heads, hd, torch.float32)
    tout, tnew = tattn.attn_forward(tp, _to_t(x), tcfg, window=tcfg.sliding_window,
                                    cache=tcache)
    assert tnew.k is tcache.k                      # written in place
    _close(tout.numpy(), jout)
    _close(tnew.k.numpy(), jnew.k)
    _close(tnew.v.numpy(), jnew.v)


@pytest.mark.parametrize("ring,window,pos", [(False, 0, 13), (False, 6, 13), (True, 0, 13),
                                             (True, 0, 5)])
def test_attn_decode_matches_jax(ring, window, pos):
    jcfg, tcfg, jp, tp = _attn_setup("gemma2-9b", pos)
    C, hd = 10 if ring else 16, tcfg.resolved_head_dim
    rng = np.random.default_rng(pos + 7 * ring)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    k0 = rng.standard_normal((2, C, tcfg.num_kv_heads, hd)).astype(np.float32)
    v0 = rng.standard_normal((2, C, tcfg.num_kv_heads, hd)).astype(np.float32)
    jout, jnew = jattn.attn_decode(jp, jnp.asarray(x), jcfg,
                                   jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0)),
                                   jnp.asarray(pos, jnp.int32), window=window, ring=ring,
                                   use_kernel=True)
    tcache = tattn.KVCache(_to_t(k0.copy()), _to_t(v0.copy()))
    tout, tnew = tattn.attn_decode(tp, _to_t(x), tcfg, tcache, pos, window=window, ring=ring)
    _close(tout.numpy(), jout)
    _close(tnew.k.numpy(), jnew.k)
    _close(tnew.v.numpy(), jnew.v)


# ---------------------------------------------------------------------------
# prefill and decode_step of whole models
# ---------------------------------------------------------------------------

MODEL_CASES = [("smollm-135m", False, 24), ("gemma2-9b", False, 40), ("gemma2-9b", True, None)]


@pytest.mark.parametrize("arch,long_context,cache_cap", MODEL_CASES)
def test_prefill_and_decode_match_jax(arch, long_context, cache_cap):
    """Prefill logits and caches, then 4 decode steps from the JAX prefill's
    cache carried across (gemma2: local/global windows and both softcaps;
    with ``long_context`` every layer windowed and a ring cache of the
    window, C = 16 < S = 20)."""
    jcfg, tcfg = _cfgs(arch)
    jparams = jtr.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = convert.model_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    S = 20
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jlog, jcaches = jtr.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                cache_cap=cache_cap, long_context=long_context)
    tlog, tcaches = ttr.prefill(tparams, tcfg, {"tokens": _to_t(toks)},
                                cache_cap=cache_cap, long_context=long_context)
    _close(tlog.numpy(), jlog)
    _close(tcaches.kv.k.numpy(), jcaches.kv.k)
    _close(tcaches.kv.v.numpy(), jcaches.kv.v)
    if long_context:
        assert tcaches.kv.k.shape[2] == tcfg.sliding_window < S

    caches = convert.caches_from_numpy(jax.tree.map(np.asarray, jcaches), "cpu")
    tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1)[:, None].astype(np.int32)
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(
        p, jcfg, t, c, pos, long_context=long_context, use_kernel=True))
    for pos in range(S, S + 4):
        jl, jcaches = step(jparams, jnp.asarray(tok), jcaches, jnp.asarray(pos, jnp.int32))
        tl, caches = ttr.decode_step(tparams, tcfg, _to_t(tok), caches, pos,
                                     long_context=long_context)
        _close(tl.numpy(), jl)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None].astype(np.int32)
    _close(caches.kv.k.numpy(), jcaches.kv.k)


def test_decode_matches_prefill_continuation():
    """decode_step over the prompt from empty caches reproduces prefill's
    final logits (the reference's own check, at its tolerance 2e-3)."""
    tcfg = reduced_for_smoke(get_arch("qwen1.5-0.5b"))
    params = ttr.init_params(0, tcfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, tcfg.vocab_size, (1, 12)))
    logits_p, _ = ttr.prefill(params, tcfg, {"tokens": toks}, cache_cap=16)
    caches = ttr.init_caches(tcfg, 1, 16)
    for t in range(12):
        logits_d, caches = ttr.decode_step(params, tcfg, toks[:, t:t + 1], caches, t)
    np.testing.assert_allclose(logits_p[:, -1].numpy(), logits_d[:, -1].numpy(),
                               atol=2e-3, rtol=2e-3)


def test_non_dense_serving_raises():
    """Serving and training of the non-dense families are both ported (the
    name is older than that; tests/test_torch_families.py and
    tests/test_torch_train_families.py hold them). Reduced mixtral (moe,
    every layer windowed) serves on the CPU with the long-context ring
    cache, its greedy tokens the reference engine's, and ``train_loss`` on
    the engine's weights equals the reference's, MoE aux term included,
    within 1e-5 relative."""
    kw = dict(batch_size=2, cache_len=16, max_new_tokens=6, long_context=True)
    jeng, teng = _engines("mixtral-8x22b", kw)
    prompts = np.random.default_rng(2).integers(1, 512, (2, 20)).astype(np.int32)
    got = teng.generate(prompts)
    assert got.shape == (2, 6) and np.array_equal(got, jeng.generate(prompts))
    toks = np.random.default_rng(3).integers(0, 512, (1, 24)).astype(np.int32)
    want = float(jtr.train_loss(jeng.params, jeng.cfg, {"tokens": jnp.asarray(toks),
                                                        "labels": jnp.asarray(toks)}))
    loss = ttr.train_loss(teng.params, teng.cfg, {"tokens": torch.from_numpy(toks),
                                                  "labels": torch.from_numpy(toks)})
    assert abs(float(loss) - want) <= 1e-5 * abs(want)


# ---------------------------------------------------------------------------
# the serving engine and the CLI
# ---------------------------------------------------------------------------

def _engines(arch, scfg_kw, eos_id=-1, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.model_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JServingEngine(jcfg, jparams, JServeConfig(use_kernel=True, **scfg_kw),
                          eos_id=eos_id)
    teng = ServingEngine(tcfg, tparams, ServeConfig(**scfg_kw), eos_id=eos_id)
    return jeng, teng


@pytest.mark.parametrize("arch,long_context", [("smollm-135m", False), ("gemma2-9b", True)])
def test_engine_greedy_tokens_match_jax(arch, long_context):
    kw = dict(batch_size=2, cache_len=24, max_new_tokens=6, long_context=long_context)
    jeng, teng = _engines(arch, kw)
    prompts = np.random.default_rng(0).integers(1, 512, (2, 12)).astype(np.int32)
    want = jeng.generate(prompts)
    got = teng.generate(prompts)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert len(teng.timings["step_s"]) == 5 and teng.timings["prefill_s"] > 0


def test_engine_eos_rule_and_batch_size_error():
    """After a request emits EOS all its further tokens are EOS, and the
    loop stops once every request is done — as the reference's engine."""
    kw = dict(batch_size=2, cache_len=32, max_new_tokens=8)
    jeng, teng = _engines("smollm-135m", kw)
    prompts = np.random.default_rng(0).integers(1, 512, (2, 8)).astype(np.int32)
    probe = teng.generate(prompts)
    eos = int(probe[0, 1])
    jeng, teng = _engines("smollm-135m", kw, eos_id=eos)
    got, want = teng.generate(prompts), jeng.generate(prompts)
    assert np.array_equal(got, want)
    row = got[0].tolist()
    k = row.index(eos)
    assert all(t == eos for t in row[k:])
    with pytest.raises(ValueError, match="batch_size=2"):
        teng.generate(prompts[:1])


def test_greedy_sample_with_temperature_draws_from_the_generator():
    logits = torch.randn(3, 1, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(greedy_sample(logits, None, 0.0)[:, 0], logits[:, 0].argmax(-1).int())
    a = greedy_sample(logits, torch.Generator().manual_seed(7), 1.0)
    b = greedy_sample(logits, torch.Generator().manual_seed(7), 1.0)
    assert a.dtype == torch.int32 and tuple(a.shape) == (3, 1) and torch.equal(a, b)
    draws = {tuple(greedy_sample(logits, torch.Generator().manual_seed(s), 5.0)[:, 0].tolist())
             for s in range(8)}
    assert len(draws) > 1


def test_functional_serve_step_runs():
    cfg = reduced_for_smoke(get_arch("qwen1.5-0.5b"))
    params = ttr.init_params(0, cfg)
    step = make_functional_serve_step(cfg, ServeConfig(batch_size=3, cache_len=32), eos_id=-1)
    state = DecodeState(tokens=torch.ones((3, 1), dtype=torch.int32),
                        caches=ttr.init_caches(cfg, 3, 32), pos=5, rng=None,
                        done=torch.zeros(3, dtype=torch.bool))
    out = step(params, state)
    assert tuple(out.tokens.shape) == (3, 1) and out.pos == 6
    assert out.caches.kv.k[:, :, 5].abs().sum() > 0          # slot 5 written in place


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m"])
def test_serve_cli_reduced_on_cpu(arch, tmp_path):
    out = tmp_path / "serve.json"
    res = tserve_cli.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                           "--max-new", "5", "--device", "cpu", "--json-out", str(out)])
    assert res["device"] == "cpu" and res["generated_per_request"] == 5
    assert np.array(res["tokens"]).shape == (2, 5) and len(res["step_ms"]) == 4
    assert res["prefill_ms"] > 0 and res["max_memory_allocated_bytes"] is None
    assert out.exists()


def test_serve_cli_asks_for_cuda_and_refuses_ckpt(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve_cli.main(["--arch", "smollm-135m"])
    with pytest.raises(CheckpointError, match="unreadable"):
        tserve_cli.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                         "--ckpt", "x.npz"])


def test_serve_cli_serves_a_saved_checkpoint(tmp_path, monkeypatch):
    """``--ckpt`` restores one model's params through ``load_checkpoint``:
    the tokens are those of the same params served from memory, and not
    those of the seed's random weights."""
    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    params = ttr.init_params(1, cfg)
    save_checkpoint(str(tmp_path / "p.npz"), params, step=3)
    argv = ["--arch", "smollm-135m", "--reduced", "--batch", "2", "--prompt-len", "8",
            "--max-new", "6", "--device", "cpu"]
    seeded = tserve_cli.main(argv)["tokens"]
    restored = tserve_cli.main(argv + ["--ckpt", str(tmp_path / "p.npz")])["tokens"]
    monkeypatch.setattr(tserve_cli.transformer, "init_params", lambda seed, c: params)
    in_memory = tserve_cli.main(argv)["tokens"]
    assert restored == in_memory and restored != seeded


def test_caches_round_trip_through_convert_keep_bf16_bits():
    jcfg = dataclasses.replace(jreduced(jget_arch("smollm-135m")), dtype="bfloat16")
    jc = jtr.init_caches(jcfg, 2, 8)
    rng = np.random.default_rng(0)
    jc = jtr.Caches(kv=jattn.KVCache(
        *(jnp.asarray(rng.standard_normal(a.shape), jnp.bfloat16) for a in jc.kv)))
    tc = convert.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert tc.kv.k.dtype == torch.bfloat16 and tc.ssm == ()
    back = convert.caches_to_numpy(tc)
    assert np.array_equal(back.kv.k, np.asarray(jc.kv.k, np.float32))
    assert np.array_equal(back.kv.v, np.asarray(jc.kv.v, np.float32))
