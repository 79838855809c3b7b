"""The port's Mamba-2 path (ssm family) against the JAX package's, on the CPU.

The same weights (the JAX package's init, carried by ``convert``) and the
same inputs (numpy, from a seed) go through both packages. The JAX side
runs its Pallas ``ssd_intra_chunk`` kernel in interpret mode where the
reference's route reaches it (``ssd_chunk_scan(use_kernel=True)``); on the
CPU the port's kernel wrapper takes its plain version.

The JAX prefill calls its layer stack without ``use_kernel`` and so never
reaches the Pallas kernel; the port's prefill does (kernels on by default).
The whole-model comparisons are therefore in float32, where the two routes
agree to rounding.

Tolerances, and why:
- ``ssd_intra_chunk``: within the first-order float32 bounds of
  ``ssd_intra_chunk_bound`` (2⁻²⁴·(N + Q + 8)·Σ|terms| for y, 2⁻²⁴·(Q + 8)
  ·Σ|terms| for the states: the sums are taken in other orders).
- float32 scans, layers, prefill and decode: 1e-5 relative to the largest
  magnitude of the compared array.
- bfloat16 scan output: one bfloat16 ulp of the larger result plus 1e-5 of
  the largest magnitude (the float32 difference can flip one rounding).
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
from repro.kernels.ssd_scan.kernel import ssd_intra_chunk_kernel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as tssd  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import ServeConfig, ServingEngine  # noqa: E402

REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |err| {err} > {rel} × {scale}"


def _to_t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jreduced(jget_arch("mamba2-780m")), dtype=dtype)
    tcfg = dataclasses.replace(reduced_for_smoke(get_arch("mamba2-780m")), dtype=dtype)
    return jcfg, tcfg


def _scan_inputs(Bsz, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(np.float32)
    A = -(rng.random(H) + 0.2).astype(np.float32)
    Bm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# ssd_intra_chunk: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bsz,nc,Q,H,P,N", [(2, 2, 32, 3, 32, 16), (1, 1, 24, 2, 8, 12)])
def test_ssd_intra_chunk_plain_matches_pallas(dtype, Bsz, nc, Q, H, P, N):
    x, dt, A, Bm, Cm = _scan_inputs(Bsz, nc * Q, H, P, N, seed=Q + N)
    x = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    la = np.cumsum(A * dtc, axis=2, dtype=np.float32)
    Bc, Cc = Bm.reshape(Bsz, nc, Q, N), Cm.reshape(Bsz, nc, Q, N)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    wy, wst = ssd_intra_chunk_kernel(jnp.asarray(x, jd), jnp.asarray(dtc), jnp.asarray(la),
                                     jnp.asarray(Bc, jd), jnp.asarray(Cc, jd), interpret=True)
    td = getattr(torch, dtype)
    args = (_to_t(x, td), _to_t(dtc), _to_t(la), _to_t(Bc, td), _to_t(Cc, td))
    y, st = kernels.WRAPPERS["ssd_intra_chunk"](*args)
    assert y.dtype == st.dtype == torch.float32
    by, bst = tssd.ssd_intra_chunk_bound(*args)
    assert bool(((y - _to_t(wy)).abs() <= by).all())
    assert bool(((st - _to_t(wst)).abs() <= bst).all())


def test_ssd_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 1, 8, 2, 4)
    dt = torch.zeros(1, 1, 8, 2)
    bc = torch.zeros(1, 1, 8, 3)
    with pytest.raises(ValueError, match="do not fit"):
        tssd.ssd_intra_chunk(x, dt, dt, bc, torch.zeros(1, 1, 8, 4))
    with pytest.raises(TypeError, match="float32"):
        tssd.ssd_intra_chunk(x, dt.double(), dt, bc, bc)
    with pytest.raises(TypeError, match="one dtype"):
        tssd.ssd_intra_chunk(x, dt, dt, bc.bfloat16(), bc)


def test_kernel_plan_fits_shared_memory():
    main = tssd.kernel_plan(256, 48, 64, 128)          # mamba2-780m
    assert main["TT"] == 64 and main["smem_bytes"] <= 232_448
    assert main["SK"] == 256 and main["NK"] == 102
    small = tssd.kernel_plan(32, 8, 32, 16)            # the reduced config
    assert small["TT"] == 32 and small["NK"] == 16
    assert tssd.kernel_plan(512, 4, 64, 128)["TT"] == 16
    with pytest.raises(ValueError, match="shared memory"):
        tssd.kernel_plan(8192, 4, 64, 128)


# ---------------------------------------------------------------------------
# the chunked scan, a Mamba-2 layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_scan_matches_jax(use_kernel, dtype):
    """S = 70 over chunks of 32: two full chunks and a ragged tail padded
    with dt = 0 steps, from a given initial state h0."""
    Bsz, S, H, P, N, Q = 2, 70, 3, 16, 8, 32
    x, dt, A, Bm, Cm = _scan_inputs(Bsz, S, H, P, N, seed=S)
    h0 = np.random.default_rng(1).standard_normal((Bsz, H, P, N)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    wy, wh = jssm.ssd_chunk_scan(jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
                                 jnp.asarray(Bm, jd), jnp.asarray(Cm, jd), Q,
                                 h0=jnp.asarray(h0), use_kernel=use_kernel)
    td = getattr(torch, dtype)
    y, h = tssm.ssd_chunk_scan(_to_t(x, td), _to_t(dt), _to_t(A), _to_t(Bm, td),
                               _to_t(Cm, td), Q, h0=_to_t(h0), use_kernel=use_kernel)
    assert y.dtype == td and h.dtype == torch.float32 and tuple(y.shape) == (Bsz, S, H, P)
    _close(h.numpy(), wh)
    want = _to_t(np.asarray(wy.astype(jnp.float32)))
    if dtype == "float32":
        _close(y.numpy(), want.numpy())
    else:
        got = y.float()
        _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
        ulp = torch.ldexp(torch.full_like(got, torch.finfo(torch.bfloat16).eps), e - 1)
        assert bool(((got - want).abs() <= ulp + REL * float(want.abs().max())).all())


def _layer(seed, dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg, jd)
    return jcfg, tcfg, jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("S", [40, 2])               # a ragged scan; a prompt shorter than K−1
def test_mamba2_forward_and_decode_match_jax(S):
    jcfg, tcfg, jp, tp = _layer(S)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    jc0 = jssm.init_ssm_cache(2, jcfg, jnp.float32)
    jout, jc = jssm.mamba2_forward(jp, jnp.asarray(x), jcfg, cache=jc0, use_kernel=True)
    tout, tc = tssm.mamba2_forward(tp, _to_t(x), tcfg,
                                   cache=tssm.init_ssm_cache(2, tcfg, torch.float32))
    _close(tout.numpy(), jout)
    _close(tc.conv.numpy(), jc.conv)
    _close(tc.state.numpy(), jc.state)
    tc = tssm.SSMCache(_to_t(jc.conv), _to_t(jc.state))      # decode from one cache
    for t in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jout, jc = jssm.mamba2_decode(jp, jnp.asarray(xt), jcfg, jc)
        tout, tc = tssm.mamba2_decode(tp, _to_t(xt), tcfg, tc)
        _close(tout.numpy(), jout)
        _close(tc.state.numpy(), jc.state)
        _close(tc.conv.numpy(), jc.conv)


def test_mamba2_bf16_dtype_flow_matches_jax():
    """A bfloat16 layer keeps A_log, D and dt_bias in float32 through
    ``convert``, and its outputs and caches take the reference's dtypes."""
    jcfg, tcfg, jp, tp = _layer(0, "bfloat16")
    for k, v in jp.items():
        assert str(tp[k].dtype).replace("torch.", "") == str(v.dtype), k
        assert np.array_equal(convert.model_params_to_numpy(tp[k]), np.asarray(v, np.float32))
    assert tp["A_log"].dtype == tp["D"].dtype == tp["dt_bias"].dtype == torch.float32
    assert tp["in_proj"].dtype == torch.bfloat16
    x = np.random.default_rng(0).standard_normal((1, 9, tcfg.d_model)).astype(np.float32)
    jout, jc = jssm.mamba2_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                   cache=jssm.init_ssm_cache(1, jcfg, jnp.bfloat16))
    tout, tc = tssm.mamba2_forward(tp, _to_t(x, torch.bfloat16), tcfg,
                                   cache=tssm.init_ssm_cache(1, tcfg, torch.bfloat16))
    jd, td = jssm.mamba2_decode(jp, jout[:, -1:], jcfg, jc), tssm.mamba2_decode(
        tp, tout[:, -1:], tcfg, tc)
    for j, t in ((jout, tout), (jc.conv, tc.conv), (jc.state, tc.state), (jd[0], td[0]),
                 (jd[1].conv, td[1].conv), (jd[1].state, td[1].state)):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        assert tuple(t.shape) == tuple(j.shape) and bool(torch.isfinite(t.float()).all())


# ---------------------------------------------------------------------------
# the whole model: prefill, decode, the engine
# ---------------------------------------------------------------------------

def _model(seed=0):
    jcfg, tcfg = _cfgs()
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, convert.model_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _counting_ssd(monkeypatch):
    """Record the xc shape of every ``ssd_intra_chunk`` call the model makes."""
    calls = []
    wrapped = tssm._ssd_ops.ssd_intra_chunk

    def counting(*a):
        calls.append(tuple(a[0].shape))
        return wrapped(*a)

    monkeypatch.setattr(tssm._ssd_ops, "ssd_intra_chunk", counting)
    return calls


def test_ssm_prefill_and_decode_match_jax(monkeypatch):
    """The port's prefill goes through the SSD kernel wrapper once per layer,
    over all three chunks (the reference calls its kernel once per chunk, and
    its prefill takes its einsum route); logits and caches agree, then 4
    decode steps from the JAX prefill's cache."""
    jcfg, tcfg, jparams, tparams = _model()
    S = 70                                       # chunks of 32: three, the last ragged
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    calls = _counting_ssd(monkeypatch)
    jlog, jcaches = jtr.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tlog, tcaches = ttr.prefill(tparams, tcfg, {"tokens": _to_t(toks)})
    assert len(calls) == tcfg.num_layers and calls[0][1] == 3         # nc = 3 per call
    _close(tlog.numpy(), jlog)
    _close(tcaches.ssm.conv.numpy(), jcaches.ssm.conv)
    _close(tcaches.ssm.state.numpy(), jcaches.ssm.state)

    caches = convert.caches_from_numpy(jax.tree.map(np.asarray, jcaches), "cpu")
    tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1)[:, None].astype(np.int32)
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, jcfg, t, c, pos, use_kernel=True))
    for pos in range(S, S + 4):
        jl, jcaches = step(jparams, jnp.asarray(tok), jcaches, jnp.asarray(pos, jnp.int32))
        tl, caches = ttr.decode_step(tparams, tcfg, _to_t(tok), caches, pos)
        _close(tl.numpy(), jl)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None].astype(np.int32)
    _close(caches.ssm.state.numpy(), jcaches.ssm.state)


def test_ssm_prefill_chunk_cap_groups_calls(monkeypatch):
    """With ``INTRA_CALL_BYTES`` at one chunk's float32 outputs each layer
    takes one call per chunk, made when its chunk comes up in the loop (K
    for a kernel call, E for a chunk's incoming-state einsum: KEKEKE a
    layer, so one chunk's outputs are live at a time), and the prefill
    gives the same logits and caches as one call per layer (and the
    reference's, as above)."""
    jcfg, tcfg, jparams, tparams = _model()
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 70)).astype(np.int32)
    whole, whole_caches = ttr.prefill(tparams, tcfg, {"tokens": _to_t(toks)})
    H, P, N, Q = tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state, tcfg.ssm_chunk
    monkeypatch.setattr(tssm, "INTRA_CALL_BYTES", 4 * 2 * (Q * H * P + H * P * N))
    calls = _counting_ssd(monkeypatch)
    counting, einsum, order = tssm._ssd_ops.ssd_intra_chunk, torch.einsum, []

    def logging_ssd(*a):
        order.append("K")
        return counting(*a)

    def logging_einsum(eq, *operands):
        if eq == "btn,bth,bhpn->bthp":           # a chunk's incoming-state pass
            order.append("E")
        return einsum(eq, *operands)

    monkeypatch.setattr(tssm._ssd_ops, "ssd_intra_chunk", logging_ssd)
    monkeypatch.setattr(torch, "einsum", logging_einsum)
    tlog, tcaches = ttr.prefill(tparams, tcfg, {"tokens": _to_t(toks)})
    monkeypatch.setattr(torch, "einsum", einsum)
    assert "".join(order) == "KE" * 3 * tcfg.num_layers
    assert len(calls) == tcfg.num_layers * 3 and all(c[1] == 1 for c in calls)
    assert torch.equal(tlog, whole)
    assert torch.equal(tcaches.ssm.state, whole_caches.ssm.state)
    jlog, _ = jtr.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    _close(tlog.numpy(), jlog)


def test_ssm_engine_greedy_tokens_match_jax():
    jcfg, tcfg, jparams, tparams = _model(1)
    kw = dict(batch_size=2, cache_len=8, max_new_tokens=6)
    prompts = np.random.default_rng(3).integers(1, 512, (2, 40)).astype(np.int32)
    want = JServingEngine(jcfg, jparams, JServeConfig(use_kernel=True, **kw),
                          eos_id=-1).generate(prompts)
    got = ServingEngine(tcfg, tparams, ServeConfig(**kw), eos_id=-1).generate(prompts)
    assert np.array_equal(got, want)


def test_ssm_layout_and_caches_match_jax():
    jcfg, tcfg = _cfgs()
    jshapes = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), jcfg))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(jshapes).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(ttr.init_params(0, tcfg)).items()}
    assert got == want
    jc, tc = jtr.init_caches(jcfg, 3, 8), ttr.init_caches(tcfg, 3, 8)
    assert tuple(tc.ssm.conv.shape) == jc.ssm.conv.shape
    assert tuple(tc.ssm.state.shape) == jc.ssm.state.shape
    assert tc.ssm.state.dtype == torch.float32 and tc.kv == ()


def test_ssm_training_is_not_ported(monkeypatch):
    """Training the ssm family is ported (its name is older than that):
    ``train_loss`` over 40 tokens (two chunks, the last ragged) goes
    through the SSD kernel wrapper once a layer and equals the reference's
    einsum-route loss within 1e-5 relative, with a finite gradient."""
    jcfg, tcfg, jparams, tparams = _model()
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    calls = _counting_ssd(monkeypatch)
    want = float(jtr.train_loss(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                                "labels": jnp.asarray(toks)}))
    grads, got = torch.func.grad_and_value(lambda p: ttr.train_loss(
        p, tcfg, {"tokens": _to_t(toks), "labels": _to_t(toks)}))(tparams)
    assert len(calls) == tcfg.num_layers and calls[0][1] == 2
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    assert all(bool(torch.isfinite(g).all()) for g in _flat(grads).values())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
