"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

The same weights (the JAX package's ``init_moe``, carried by ``convert``)
and the same inputs (numpy, from a seed) go through both.

Tolerances, and why:
- float32: 1e-5 relative to the largest magnitude of the output (the router
  and expert matmuls sum in other orders);
- bfloat16: bitwise, with the layer's matrix products (the router's and the
  three expert products) taken by XLA's dot in the reference's form on both
  sides. Everything else — the routing, the capacity slots, the dispatch,
  silu, the combine's rounding order, the dtype flow — is the port's own
  code, and it gives the reference's bits, a forced router tie (the lower
  expert index first, as ``jax.lax.top_k`` orders it) and dropped choices
  included. With torch's own products a float32 sum that lands next to a
  bfloat16 rounding boundary can round the other way, since the two
  libraries add the terms in other orders (0 to 91 of 3,072 output
  elements on six seeds); the float32 test covers those products.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

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


def _setup(E, D, F, dtype, seed, B=2, S=12):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, F, E, jd)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    jx = jnp.asarray(x, jd)
    return jp, tp, jx, _t(jx)


def _t(a):
    return convert.model_params_from_numpy(np.asarray(a), "cpu")


@pytest.fixture
def xla_products(monkeypatch):
    """The port's MoE products by XLA's dot, in the reference's shapes: the
    router's (G, T, D) @ (D, E) and the experts' 'gecd,edf->gecf' with G = 1."""
    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                           else jnp.float32)

    def matmul(a, b):
        assert a.dim() == 2 and b.dim() == 2
        return _t((j(a)[None] @ j(b))[0])

    def bmm(a, b):
        return _t(jnp.einsum("gecd,edf->gecf", j(a)[None], j(b))[0])

    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
    monkeypatch.setattr(tmoe.torch, "bmm", bmm)


def _both(jp, tp, jx, tx, **kw):
    jout, jaux = jmoe.moe_forward(jp, jx, **kw)
    tout, taux = tmoe.moe_forward(tp, tx, **kw)
    assert tout.dtype == tx.dtype and tuple(tout.shape) == jout.shape
    return (np.asarray(jout.astype(jnp.float32)), float(jaux),
            tout.float().numpy(), float(taux))


@pytest.mark.parametrize("E,k,D,F", [(4, 2, 128, 256), (8, 3, 64, 96)])
def test_moe_forward_matches_jax_fp32(E, k, D, F):
    jp, tp, jx, tx = _setup(E, D, F, "float32", seed=E + k)
    jout, jaux, tout, taux = _both(jp, tp, jx, tx, top_k=k)
    _close(tout, jout)
    assert abs(taux - jaux) <= REL * abs(jaux)


@pytest.mark.parametrize("E,k,D,F,cap", [(4, 2, 128, 256, 1.25), (8, 3, 64, 96, 1.25),
                                         (32, 8, 64, 32, 1.25)])
def test_moe_forward_bitwise_bf16(E, k, D, F, cap, xla_products):
    jp, tp, jx, tx = _setup(E, D, F, "bfloat16", seed=3 * E + k)
    jout, jaux, tout, taux = _both(jp, tp, jx, tx, top_k=k, capacity_factor=cap)
    assert np.array_equal(tout, jout)
    assert abs(taux - jaux) <= REL * abs(jaux)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_router_tie_keeps_the_lower_expert_first(dtype, request):
    """Experts 1 and 2 share a router column, so every token's probabilities
    tie there; top-1 must take expert 1 wherever the pair leads, as
    ``jax.lax.top_k`` does, and the whole layer then agrees bit for bit in
    bfloat16."""
    E, D, F = 4, 64, 32
    jp, tp, jx, tx = _setup(E, D, F, dtype, seed=7, S=16)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router, jp["router"].dtype))
    tp = dict(tp, router=_t(jp["router"]))
    probs = torch.softmax((tx.reshape(-1, D) @ tp["router"]).float(), dim=-1)
    assert torch.equal(probs[:, 1], probs[:, 2])
    leads = (probs[:, 1] >= probs.amax(dim=-1)).sum()
    assert int(leads) > 0                                # the tie decides some tokens
    # top-1 never routes to expert 2: its tie partner 1 comes first
    one = {k: v.clone() for k, v in tp.items()}
    one["w_down"] = torch.zeros_like(one["w_down"])
    one["w_down"][2] = 1.0
    tout, _ = tmoe.moe_forward(one, tx, top_k=1)
    assert float(tout.abs().max()) == 0.0
    if dtype == "bfloat16":
        request.getfixturevalue("xla_products")
    for k in (1, 2):
        jout, _, tout, _ = _both(jp, tp, jx, tx, top_k=k)
        if dtype == "bfloat16":
            assert np.array_equal(tout, jout)
        else:
            _close(tout, jout)


def test_moe_capacity_drops_bitwise_bf16(xla_products):
    """A capacity of a few slots drops most choices; the dropped ones add
    zero, on both sides, bit for bit. Decode's ``min_capacity = T·k``
    drops none."""
    E, k, D, F = 4, 2, 64, 32
    jp, tp, jx, tx = _setup(E, D, F, "bfloat16", seed=11, S=16)
    T = tx.shape[0] * tx.shape[1]
    cap = 0.1                                            # C = int(0.1·32·2/4) = 1
    jout, _, tout, _ = _both(jp, tp, jx, tx, top_k=k, capacity_factor=cap)
    assert np.array_equal(tout, jout)
    dropped = (np.abs(tout).sum(axis=-1) == 0).sum()     # every choice of these tokens dropped
    assert dropped > 0
    full, _, tfull, _ = _both(jp, tp, jx, tx, top_k=k, min_capacity=T * k)
    assert np.array_equal(tfull, full) and (np.abs(tfull).sum(axis=-1) > 0).all()
    assert not np.array_equal(tfull, tout)


def test_moe_init_layout_matches_jax():
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 48, 24, 6, jnp.float32)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), 48, 24, 6, torch.float32, (3,))
    assert set(tp) == set(jp)
    for name, a in jp.items():
        assert tuple(tp[name].shape) == (3,) + a.shape
