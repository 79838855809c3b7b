"""Public names of the reference that the port's modules carry too, on the CPU.

- Every name in ``repro.core.__all__`` imports from ``repro_torch.core``
  and stands in its ``__all__``.
- Every name in ``repro.dsgd.__all__`` imports from ``repro_torch.dsgd``
  and stands in its ``__all__``, in the reference's order; the two pjit
  steps not ported yet raise naming item 7c, and ``gossip_shard_dynamic``
  (not in the reference's ``__all__``) is exported too.
- ``repro_torch.core.simulate_consensus``, the one-topology call of
  ``simulate_consensus_batched``, gives the reference's trace on a shared
  float64 ``x0`` (the reference's own draw from its seed): the errors within
  1e-12 of the initial error (float64 matmuls summed in other orders), the
  times exactly.
- ``repro_torch.core.shard.__all__`` is the reference's; on an edge
  partition ``edge_kernel=True`` is a deviation: the reference refuses it,
  the port runs its windowed kernels (their plain window forms on the CPU)
  and matches the reference's unsharded solve within 1e-10.
- ``kernels/gossip_mix/ops.gossip_mix_tree`` mixes a parameter pytree leaf
  by leaf as the reference's does (its Pallas kernel in interpret mode):
  float32 within 1e-6, as ``tests/test_torch_gossip.py`` holds
  ``gossip_mix``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as jcore  # noqa: E402
import repro.dsgd as jdsgd  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import shard as jshard  # noqa: E402
from repro.core.topologies import make_baseline as j_baseline  # noqa: E402
from repro.kernels.gossip_mix import ops as jops  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.dsgd as tdsgd  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import shard as tshard  # noqa: E402
from repro_torch.kernels.edge_laplacian import ops as tel  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as tops  # noqa: E402


@pytest.mark.parametrize("name", jcore.__all__)
def test_every_reference_core_name_imports_from_the_port(name):
    assert name in tcore.__all__
    assert getattr(tcore, name) is not None


#: reference names that the port exports but does not run yet (ROADMAP.md,
#: Queue 1, item 7c: tensor parallelism inside a worker)
UNPORTED_DSGD = ("make_matmul_gossip_train_step", "make_tp_train_step")


@pytest.mark.parametrize("name", jdsgd.__all__)
def test_every_reference_dsgd_name_imports_from_the_port(name):
    assert name in tdsgd.__all__
    assert getattr(tdsgd, name) is not None
    if name in UNPORTED_DSGD:
        with pytest.raises(NotImplementedError, match="item 7c"):
            getattr(tdsgd, name)()


def test_dsgd_names_keep_the_reference_order():
    assert [n for n in tdsgd.__all__ if n in jdsgd.__all__] == list(jdsgd.__all__)
    from repro.dsgd.dynamic import gossip_shard_dynamic as jdyn

    assert "gossip_shard_dynamic" in tdsgd.__all__ and jdyn.__name__ == "gossip_shard_dynamic"


def test_shard_names_are_the_reference_names():
    assert tshard.__all__ == jshard.__all__
    assert all(getattr(tshard, name) is not None for name in tshard.__all__)
    assert tcore.resolve_partition("auto", 4096) == "none"


def test_edge_kernel_on_an_edge_partition_is_a_deviation(monkeypatch):
    """The reference's sharded solve refuses ``edge_kernel=True`` (its
    Pallas pair needs the whole edge list); the port's runs the windowed
    wrappers, here on one process (one window, the whole list, on the CPU)."""
    cfg = dict(max_iters=20, check_every=10)
    g0 = np.random.default_rng(9).random(28) * 0.3
    jspec = jengine.make_homo_spec(8, 12, jengine.ADMMConfig(edge_kernel=True, **cfg))
    jst = jengine.init_state(jspec, jnp.asarray(g0), 0.5)
    with pytest.raises(ValueError, match="edge_kernel=True"):
        jshard.solve_spec_sharded(jspec, jst, jengine.ADMMConfig(edge_kernel=True, **cfg),
                                  ndev=1)
    tcfg = tengine.ADMMConfig(device="cpu", **cfg)
    assert tcfg.edge_kernel
    tspec = tengine.make_homo_spec(8, 12, tcfg)
    tst = tengine.init_state(tspec, g0, 0.5)
    calls = []
    for name in ("edge_laplacian", "edge_adjoint"):
        fn = getattr(tel, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, a[3:] if _name == "edge_adjoint" else a[2:]))
            return _fn(*a, **kw)

        monkeypatch.setattr(tel, name, spy)
    got = tshard.solve_spec_sharded(tspec, tst, tcfg)
    assert calls and {c[1] for c in calls} == {(0,), (None, 0, 28)}
    want = jengine.solve_spec(jspec, jst, jengine.ADMMConfig(**cfg))
    np.testing.assert_allclose(got.g, np.asarray(want.g), rtol=0, atol=1e-10)
    assert abs(got.lam_tilde - want.lam_tilde) <= 1e-10 and got.iters == want.iters


@pytest.mark.parametrize("kind", ["ring", "exponential"])
def test_simulate_consensus_matches_the_reference(kind):
    n, iters, dim, seed = 8, 60, 5, 3
    jtopo = j_baseline(kind, n)
    want = jcons.simulate_consensus(jtopo, iters=iters, dim=dim, seed=seed, b_min=4.0)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, dim), dtype=jnp.float64))
    got = tcore.simulate_consensus(tcore.make_baseline(kind, n), iters=iters, dim=dim,
                                   b_min=4.0, device="cpu", x0=x0)
    assert got.topology == want.topology and got.errors.shape == (iters + 1,)
    assert np.abs(got.errors - want.errors).max() <= 1e-12 * want.errors[0]
    assert got.t_iter_ms == want.t_iter_ms and np.array_equal(got.times_ms, want.times_ms)
    assert tcore.time_to_error(got, 1e-3) == jcons.time_to_error(want, 1e-3)


def test_gossip_mix_tree_matches_the_reference():
    rng = np.random.default_rng(4)
    deg = 3
    tree = {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((9,)).astype(np.float32)}}
    nbrs = {"w": rng.standard_normal((deg, 5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((deg, 9)).astype(np.float32)}}
    w = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    want = jops.gossip_mix_tree(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, nbrs),
                                jnp.asarray(w), use_kernel=True)
    got = tops.gossip_mix_tree(jax.tree.map(torch.from_numpy, tree),
                               jax.tree.map(torch.from_numpy, nbrs), torch.from_numpy(w))
    assert np.abs(got["w"].numpy() - np.asarray(want["w"])).max() <= 1e-6
    assert np.abs(got["b"]["c"].numpy() - np.asarray(want["b"]["c"])).max() <= 1e-6
