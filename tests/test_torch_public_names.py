"""Public names of the reference that the port's modules carry too, on the CPU.

- Every name in ``repro.core.__all__`` imports from ``repro_torch.core``
  and stands in its ``__all__``.
- ``repro_torch.core.simulate_consensus``, the one-topology call of
  ``simulate_consensus_batched``, gives the reference's trace on a shared
  float64 ``x0`` (the reference's own draw from its seed): the errors within
  1e-12 of the initial error (float64 matmuls summed in other orders), the
  times exactly.
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
from repro.core import consensus as jcons  # noqa: E402
from repro.core.topologies import make_baseline as j_baseline  # noqa: E402
from repro.kernels.gossip_mix import ops as jops  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as tops  # noqa: E402


@pytest.mark.parametrize("name", jcore.__all__)
def test_every_reference_core_name_imports_from_the_port(name):
    assert name in tcore.__all__
    assert getattr(tcore, name) is not None


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
