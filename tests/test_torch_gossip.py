"""The port's gossip against the JAX package's, on the CPU.

On the CPU the port's ``gossip_mix_batched`` and ``gossip_mix`` run their
plain versions (``ref.py`` in PyTorch); the JAX side runs its Pallas
kernels in interpret mode (``use_kernel=True``), as the JAX package's own
tests do. Inputs are made with numpy from a seed and handed to both.

Tolerances: fp32 within 1e-6 (the same float32 sums, taken in another
order); bf16 within one bf16 ulp of the larger of the two results (the
float32 sums differ in their last bits, and the one rounding to bf16 may
then land on either side) plus the float32 summation bound
(deg+1)·2⁻²⁴·Σ|w·x|, which only matters where the terms cancel to near 0
and a bf16 ulp is finer than float32's error on the terms; the padded
neighbour tables identical; the port's row loop against its batched path
within 1e-6; the dense ``gossip_sim_tree`` within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.core import graph as jgraph  # noqa: E402
from repro.core.topologies import make_baseline  # noqa: E402
from repro.dsgd import gossip as jgossip  # noqa: E402
from repro.kernels.gossip_mix import ops as jops  # noqa: E402
from repro_torch.dsgd import gossip as tgossip  # noqa: E402
from repro_torch.kernels import WRAPPERS  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as tops  # noqa: E402

SHAPES = [(130,), (4, 7), (8, 130)]


def _star(n):
    edges = [(0, i) for i in range(1, n)]
    g = np.array([1.0 / n] * len(edges))      # Metropolis weights of a star
    return jgraph.weight_matrix_from_weights(n, edges, g)


def _W(kind):
    if kind == "star":           # hub of degree 5, leaves of degree 1: padded slots
        return _star(6)
    topo = make_baseline(kind, 8)
    return jgraph.weight_matrix_from_weights(topo.n, topo.edges, topo.g)


def _bf16_ulp(a, b):
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.spacing(mag) * 65536.0          # bf16 keeps 8 of float32's 24 bits


def _close(got, want, dtype, deg=0, terms=None):
    """``terms``: Σ_d |w_d|·|x_d| per element, for the float32 sum's bound."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6
    else:
        floor = 0.0 if terms is None else (deg + 1) * 2.0 ** -24 * np.asarray(terms)
        assert np.all(np.abs(got - want) <= _bf16_ulp(got, want) + floor)


def _inputs(n, shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((n,) + shape).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("kind", ["ring", "exponential", "star"])
def test_padded_neighbors_identical(kind):
    W = _W(kind).astype(np.float32)
    j_idx, j_w = jgossip.padded_neighbors(jnp.asarray(W))
    t_idx, t_w = tgossip.padded_neighbors(torch.from_numpy(W))
    assert t_idx.dtype == torch.int32 and t_w.dtype == torch.float32
    assert np.array_equal(np.asarray(j_idx), t_idx.numpy())
    assert np.array_equal(np.asarray(j_w), t_w.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["ring", "exponential", "star"])
def test_gossip_mix_batched_matches_pallas(kind, shape, dtype):
    W = _W(kind).astype(np.float32)
    n = W.shape[0]
    jx, tx = _inputs(n, shape, dtype, seed=len(shape) + n)
    j_idx, j_w = jgossip.padded_neighbors(jnp.asarray(W))
    want = jops.gossip_mix_batched(jx, j_idx, j_w, use_kernel=True)
    t_idx, t_w = tgossip.padded_neighbors(torch.from_numpy(W))
    before = WRAPPERS["gossip_mix_batched"].launches
    got = tops.gossip_mix_batched(tx, t_idx, t_w)
    assert WRAPPERS["gossip_mix_batched"].launches == before   # the CPU takes the plain version
    assert got.dtype == tx.dtype and tuple(got.shape) == (n,) + shape
    terms = tops.gossip_mix_batched_plain(tx.double().abs(), t_idx, t_w.abs())
    _close(_to_np(got), np.asarray(want, dtype=np.float32), dtype, t_idx.shape[1], terms)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gossip_mix_one_worker_matches_pallas(shape, dtype):
    W = _star(6).astype(np.float32)
    jx, tx = _inputs(6, shape, dtype, seed=7)
    for i in (0, 3):              # the hub (deg 5) and a leaf (deg 1)
        nbrs = [j for j in range(6) if j != i and W[i, j] != 0.0]
        w = np.array([W[i, i]] + [W[i, j] for j in nbrs], np.float32)
        want = jops.gossip_mix(jx[i], jx[jnp.asarray(nbrs)], jnp.asarray(w), use_kernel=True)
        got = tops.gossip_mix(tx[i], tx[torch.tensor(nbrs)], torch.from_numpy(w))
        assert got.dtype == tx.dtype and tuple(got.shape) == shape
        terms = tops.gossip_mix_plain(tx[i].double().abs(), tx[torch.tensor(nbrs)].double().abs(),
                                      torch.from_numpy(np.abs(w)))
        _close(_to_np(got), np.asarray(want, dtype=np.float32), dtype, len(nbrs), terms)


@pytest.mark.parametrize("kind", ["ring", "exponential", "star"])
def test_rowloop_matches_batched(kind):
    W = torch.from_numpy(_W(kind).astype(np.float32))
    n = W.shape[0]
    rng = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(rng.standard_normal((n, 130)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.standard_normal((n, 4, 7)).astype(np.float32))}}
    batched = tgossip.gossip_sim_tree(tree, W)
    rowloop = tgossip.gossip_sim_tree_rowloop(tree, W)
    for path in (("a",), ("b", "c")):
        got, want = rowloop, batched
        for k in path:
            got, want = got[k], want[k]
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("kind", ["ring", "exponential", "star"])
def test_dense_gossip_tree_matches_jax(kind):
    W = _W(kind).astype(np.float32)
    n = W.shape[0]
    rng = np.random.default_rng(5)
    leaves = {"a": rng.standard_normal((n, 130)).astype(np.float32),
              "v": rng.standard_normal((n,)).astype(np.float32),
              "b": rng.standard_normal((n, 4, 7)).astype(np.float32)}
    want = jgossip.gossip_sim_tree({k: jnp.asarray(v) for k, v in leaves.items()},
                                   jnp.asarray(W))
    got = tgossip.gossip_sim_tree({k: torch.from_numpy(v) for k, v in leaves.items()},
                                  torch.from_numpy(W), use_kernel=False)
    for k in leaves:
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 1e-5
    # the batched kernel path gives the dense result too
    mixed = tgossip.gossip_sim_tree({k: torch.from_numpy(v) for k, v in leaves.items()},
                                    torch.from_numpy(W))
    for k in leaves:
        assert np.abs(mixed[k].numpy() - np.asarray(want[k])).max() <= 1e-5


def test_select_cycle_matrix_matches_jax():
    Wc = np.random.default_rng(0).random((3, 4, 4)).astype(np.float32)
    for R, t in ((3, 0), (3, 4), (2, 5), (1, 7)):
        want = np.asarray(jgossip.select_cycle_matrix(jnp.asarray(Wc), R, t))
        got = tgossip.select_cycle_matrix(torch.from_numpy(Wc), torch.tensor(R), torch.tensor(t))
        assert np.array_equal(got.numpy(), want)


def test_wrappers_reject_bad_shapes_and_types():
    x = torch.zeros((4, 10))
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.gossip_mix_batched(x, idx, torch.zeros((4, 2)))
    with pytest.raises(ValueError):
        tops.gossip_mix_batched(x, torch.zeros((3, 2), dtype=torch.int32), torch.zeros((3, 3)))
    with pytest.raises(TypeError):
        tops.gossip_mix_batched(x.double(), idx, torch.zeros((4, 3)))
    with pytest.raises(TypeError):
        tops.gossip_mix_batched(x, idx, torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        tops.gossip_mix(x[0], torch.zeros((2, 9)), torch.zeros(3))
    with pytest.raises(ValueError):
        tops.gossip_mix(x[0], torch.zeros((2, 10)), torch.zeros(2))
