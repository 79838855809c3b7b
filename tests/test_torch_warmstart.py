"""The port's SA warm start, weight polish and numpy leaves against the
JAX package, on the CPU.

- ``aspl_matmul`` is bit-equal to ``graph.aspl``.
- The device SA keeps the reference's invariants (degree sequence,
  connectivity, feasibility under a ``ConstraintSet``). Its random streams
  differ from ``jax.random``, so its quality is held to a band: at n=16,
  degree 4, 200 moves and 8 restarts, the mean ASPL of the port and of the
  JAX device SA differed by 0.007 when measured (CPU); the band is 0.03.
- The stream driver is bit-equal to the one-shot driver at exhaustion.
- ``polish_weights_batched`` in float64 is within 1e-7 of the reference on
  supports whose Laplacian spectrum has no repeated eigenvalues (on a ring
  or a torus the eigenvector LAPACK returns inside a repeated eigenspace is
  a free choice, and the subgradient path follows it).
- The numpy leaves copied into the port give bit-identical outputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import allocation as j_alloc  # noqa: E402
from repro.core import anneal as j_anneal  # noqa: E402
from repro.core import constraints as j_cs  # noqa: E402
from repro.core import graph as j_graph  # noqa: E402
from repro.core import topologies as j_topo  # noqa: E402
from repro.core import weights as j_weights  # noqa: E402
from repro.core.warmstart import anneal_topology_batched as j_sa  # noqa: E402
from repro_torch.core import allocation as t_alloc  # noqa: E402
from repro_torch.core import anneal as t_anneal  # noqa: E402
from repro_torch.core import constraints as t_cs  # noqa: E402
from repro_torch.core import graph as t_graph  # noqa: E402
from repro_torch.core import topologies as t_topo  # noqa: E402
from repro_torch.core import weights as t_weights  # noqa: E402
from repro_torch.core.warmstart import (  # noqa: E402
    anneal_topology_batched, anneal_topology_stream, aspl_matmul)


def _greedy(n, deg, seed, count, cs=None):
    rng = np.random.default_rng(seed)
    return [t_anneal.greedy_degree_graph(n, np.full(n, deg), rng, cs)
            for _ in range(count)]


def _degrees(n, edges):
    return np.bincount(np.asarray(edges).reshape(-1), minlength=n)


@pytest.mark.parametrize("n,p,seed", [(6, 0.5, 0), (16, 0.3, 1), (33, 0.12, 2),
                                      (40, 0.02, 3)])
def test_aspl_matmul_bit_equals_graph_aspl(n, p, seed):
    rng = np.random.default_rng(seed)
    up = np.triu(rng.random((n, n)) < p, 1)
    adj = up | up.T
    edges = [(int(i), int(j)) for i, j in zip(*np.nonzero(up))]
    want = j_graph.aspl(n, edges)
    got = aspl_matmul(adj, device="cpu")
    assert got == want or (np.isinf(got) and np.isinf(want))
    assert aspl_matmul(adj, use_kernel=False, device="cpu") == got or np.isinf(got)


def _check_sa_invariants(n, starts, outs, cs=None):
    for e0, e1 in zip(starts, outs):
        assert len(e1) == len(e0)
        assert (_degrees(n, e1) == _degrees(n, e0)).all()
        assert t_graph.is_connected(n, e1)
        assert all(i < j for i, j in e1) and len(set(e1)) == len(e1)
        if cs is not None:
            sel = np.zeros(len(t_graph.all_edges(n)), dtype=bool)
            eidx = t_graph.edge_index(n)
            for e in e1:
                sel[eidx[e]] = True
            assert cs.feasible(sel)
            assert cs.edge_ok[sel].all()


def test_device_sa_invariants_and_quality_band():
    n = 16
    starts = _greedy(n, 4, 0, 8)
    outs = anneal_topology_batched(n, starts, None, iters=200, seeds=list(range(8)),
                                   device="cpu")
    _check_sa_invariants(n, starts, outs)
    ref = j_sa(n, starts, None, iters=200, seeds=list(range(8)))
    got_mean = np.mean([t_graph.aspl(n, e) for e in outs])
    ref_mean = np.mean([j_graph.aspl(n, e) for e in ref])
    assert abs(got_mean - ref_mean) <= 0.03
    assert got_mean < np.mean([t_graph.aspl(n, e) for e in starts])


@pytest.mark.parametrize("which", ["node", "bcube", "intra"])
def test_device_sa_keeps_constraints_feasible(which):
    from repro_torch.core.api import _greedy_constraint_graph

    if which == "node":
        n = 12
        cs = t_cs.node_level_constraints(n, np.full(n, 3), np.ones(n))
        starts = _greedy(n, 3, 5, 2, cs)
    elif which == "bcube":
        n = 16
        cs = t_cs.bcube_constraints(p=4, k=2)
        starts = [_greedy_constraint_graph(n, 40, cs, np.random.default_rng(s))
                  for s in range(6)]
        starts = [e for e in starts if len(e) == len(starts[0])]
    else:
        n = 8
        cs = t_cs.intra_server_constraints(8)
        starts = [_greedy_constraint_graph(n, 12, cs, np.random.default_rng(s))
                  for s in range(2)]
    outs = anneal_topology_batched(n, starts, cs, iters=150,
                                   seeds=[10 + k for k in range(len(starts))],
                                   device="cpu")
    _check_sa_invariants(n, starts, outs, cs)


def test_stream_bit_equals_one_shot():
    n = 12
    starts = _greedy(n, 3, 4, 3)
    want = anneal_topology_batched(n, starts, None, iters=90, seeds=[1, 2, 3],
                                   device="cpu")
    seen = []
    for edges, costs, t in anneal_topology_stream(n, starts, None, iters=90,
                                                  seeds=[1, 2, 3], chunk=25,
                                                  device="cpu"):
        seen.append(t)
        last, last_costs = edges, costs
    assert seen == [25, 50, 75, 90]
    assert last == want
    assert last_costs == [t_graph.aspl(n, e) for e in want]


def test_restarts_are_independent_of_the_batch():
    n = 12
    starts = _greedy(n, 3, 8, 3)
    batch = anneal_topology_batched(n, starts, None, iters=60, seeds=[4, 5, 6],
                                    device="cpu")
    for k in range(3):
        one = anneal_topology_batched(n, [starts[k]], None, iters=60,
                                      seeds=[4 + k], device="cpu")
        assert one[0] == batch[k]


def test_sa_plain_and_kernel_route_agree_on_cpu():
    n = 10
    starts = _greedy(n, 3, 9, 2)
    a = anneal_topology_batched(n, starts, None, iters=40, seeds=[0, 1],
                                use_kernel=True, device="cpu")
    b = anneal_topology_batched(n, starts, None, iters=40, seeds=[0, 1],
                                use_kernel=False, device="cpu")
    assert a == b


def test_polish_batched_matches_reference_in_float64():
    n = 16
    supports = _greedy(n, 4, 11, 3) + _greedy(n, 3, 12, 1)
    g0s = [t_weights.metropolis_weights(n, e) for e in supports]
    want = j_weights.polish_weights_batched(n, supports, g0s, iters=150,
                                            dtype="float64")
    got = t_weights.polish_weights_batched(n, supports, g0s, iters=150,
                                           dtype="float64", device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    host = [t_weights.polish_weights(n, e, g0, iters=150) for e, g0 in zip(supports, g0s)]
    for a, b in zip(got, host):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_polish_batched_float32_lowers_the_objective():
    n = 12
    supports = _greedy(n, 3, 13, 2)
    g0s = [t_weights.metropolis_weights(n, e) for e in supports]
    got = t_weights.polish_weights_batched(n, supports, g0s, iters=100, device="cpu")
    for e, g0, g in zip(supports, g0s, got):
        assert g.dtype == np.float64 and g.shape == (len(e),)
        before = t_weights.asym_factor_from_g(n, e, g0)
        assert t_weights.asym_factor_from_g(n, e, g) <= before


# ---------------------------------------------------------------------------
# numpy leaves: copies of the reference, bit-identical outputs
# ---------------------------------------------------------------------------

def test_graph_leaf_bit_identical():
    rng = np.random.default_rng(0)
    for n in (6, 16, 200):
        edges = t_topo.random_graph(n, 2 * n, seed=n).edges
        g = rng.random(len(edges)) * 0.1
        W_t = t_graph.weight_matrix_from_weights(n, edges, g)
        W_j = j_graph.weight_matrix_from_weights(n, edges, g)
        assert W_t.tobytes() == W_j.tobytes()
        assert t_graph.r_asym(W_t) == j_graph.r_asym(W_j)
        assert t_graph.aspl(n, edges) == j_graph.aspl(n, edges)
    assert t_graph.FAST_SPECTRAL_MIN_N == j_graph.FAST_SPECTRAL_MIN_N
    W = t_graph.weight_matrix_from_weights(200, edges, g)
    assert abs(t_graph.r_asym_fast(W, symmetric=True)
               - j_graph.r_asym_fast(W, symmetric=True)) <= 1e-9


def test_constraint_and_allocation_leaves_bit_identical():
    for t_cs_, j_cs_ in ((t_cs.bcube_constraints(4, 2), j_cs.bcube_constraints(4, 2)),
                         (t_cs.intra_server_constraints(8), j_cs.intra_server_constraints(8)),
                         (t_cs.pod_boundary_constraints(12), j_cs.pod_boundary_constraints(12))):
        assert (t_cs_.M == j_cs_.M).all() and (t_cs_.e_cap == j_cs_.e_cap).all()
        assert (t_cs_.edge_ok == j_cs_.edge_ok).all() and t_cs_.equality == j_cs_.equality
        sel = np.random.default_rng(0).random(t_cs_.M.shape[1]) < 0.2
        assert (t_cs_.edge_bandwidth(sel) == j_cs_.edge_bandwidth(sel)).all()
    bw = np.array([9.76] * 8 + [3.25] * 8)
    a, b = t_alloc.allocate_edge_capacity(bw, 32), j_alloc.allocate_edge_capacity(bw, 32)
    assert (a.e == b.e).all() and a.b_unit == b.b_unit
    assert (t_alloc.graphical_repair(a.e) == j_alloc.graphical_repair(b.e)).all()


@pytest.mark.parametrize("kind", ["ring", "torus", "hypercube", "exponential"])
def test_topology_leaf_bit_identical(kind):
    a, b = t_topo.make_baseline(kind, 16), j_topo.make_baseline(kind, 16)
    assert a.edges == b.edges and a.W.tobytes() == b.W.tobytes()


def test_host_sa_leaf_bit_identical():
    n = 12
    cs_t, cs_j = (t_cs.node_level_constraints(n, np.full(n, 3), np.ones(n)),
                  j_cs.node_level_constraints(n, np.full(n, 3), np.ones(n)))
    e_t = t_anneal.greedy_degree_graph(n, np.full(n, 3), np.random.default_rng(2), cs_t)
    e_j = j_anneal.greedy_degree_graph(n, np.full(n, 3), np.random.default_rng(2), cs_j)
    assert e_t == e_j
    assert (t_anneal.anneal_topology(n, e_t, cs_t, iters=150, seed=3)
            == j_anneal.anneal_topology(n, e_j, cs_j, iters=150, seed=3))
    g = t_weights.metropolis_weights(n, e_t)
    assert g.tobytes() == j_weights.metropolis_weights(n, e_j).tobytes()
    assert (t_weights.polish_weights(n, e_t, g, iters=50).tobytes()
            == j_weights.polish_weights(n, e_j, g, iters=50).tobytes())
