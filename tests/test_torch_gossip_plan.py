"""The tiled ``gossip_mix_batched`` on the CPU: its plan, and the grouped
call that mixes every leaf of a step in one launch a dtype.

The plan (``gossip_plan``) is plain Python, so it is held here: every
column of every leaf lies in exactly one (leaf, tile), in the kernel's own
numbering (the walk of its ``locate``); a tile's row is a power of two of at least 16
bytes; a block's shared memory is within the H100's 227 KB for n ∈ {1, 4,
8, 144, 432} in each dtype and for the paths' tables; past ``max_rows`` it
raises. On the CPU ``gossip_mix_batched_leaves`` takes the plain version,
leaf by leaf: bitwise the per-leaf plain mix, within ``_close``'s
tolerance of the JAX package's Pallas kernel in interpret mode (fp32 within
1e-6; bf16 within one bf16 ulp plus the float32 summation bound), each leaf
in its own dtype. A reduced smollm's DSGD step and the §VI-B sim's step,
which now gossip through the grouped call, equal bitwise the same steps
composed of per-leaf ``gossip_mix_batched`` calls.
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
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.dsgd import gossip as tgossip  # noqa: E402
from repro_torch.dsgd import sim as tsim  # noqa: E402
from repro_torch.dsgd import trainer as ttrainer  # noqa: E402
from repro_torch.kernels import WRAPPERS  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as tops  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

SMOLLM_ROWS = [49152 * 576, 576] + [30 * m for m in (576, 576, 576 * 576, 576 * 192, 576 * 192,
                                                     576 * 576, 576 * 1536, 576 * 1536,
                                                     1536 * 576)]
SIM_ROWS = [128, 10, 64 * 128, 128 * 10]          # b1, b2, w1, w2 of the §VI-B MLP


def _tiles(plan, Ms) -> list:
    """(leaf, first column, width) of every tile, as the kernel's
    ``locate`` walks them: a leaf cursor over the prefix sums."""
    out, leaf = [], 0
    for t in range(plan.tiles):
        while t >= plan.tile_end[leaf]:
            leaf += 1
        c0 = (t - (plan.tile_end[leaf - 1] if leaf else 0)) * plan.tile_elems
        out.append((leaf, c0, min(plan.tile_elems, Ms[leaf] - c0)))
    return out


def _covers(plan, Ms) -> None:
    """Every column of every leaf in exactly one (leaf, tile)."""
    seen = [np.zeros(m, np.int64) for m in Ms]
    tiles = _tiles(plan, Ms)
    for leaf, c0, width in tiles:
        assert 0 < width <= plan.tile_elems and c0 % plan.tile_elems == 0
        seen[leaf][c0:c0 + width] += 1
    assert all(np.all(s == 1) for s in seen)
    assert plan.tiles == len(tiles) == plan.tile_end[-1]


@pytest.mark.parametrize("n,deg,Ms,size", [
    (8, 4, [130, 4 * 7, 8 * 130, 1, 17280], 2), (8, 7, [130, 1000003], 4),
    (144, 6, SIM_ROWS, 4), (272, 6, SIM_ROWS, 4), (4, 3, [5, 0, 33], 2), (1, 1, [5], 4)])
def test_plan_covers_every_column_once(n, deg, Ms, size):
    _covers(tops.gossip_plan(n, deg, Ms, size, 132), Ms)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("n", [1, 4, 8, 144, 432])
def test_plan_fits_shared_memory(n, size):
    for deg, Ms in ((1, [7]), (6, SIM_ROWS), (7, SMOLLM_ROWS)):
        p = tops.gossip_plan(n, deg, Ms, size, 132)
        tb = p.tile_bytes
        assert tb >= 16 and tb % 16 == 0 and tb & (tb - 1) == 0 and tb % size == 0
        assert p.tile_elems * size == tb and 2 <= p.stages <= 4
        table = 4 * n * (deg + 1) + 4 * n * deg
        assert p.smem == p.stages * n * tb + 16 * p.stages + table <= tops.SMEM_BYTES
        assert 1 <= p.blocks <= min(p.tiles, 132 * p.blocks_per_sm)
        assert p.bulk == (tb >= tops.BULK_MIN_BYTES)


def test_plan_shapes_of_the_paths():
    """The paths' shapes: smollm's step at n = 8 in bf16 comes in by bulk
    copies of 2 KB rows; the sim's 144 rows by 16-byte cp.async of 128-byte
    rows; every table of the paths lies under the row limit."""
    p = tops.gossip_plan(8, 4, SMOLLM_ROWS, 2, 132)
    assert (p.tile_bytes, p.stages, p.bulk) == (2048, 2, True)
    q = tops.gossip_plan(144, 6, SIM_ROWS, 4, 132)
    assert (q.tile_bytes, q.stages, q.bulk) == (128, 2, False)
    # main_sim_cross's 17 runs of 16 workers; main_sim's 9; elastic deg_cap = n − 1
    assert 17 * 16 < tops.max_rows(6) and tops.max_rows(7) > 8


@pytest.mark.parametrize("deg", [0, 6, 12])
def test_plan_raises_past_the_row_limit(deg):
    limit = tops.max_rows(deg)
    tops.gossip_plan(limit, deg, [64], 4, 132)
    with pytest.raises(ValueError, match=f"at most {limit:,} rows at deg {deg}"):
        tops.gossip_plan(limit + 1, deg, [64], 4, 132)


def _W(kind):
    if kind == "star":                             # hub of degree 5: padded slots
        edges = [(0, i) for i in range(1, 6)]
        return jgraph.weight_matrix_from_weights(6, edges, np.array([1.0 / 6] * 5))
    topo = make_baseline(kind, 8)
    return jgraph.weight_matrix_from_weights(topo.n, topo.edges, topo.g)


def _leaves(n, dtypes, seed):
    rng = np.random.default_rng(seed)
    shapes = [(130,), (4, 7), (8, 130), (3,)]
    return [rng.standard_normal((n,) + shapes[k % len(shapes)]).astype(np.float32)
            for k in range(len(dtypes))]


@pytest.mark.parametrize("kind", ["ring", "exponential", "star"])
def test_leaves_on_cpu_bitwise_the_per_leaf_plain_mix(kind):
    W = torch.from_numpy(_W(kind).astype(np.float32))
    idx, w = tgossip.padded_neighbors(W)
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.bfloat16, torch.float32]
    xs = [torch.from_numpy(a).to(dt) for a, dt in zip(_leaves(W.shape[0], dtypes, 1), dtypes)]
    before = WRAPPERS["gossip_mix_batched"].launches
    got = tops.gossip_mix_batched_leaves(xs, idx, w)
    assert WRAPPERS["gossip_mix_batched"].launches == before     # the CPU: plain version
    assert len(got) == len(xs)
    for g, x in zip(got, xs):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, tops.gossip_mix_batched_plain(x, idx, w))
        assert torch.equal(g, tops.gossip_mix_batched(x, idx, w))
    assert tops.gossip_mix_batched_leaves([], idx, w) == []


@pytest.mark.parametrize("kind", ["ring", "star"])
def test_leaves_match_pallas_leaf_by_leaf(kind):
    W = _W(kind).astype(np.float32)
    n = W.shape[0]
    dtypes = ["float32", "bfloat16", "float32", "bfloat16"]
    arrays = _leaves(n, dtypes, 2)
    j_idx, j_w = jgossip.padded_neighbors(jnp.asarray(W))
    t_idx, t_w = tgossip.padded_neighbors(torch.from_numpy(W))
    xs = [torch.from_numpy(a).to(getattr(torch, dt)) for a, dt in zip(arrays, dtypes)]
    got = tops.gossip_mix_batched_leaves(xs, t_idx, t_w)
    deg = int(t_idx.shape[1])
    for g, a, dt, x in zip(got, arrays, dtypes, xs):
        jx = jnp.asarray(a, dtype=jnp.float32 if dt == "float32" else jnp.bfloat16)
        want = np.asarray(jops.gossip_mix_batched(jx, j_idx, j_w, use_kernel=True),
                          dtype=np.float32)
        assert g.dtype == x.dtype
        g = g.float().numpy()
        if dt == "float32":
            assert np.abs(g - want).max() <= 1e-6
        else:
            terms = tops.gossip_mix_batched_plain(x.double().abs(), t_idx, t_w.abs()).numpy()
            ulp = np.spacing(np.maximum(np.abs(g), np.abs(want)).astype(np.float32)) * 65536.0
            assert np.all(np.abs(g - want) <= ulp + (deg + 1) * 2.0 ** -24 * terms)


def test_leaves_reject_mixed_devices_and_bad_tables():
    x = torch.zeros((4, 10))
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.gossip_mix_batched_leaves([x, torch.zeros((3, 10))], idx, torch.zeros((4, 3)))
    with pytest.raises(ValueError):
        tops.gossip_mix_batched_leaves([x], idx, torch.zeros((4, 2)))
    with pytest.raises(TypeError):
        tops.gossip_mix_batched_leaves([x, x.double()], idx, torch.zeros((4, 3)))
    with pytest.raises(ValueError):
        tops.gossip_mix_batched_leaves([x, torch.zeros((4, 10), device="meta")], idx,
                                       torch.zeros((4, 3)))


def _per_leaf(xs, nbr_idx, weights):
    return [tops.gossip_mix_batched(x, nbr_idx, weights) for x in xs]


def test_dsgd_step_bitwise_the_per_leaf_composition(tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "TABLE_DIR", tmp_path / "bigram")
    monkeypatch.setattr(tdata, "_TABLES", {})
    n = 4
    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    init, upd = topt.make_optimizer("sgd", tsched.warmup_cosine(0.05, 1, 2))
    dc = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=0)
    runs = []
    for mix in (tops.gossip_mix_batched_leaves, _per_leaf):
        monkeypatch.setattr(tgossip, "gossip_mix_batched_leaves", mix)
        state = ttrainer.init_dsgd_state(0, cfg, n, init, device="cpu")
        step = ttrainer.dsgd_train_step(cfg, make_baseline("exponential", n), upd, device="cpu")
        metrics = []
        for s in range(1):
            per = [tdata.lm_batch_numpy(dc, s, node=i) for i in range(n)]
            state, m = step(state, {k: torch.from_numpy(np.stack([b[k] for b in per]))
                                    for k in per[0]})
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((torch.utils._pytree.tree_leaves(state.params), metrics))
    (grouped, m0), (single, m1) = runs
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(grouped, single))


@pytest.mark.parametrize("compressor", ["dense", "top_k", "random_k"])
def test_sim_step_bitwise_the_per_leaf_composition(monkeypatch, compressor):
    """The sim's step, dense and CHOCO (all four (W − I)x̂ products in one
    grouped call), bitwise the step made of one-leaf calls."""
    from repro_torch.dsgd.dynamic import stack_cycles

    n, dim, hidden, classes, batch = 4, 16, 16, 4, 8
    Ws = np.stack([make_baseline(k, n).W for k in ("ring", "exponential", "grid")])
    Wc, lens = stack_cycles([W[None] for W in Ws])
    table = tsim._Tables(Wc.astype(np.float32), lens, 1, torch.device("cpu")).at(0)
    rows = len(Ws) * n
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((3, rows, batch, dim)).astype(np.float32))
    yb = torch.from_numpy(rng.integers(0, classes, (3, rows, batch)))
    cfg = tsim.DSGDSimConfig(epochs=1, batch=batch, hidden=hidden)
    spec = tsim.CommSpec() if compressor == "dense" else tsim.CommSpec(compressor, 0.25)
    gamma = torch.full((rows,), 0.4)
    runs = []
    for mix in (tops.gossip_mix_batched_leaves, _per_leaf):
        monkeypatch.setattr(tsim, "gossip_mix_batched_leaves", mix)
        params = tsim._stack_params([tsim.init_mlp(0, dim, hidden, classes)], len(Ws), n, "cpu")
        mom = {k: torch.zeros_like(v) for k, v in params.items()}
        hat = {k: torch.zeros_like(v) for k, v in params.items()}
        step = tsim._make_step(spec, cfg, n, len(Ws), gamma)
        gen = torch.Generator().manual_seed(1)
        for t in range(3):
            params, mom, hat = step(params, mom, hat, xb[t], yb[t], table, gen=gen)
        runs.append((params, hat))
    for k in tsim.LEAVES:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
        assert torch.equal(runs[0][1][k], runs[1][1][k])
