"""The port's sharded ADMM (``repro_torch.core.shard``) on gloo ranks against
the JAX package's unsharded drivers, on the CPU.

The JAX package's own sharded layer fails under jax 0.9.0 (ROADMAP.md
Queue 3), so the oracle is its unsharded ``engine.solve_spec`` and its
batched and sweep drivers. Two groups of ranks, 2 and 3 (3 so that m is
padded; it runs ``WORLD3_CASES``), are started once for the module as
subprocesses of this file's
``WORKER`` (one torch thread each, a ``file://`` rendezvous in
``tmp_path``), while this process runs the JAX references.

Edge-partitioned solves, float64, ≤ 30 iterations from tie-free random
starts: every rank returns the same result bitwise; against JAX, g and λ̃
within 1e-10 (the drift is the reassociation of the cross-rank sums), the
same iteration count and history iterations, the same z (the binary
projection's ranks are exact). The history's residual and λ̃ (the
x-iterate's, before the projection) within 1e-9: the port's unsharded
solve is already 1.2e-10 from JAX's history with the default CG tolerance
at ``hetero_eq_ns`` (thirty Newton–Schulz sign iterations a projection
amplify the reassociation). CG counts equal the port's own unsharded
solve's (a homogeneous constraint-space vector is replicated, so every CG
dot is the single-device one; the heterogeneous cases stop above the
float64 floor, see ``EDGE_CASES``), and are within 2 % of JAX's, as the
port's unsharded solve is: the exact-mode CG stops at the float64 floor of
its residual, where another summation order moves a stop by one (1.9 % at
``homo_jacobi_ns``: 360 against 367; ``test_torch_engine.py``'s
``test_solve_spec_matches`` allows 1 % on its cases).
Instance-partitioned restarts and sweeps (B = 3 on 2 ranks, so one
element is padded) are held to JAX's batched and sweep drivers at 300
iterations by ``tests/test_torch_batched.py``'s tolerances.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import shard as jshard  # noqa: E402
from repro.kernels.edge_laplacian import ref as jref  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import shard  # noqa: E402
from repro_torch.core.admm import HomogeneousADMM  # noqa: E402
from repro_torch.kernels.edge_laplacian import ops as tel  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ITERS = 300

# name → (n, r, hetero, equality, ADMMConfig keywords, tolerance on g and
# λ̃ against JAX); ≤ 30 iterations.
# n = 11: m = 55 pads 1 slot on 2 ranks and 2 on 3, and the row-partitioned
# Newton–Schulz pads one row on either.
EDGE_CASES = {
    # the plain window forms, on the padded window as the reference's
    "homo": (11, 18, False, True, dict(max_iters=30, edge_kernel=False), 1e-10),
    "homo_jacobi_ns": (11, 18, False, True, dict(max_iters=30, precond="jacobi",
                                                 psd_backend="newton_schulz"), 1e-10),
    # cg_tol 1e-9: with the default 1e-11 the heterogeneous CG stops at the
    # float64 floor of its residual, where the cross-rank reassociation moves
    # stops by one (λ̃ 5.3e-10 from the port's own unsharded solve at
    # hetero_eq_ns on 2 ranks, 3.4e-10 with every CG dot in the single-device
    # order); 1e-9 stops above it, and the counts agree exactly
    "hetero_ineq_jacobi": (11, 16, True, False, dict(max_iters=20, precond="jacobi",
                                                     cg_tol=1e-9), 1e-10),
    "hetero_eq_ns": (11, 16, True, True, dict(max_iters=20, psd_backend="newton_schulz",
                                              cg_tol=1e-9), 1e-10),
}


#: the cases the group of 3 runs too: Newton–Schulz (its rows pad) on both
#: problems, the heterogeneous one with the binary projection's gather
WORLD3_CASES = ("homo_jacobi_ns", "hetero_eq_ns")


def _edge_inputs(name):
    """Seed-made inputs of one edge case: g0, λ̃0, M, e_cap."""
    n, r, hetero, equality, _, _ = EDGE_CASES[name]
    m = n * (n - 1) // 2
    rng = np.random.default_rng(len(name))
    g0 = np.abs(rng.normal(size=m)) * 0.1
    if not hetero:
        return g0, 0.5, None, None
    M = rng.integers(0, 2, size=(4, m)).astype(np.float64)
    e_cap = M @ (g0 > 0.05) if equality else M.sum(axis=1) * 0.4
    return g0, 0.5, M, e_cap


def _batched_inputs():
    """``tests/test_torch_batched.py``'s homogeneous restarts (n=8, r=12)."""
    rng = np.random.default_rng(19)
    return rng.random((3, 28)) * 0.3, np.array([0.5, 0.4, 0.6])


def _sweep_inputs():
    """Three tie-free budgets 10, 14, 18 on the spec of budget 18 (n=8)."""
    rng = np.random.default_rng(8)
    return [10, 14, 18], rng.random((3, 28)) * 0.3, np.array([0.4, 0.45, 0.5])


WORKER = r'''
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, init, jobs_path, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
from repro_torch.core import BATopoConfig, engine as te, shard, sweep_topologies
from repro_torch.core.admm import HomogeneousADMM

jobs = pickle.load(open(jobs_path, "rb"))
out = {}


def spec_of(job):
    cfg = te.ADMMConfig(device="cpu", **job["cfg"])
    if job["M"] is None:
        return cfg, te.make_homo_spec(job["n"], job["r"], cfg)
    return cfg, te.make_hetero_spec(job["n"], job["r"], job["M"], job["e_cap"], cfg,
                                    equality=job["equality"])


for name, job in jobs["edges"].items():
    cfg, spec = spec_of(job)
    # rank r's own start is rank 0's perturbed: the entry broadcast undoes it
    g0 = job["g0"] * (1.0 + 1e-3 * rank)
    out[name] = shard.solve_spec_sharded(spec, te.init_state(spec, g0, job["lam0"]), cfg)

if "batched" in jobs:
    job = jobs["batched"]
    cfg, spec = spec_of(job)
    out["batched"] = shard.solve_batched_spec_sharded(
        spec, te.init_state(spec, job["g0s"], job["lam0s"]), cfg)
    job = jobs["sweep"]
    cfg, spec = spec_of(job)
    out["sweep"] = shard.solve_sweep_spec_sharded(
        spec, job["rs"], te.init_state(spec, job["g0s"], job["lam0s"]), cfg)

if "dispatch" in jobs:
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("solve_spec_sharded", "solve_batched_spec_sharded",
                 "solve_sweep_spec_sharded"):
        setattr(shard, name, spy(name, getattr(shard, name)))
    shard.EDGE_PARTITION_MIN_N = 4
    cfg = te.ADMMConfig(device="cpu", partition="auto", max_iters=20)
    admm = HomogeneousADMM(8, 12, cfg)
    rng = np.random.default_rng(3)
    trace = {"auto@8": te.resolve_partition("auto", 8), "auto@8,B=2":
             te.resolve_partition("auto", 8, batch=2)}
    admm.solve(rng.random(28) * 0.3, 0.5)
    trace["solve"] = list(calls)
    calls.clear()
    admm.solve_batched(rng.random((2, 28)) * 0.3, [0.5, 0.4])
    trace["solve_batched"] = list(calls)
    calls.clear()
    bcfg = BATopoConfig(device="cpu", sa_iters=40, polish_iters=40, admm=cfg)
    topos = sweep_topologies([8], [10, 12], cfg=bcfg)
    trace["sweep_topologies"] = list(calls)
    trace["sweep_edges"] = sorted(len(t.edges) for t in topos.values())
    out["dispatch"] = trace

pickle.dump(out, open(f"{out_dir}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
'''


def _start(world, jobs, tmp):
    tmp.mkdir()
    jobs_path = tmp / "jobs.pkl"
    jobs_path.write_bytes(pickle.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(rank), str(world), init,
                              str(jobs_path), str(tmp)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]


def _join(procs, tmp):
    outs = []
    for rank, proc in enumerate(procs):
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"rank {rank} failed:\n{log}"
        outs.append(pickle.loads((tmp / f"rank{rank}.pkl").read_bytes()))
    return outs


def _edge_job(name):
    n, r, hetero, equality, cfg, _ = EDGE_CASES[name]
    g0, lam0, M, e_cap = _edge_inputs(name)
    return dict(n=n, r=r, cfg=cfg, g0=g0, lam0=lam0, M=M, e_cap=e_cap, equality=equality)


def _jax_edge(name):
    n, r, hetero, equality, cfg, _ = EDGE_CASES[name]
    g0, lam0, M, e_cap = _edge_inputs(name)
    jcfg = je.ADMMConfig(**cfg)
    spec = (je.make_hetero_spec(n, r, M, e_cap, jcfg, equality=equality) if hetero
            else je.make_homo_spec(n, r, jcfg))
    return je.solve_spec(spec, je.init_state(spec, jnp.asarray(g0), lam0), jcfg)


def _port_edge(name):
    """The port's own unsharded solve of an edge case."""
    n, r, hetero, equality, cfg, _ = EDGE_CASES[name]
    g0, lam0, M, e_cap = _edge_inputs(name)
    tcfg = te.ADMMConfig(device="cpu", **cfg)
    spec = (te.make_hetero_spec(n, r, M, e_cap, tcfg, equality=equality) if hetero
            else te.make_homo_spec(n, r, tcfg))
    return te.solve_spec(spec, te.init_state(spec, g0, lam0), tcfg)


def _jax_states(spec, g0s, lam0s):
    return jax.vmap(lambda g, l: je.init_state(spec, g, l))(jnp.asarray(g0s),
                                                            jnp.asarray(lam0s))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both groups' results (one list a group, one entry a rank) and the
    JAX references, computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("shard")
    g0s, lam0s = _batched_inputs()
    rs, sg0s, slam0s = _sweep_inputs()
    jobs2 = {"edges": {k: _edge_job(k) for k in EDGE_CASES},
             "batched": dict(n=8, r=12, cfg=dict(max_iters=ITERS), g0s=g0s, lam0s=lam0s,
                             M=None),
             "sweep": dict(n=8, r=max(rs), cfg=dict(max_iters=ITERS), rs=rs, g0s=sg0s,
                           lam0s=slam0s, M=None),
             "dispatch": True}
    jobs3 = {"edges": {k: _edge_job(k) for k in WORLD3_CASES}}
    procs2, procs3 = _start(2, jobs2, tmp / "w2"), _start(3, jobs3, tmp / "w3")
    try:
        want = {k: _jax_edge(k) for k in EDGE_CASES}
        cfg = je.ADMMConfig(max_iters=ITERS)
        spec = je.make_homo_spec(8, 12, cfg)
        want["batched"] = je.solve_batched_spec(spec, _jax_states(spec, g0s, lam0s), cfg)
        spec = je.make_homo_spec(8, max(rs), cfg)
        want["sweep"] = je.solve_sweep_spec(spec, np.asarray(rs),
                                            _jax_states(spec, sg0s, slam0s), cfg)
    finally:
        got = {2: _join(procs2, tmp / "w2"), 3: _join(procs3, tmp / "w3")}
    return got, want


def _same_bits(a, b):
    """Two ranks' results of one solve are the same bits."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("world,name", [(2, k) for k in EDGE_CASES]
                         + [(3, k) for k in WORLD3_CASES])
def test_edge_partitioned_solve_matches_the_unsharded_reference(ranks, world, name):
    got, want = ranks
    res, ref = got[world][0][name], want[name]
    for other in got[world][1:]:
        _same_bits(res, other[name])
    tol = EDGE_CASES[name][5]
    np.testing.assert_allclose(res.g, np.asarray(ref.g), rtol=0, atol=tol)
    np.testing.assert_allclose(res.g_raw, np.asarray(ref.g_raw), rtol=0, atol=tol)
    assert abs(res.lam_tilde - ref.lam_tilde) <= tol
    assert res.iters == ref.iters == EDGE_CASES[name][4]["max_iters"]
    assert [h[0] for h in res.history] == [h[0] for h in ref.history]
    np.testing.assert_allclose(np.array(res.history)[:, 1:], np.array(ref.history)[:, 1:],
                               rtol=0, atol=1e-9)
    assert abs(res.cg_iters - ref.cg_iters) <= 0.02 * ref.cg_iters
    assert res.cg_iters == _port_edge(name).cg_iters
    if EDGE_CASES[name][2]:
        assert (res.z == np.asarray(ref.z)).all()


def _assert_same_solve(got, want):
    """``tests/test_torch_batched.py``'s per-instance check."""
    def support(g):
        return tuple(np.nonzero(np.asarray(g) > 1e-6)[0])

    assert support(got.g) == support(want.g)
    assert abs(got.lam_tilde - want.lam_tilde) <= 1e-6
    assert got.iters == want.iters
    assert [h[0] for h in got.history] == [h[0] for h in want.history]
    assert abs(got.cg_iters - want.cg_iters) <= 0.01 * want.cg_iters


@pytest.mark.parametrize("driver", ["batched", "sweep"])
def test_instance_partitioned_drivers_match_the_reference(ranks, driver):
    got, want = ranks
    res = got[2][0][driver]
    assert len(res) == 3
    for a, b in zip(res, got[2][1][driver]):
        _same_bits(a, b)
    for a, b in zip(res, want[driver]):
        _assert_same_solve(a, b)


def test_dispatch_on_two_ranks_follows_the_reference(ranks):
    """``EDGE_PARTITION_MIN_N`` patched to 4 inside the ranks, partition
    ``"auto"``: a single solve takes the edge path, a batch of 2 on 2 ranks
    the instance path, and ``sweep_topologies``' two budgets the instance
    path of ``_sweep_one_n``."""
    got, _ = ranks
    for out in got[2]:
        trace = out["dispatch"]
        assert trace["auto@8"] == "edges" and trace["auto@8,B=2"] == "instances"
        assert trace["solve"] == ["solve_spec_sharded"]
        assert trace["solve_batched"] == ["solve_batched_spec_sharded"]
        assert trace["sweep_topologies"] == ["solve_sweep_spec_sharded"]
        assert trace["sweep_edges"] == [10, 12]


def test_a_process_without_a_group_stays_on_none(monkeypatch):
    monkeypatch.setattr(shard, "EDGE_PARTITION_MIN_N", 4)
    assert not torch.distributed.is_initialized()
    assert te.resolve_partition("auto", 4096) == "none"
    assert te.resolve_partition("auto", 8, batch=8) == "none"
    calls = []
    monkeypatch.setattr(shard, "solve_spec_sharded",
                        lambda *a, **kw: calls.append(a))
    res = HomogeneousADMM(8, 12, te.ADMMConfig(device="cpu", partition="auto",
                                                max_iters=10)).solve()
    assert not calls and res.iters == 10


@pytest.mark.parametrize("env,rank,want", [(None, 3, 1), ("2", 3, 0)])
def test_a_rank_asking_for_cuda_gets_its_card(monkeypatch, env, rank, want):
    """In a process group, ``"cuda"`` is ``cuda:<local rank % device
    count>`` (LOCAL_RANK when set, else the group rank), made current; an
    index or the CPU is kept, and a process without a group keeps
    ``"cuda"``."""
    from repro_torch import device as tdev

    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    assert tdev.resolve_device("cuda") == torch.device("cuda") and not current
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: rank)
    if env is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", env)
    assert tdev.resolve_device("cuda") == torch.device("cuda", want)
    assert current == [torch.device("cuda", want)]
    assert tdev.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert tdev.resolve_device("cpu") == torch.device("cpu")


def test_resolve_partition_equals_the_reference_on_its_grid():
    for part in ("none", "edges", "instances", "auto"):
        for n in (8, 64, 511, 512, 513, 4096):
            for batch in (None, *range(1, 9)):
                for ndev in range(1, 9):
                    assert (shard.resolve_partition(part, n, batch, ndev)
                            == jshard.resolve_partition(part, n, batch, ndev)), \
                        (part, n, batch, ndev)
    assert shard.EDGE_PARTITION_MIN_N == jshard.EDGE_PARTITION_MIN_N == 512
    for mod in (shard, jshard):
        with pytest.raises(ValueError, match="unknown partition"):
            mod.resolve_partition("Edges", 64, None, 8)


@pytest.mark.parametrize("n", [5, 12, 24])
def test_window_plain_forms_are_the_reference_windows(n):
    """A world of 3: the windows start, end and (the last) pad at every
    rank. ``edge_laplacian_window_plain`` is bitwise the reference's
    ``edge_laplacian_window`` in float64 (its rows sum in index order,
    XLA:CPU's order for these rows), the wrapper's window (the unpadded
    slice) the same bits, and the windows sum to L(g). The windowed
    ``edge_adjoint`` is the full call's entries and trace, bitwise."""
    m = n * (n - 1) // 2
    m_loc = -(-m // 3)
    rng = np.random.default_rng(n)
    g = np.zeros(3 * m_loc)
    g[:m] = rng.standard_normal(m)
    lidx = tel.packed_edge_index(n)
    P, Q, w, v = (torch.from_numpy(rng.standard_normal(s)) for s in ((n, n), (n, n), n, m))
    full = tel.edge_adjoint(P, Q, w, v)
    total = torch.zeros(n, n, dtype=torch.float64)
    for rank in range(3):
        first = rank * m_loc
        count = max(0, min(m_loc, m - first))
        g_loc = g[first:first + m_loc]
        want = np.asarray(jref.edge_laplacian_window(jnp.asarray(g_loc), jnp.asarray(lidx.numpy()),
                                                     first))
        got = tel.edge_laplacian_window_plain(torch.from_numpy(g_loc), lidx, first)
        assert got.numpy().tobytes() == want.tobytes()
        wrapped = tel.edge_laplacian(torch.from_numpy(g_loc[:count]), n, first)
        assert wrapped.numpy().tobytes() == want.tobytes()
        total += wrapped
        x = tel.edge_adjoint(P, Q, w, v[first:first + count], first, count)
        assert x.shape == (count + 1,)
        assert x[:count].numpy().tobytes() == full[first:first + count].numpy().tobytes()
        assert x[count].item() == full[m].item()
    L = tel.edge_laplacian(torch.from_numpy(g[:m]), n)
    np.testing.assert_allclose(total.numpy(), L.numpy(), rtol=0, atol=1e-12)
    assert tel.edge_laplacian(torch.from_numpy(g[:m]), n, 0).numpy().tobytes() == \
        L.numpy().tobytes()


def test_windows_outside_the_list_are_refused():
    with pytest.raises(ValueError, match="does not lie"):
        tel.edge_laplacian(torch.zeros(3, dtype=torch.float64), 4, 4)
    P = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="does not lie"):
        tel.edge_adjoint(P, P, torch.zeros(4), None, 5, 2)
    with pytest.raises(ValueError, match="both first and count"):
        tel.edge_adjoint(P, P, torch.zeros(4), None, 0)
    with pytest.raises(ValueError, match="schur_cg"):
        cfg = te.ADMMConfig(device="cpu", solver="kkt_bicgstab")
        spec = te.make_homo_spec(6, 8, cfg)
        shard.solve_spec_sharded(spec, te.init_state(spec, np.zeros(15), 0.5), cfg)
    with pytest.raises(ValueError, match="ndev=2"):
        cfg = te.ADMMConfig(device="cpu")
        spec = te.make_homo_spec(6, 8, cfg)
        shard.solve_spec_sharded(spec, te.init_state(spec, np.zeros(15), 0.5), cfg, ndev=2)
