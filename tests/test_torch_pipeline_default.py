"""The port's default pipeline stack on the CPU, its evaluation, and the
rules the package keeps (imports, device default, what is not ported).

With the default stack (device SA, float32 ADMM with inexact CG, float32
polish) the port's random SA streams differ from ``jax.random``, so the
result is held to release validity and to a band around the JAX package's
default-stack result: |Δr_asym| ≤ 0.05 (the largest gap measured on the
CPU over the four scenarios and two seeds was 0.018). The consensus
simulation is held to 1e-10 of the reference's on the same initial values.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import BATopoConfig as JaxConfig  # noqa: E402
from repro.core import consensus as j_consensus  # noqa: E402
from repro.core.anytime import TopologyRequest as JaxRequest  # noqa: E402
from repro.core.anytime import solve_topology as jax_solve  # noqa: E402
from repro.core.constraints import bcube_constraints as jax_bcube  # noqa: E402
from repro.core.constraints import intra_server_constraints as jax_intra  # noqa: E402
from repro_torch.core import (BATopoConfig, TopologyRequest, check_invariants,  # noqa: E402
                              solve_topology)
from repro_torch.core import anytime as t_anytime  # noqa: E402
from repro_torch.core import consensus as t_consensus  # noqa: E402
from repro_torch.core.constraints import bcube_constraints, intra_server_constraints  # noqa: E402
from repro_torch.core.topologies import make_baseline  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODE_BW_16 = np.array([9.76] * 8 + [3.25] * 8)
SCENARIOS = {
    "homo": dict(n=16, r=32, scenario="homo"),
    "node": dict(n=16, r=32, scenario="node", node_bandwidths=NODE_BW_16),
    "intra": dict(n=8, r=12, scenario="constraint", cs="intra"),
    "bcube": dict(n=16, r=48, scenario="constraint", cs="bcube"),
}
FAST = dict(sa_iters=120, polish_iters=100, restarts=1)


def _requests(name):
    kw = dict(SCENARIOS[name])
    cs = kw.pop("cs", None)
    jax_cs = {"intra": jax_intra(8), "bcube": jax_bcube(p=4, k=2)}.get(cs)
    port_cs = {"intra": intra_server_constraints(8),
               "bcube": bcube_constraints(p=4, k=2)}.get(cs)
    return JaxRequest(cs=jax_cs, **kw), TopologyRequest(cs=port_cs, **kw)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_default_stack_is_release_valid_within_band(name):
    jreq, treq = _requests(name)
    want = jax_solve(jreq, cfg=JaxConfig(**FAST))
    got = solve_topology(treq, cfg=BATopoConfig(device="cpu", **FAST))
    assert got.complete and got.quality_tier == "full"
    assert check_invariants(got.topology) is None
    assert len(got.topology.edges) <= treq.r
    if treq.cs is not None:
        sel = np.zeros(treq.n * (treq.n - 1) // 2, dtype=bool)
        for i, j in got.topology.edges:
            sel[i * treq.n - i * (i + 1) // 2 + (j - i - 1)] = True
        assert treq.cs.feasible(sel)
    assert abs(got.r_asym - want.r_asym) <= 0.05


def test_budgeted_solve_streams_and_stays_valid():
    req = TopologyRequest(n=12, r=24, deadline_ms=60_000.0)
    solver = t_anytime.AnytimeSolver(req, BATopoConfig(device="cpu", **FAST))
    seen = []
    while (inc := solver.next_improvement()) is not None:
        seen.append(inc.r_asym)
    assert seen and all(b <= a for a, b in zip(seen, seen[1:]))
    res = solver.result()
    assert check_invariants(res.topology) is None and res.r_asym == seen[-1]
    expired = solve_topology(TopologyRequest(n=12, r=24),
                             cfg=BATopoConfig(device="cpu", **FAST), budget_ms=1e-3)
    assert not expired.complete and expired.quality_tier == "classic"
    assert check_invariants(expired.topology) is None


def test_consensus_matches_reference_on_shared_initial_values():
    n = 16
    topos = [make_baseline(k, n) for k in ("ring", "torus", "hypercube")]
    x0 = np.random.default_rng(0).standard_normal((n, 8))
    Ws = np.stack([t.W for t in topos])
    want = np.asarray(j_consensus._consensus_errors_batched(Ws, x0, 60))
    got = t_consensus.simulate_consensus_batched(topos, iters=60, x0=x0, device="cpu")
    for k, tr in enumerate(got):
        np.testing.assert_allclose(tr.errors, want[k], rtol=0, atol=1e-10)
        assert t_consensus.time_to_error(tr, 1e-3) == pytest.approx(
            j_consensus.time_to_error(j_consensus.ConsensusTrace(
                errors=want[k], t_iter_ms=float("nan"),
                times_ms=np.arange(61, dtype=float), topology=""), 1e-3))
    timed = t_consensus.simulate_consensus_batched(topos[:1], iters=60, x0=x0,
                                                   b_mins=[2.0], device="cpu")[0]
    np.testing.assert_allclose(timed.errors, want[0], rtol=0, atol=1e-10)
    assert np.isfinite(timed.t_iter_ms) and timed.times_ms[1] == timed.t_iter_ms


def test_entry_points_not_ported_raise_naming_the_roadmap_item():
    """The W-matmul train step (item 7c, ported) builds over a topology,
    and a decode step over a mesh (item 7c′) raises naming the roadmap
    item; a ``driver="python"`` request (item 2, ported)
    runs through the barrier engine, one restart at a time, to a
    release-valid topology, and so does ``partition="edges"`` (item 7a,
    ported: one process is a world of one rank)."""
    from repro_torch.core.engine import ADMMConfig
    from repro_torch.dsgd.trainer import make_matmul_gossip_train_step
    from repro_torch.launch.steps import build_step
    from repro_torch.optim import sgd_momentum

    assert callable(make_matmul_gossip_train_step(None, make_baseline("ring", 4),
                                                  sgd_momentum(0.05)[1]))
    with pytest.raises(NotImplementedError, match="Queue 1, item 7c′"):
        build_step("smollm-135m", "decode_32k", None)
    for admm in (ADMMConfig(driver="python", max_iters=40),
                 ADMMConfig(partition="edges", max_iters=40)):
        cfg = BATopoConfig(device="cpu", sa_iters=60, polish_iters=50, restarts=2, admm=admm)
        res = solve_topology(TopologyRequest(n=8, r=12), cfg=cfg, engine="barrier")
        assert res.complete and check_invariants(res.topology) is None


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_topology(TopologyRequest(n=8, r=12))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_consensus.simulate_consensus_batched([make_baseline("ring", 8)])


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _foreign(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_and_chip_smoke_never_import_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(n for n in _imports(f) if _foreign(n))
           for f in files}
    assert not {f: n for f, n in bad.items() if n}
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the no-card exit cannot be checked here")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text(encoding="utf-8"))
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
