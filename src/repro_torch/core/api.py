"""High-level BA-Topo pipeline helpers, in the port.

The stages ``anytime.AnytimeSolver`` runs, ported from ``repro.core.api``:
scenario → ConstraintSet, greedy start graphs, simulated annealing on the
device (``warmstart``), the ADMM solve, support extraction + greedy
feasibility repair, and the classic candidates. ``BATopoConfig`` carries
``device`` (default ``"cuda"``), handed down to the ADMM solver, the SA and
the polish.

Deviation from the reference: ``BATopoConfig.sa_kernel`` defaults to True,
so every BFS hop of the SA runs the ``hop_bfs`` CUDA kernel on the card;
False selects the plain PyTorch hop explicitly.

The phase-barriered pipeline ``_optimize_request`` (behind
``solve_topology(engine="barrier")`` and the deprecated
``optimize_topology``) runs all SA restarts, then all ADMM restarts as ONE
``solve_batched`` call, then rounding, one polish call for every candidate
and the pick; pass ``profile={}`` for its ``warm_s/admm_s/round_s/
polish_s/eval_s`` wall times. Every phase ends in a host read of its
result, so the times are the card's and not the time to enqueue.

``_sweep_one_n`` solves every budget of one node count as one batched ADMM
solve (``engine.solve_sweep_spec``), then rounds, polishes
(``_finalize_batch``) and picks (``_pick_best``) per budget; it is what
``anytime.solve_topologies`` and the deprecated ``sweep_topologies`` stand
on.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, replace

import numpy as np

from ..device import resolve_device
from .admm import ADMMConfig, HeterogeneousADMM, HomogeneousADMM
from .anneal import anneal_topology, greedy_degree_graph
from .constraints import ConstraintSet
from .graph import (Topology, all_edges, edge_index, is_connected, r_asym,
                    weight_matrix_from_weights)
from .weights import metropolis_weights, polish_weights, polish_weights_batched

__all__ = ["BATopoConfig", "optimize_topology", "sweep_topologies",
           "extract_support", "repair_selection", "large_n_admm_config"]


def _pipeline_admm_default() -> ADMMConfig:
    """Pipeline-default ADMM stack (the reference's ``api.py:49-65``): fp32
    loop with fp64 residuals, inexact CG tied to the primal residual, a
    600-iteration budget, and the "auto" PSD backend and partition — on one
    GPU at n < 256 they resolve to eigh and the unpartitioned solve, the
    same stack as the reference on one device."""
    return ADMMConfig(max_iters=600, cg_inexact=True, dtype="float32",
                      psd_backend="auto", partition="auto")


def large_n_admm_config(max_iters: int = 600) -> ADMMConfig:
    """The measured large-n solver stack as an explicit factory for direct
    solver use and benchmarks: the pipeline default (fp32 loop with fp64
    residuals, inexact CG tied to the primal residual, the "auto" PSD
    backend and partition) at ``max_iters``, named so callers need not rely
    on the pipeline default staying the same."""
    return replace(_pipeline_admm_default(), max_iters=max_iters)


@dataclass
class BATopoConfig:
    admm: ADMMConfig = field(default_factory=_pipeline_admm_default)
    sa_iters: int = 1500
    polish_iters: int = 500
    support_tol: float = 1e-6
    seed: int = 0
    restarts: int = 1
    warmstart: str = "device"     # device (batched SA) | host (numpy oracle)
    polish: str = "device"        # device (batched loop) | host (numpy)
    polish_dtype: str = "float32"  # device polish loop dtype (f64 bookkeeping)
    # Deviation from the reference (False there): every SA BFS hop runs the
    # hop_bfs kernel on the card; False selects the plain hop explicitly.
    sa_kernel: bool = True
    device: str = "cuda"          # handed to the ADMM solver, SA and polish


def _validate_pipeline_cfg(cfg: BATopoConfig) -> None:
    """Reject typo'd backend selectors (a silently-ignored
    ``warmstart="Device"`` would benchmark the wrong pipeline)."""
    if cfg.warmstart not in ("device", "host"):
        raise ValueError(f"unknown warmstart {cfg.warmstart!r}; "
                         "expected 'device' or 'host'")
    if cfg.polish not in ("device", "host"):
        raise ValueError(f"unknown polish {cfg.polish!r}; "
                         "expected 'device' or 'host'")
    if cfg.polish_dtype not in ("float32", "float64"):
        raise ValueError(f"unknown polish_dtype {cfg.polish_dtype!r}; "
                         "expected 'float32' or 'float64'")
    resolve_device(cfg.device)


def extract_support(
    n: int, g: np.ndarray, r: int, tol: float, z: np.ndarray | None = None,
    edge_ok: np.ndarray | None = None,
) -> np.ndarray:
    """Boolean selection over the full candidate edge list: top-r weights
    (optionally gated by the binary z of the heterogeneous solver)."""
    m = len(g)
    score = np.asarray(g, dtype=np.float64).copy()
    if z is not None:
        score = score + 1e-3 * np.asarray(z)  # prefer z-selected edges on ties
    if edge_ok is not None:
        score[~edge_ok] = -np.inf
    score[score <= tol] = -np.inf
    k = min(r, int(np.isfinite(score).sum()))
    sel = np.zeros(m, dtype=bool)
    if k > 0:
        idx = np.argpartition(-score, k - 1)[:k]
        sel[idx] = True
    return sel


def repair_selection(n: int, sel: np.ndarray, g: np.ndarray, cs: ConstraintSet | None) -> np.ndarray:
    """Greedy feasibility + connectivity repair of a rounded edge selection.

    1. While a capacity row is violated (M z > e), drop the lowest-weight
       selected edge contributing to the most-violated row.
    2. While the graph is disconnected, add the highest-weight admissible
       edge joining two components that does not violate capacities.

    Capacity usage ``M @ sel`` is computed once per phase and updated
    incrementally as edges are dropped/added (it used to be recomputed per
    candidate edge, a quadratic hot spot on dense candidate sets).
    """
    edges_full = all_edges(n)
    sel = sel.copy()
    g = np.asarray(g, dtype=np.float64)
    usage = cs.M @ sel.astype(np.int64) if cs is not None else None

    if cs is not None:
        while True:
            over = usage - cs.e_cap
            if np.all(over <= 0):
                break
            row = int(np.argmax(over))
            members = [l for l in np.nonzero(sel)[0] if cs.M[row, l]]
            drop = min(members, key=lambda l: g[l])
            sel[drop] = False
            usage = usage - cs.M[:, drop]

    def comps(sel_mask):
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for l in np.nonzero(sel_mask)[0]:
            i, j = edges_full[l]
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
        return [find(i) for i in range(n)]

    for _ in range(n):
        c = comps(sel)
        if len(set(c)) == 1:
            break
        cands = []
        for l, (i, j) in enumerate(edges_full):
            if sel[l] or c[i] == c[j]:
                continue
            if cs is not None:
                if not cs.edge_ok[l]:
                    continue
                if np.any(usage + cs.M[:, l] > cs.e_cap):
                    continue
            cands.append(l)
        if not cands:
            break  # cannot connect under capacities — caller handles r_asym=1
        best = max(cands, key=lambda l: g[l])
        sel[best] = True
        if cs is not None:
            usage = usage + cs.M[:, best]
    return sel


def _homo_degree_targets(n: int, r: int) -> np.ndarray:
    """Balanced degree sequence with Σd = 2r (homogeneous Algorithm-1 limit)."""
    base = (2 * r) // n
    extra = (2 * r) % n
    d = np.full(n, base, dtype=np.int64)
    d[:extra] += 1
    return np.minimum(d, n - 1)


def _finalize_batch(n: int, items: list[tuple[np.ndarray, str, dict]],
                    cfg: BATopoConfig, cs: ConstraintSet | None) -> list[Topology]:
    """Connectivity-check + weight-polish a batch of candidate selections.
    Each distinct connected support is polished once, all of them in one
    ``polish_weights_batched`` call on ``cfg.device`` (``cfg.polish="host"``
    keeps the serial numpy loop); a disconnected candidate keeps its
    Metropolis weights and ``meta["connected"] = False``."""
    edges_full = all_edges(n)
    topos: list[Topology | None] = [None] * len(items)
    # identical supports (an ADMM result that rounds back to its warm start,
    # coinciding restarts) polish to identical weights: solve each once
    support_of: dict[bytes, list[int]] = {}
    for k, (sel, name, meta) in enumerate(items):
        edges = [edges_full[l] for l in np.nonzero(sel)[0]]
        if not edges or not is_connected(n, edges):
            g = metropolis_weights(n, edges) if edges else np.zeros(0)
            topos[k] = Topology(n, edges, g, name=name,
                                meta={**meta, "connected": False})
            continue
        support_of.setdefault(np.asarray(sel, dtype=bool).tobytes(), []).append(k)
    if support_of:
        pending = []
        for ks in support_of.values():
            edges = [edges_full[l] for l in np.nonzero(items[ks[0]][0])[0]]
            pending.append((ks, edges, metropolis_weights(n, edges)))
        if cfg.polish == "device":
            gs = polish_weights_batched(
                n, [e for _, e, _ in pending], [g0 for _, _, g0 in pending],
                iters=cfg.polish_iters, dtype=cfg.polish_dtype, device=cfg.device)
        else:
            gs = [polish_weights(n, e, g0, iters=cfg.polish_iters)
                  for _, e, g0 in pending]
        for (ks, edges, _), g in zip(pending, gs):
            for k in ks:
                _, name, meta = items[k]
                topos[k] = Topology(n, edges, g, name=name,
                                    meta={**meta, "connected": True})
    return topos


def _pick_best(n: int, items, topos, sources,
               ) -> tuple[Topology | None, float, list[str]]:
    """Release-validate each connected candidate against the ``guard``
    invariant checklist (finite W, symmetry, row-stochasticity,
    connectivity) and pick the lowest r_asym among the survivors, one
    invariant check and one r_asym per distinct support; the winner's
    ``meta["selected_from"]`` names its source. Returns ``(best, best_val,
    failures)``, ``failures`` naming the invariant each flunked candidate
    violated."""
    from .guard import check_invariants

    best: Topology | None = None
    best_val = np.inf
    val_cache: dict[bytes, float] = {}
    inv_cache: dict[bytes, str | None] = {}
    failures: list[str] = []
    for (sel, _, _), cand, src in zip(items, topos, sources):
        if not cand.meta.get("connected", False):
            continue
        key = np.asarray(sel, dtype=bool).tobytes()
        if key not in inv_cache:
            inv_cache[key] = check_invariants(cand)
        bad = inv_cache[key]
        if bad is not None:
            failures.append(f"{cand.name}: {bad}")
            continue
        if key not in val_cache:
            val_cache[key] = cand.r_asym()
        val = val_cache[key]
        if best is None or val < best_val:
            cand.meta["selected_from"] = src
            best, best_val = cand, val
    return best, best_val, failures


def _sweep_one_n(n: int, rs_req: list[int], cfg: BATopoConfig) -> dict:
    """Every budget in ``rs_req`` for one node count, homogeneous: one warm
    start per (n, r) (``_init_graph``, the SA of ``_anneal_edges``,
    ``_pack_warm``; instance k plays restart k), ONE batched ADMM solve of
    all budgets (``solve_sweep_spec`` on the spec of the largest; split
    over the ranks by ``ADMMConfig.partition`` as the reference does), then per
    budget the candidates (ADMM, warm start, feasible classics), one polish
    call and the pick. Returns ``{(n, r): Topology}`` keyed by the
    requested r (budgets above the candidate-edge count are clamped for the
    solve). Raises ``TopologyInvariantError`` when no candidate of a budget
    passes release validation."""
    import torch

    from .engine import check_solver, init_state, make_homo_spec, solve_sweep_spec
    from .shard import resolve_partition, solve_spec_sharded, solve_sweep_spec_sharded

    admm = replace(cfg.admm, device=cfg.device)
    check_solver(admm)
    m = len(all_edges(n))
    rs_n = [min(r, m) for r in rs_req]
    spec = make_homo_spec(n, max(rs_n), admm)
    inits, seeds = [], []
    for k, r in enumerate(rs_n):
        edges0, seed = _init_graph(n, r, "homo", None, _homo_degree_targets(n, r), cfg, k)
        inits.append(edges0)
        seeds.append(seed)
    warms = [_pack_warm(n, e) for e in _anneal_edges(n, inits, seeds, None, cfg)]
    states = init_state(spec, np.stack([g0 for g0, _, _ in warms]),
                        np.array([lam0 for _, _, lam0 in warms]))
    part = resolve_partition(admm.partition, n, batch=len(rs_n))
    if part == "instances":
        results = solve_sweep_spec_sharded(spec, rs_n, states, admm)
    elif part == "edges":
        results = [solve_spec_sharded(
            spec.replace(r=torch.tensor(rn, dtype=torch.int64, device=spec.I.device)),
            states.map(lambda a, k=k: a[k]), admm, r_cap=max(rs_n))
            for k, rn in enumerate(rs_n)]
    else:
        results = solve_sweep_spec(spec, rs_n, states, admm)
    out: dict = {}
    for r_req, r, warm, res in zip(rs_req, rs_n, warms, results):
        meta = {"scenario": "homo", "r": r}
        items, sources = _candidate_items(n, r, [warm], [res], None, cfg, meta, use_z=False)
        topos = _finalize_batch(n, items, cfg, None)
        best, best_val, failures = _pick_best(n, items, topos, sources)
        if best is None and failures:
            from .guard import TopologyInvariantError

            bad = failures[0].rsplit(": ", 1)[-1]
            raise TopologyInvariantError(
                f"no candidate topology for n={n}, r={r} passed release "
                f"validation — first failure: {failures[0]!r} "
                f"(all: {failures})", invariant=bad, failures=failures)
        if best is not None:
            best.meta["r_asym"] = best_val
        out[(n, r_req)] = best
    return out


def _candidate_items(n: int, r: int, warms, results, cs: ConstraintSet | None,
                     cfg: BATopoConfig, meta: dict, use_z: bool,
                     ) -> tuple[list[tuple[np.ndarray, str, dict]], list[str]]:
    """Phase 3 of the solve: round every ADMM result (top-r support + greedy
    feasibility repair), and enter the annealed warm starts and the feasible
    classic baselines as competing candidates. Returns the ``(sel, name,
    meta)`` items plus a parallel provenance list."""
    items: list[tuple[np.ndarray, str, dict]] = []
    sources: list[str] = []
    edge_ok = (np.asarray(cs.edge_ok)
               if (use_z and cs is not None) else None)
    for (g0, z0, lam0), res in zip(warms, results):
        score = res.g + res.g_raw
        if use_z:
            sel = extract_support(n, score, r, cfg.support_tol, z=res.z,
                                  edge_ok=edge_ok)
        else:
            sel = extract_support(n, score, r, cfg.support_tol)
        sel = repair_selection(n, sel, score, cs)
        items.append((sel, f"ba-topo(n={n},r={r})", {**meta,
                      "admm_iters": res.iters, "admm_residual": res.residual,
                      "lam_tilde": res.lam_tilde}))
        sources.append("admm")
        items.append((z0.astype(bool), f"ba-topo(n={n},r={r},warm)",
                      dict(meta)))
        sources.append("warm-start")
    for base_name, sel in _classic_candidates(n, r, cs):
        items.append((sel, f"ba-topo(n={n},r={r},{base_name})", dict(meta)))
        sources.append(f"classic:{base_name}")
    return items, sources


def _init_graph(n: int, r: int, scenario: str, cs: ConstraintSet | None,
                deg_targets, cfg: BATopoConfig, restart: int):
    """Greedy feasible start graph for one restart. Returns (edges0, seed)."""
    seed = cfg.seed + 1000 * restart
    rng = np.random.default_rng(seed)
    if deg_targets is not None:
        warm_cs = cs if scenario == "node" else None
        return greedy_degree_graph(n, deg_targets, rng, warm_cs), seed
    return _greedy_constraint_graph(n, r, cs, rng), seed


def _pack_warm(n: int, edges0: list[tuple[int, int]]):
    """Annealed edge list → (g0, z0, lam0) ADMM warm start."""
    eidx = edge_index(n)
    m = len(all_edges(n))
    z0 = np.zeros(m)
    for e in edges0:
        z0[eidx[e]] = 1.0
    g0 = np.zeros(m)
    gm = metropolis_weights(n, edges0)
    for k, e in enumerate(edges0):
        g0[eidx[e]] = gm[k]
    W0 = weight_matrix_from_weights(n, edges0, gm)
    lam0 = max(1.0 - r_asym(W0, symmetric=True), 0.05)
    return g0, z0, lam0


def _anneal_edges(n: int, inits: list[list[tuple[int, int]]], seeds: list[int],
                  sa_cs: ConstraintSet | None, cfg: BATopoConfig) -> list:
    """Anneal a batch of start graphs. ``cfg.warmstart="device"`` runs one
    batched SA on ``cfg.device`` per distinct edge count (a 2-swap
    preserves the count, so restarts with equal-size init graphs share a
    batch); ``"host"`` keeps the per-graph numpy SA as the parity oracle."""
    if cfg.warmstart == "device":
        from .warmstart import anneal_topology_batched

        groups: dict[int, list[int]] = {}
        for k, e in enumerate(inits):
            groups.setdefault(len(e), []).append(k)
        annealed: list = [None] * len(inits)
        for idxs in groups.values():
            outs = anneal_topology_batched(
                n, [inits[i] for i in idxs], sa_cs, iters=cfg.sa_iters,
                seeds=[seeds[i] for i in idxs], use_kernel=cfg.sa_kernel,
                device=cfg.device)
            for i, out in zip(idxs, outs):
                annealed[i] = out
        return annealed
    return [anneal_topology(n, e0, sa_cs, iters=cfg.sa_iters, seed=sd)
            for e0, sd in zip(inits, seeds)]


def _warm_starts(n: int, r: int, scenario: str, cs: ConstraintSet | None,
                 deg_targets, cfg: BATopoConfig, n_restarts: int):
    """Warm starts for every restart: greedy init (host) + simulated
    annealing (batched on ``cfg.device`` by default). Returns
    (g0, z0, lam0)s."""
    inits, seeds = [], []
    for k in range(n_restarts):
        edges0, seed = _init_graph(n, r, scenario, cs, deg_targets, cfg, k)
        inits.append(edges0)
        seeds.append(seed)
    sa_cs = cs if scenario != "homo" else None
    annealed = _anneal_edges(n, inits, seeds, sa_cs, cfg)
    return [_pack_warm(n, e) for e in annealed]


def _make_solver(n: int, r: int, scenario: str, cs: ConstraintSet | None,
                 cfg: BATopoConfig):
    admm = replace(cfg.admm, device=cfg.device)
    if scenario == "homo":
        return HomogeneousADMM(n, r, admm)
    return HeterogeneousADMM(
        n, r, np.asarray(cs.M, dtype=np.float64), np.asarray(cs.e_cap, dtype=np.float64),
        admm, equality=cs.equality, edge_ok=np.asarray(cs.edge_ok),
    )


def optimize_topology(
    n: int,
    r: int,
    scenario: str = "homo",
    cs: ConstraintSet | None = None,
    node_bandwidths: np.ndarray | None = None,
    cfg: BATopoConfig | None = None,
    profile: dict | None = None,
) -> Topology:
    """Deprecated signature-compatible wrapper around the unified request
    API: build a :class:`~repro_torch.core.anytime.TopologyRequest` and call
    :func:`~repro_torch.core.anytime.solve_topology` instead. Behavior
    (including the barrier execution order, profile keys and error
    messages) is unchanged.
    """
    warnings.warn(
        "optimize_topology(n, r, ...) is deprecated; build a "
        "TopologyRequest and call repro_torch.core.anytime.solve_topology(...)",
        DeprecationWarning, stacklevel=2)
    return _optimize_request(n, r, scenario=scenario, cs=cs,
                             node_bandwidths=node_bandwidths, cfg=cfg,
                             profile=profile)


def _optimize_request(
    n: int,
    r: int,
    scenario: str = "homo",
    cs: ConstraintSet | None = None,
    node_bandwidths: np.ndarray | None = None,
    cfg: BATopoConfig | None = None,
    profile: dict | None = None,
) -> Topology:
    """Produce a BA-Topo for the given scenario — the phase-barriered
    pipeline (``solve_topology(engine="barrier")``).

    scenario ∈ {"homo", "node", "constraint"}:
      - "homo": Eq. (9) with Card(g) ≤ r.
      - "node": §IV-B1 — requires ``node_bandwidths``; Algorithm 1 allocates
        per-node capacities, then the heterogeneous ADMM runs with equality
        degree rows.
      - "constraint": any ConstraintSet (intra-server, BCube, pod-boundary)
        with inequality capacities.

    With ``cfg.restarts > 1`` all restarts are solved by one batched call
    (``solve_batched``) on ``cfg.device``; the best candidate (lowest
    ``r_asym`` after repair + polish) wins. Pass ``profile={}`` to collect
    the per-phase wall-time breakdown (keys
    ``warm_s/admm_s/round_s/polish_s/eval_s``).
    """
    from .anytime import resolve_scenario

    cfg = cfg or BATopoConfig()
    _validate_pipeline_cfg(cfg)
    prof = {} if profile is None else profile
    cs, deg_targets, meta = resolve_scenario(n, r, scenario, cs,
                                             node_bandwidths, context="api")

    # ---- phase 1: warm starts (device SA by default) ----------------------
    t0 = time.perf_counter()
    n_restarts = max(1, cfg.restarts)
    warms = _warm_starts(n, r, scenario, cs, deg_targets, cfg, n_restarts)
    prof["warm_s"] = prof.get("warm_s", 0.0) + time.perf_counter() - t0

    solver = _make_solver(n, r, scenario, cs, cfg)

    # ---- phase 2: ADMM — batched restarts in one call (scan driver only;
    # an explicit driver="python" request keeps the per-restart loop)
    t0 = time.perf_counter()
    if (n_restarts > 1 and cfg.admm.solver != "kkt_bicgstab_ilu"
            and cfg.admm.driver == "scan"):
        g0s = np.stack([w[0] for w in warms])
        lam0s = np.asarray([w[2] for w in warms])
        if scenario == "homo":
            results = solver.solve_batched(g0s, lam0s)
        else:
            results = solver.solve_batched(g0s, np.stack([w[1] for w in warms]), lam0s)
    elif scenario == "homo":
        results = [solver.solve(g0=g0, lam0=lam0) for g0, _, lam0 in warms]
    else:
        results = [solver.solve(g0=g0, z0=z0, lam0=lam0) for g0, z0, lam0 in warms]
    prof["admm_s"] = prof.get("admm_s", 0.0) + time.perf_counter() - t0

    # ---- phase 3: rounding + greedy feasibility repair --------------------
    t0 = time.perf_counter()
    items, sources = _candidate_items(n, r, warms, results, cs, cfg, meta,
                                      use_z=(scenario != "homo"))
    prof["round_s"] = prof.get("round_s", 0.0) + time.perf_counter() - t0

    # ---- phase 4: weight polish, all candidates in one batched call -------
    t0 = time.perf_counter()
    topos = _finalize_batch(n, items, cfg, cs)
    prof["polish_s"] = prof.get("polish_s", 0.0) + time.perf_counter() - t0

    # ---- phase 5: release validation + spectral evaluation (one invariant
    # check and one r_asym per distinct support) ----------------------------
    t0 = time.perf_counter()
    best_topo, best_val, failures = _pick_best(n, items, topos, sources)
    if best_topo is None:
        if failures:
            from .guard import TopologyInvariantError

            bad = failures[0].rsplit(": ", 1)[-1]
            raise TopologyInvariantError(
                f"no candidate topology for n={n}, r={r}, "
                f"scenario={scenario!r} passed release validation — first "
                f"failure: {failures[0]!r} (all: {failures})",
                invariant=bad, failures=failures)
        raise ValueError(
            f"failed to construct any connected topology for n={n}, r={r}, "
            f"scenario={scenario!r} — every candidate (ADMM, warm starts, "
            "classics) was disconnected under the constraints; raise r or "
            "relax the ConstraintSet")
    best_topo.meta["r_asym"] = best_val
    prof["eval_s"] = prof.get("eval_s", 0.0) + time.perf_counter() - t0
    return best_topo


def sweep_topologies(ns, rs, cfg: BATopoConfig | None = None) -> dict:
    """Deprecated signature-compatible wrapper: build
    :class:`~repro_torch.core.anytime.TopologyRequest` objects and call
    :func:`~repro_torch.core.anytime.solve_topologies` instead (the same
    batched per-n sweep underneath). Returns ``{(n, r): Topology}``."""
    warnings.warn(
        "sweep_topologies(ns, rs, ...) is deprecated; build TopologyRequest "
        "objects and call repro_torch.core.anytime.solve_topologies(...)",
        DeprecationWarning, stacklevel=2)
    return _sweep_requests(ns, rs, cfg)


def _sweep_requests(ns, rs, cfg: BATopoConfig | None = None) -> dict:
    """Homogeneous multi-scenario sweep: a BA-Topo for every (n, r) pair,
    each node count's budgets as ONE batched ADMM solve
    (``_sweep_one_n``). Returns ``{(n, r): Topology}``, keyed by the
    *requested* r; a value is ``None`` if no connected candidate was found.
    One warm start per (n, r): ``cfg.restarts`` is not consulted."""
    cfg = cfg or BATopoConfig()
    if cfg.admm.driver not in ("scan", "python"):
        raise ValueError(
            f"unknown driver {cfg.admm.driver!r}; expected 'scan' or 'python'")
    if cfg.admm.solver == "kkt_bicgstab_ilu":
        raise ValueError(
            "sweep_topologies needs a device backend (schur_cg or "
            "kkt_bicgstab); the scipy-ILU backend is host-side")
    _validate_pipeline_cfg(cfg)
    out: dict = {}
    for n in ns:
        out.update(_sweep_one_n(int(n), [int(r) for r in rs], cfg))
    return out


def _classic_candidates(n: int, r: int,
                        cs: ConstraintSet | None) -> list[tuple[str, np.ndarray]]:
    """Classic-topology candidates: the ADMM is non-convex, and on small
    tightly-budgeted instances a known-good structure (ring / torus) that
    happens to be feasible can beat a weak local optimum. Their weights get
    the same convex polish as the ADMM output so the comparison is fair.

    Returns (name, selection) pairs for the feasible classics. Only
    ``ValueError`` — the documented "n not expressible for this family"
    signal (e.g. hypercube needs a power of two) — skips a baseline; any
    other exception is a real construction bug and propagates.
    """
    from .topologies import make_baseline
    eidx = edge_index(n)
    out: list[tuple[str, np.ndarray]] = []
    for kind in ("ring", "torus", "hypercube"):
        try:
            base = make_baseline(kind, n)
        except ValueError:
            continue
        if len(base.edges) > r or base.meta.get("directed"):
            continue
        sel = np.zeros(len(all_edges(n)), dtype=bool)
        for e in base.edges:
            sel[eidx[tuple(sorted(e))]] = True
        if cs is not None and not cs.feasible(sel):
            continue
        out.append((base.name, sel))
    return out


def _greedy_constraint_graph(n: int, r: int, cs: ConstraintSet, rng) -> list[tuple[int, int]]:
    """Random feasible connected graph with ≤ r edges under ``cs`` capacities."""
    edges_full = all_edges(n)
    m = len(edges_full)
    order = [l for l in range(m) if cs.edge_ok[l]]
    for _ in range(256):
        rng.shuffle(order)
        usage = np.zeros(cs.q, dtype=np.int64)
        sel = np.zeros(m, dtype=bool)
        count = 0
        # first pass: spanning-tree bias for connectivity
        comp = list(range(n))

        def find(a):
            while comp[a] != a:
                comp[a] = comp[comp[a]]
                a = comp[a]
            return a

        for phase in (0, 1):
            for l in order:
                if count >= r:
                    break
                if sel[l]:
                    continue
                i, j = edges_full[l]
                if phase == 0 and find(i) == find(j):
                    continue
                col = cs.M[:, l]
                if np.any(usage + col > cs.e_cap):
                    continue
                sel[l] = True
                usage += col
                count += 1
                comp[find(i)] = find(j)
        edges = [edges_full[l] for l in np.nonzero(sel)[0]]
        if is_connected(n, edges):
            return edges
    raise RuntimeError("could not build a feasible connected warm start")
