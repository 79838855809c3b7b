"""Anytime outer pipeline + unified request/result API (DESIGN.md §17), in
the port.

The port of ``repro.core.anytime``: :class:`TopologyRequest` /
:class:`TopologyResult`, :func:`validate_request`, :func:`resolve_scenario`,
:class:`PhaseProfile` and the :class:`AnytimeSolver` behind
:func:`solve_topology`. Feasible classics polish and evaluate first, then
each restart runs init → SA → warm candidate → ADMM → rounding → ADMM
candidate, every candidate entering a monotone best-so-far incumbent; with
a budget, stages whose cost estimate no longer fits are skipped.

Every device stage (SA, ADMM, polish) ends in a host read of its result,
which waits for the card, so the ``PhaseProfile`` times are the card's
wall time and not the time to enqueue.

:func:`solve_topologies` sends each node count's homogeneous, unbudgeted
requests through one batched sweep (``api._sweep_one_n``) and the rest
through :func:`solve_topology`.

``solve_topology(engine="barrier")`` runs the phase-barriered pipeline
(``api._optimize_request``: all SA restarts, then all ADMM restarts as one
batched solve, then the polish and the pick), the comparison arm of the
anytime engine and the full tier of the topology service. Deviation from
the reference, whose barrier engine reads only ``cfg``: both engines apply
the request's ``restarts`` and ``seed`` overrides.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Iterator

import numpy as np

from .constraints import ConstraintSet
from .graph import Topology, all_edges, is_connected
from .weights import metropolis_weights, polish_weights, polish_weights_batched

__all__ = [
    "TopologyRequest", "TopologyResult", "PhaseProfile", "Incumbent",
    "AnytimeSolver", "solve_topology", "solve_topologies",
    "validate_request", "resolve_scenario",
]

_req_counter = itertools.count(1)

_SCENARIOS = ("homo", "node", "constraint")

#: Context-pinned messages for the two scenario-requirement errors. The
#: "api" and "reopt" texts predate this module and are asserted on by
#: tests — byte-identical here so the shims stay drop-in.
_MISSING_BW = {
    "api": ("scenario='node' requires node_bandwidths "
            "(per-node GB/s profile for Algorithm 1)"),
    "reopt": ("scenario='node' re-optimization requires the drifted "
              "node_bandwidths profile"),
    "service": "scenario='node' requires node_bandwidths",
}
_MISSING_CS = {
    "api": "scenario='constraint' requires a ConstraintSet (cs=...)",
    "reopt": ("scenario='constraint' re-optimization requires the drifted "
              "ConstraintSet"),
    "service": "scenario='constraint' requires a ConstraintSet",
}


# ---------------------------------------------------------------------------
# request / result
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TopologyRequest:
    """One topology-optimization problem, shared by the library API, the
    sweep, the service and re-optimization: (n, r, scenario, constraint
    set, bandwidth profile, budget/deadline, restarts/seed overrides).

    ``deadline_ms`` doubles as the anytime budget; ``restarts``/``seed``
    override the config's values when set (None = use config). Field order
    up to ``deadline_ms`` matches the former ``serve.TopoRequest`` so
    positional construction keeps working.
    """

    n: int
    r: int
    scenario: str = "homo"
    node_bandwidths: np.ndarray | None = None
    cs: ConstraintSet | None = None
    deadline_ms: float | None = None
    restarts: int | None = None
    seed: int | None = None
    request_id: int = field(default_factory=lambda: next(_req_counter))


def validate_request(req: TopologyRequest) -> str | None:
    """First malformed field of ``req``, or None — THE validation path for
    every entrypoint (service admission uses the returned string verbatim;
    the library API raises it as a ValueError)."""
    try:
        n, r = int(req.n), int(req.r)
    except (TypeError, ValueError):
        return "n and r must be integers"
    if n < 2:
        return f"n={req.n} (need n >= 2)"
    if r < n - 1:
        return (f"r={req.r} can never connect n={n} nodes "
                f"(need r >= n-1)")
    if req.scenario not in _SCENARIOS:
        return f"unknown scenario {req.scenario!r}"
    if req.scenario == "node":
        if req.node_bandwidths is None:
            return _MISSING_BW["service"]
        bw = np.asarray(req.node_bandwidths, dtype=np.float64)
        if bw.shape != (n,):
            return (f"node_bandwidths shape {bw.shape} != ({n},)")
        if not np.all(np.isfinite(bw)) or not np.all(bw > 0):
            return "node_bandwidths must be finite and positive"
    if req.scenario == "constraint":
        if req.cs is None:
            return _MISSING_CS["service"]
        if req.cs.n != n:
            return f"ConstraintSet.n={req.cs.n} != n={n}"
    if req.deadline_ms is not None and not (req.deadline_ms > 0):
        return f"deadline_ms={req.deadline_ms} (need > 0)"
    if req.restarts is not None and int(req.restarts) < 1:
        return f"restarts={req.restarts} (need >= 1)"
    return None


def resolve_scenario(n: int, r: int, scenario: str,
                     cs: ConstraintSet | None,
                     node_bandwidths: np.ndarray | None,
                     context: str = "api"):
    """Scenario → (ConstraintSet, degree targets, base meta): the phase-0
    block formerly replicated across ``optimize_topology``,
    ``reoptimize_topology`` and the service warm tier. ``context`` selects
    the historical (test-pinned) error text for the two missing-argument
    cases."""
    meta: dict = {"scenario": scenario, "r": r}
    if scenario == "node":
        if node_bandwidths is None:
            raise ValueError(_MISSING_BW[context])
        from .allocation import allocate_edge_capacity, graphical_repair
        from .constraints import node_level_constraints

        alloc = allocate_edge_capacity(np.asarray(node_bandwidths), r)
        e_alloc = graphical_repair(alloc.e)
        cs = node_level_constraints(n, e_alloc, np.asarray(node_bandwidths))
        meta["b_unit"] = alloc.b_unit
        meta["alloc_e"] = e_alloc.tolist()
        return cs, e_alloc, meta
    if scenario == "constraint":
        if cs is None:
            raise ValueError(_MISSING_CS[context])
        return cs, None, meta
    from .api import _homo_degree_targets

    return cs, _homo_degree_targets(n, r), meta


@dataclass
class PhaseProfile:
    """Documented per-phase wall-time profile: phase name → SECONDS.

    Canonical phases: ``prep`` (validation + scenario resolution),
    ``warm`` (greedy init + SA), ``admm``, ``round`` (support extraction +
    repair), ``polish``, ``eval`` (invariants + spectral), ``classic``
    (fallback construction), ``queue``/``solve`` (service-side). Seconds
    everywhere; use :meth:`ms` for milliseconds — this replaces the old
    ad-hoc mix of ``*_s`` dict keys and per-phase ms values.
    """

    phases: dict[str, float] = field(default_factory=dict)

    def add(self, phase: str, seconds: float) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + float(seconds)

    def merge(self, other: "PhaseProfile | dict") -> "PhaseProfile":
        """New profile with the phase times of both operands summed."""
        out = PhaseProfile(dict(self.phases))
        src = other.phases if isinstance(other, PhaseProfile) else \
            PhaseProfile.from_dict(other).phases
        for k, v in src.items():
            out.add(k, v)
        return out

    def ms(self, phase: str) -> float:
        return 1e3 * self.phases.get(phase, 0.0)

    @property
    def total_s(self) -> float:
        return float(sum(self.phases.values()))

    @classmethod
    def from_dict(cls, d: dict) -> "PhaseProfile":
        """Parse a legacy profile dict: ``<phase>_s`` values are seconds,
        ``<phase>_ms`` milliseconds, bare numeric keys seconds."""
        out = cls()
        for k, v in d.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            if k.endswith("_ms"):
                out.add(k[:-3], v / 1e3)
            elif k.endswith("_s"):
                out.add(k[:-2], v)
            else:
                out.add(k, v)
        return out

    def to_dict(self) -> dict:
        """Legacy ``<phase>_s`` dict view (seconds), for consumers of the
        pre-§17 profile plumbing."""
        return {f"{k}_s": v for k, v in self.phases.items()}


@dataclass(frozen=True)
class Incumbent:
    """One best-so-far point of an anytime solve."""

    support: np.ndarray          # bool over all_edges(n)
    W: np.ndarray                # gossip matrix of the incumbent topology
    r_asym: float
    quality_tier: str            # classic | sa_only | warm (pre-completion)
    elapsed_ms: float
    topology: Topology = field(repr=False, compare=False, default=None)
    source: str = ""
    order: int = 0               # barrier candidate-order index (ties)


@dataclass
class TopologyResult:
    """Uniform solve answer: the topology plus quality/latency provenance."""

    topology: Topology | None
    r_asym: float
    quality_tier: str            # full | warm | sa_only | classic
    elapsed_ms: float
    profile: PhaseProfile
    complete: bool               # every stage ran (no budget curtailment)
    reason: str | None = None    # degradation trail, None when clean
    request: TopologyRequest | None = None
    improvements: int = 0        # number of incumbent updates observed
    #: the solver's per-stage-invocation cost estimates (stage → seconds,
    #: an EMA over the invocations this solve made); what a later solve's
    #: ``seed_profile`` takes
    stage_estimates: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.topology is not None


# ---------------------------------------------------------------------------
# the anytime solver
# ---------------------------------------------------------------------------

#: Preview candidates (Metropolis-weighted SA best-so-far graphs) sit
#: outside the barrier candidate set; this order index makes them lose
#: every tie against a real candidate, preserving barrier tie-breaking.
_PREVIEW_ORDER = 1 << 30

#: A stage is skipped (once an incumbent exists) when its EMA cost
#: estimate × this safety factor exceeds the remaining budget — same
#: semantics as ``ServicePolicy.deadline_safety``.
_SAFETY = 1.5

#: EMA smoothing for the per-stage cost estimates.
_EST_ALPHA = 0.5


class AnytimeSolver:
    """Budgeted best-so-far topology solver (see module docstring).

    Usage::

        solver = AnytimeSolver(TopologyRequest(n=64, r=128), cfg)
        res = solver.solve(budget_ms=200)          # incumbent at deadline
        # or poll:
        while (inc := solver.next_improvement()) is not None:
            adopt(inc)                             # r_asym monotone ↓
        res = solver.result()

    The budget clock starts at construction. With no budget the solve runs
    every stage, in the candidate order of the reference's barrier pipeline.
    """

    def __init__(self, request: TopologyRequest, cfg=None, *,
                 seed_profile: PhaseProfile | None = None,
                 previews: bool | None = None,
                 clock=time.perf_counter):
        from . import api as _api

        bad = validate_request(request)
        if bad is not None:
            raise ValueError(bad)
        cfg = _request_cfg(request, cfg)
        _api._validate_pipeline_cfg(cfg)
        self.request = request
        self.cfg = cfg
        self.profile = PhaseProfile()
        self.incumbent: Incumbent | None = None
        self.complete = False
        self.reasons: list[str] = []
        self._previews = previews
        self._clock = clock
        self._t0 = clock()
        self._deadline: float | None = None
        if request.deadline_ms is not None:
            self._deadline = self._t0 + float(request.deadline_ms) / 1e3
        # seed_profile carries PER-STAGE-INVOCATION priors (per restart /
        # per candidate), e.g. a tracked bench row's phase totals divided
        # by its restart count — see TopologyService._seed_ema.
        self._est: dict[str, float] = {}
        if seed_profile is not None:
            for stage in ("warm", "admm", "polish", "eval"):
                v = seed_profile.phases.get(stage)
                if v:
                    self._est[stage] = float(v)
        self._best_val = np.inf
        self._best_order = _PREVIEW_ORDER + 1
        self._n_improvements = 0
        self._curtailed = False
        self._failures: list[str] = []
        self._g_cache: dict[bytes, np.ndarray] = {}      # polished weights
        self._val_cache: dict[tuple, float] = {}
        self._inv_cache: dict[tuple, str | None] = {}
        self._cs: ConstraintSet | None = None
        self._gen: Iterator[Incumbent] = self._stages()

    # -- clocks ----------------------------------------------------------

    @property
    def elapsed_ms(self) -> float:
        return (self._clock() - self._t0) * 1e3

    def _remaining_s(self) -> float | None:
        if self._deadline is None:
            return None
        return self._deadline - self._clock()

    def _expired(self) -> bool:
        rem = self._remaining_s()
        return rem is not None and rem <= 0.0

    def _fits(self, stage: str) -> bool:
        """Budget gate: always run while there is no incumbent (an answer
        beats a deadline); afterwards skip stages whose EMA estimate ×
        safety no longer fits."""
        rem = self._remaining_s()
        if rem is None or self.incumbent is None:
            return True
        est = self._est.get(stage)
        if est is None:
            return True
        return est * _SAFETY <= max(rem, 0.0)

    def _observe(self, stage: str, phase: str, dt: float) -> None:
        self.profile.add(phase, dt)
        prev = self._est.get(stage)
        self._est[stage] = (dt if prev is None
                            else (1 - _EST_ALPHA) * prev + _EST_ALPHA * dt)

    # -- public handle ---------------------------------------------------

    def next_improvement(self) -> Incumbent | None:
        """Advance the solve until the incumbent improves (or everything
        finishes → None). Each returned incumbent has r_asym ≤ the previous
        one's — monotone non-increasing over polls."""
        return next(self._gen, None)

    def solve(self, budget_ms: float | None = None) -> TopologyResult:
        """Drain the solve (optionally tightening/setting the budget, still
        measured from construction) and return the final result."""
        if budget_ms is not None:
            self._deadline = self._t0 + float(budget_ms) / 1e3
        for _ in self._gen:
            pass
        return self.result()

    def result(self) -> TopologyResult:
        inc = self.incumbent
        if inc is None:
            raise RuntimeError(
                "no incumbent yet — call solve() or drain next_improvement()")
        topo = inc.topology
        topo.meta["r_asym"] = inc.r_asym
        tier = "full" if self.complete else inc.quality_tier
        return TopologyResult(
            topology=topo, r_asym=inc.r_asym, quality_tier=tier,
            elapsed_ms=self.elapsed_ms, profile=self.profile,
            complete=self.complete, reason="; ".join(self.reasons) or None,
            request=self.request, improvements=self._n_improvements,
            stage_estimates=dict(self._est))

    # -- candidate machinery --------------------------------------------

    def _offer(self, sel: np.ndarray, topo: Topology, order: int, tier: str,
               source: str, polished: bool) -> Incumbent | None:
        """Evaluate a candidate (one invariant check + one r_asym per
        distinct (support, weighting), like ``api._pick_best``) and install
        it as incumbent when it wins the lexicographic (r_asym, candidate
        order) comparison — exactly the barrier's first-strict-minimum
        selection."""
        from .guard import check_invariants

        key = (np.asarray(sel, dtype=bool).tobytes(), polished)
        t0 = self._clock()
        if key not in self._inv_cache:
            self._inv_cache[key] = check_invariants(topo)
        bad = self._inv_cache[key]
        if bad is not None:
            self._observe("eval", "eval", self._clock() - t0)
            self._failures.append(f"{topo.name}: {bad}")
            return None
        if key not in self._val_cache:
            self._val_cache[key] = topo.r_asym()
        val = self._val_cache[key]
        self._observe("eval", "eval", self._clock() - t0)
        if val < self._best_val or (val == self._best_val
                                    and order < self._best_order):
            topo.meta["selected_from"] = source
            self._best_val, self._best_order = val, order
            self._n_improvements += 1
            self.incumbent = Incumbent(
                support=np.asarray(sel, dtype=bool).copy(), W=topo.W,
                r_asym=float(val), quality_tier=tier,
                elapsed_ms=self.elapsed_ms, topology=topo,
                source=source, order=order)
            return self.incumbent
        return None

    def _polish_and_offer(self, sel: np.ndarray, name: str, meta: dict,
                          order: int, tier: str, source: str,
                          ) -> Incumbent | None:
        """Connectivity-check + polish + evaluate one candidate selection,
        with polished weights cached per distinct support."""
        n = int(self.request.n)
        cfg = self.cfg
        edges_full = all_edges(n)
        edges = [edges_full[ln] for ln in np.nonzero(sel)[0]]
        if not edges or not is_connected(n, edges):
            return None                      # barrier skips these silently
        skey = np.asarray(sel, dtype=bool).tobytes()
        g = self._g_cache.get(skey)
        if g is None:
            t0 = self._clock()
            g0 = metropolis_weights(n, edges)
            if cfg.polish == "device":
                g = polish_weights_batched(n, [edges], [g0],
                                           iters=cfg.polish_iters,
                                           dtype=cfg.polish_dtype,
                                           device=cfg.device)[0]
            else:
                g = polish_weights(n, edges, g0, iters=cfg.polish_iters)
            self._observe("polish", "polish", self._clock() - t0)
            self._g_cache[skey] = g
        topo = Topology(n, edges, g, name=name,
                        meta={**meta, "connected": True})
        return self._offer(sel, topo, order, tier, source, polished=True)

    def _preview(self, edges: list, order: int, tier: str, source: str,
                 name: str) -> Incumbent | None:
        """Budget-mode-only cheap candidate: Metropolis weights, no polish."""
        n = int(self.request.n)
        if not edges or not is_connected(n, edges):
            return None
        eidx_sel = np.zeros(len(all_edges(n)), dtype=bool)
        from .graph import edge_index
        eidx = edge_index(n)
        for e in edges:
            eidx_sel[eidx[tuple(sorted(e))]] = True
        g = metropolis_weights(n, edges)
        topo = Topology(n, edges, g, name=name, meta={"connected": True})
        return self._offer(eidx_sel, topo, order, tier, source,
                           polished=False)

    # -- the stage graph -------------------------------------------------

    def _stages(self) -> Iterator[Incumbent]:
        from .guard import TopologyInvariantError, classic_fallback

        req = self.request
        n, r, scenario = int(req.n), int(req.r), req.scenario
        yield from self._plan()
        if self.incumbent is None:
            if self._deadline is None:
                # unbudgeted: same terminal errors as the barrier pipeline
                if self._failures:
                    bad = self._failures[0].rsplit(": ", 1)[-1]
                    raise TopologyInvariantError(
                        f"no candidate topology for n={n}, r={r}, "
                        f"scenario={scenario!r} passed release validation — "
                        f"first failure: {self._failures[0]!r} "
                        f"(all: {self._failures})",
                        invariant=bad, failures=self._failures)
                raise ValueError(
                    f"failed to construct any connected topology for n={n}, "
                    f"r={r}, scenario={scenario!r} — every candidate (ADMM, "
                    "warm starts, classics) was disconnected under the "
                    "constraints; raise r or relax the ConstraintSet")
            # budgeted and empty-handed: the guaranteed closed-form answer
            t0 = self._clock()
            fb = classic_fallback(n, r,
                                  self._cs if scenario != "homo" else None)
            self.profile.add("classic", self._clock() - t0)
            self.reasons.append("budget expired — classic fallback")
            sel = np.zeros(len(all_edges(n)), dtype=bool)
            from .graph import edge_index
            eidx = edge_index(n)
            for e in fb.edges:
                sel[eidx[tuple(sorted(e))]] = True
            inc = self._offer(sel, fb, _PREVIEW_ORDER + 1, "classic",
                              "classic-fallback", polished=False)
            if inc is not None:
                yield inc
        self.complete = self.incumbent is not None and not self._curtailed

    def _plan(self) -> Iterator[Incumbent]:
        from . import api as _api

        req, cfg = self.request, self.cfg
        n, r, scenario = int(req.n), int(req.r), req.scenario
        t0 = self._clock()
        cs, deg_targets, meta = resolve_scenario(
            n, r, scenario, req.cs, req.node_bandwidths, context="api")
        self._cs = cs
        self.profile.add("prep", self._clock() - t0)
        R = max(1, cfg.restarts)
        use_z = scenario != "homo"
        sa_cs = cs if scenario != "homo" else None

        # ---- classics first: cheapest path to a polished incumbent ------
        for j, (base_name, sel) in enumerate(_api._classic_candidates(n, r, cs)):
            if self._expired():
                self._note_expiry("classics")
                return
            inc = self._polish_and_offer(
                sel, f"ba-topo(n={n},r={r},{base_name})", dict(meta),
                order=2 * R + j, tier="classic", source=f"classic:{base_name}")
            if inc is not None:
                yield inc

        solver = _api._make_solver(n, r, scenario, cs, cfg)
        previews = (self._previews if self._previews is not None
                    else self._deadline is not None)

        # ---- per-restart chains: init → SA → warm cand → ADMM → cand ----
        for k in range(R):
            if self._expired():
                self._note_expiry(f"restart {k}")
                return
            if not self._fits("warm"):
                self._skip(f"restart {k}", "warm")
                continue
            t0 = self._clock()
            edges0, seed = _api._init_graph(n, r, scenario, cs, deg_targets,
                                            cfg, k)
            annealed = yield from self._anneal(
                n, edges0, seed, sa_cs, cfg, k, previews)
            self._observe("warm", "warm", self._clock() - t0)
            if self._expired():
                self._note_expiry(f"restart {k} (post-SA)")
                return
            warm = _api._pack_warm(n, annealed)
            # warm-start candidate (barrier order 2k+1) — available before
            # the ADMM solve, so it is offered first
            if self._fits("polish"):
                inc = self._polish_and_offer(
                    warm[1].astype(bool), f"ba-topo(n={n},r={r},warm)",
                    dict(meta), order=2 * k + 1, tier="warm",
                    source="warm-start")
                if inc is not None:
                    yield inc
            else:
                self._skip(f"restart {k} warm candidate", "polish")
            if not self._fits("admm"):
                self._skip(f"restart {k}", "admm")
                continue
            if self._expired():
                self._note_expiry(f"restart {k} (pre-ADMM)")
                return
            t0 = self._clock()
            g0, z0, lam0 = warm
            if scenario == "homo":
                res = solver.solve(g0=g0, lam0=lam0)
            else:
                res = solver.solve(g0=g0, z0=z0, lam0=lam0)
            self._observe("admm", "admm", self._clock() - t0)
            t0 = self._clock()
            items, _ = _api._candidate_items(n, r, [warm], [res], cs, cfg,
                                             meta, use_z=use_z)
            self.profile.add("round", self._clock() - t0)
            admm_sel, admm_name, admm_meta = items[0]
            if self._fits("polish") or self.incumbent is None:
                inc = self._polish_and_offer(
                    admm_sel, admm_name, admm_meta, order=2 * k,
                    tier="warm", source="admm")
                if inc is not None:
                    yield inc
            else:
                self._skip(f"restart {k} admm candidate", "polish")

    def _anneal(self, n, edges0, seed, sa_cs, cfg, k, previews):
        """SA for one restart. Unbudgeted: the exact barrier call
        (``_anneal_edges``, one-shot). Budgeted: the chunked stream —
        bit-equal at exhaustion — checking the deadline between chunks and
        adopting the best-so-far graph on expiry; with previews on, each
        improving chunk offers a Metropolis-weighted incumbent."""
        from . import api as _api

        if self._deadline is None:
            return _api._anneal_edges(n, [edges0], [seed], sa_cs, cfg)[0]
        from .warmstart import anneal_topology_stream

        best_edges, last_cost = edges0, np.inf
        t_prev = self._clock()
        for edges_b, costs, t in anneal_topology_stream(
                n, [edges0], sa_cs, iters=cfg.sa_iters, seeds=[seed],
                use_kernel=cfg.sa_kernel, device=cfg.device):
            dt = self._clock() - t_prev
            prev = self._est.get("warm_chunk")
            self._est["warm_chunk"] = (
                dt if prev is None
                else (1 - _EST_ALPHA) * prev + _EST_ALPHA * dt)
            best_edges = edges_b[0]
            if previews and costs[0] < last_cost:
                last_cost = costs[0]
                inc = self._preview(
                    best_edges, _PREVIEW_ORDER, "sa_only",
                    f"sa-preview:restart{k}",
                    f"ba-topo(n={n},r={int(self.request.r)},sa@{t})")
                if inc is not None:
                    yield inc
            if self._expired() or not self._fits("warm_chunk"):
                if t < cfg.sa_iters:
                    self._curtailed = True
                    self.reasons.append(
                        f"restart {k}: SA curtailed at {t}/{cfg.sa_iters}")
                break
            t_prev = self._clock()
        return best_edges

    def _note_expiry(self, where: str) -> None:
        self._curtailed = True
        self.reasons.append(f"budget expired at {where}")

    def _skip(self, what: str, stage: str) -> None:
        self._curtailed = True
        est = self._est.get(stage)
        self.reasons.append(
            f"{what}: skipped ({stage} est {est * 1e3:.1f}ms does not fit)"
            if est is not None else f"{what}: skipped ({stage})")


# ---------------------------------------------------------------------------
# module-level entrypoints
# ---------------------------------------------------------------------------


def _request_cfg(request: TopologyRequest, cfg):
    """``cfg`` (default ``BATopoConfig()``) with the request's ``restarts``
    and ``seed`` overrides applied."""
    from . import api as _api

    cfg = cfg or _api.BATopoConfig()
    if request.restarts is not None:
        cfg = replace(cfg, restarts=int(request.restarts))
    if request.seed is not None:
        cfg = replace(cfg, seed=int(request.seed))
    return cfg


def solve_topology(request: TopologyRequest, *, cfg=None,
                   budget_ms: float | None = None,
                   profile: dict | None = None,
                   seed_profile: PhaseProfile | None = None,
                   engine: str = "anytime") -> TopologyResult:
    """Solve one :class:`TopologyRequest`.

    ``engine="anytime"`` (default) runs the :class:`AnytimeSolver` — with
    ``budget_ms`` (or ``request.deadline_ms``) set it returns the best
    incumbent at the deadline, otherwise the full solve. ``engine="barrier"``
    runs the phase-barriered pipeline (``api._optimize_request``, restarts
    batched into one ADMM solve) — the comparison arm. ``profile``, when a
    dict, receives the legacy ``<phase>_s`` keys in both engines. The stages
    run on ``cfg.device`` (default ``"cuda"``).
    """
    if engine == "barrier":
        from . import api as _api

        prof: dict = {} if profile is None else profile
        t0 = time.perf_counter()
        topo = _api._optimize_request(
            int(request.n), int(request.r), scenario=request.scenario,
            cs=request.cs, node_bandwidths=request.node_bandwidths,
            cfg=_request_cfg(request, cfg), profile=prof)
        return TopologyResult(
            topology=topo, r_asym=float(topo.meta["r_asym"]),
            quality_tier="full",
            elapsed_ms=(time.perf_counter() - t0) * 1e3,
            profile=PhaseProfile.from_dict(prof), complete=True,
            request=request)
    if engine != "anytime":
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'anytime' or 'barrier'")
    solver = AnytimeSolver(request, cfg, seed_profile=seed_profile)
    res = solver.solve(budget_ms=budget_ms)
    if profile is not None:
        profile.update(res.profile.to_dict())
    return res


def solve_topologies(requests, *, cfg=None) -> list[TopologyResult]:
    """Solve many requests, amortizing where the problem shape allows: the
    homogeneous, unbudgeted requests without ``restarts`` or ``seed`` of one
    n run as ONE batched sweep (``api._sweep_one_n``: one ADMM solve for all
    their budgets) under the scan driver and a device backend; every other
    request (all of them under ``driver="python"`` or the scipy-ILU
    backend) goes through
    :func:`solve_topology`. Results come back in the input order. The
    stages run on ``cfg.device`` (default ``"cuda"``)."""
    from . import api as _api
    from .engine import check_solver

    requests = list(requests)
    cfg = cfg or _api.BATopoConfig()
    _api._validate_pipeline_cfg(cfg)
    check_solver(cfg.admm)
    results: list[TopologyResult | None] = [None] * len(requests)
    groups: dict[int, list[int]] = {}
    for i, q in enumerate(requests):
        if (q.scenario == "homo" and q.deadline_ms is None
                and q.restarts is None and q.seed is None
                and cfg.admm.driver == "scan"
                and cfg.admm.solver != "kkt_bicgstab_ilu"):
            groups.setdefault(int(q.n), []).append(i)
    for n, idxs in groups.items():
        t0 = time.perf_counter()
        out = _api._sweep_one_n(n, [int(requests[i].r) for i in idxs], cfg)
        dt_ms = (time.perf_counter() - t0) * 1e3
        for i in idxs:
            topo = out[(n, int(requests[i].r))]
            results[i] = TopologyResult(
                topology=topo,
                r_asym=(float(topo.meta["r_asym"]) if topo is not None
                        else float("inf")),
                quality_tier="full", elapsed_ms=dt_ms,
                profile=PhaseProfile(), complete=True,
                reason=None if topo is not None
                else "no connected candidate under the constraints",
                request=requests[i])
    for i, q in enumerate(requests):
        if results[i] is None:
            results[i] = solve_topology(q, cfg=cfg)
    return results
