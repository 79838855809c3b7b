"""Fault-tolerant topology-optimization service (DESIGN.md §15), in the port.

The port of ``repro.serve.topo_service``. A :class:`TopologyService`
admits ``(n, r, scenario, bandwidth profile, deadline_ms)`` requests through
a bounded queue and answers each admitted request with either a valid
topology (finite, symmetric, connected, row-stochastic W — the
``core.guard`` release checklist) or a structured rejection with a reason.
The solves run on ``cfg.device`` (default ``"cuda"``).

  submit ──► validate spec ──► bounded queue ──► canonical cache key
     │            │ malformed       │ full            │
     │            ▼                 ▼                 ▼ hit (drift-checked)
     │        rejection         rejection          tier "cache"
     ▼ miss
  deadline ladder: full pipeline → warm-started guarded ADMM → SA-only
  topology → classic fallback, each rung EMA-cost-gated against the
  remaining deadline budget and tagged ``quality_tier`` + reason.

* **Admission control** — the queue is bounded (``ServicePolicy.max_queue``);
  overload and malformed specs are answered with structured rejections.
* **Canonical cache** — specs canonicalize to ``(n, min(r, |E|), scenario,
  quantized bandwidth profile, ConstraintSet fingerprint)`` (host numpy
  only); the cache is LRU over ``ServicePolicy.cache_capacity``, and a
  ``core.reopt.DriftDetector`` guards every hit and :meth:`observe`.
* **Bucketed misses** — compatible misses (same n, homogeneous, no
  deadline) are solved as ONE batched ``engine.solve_sweep_spec`` call,
  restart indices as the one-shot pipeline's.
* **Deadline degradation** — per-(tier, n) EMA latency estimates decide
  which rungs still fit; deadlined misses take one budgeted anytime solve.
  Responses carry ``quality_tier`` ∈ {cache, full, warm, sa_only, classic}.
* **Fault injection** — :class:`ServiceHooks` replaces any tier's solver
  with a stub; the guard ladder and the invariant checks still run.

Every tier ends in a host read of its result (the ADMM's and the SA's
results and the polished weights come back as numpy), so ``latency_ms``
and the EMAs are the card's time, not the time to enqueue.

Deviations from the reference, each pinned by a test:

* **No TPU latency priors.** :func:`_load_bench_rows` reads no file:
  ``BENCH_admm.json``'s rows were not taken on the card. By default the
  EMAs learn from live requests; ``bench_rows=`` still seeds them.
* **``ServicePolicy.pad_pow2`` defaults to False.** The padding exists so
  that JAX reuses a vmap compilation; PyTorch compiles nothing per shape,
  and a padded instance is real work on the card.
* **Device faults propagate.** A ``DeviceFault`` or
  ``torch.AcceleratorError`` leaves :meth:`~TopologyService.drain` and
  :meth:`~TopologyService.request` as that exception: the service never
  raises for a solver outcome, but a broken card is not one.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np

from ..core.anytime import (
    PhaseProfile, TopologyRequest, resolve_scenario, solve_topology,
    validate_request,
)
from ..core.api import (
    BATopoConfig, _anneal_edges, _candidate_items, _finalize_batch,
    _homo_degree_targets, _init_graph, _pack_warm, _pick_best,
)
from ..core.constraints import ConstraintSet  # noqa: F401 — public re-export
from ..core.graph import Topology, all_edges, is_connected
from ..core.guard import (
    GuardPolicy, check_invariants, classic_fallback, jittered_warm_rungs,
    run_ladder,
)
from ..core.reopt import DriftDetector, DriftPolicy
from ..core.weights import metropolis_weights
from ..device import DEVICE_FAULTS

__all__ = ["ServicePolicy", "ServiceHooks", "TopoRequest", "TopoResponse",
           "TopologyService", "QUALITY_TIERS"]

#: Degradation order: best answer first, closed-form last resort last.
QUALITY_TIERS = ("cache", "full", "warm", "sa_only", "classic")

#: The service request IS the unified request dataclass (DESIGN.md §17) —
#: same fields, same auto-assigned ``request_id``, one validation path.
TopoRequest = TopologyRequest


@dataclass(frozen=True)
class ServicePolicy:
    """Service knobs.

    ``max_queue``: admitted-but-unprocessed requests beyond this are
    rejected with reason ``overloaded`` (bounded queue = backpressure).
    ``cache_capacity``: LRU entry cap of the canonical topology cache.
    ``bw_quant``: relative quantization step for bandwidth profiles in the
    cache key — profiles within one step of each other share an entry.
    ``drift``: DriftDetector thresholds for hit-time cache invalidation.
    ``guard``: retry-ladder policy for the warm tier (ρ jitter, retries).
    ``deadline_safety``: a tier is skipped when its EMA latency estimate ×
    this factor exceeds the remaining deadline budget.
    ``ema_alpha``: EMA smoothing for the per-(tier, n) latency estimates.
    ``pad_pow2``: pad bucketed solve batches to the next power of two
    (the reference's default, for JAX's compilation reuse; off here,
    because a padded instance costs real work on the card).
    ``ema_seed``: seed the per-(tier, n) latency EMAs and the anytime
    per-phase estimates from the ``bench_rows`` given at construction.
    """

    max_queue: int = 32
    cache_capacity: int = 128
    bw_quant: float = 0.05
    drift: DriftPolicy = field(default_factory=DriftPolicy)
    guard: GuardPolicy = field(default_factory=GuardPolicy)
    deadline_safety: float = 1.5
    ema_alpha: float = 0.3
    pad_pow2: bool = False
    ema_seed: bool = True


@dataclass
class ServiceHooks:
    """Per-tier solver overrides — the fault-injection surface.

    Each hook, when set, replaces that tier's solve with
    ``hook(request, profile) -> Topology`` (may raise, may return garbage:
    the service still release-validates whatever comes back, so a
    NaN-returning stub exercises the real invariant checklist and ladder).
    ``full`` set also disables miss bucketing (the stub sees every request).
    """

    full: Callable | None = None
    warm: Callable | None = None
    sa: Callable | None = None
    classic: Callable | None = None


@dataclass
class TopoResponse:
    """Structured answer: a topology with a quality tier, or a rejection."""

    request_id: int
    status: str                        # "ok" | "rejected"
    topology: Topology | None = None
    quality_tier: str | None = None    # one of QUALITY_TIERS when ok
    reason: str | None = None          # rejection reason / degradation trail
    cache_hit: bool = False
    latency_ms: float = 0.0
    profile: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def degraded(self) -> bool:
        return self.ok and self.quality_tier not in ("cache", "full")


@dataclass
class _CacheEntry:
    topology: Topology
    bandwidth: np.ndarray | None       # profile at solve time (drift baseline)
    hits: int = 0


def _load_bench_rows() -> list[dict] | None:
    """None: the port has no latency priors to load. The reference reads
    ``BENCH_admm.json``, whose pipeline rows were taken on a TPU (its n=64
    device row says 4.25 s; the same solve takes tens of seconds on the
    card), so a deadline ladder primed with them would try the full tier
    where it cannot fit. Explicit ``bench_rows=`` still seed the EMAs."""
    return None


class TopologyService:
    """Admission-controlled, deadline-aware, fault-tolerant topology oracle.

    Synchronous single-owner engine (like ``dsgd``'s simulators): callers
    :meth:`submit` requests — each submit returns either a queued request id
    or an immediate structured rejection — then :meth:`drain` processes the
    queue (bucketing compatible misses into one batched solve) and
    returns the responses. :meth:`request` is the submit-and-drain
    convenience for one spec. Neither raises for a solver outcome; a
    device fault propagates.
    """

    def __init__(self, cfg: BATopoConfig | None = None,
                 policy: ServicePolicy | None = None,
                 hooks: ServiceHooks | None = None,
                 bench_rows: list[dict] | None = None):
        self.cfg = cfg or BATopoConfig()
        self.policy = policy or ServicePolicy()
        self.hooks = hooks or ServiceHooks()
        self._queue: list[tuple[TopoRequest, float]] = []   # (req, t_submit)
        self._cache: OrderedDict[tuple, _CacheEntry] = OrderedDict()
        self._ema_ms: dict[tuple[str, int], float] = {}
        self._seed_profiles: dict[int, PhaseProfile] = {}
        self.stats = {"submitted": 0, "admitted": 0, "rejected_overload": 0,
                      "rejected_malformed": 0, "cache_hits": 0, "misses": 0,
                      "invalidations": 0, "bucketed_solves": 0,
                      "degraded": 0, "failed": 0, "ema_seeded": 0}
        if self.policy.ema_seed:
            if bench_rows is None:
                bench_rows = _load_bench_rows()
            self._seed_ema(bench_rows or [])

    def _seed_ema(self, rows: list[dict]) -> None:
        """Prime the cold-start latency estimates from tracked pipeline
        bench rows: the device-pipeline ``total_s`` becomes the full-tier
        EMA prior for that n, and the per-phase breakdown becomes the
        anytime solver's stage-scheduling seed profile."""
        for row in rows:
            if row.get("pipeline") != "device" or "n" not in row:
                continue
            n = int(row["n"])
            if "total_s" in row:
                self._ema_ms.setdefault(("full", n),
                                        float(row["total_s"]) * 1e3)
                self.stats["ema_seeded"] += 1
            prof = PhaseProfile.from_dict(
                {k: row[k] for k in ("warm_s", "admm_s", "round_s",
                                     "polish_s", "eval_s") if k in row})
            if prof.phases:
                restarts = max(1, int(row.get("restarts", 1)))
                self._seed_profiles[n] = PhaseProfile(
                    {k: v / restarts for k, v in prof.phases.items()})

    _PIPELINE_PHASES = ("warm_s", "admm_s", "round_s", "polish_s", "eval_s")

    def _seed_from_run(self, n: int, phases: dict, instances: int) -> None:
        """Seed the stage profile of ``n`` from a full-tier solve this
        service ran, where none is learned yet: its measured phase times
        (``<phase>_s``) divided by the instances it solved (restarts of one
        request, or every restart of a bucket), as :meth:`_seed_ema` turns a
        bench row into a :class:`PhaseProfile`, but from this service's own
        measurements on its own device. Reads no file."""
        if n in self._seed_profiles:
            return
        prof = PhaseProfile.from_dict({k: phases[k] for k in self._PIPELINE_PHASES
                                       if k in phases})
        if prof.phases:
            k = max(1, int(instances))
            self._seed_profiles[n] = PhaseProfile({p: v / k for p, v in prof.phases.items()})

    def _seed_profile_for(self, n: int) -> PhaseProfile | None:
        """The stage profile that seeds an anytime solve at ``n``: the one
        learned at ``n``, else the nearest learned n's (the larger on a tie)
        scaled by ``max(1, m(n) / m(n'))`` with m(k) = k(k−1)/2 candidate
        edges — a stage's work grows with the edge count (SA moves, the
        ADMM's edge leaves, the polish), and on the card a smaller problem is
        launch-bound and costs no less, so an estimate never scales down.
        None when nothing is learned."""
        if n in self._seed_profiles:
            return self._seed_profiles[n]
        if not self._seed_profiles:
            return None
        near = min(self._seed_profiles, key=lambda k: (abs(k - n), -k))
        scale = max(1.0, (n * (n - 1)) / (near * (near - 1)))
        return PhaseProfile({p: v * scale for p, v in self._seed_profiles[near].phases.items()})

    def _learn_stages(self, n: int, estimates: dict) -> None:
        """Keep one anytime solve's per-stage-invocation cost estimates
        (seconds per SA restart, per ADMM solve, per polish, per evaluation)
        as the seed profile of ``n``, so the next deadlined request at ``n``
        skips the stages that cannot fit. The solver seeded its estimates
        from this profile and folded each invocation in as an EMA, so they
        already blend the prior with this solve. The reference learns no
        stage estimates live: it seeds them from its bench rows only (a
        deviation; the port has no card rows to seed from)."""
        stages = {k: v for k, v in estimates.items()
                  if k in ("warm", "admm", "polish", "eval")}
        if stages:
            self._seed_profiles[n] = PhaseProfile(stages)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, req: TopoRequest) -> TopoResponse | int:
        """Admit ``req`` into the bounded queue.

        Returns the request id when admitted, or an immediate
        :class:`TopoResponse` rejection (malformed spec / overload). Never
        raises.
        """
        self.stats["submitted"] += 1
        bad = self._validate(req)
        if bad is not None:
            self.stats["rejected_malformed"] += 1
            return TopoResponse(req.request_id, "rejected",
                                reason=f"malformed: {bad}")
        if len(self._queue) >= self.policy.max_queue:
            self.stats["rejected_overload"] += 1
            return TopoResponse(
                req.request_id, "rejected",
                reason=f"overloaded: queue full "
                       f"({len(self._queue)}/{self.policy.max_queue})")
        self.stats["admitted"] += 1
        self._queue.append((req, time.perf_counter()))
        return req.request_id

    def request(self, n: int, r: int, scenario: str = "homo",
                node_bandwidths: np.ndarray | None = None,
                cs: ConstraintSet | None = None,
                deadline_ms: float | None = None) -> TopoResponse:
        """Submit one spec and process it to completion."""
        req = TopoRequest(n=n, r=r, scenario=scenario,
                          node_bandwidths=node_bandwidths, cs=cs,
                          deadline_ms=deadline_ms)
        out = self.submit(req)
        if isinstance(out, TopoResponse):
            return out
        return self.drain()[-1]

    def _validate(self, req: TopoRequest) -> str | None:
        """First malformed field of ``req``, or None — delegated to the
        unified ``anytime.validate_request`` path (the service-level twin of
        the topology release checklist: bad requests die here, named)."""
        return validate_request(req)

    # ------------------------------------------------------------------
    # canonical cache
    # ------------------------------------------------------------------

    def _cache_key(self, req: TopoRequest) -> tuple:
        n = int(req.n)
        r_eff = min(int(req.r), len(all_edges(n)))
        bw_key: tuple | None = None
        if req.node_bandwidths is not None:
            bw = np.asarray(req.node_bandwidths, dtype=np.float64)
            step = self.policy.bw_quant * max(float(bw.mean()), 1e-12)
            bw_key = tuple(np.round(bw / step).astype(np.int64).tolist())
        cs_key: str | None = None
        if req.cs is not None:
            h = hashlib.sha1()
            h.update(np.ascontiguousarray(req.cs.M).tobytes())
            h.update(np.ascontiguousarray(req.cs.e_cap).tobytes())
            h.update(np.ascontiguousarray(req.cs.edge_ok).tobytes())
            h.update(b"eq" if req.cs.equality else b"ineq")
            cs_key = h.hexdigest()
        return (n, r_eff, req.scenario, bw_key, cs_key)

    def _cache_lookup(self, req: TopoRequest, key: tuple) -> Topology | None:
        """Drift-checked LRU hit: the entry's solve-time bandwidth profile
        must still be within ``policy.drift`` of the request's current
        profile, else the entry is invalidated (stale world)."""
        entry = self._cache.get(key)
        if entry is None:
            return None
        if (entry.bandwidth is not None
                and req.node_bandwidths is not None):
            det = DriftDetector.from_profile(
                entry.bandwidth, np.ones(len(entry.bandwidth)),
                self.policy.drift)
            if det.check(1, np.asarray(req.node_bandwidths, np.float64),
                         np.ones(len(entry.bandwidth))) is not None:
                del self._cache[key]
                self.stats["invalidations"] += 1
                return None
        entry.hits += 1
        self._cache.move_to_end(key)
        return entry.topology

    def _cache_store(self, req: TopoRequest, key: tuple,
                     topo: Topology) -> None:
        bw = (np.asarray(req.node_bandwidths, np.float64).copy()
              if req.node_bandwidths is not None else None)
        self._cache[key] = _CacheEntry(topo, bw)
        self._cache.move_to_end(key)
        while len(self._cache) > self.policy.cache_capacity:
            self._cache.popitem(last=False)

    def observe(self, node_bandwidths: np.ndarray) -> int:
        """Feed live bandwidth telemetry: invalidate every cached entry
        whose solve-time profile has drifted past ``policy.drift`` relative
        to the observed world. Returns the number of entries evicted."""
        bw_t = np.asarray(node_bandwidths, np.float64)
        dead = []
        for key, entry in self._cache.items():
            if entry.bandwidth is None or len(entry.bandwidth) != len(bw_t):
                continue
            det = DriftDetector.from_profile(
                entry.bandwidth, np.ones(len(bw_t)), self.policy.drift)
            if det.check(1, bw_t, np.ones(len(bw_t))) is not None:
                dead.append(key)
        for key in dead:
            del self._cache[key]
        self.stats["invalidations"] += len(dead)
        return len(dead)

    def _nearest_warm(self, req: TopoRequest) -> tuple | None:
        """Nearest-neighbor warm start: the cached same-(n, scenario) entry
        with the closest (r, bandwidth) spec, packed into an ADMM
        ``(g0, z0, lam0)`` start from its support. None if no neighbor."""
        n = int(req.n)
        bw = (np.asarray(req.node_bandwidths, np.float64)
              if req.node_bandwidths is not None else None)
        best_key, best_d = None, np.inf
        for key, entry in self._cache.items():
            kn, kr, kscen, _, _ = key
            if kn != n or kscen != req.scenario:
                continue
            d = abs(kr - min(int(req.r), len(all_edges(n))))
            if bw is not None and entry.bandwidth is not None:
                rel = np.abs(entry.bandwidth - bw) / np.maximum(bw, 1e-12)
                d += float(rel.mean())
            if d < best_d:
                best_key, best_d = key, d
        if best_key is None:
            return None
        return _pack_warm(n, self._cache[best_key].topology.edges)

    # ------------------------------------------------------------------
    # deadline accounting
    # ------------------------------------------------------------------

    def _remaining_ms(self, req: TopoRequest, t_submit: float) -> float | None:
        if req.deadline_ms is None:
            return None
        return req.deadline_ms - (time.perf_counter() - t_submit) * 1e3

    def _estimate_ms(self, tier: str, n: int) -> float | None:
        return self._ema_ms.get((tier, n))

    def _record_ms(self, tier: str, n: int, elapsed_ms: float) -> None:
        key = (tier, n)
        prev = self._ema_ms.get(key)
        a = self.policy.ema_alpha
        self._ema_ms[key] = (elapsed_ms if prev is None
                             else (1 - a) * prev + a * elapsed_ms)

    # ------------------------------------------------------------------
    # tiers
    # ------------------------------------------------------------------

    def _tier_full(self, req: TopoRequest, prof: dict) -> Topology:
        """The unabridged pipeline — the same barrier execution the library
        API runs, so a fault-free full-tier answer is bit-equal to what
        one-shot ``solve_topology`` returns."""
        if self.hooks.full is not None:
            return self.hooks.full(req, prof)
        return solve_topology(req, cfg=self.cfg, profile=prof,
                              engine="barrier").topology

    def _tier_warm(self, req: TopoRequest, prof: dict) -> Topology | None:
        """Guarded warm-started ADMM from the nearest cached support (greedy
        init when the cache has no neighbor): skips SA and restarts, runs
        the ``core.guard`` ρ-jitter retry ladder."""
        if self.hooks.warm is not None:
            return self.hooks.warm(req, prof)
        n, r = int(req.n), int(req.r)
        scenario = req.scenario
        cs, _, _ = resolve_scenario(n, r, scenario, req.cs,
                                    req.node_bandwidths, context="service")
        t0 = time.perf_counter()
        warm = self._nearest_warm(req)
        if warm is None:
            deg = _homo_degree_targets(n, r) if scenario == "homo" else None
            edges0, _ = _init_graph(n, r, scenario, cs, deg, self.cfg, 0)
            warm = _pack_warm(n, edges0)
        prof["warm_s"] = prof.get("warm_s", 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        ladder = run_ladder(jittered_warm_rungs(
            n, r, scenario, cs, self.cfg, warm,
            f"ba-topo(n={n},r={r},svc-warm)", self.policy.guard))
        prof["admm_s"] = prof.get("admm_s", 0.0) + time.perf_counter() - t0
        if ladder.topology is None:
            raise RuntimeError(f"warm ladder exhausted ({ladder.reason})")
        ladder.topology.meta["ladder_rung"] = ladder.rung
        return ladder.topology

    def _tier_sa(self, req: TopoRequest, prof: dict) -> Topology | None:
        """SA-only topology: greedy init + simulated annealing, Metropolis
        weights, NO ADMM and NO polish — the cheap-but-principled rung for
        tight deadlines."""
        if self.hooks.sa is not None:
            return self.hooks.sa(req, prof)
        n, r = int(req.n), int(req.r)
        t0 = time.perf_counter()
        deg = _homo_degree_targets(n, r) if req.scenario == "homo" else None
        cs = req.cs if req.scenario != "homo" else None
        edges0, seed = _init_graph(n, r, req.scenario, cs, deg, self.cfg, 0)
        edges = _anneal_edges(n, [edges0], [seed], cs, self.cfg)[0]
        prof["warm_s"] = prof.get("warm_s", 0.0) + time.perf_counter() - t0
        if not edges or not is_connected(n, edges):
            return None
        g = metropolis_weights(n, edges)
        return Topology(n, edges, g, name=f"ba-topo(n={n},r={r},svc-sa)",
                        meta={"connected": True, "sa_only": True})

    def _tier_classic(self, req: TopoRequest, prof: dict) -> Topology:
        """Closed-form last resort — always answers."""
        if self.hooks.classic is not None:
            return self.hooks.classic(req, prof)
        return classic_fallback(int(req.n), int(req.r),
                                req.cs if req.scenario != "homo" else None)

    _TIER_ORDER = ("full", "warm", "sa_only", "classic")

    # ------------------------------------------------------------------
    # processing
    # ------------------------------------------------------------------

    def drain(self) -> list[TopoResponse]:
        """Process every queued request; responses in submit order.

        Cache hits answer immediately; compatible misses (homogeneous
        scenario, no deadline, default solver path, no full-tier hook) are
        bucketed per n into one batched sweep solve; everything else
        walks the deadline ladder individually. Never raises for a solver
        outcome; a device fault propagates.
        """
        batch, self._queue = self._queue, []
        responses: dict[int, TopoResponse] = {}
        buckets: dict[int, list[tuple[TopoRequest, float, tuple]]] = {}
        singles: list[tuple[TopoRequest, float]] = []

        for req, t_sub in batch:
            key = self._cache_key(req)
            t0 = time.perf_counter()
            hit = self._cache_lookup(req, key)
            if hit is not None:
                self.stats["cache_hits"] += 1
                responses[req.request_id] = TopoResponse(
                    req.request_id, "ok", topology=hit, quality_tier="cache",
                    reason=None, cache_hit=True,
                    latency_ms=(time.perf_counter() - t_sub) * 1e3,
                    profile={"cache_s": time.perf_counter() - t0})
                continue
            self.stats["misses"] += 1
            if (req.scenario == "homo" and req.deadline_ms is None
                    and self.hooks.full is None
                    and self.cfg.admm.driver == "scan"
                    and self.cfg.admm.solver != "kkt_bicgstab_ilu"):
                buckets.setdefault(int(req.n), []).append((req, t_sub, key))
            else:
                singles.append((req, t_sub))

        for n, group in buckets.items():
            if len(group) < 2:           # nothing to amortize — go individual
                singles.extend((req, t_sub) for req, t_sub, _ in group)
                continue
            phases: dict = {}
            try:
                topos = self._solve_bucket(n, [req for req, _, _ in group], phases)
                self.stats["bucketed_solves"] += 1
            except DEVICE_FAULTS:
                raise
            except Exception:  # noqa: BLE001 — bucket failure → singles
                singles.extend((req, t_sub) for req, t_sub, _ in group)
                topos = None
            if topos is None:
                continue
            for (req, t_sub, key), topo in zip(group, topos):
                if topo is None or check_invariants(topo) is not None:
                    singles.append((req, t_sub))   # ladder rescues it
                    continue
                self._cache_store(req, key, topo)
                responses[req.request_id] = TopoResponse(
                    req.request_id, "ok", topology=topo, quality_tier="full",
                    reason=None,
                    latency_ms=(time.perf_counter() - t_sub) * 1e3,
                    profile={"bucketed": True, "bucket_size": len(group), **phases})

        for req, t_sub in singles:
            responses[req.request_id] = self._process_single(req, t_sub)

        out = [responses[req.request_id] for req, _ in batch]
        self.stats["degraded"] += sum(r.degraded for r in out)
        return out

    def _process_anytime(self, req: TopoRequest, t_sub: float) -> TopoResponse:
        """Deadline-driven miss on the anytime pipeline (DESIGN.md §17): the
        former full→warm→sa_only ladder rungs collapse into ONE budgeted
        best-so-far solve that degrades continuously — the budget is the
        remaining deadline, the stage scheduler is seeded from explicit
        bench rows and from what earlier solves at this n learned
        (:meth:`_learn_stages`), and an expired budget still answers via
        the solver's internal classic fallback. Never raises for a solver
        outcome; a device fault propagates."""
        n = int(req.n)
        key = self._cache_key(req)
        queue_s = time.perf_counter() - t_sub
        remaining = self._remaining_ms(req, t_sub)
        t0 = time.perf_counter()
        try:
            res = solve_topology(req, cfg=self.cfg,
                                 budget_ms=max(float(remaining), 0.0),
                                 seed_profile=self._seed_profile_for(n))
            topo, tier, reason = res.topology, res.quality_tier, res.reason
            prof = {"queue_s": queue_s, **res.profile.to_dict()}
            self._learn_stages(n, res.stage_estimates)
        except DEVICE_FAULTS:
            raise
        except Exception as exc:  # noqa: BLE001 — terminal guard
            topo, tier = None, None
            reason = f"anytime: {type(exc).__name__}: {exc}"
            prof = {"queue_s": queue_s}
        solve_s = time.perf_counter() - t0
        self._record_ms(tier or "full", n, solve_s * 1e3)
        if topo is not None and check_invariants(topo) is None:
            prof["solve_s"] = solve_s
            self._cache_store(req, key, topo)
            return TopoResponse(
                req.request_id, "ok", topology=topo, quality_tier=tier,
                reason=reason,
                latency_ms=(time.perf_counter() - t_sub) * 1e3, profile=prof)
        if topo is not None:
            bad = check_invariants(topo)
            reason = f"{reason}; anytime: invalid topology ({bad} violated)" \
                if reason else f"anytime: invalid topology ({bad} violated)"
        # terminal rescue: the closed-form classic (always answers)
        try:
            topo = (self.hooks.classic(req, prof) if self.hooks.classic
                    else classic_fallback(
                        n, int(req.r),
                        req.cs if req.scenario != "homo" else None))
            if check_invariants(topo) is None:
                prof["solve_s"] = time.perf_counter() - t0
                self._cache_store(req, key, topo)
                return TopoResponse(
                    req.request_id, "ok", topology=topo,
                    quality_tier="classic", reason=reason,
                    latency_ms=(time.perf_counter() - t_sub) * 1e3,
                    profile=prof)
        except DEVICE_FAULTS:
            raise
        except Exception as exc:  # noqa: BLE001
            reason = f"{reason}; classic: {type(exc).__name__}: {exc}"
        self.stats["failed"] += 1
        return TopoResponse(
            req.request_id, "rejected",
            reason=f"all tiers failed: {reason}",
            latency_ms=(time.perf_counter() - t_sub) * 1e3, profile=prof)

    def _process_single(self, req: TopoRequest, t_sub: float) -> TopoResponse:
        """Walk the deadline ladder for one cache miss (fault-injection
        hooks and undeadlined requests); deadlined requests without
        optimizer hooks route through :meth:`_process_anytime` instead.
        Every solver failure is recorded in the reason trail and the next
        rung runs; if even the classic fallback fails, the request is
        rejected with the full trail. A device fault propagates."""
        if (req.deadline_ms is not None and self.hooks.full is None
                and self.hooks.warm is None and self.hooks.sa is None):
            return self._process_anytime(req, t_sub)
        n = int(req.n)
        key = self._cache_key(req)
        prof: dict = {"queue_s": time.perf_counter() - t_sub}
        reasons: list[str] = []
        tiers = {"full": self._tier_full, "warm": self._tier_warm,
                 "sa_only": self._tier_sa, "classic": self._tier_classic}
        for tier in self._TIER_ORDER:
            remaining = self._remaining_ms(req, t_sub)
            if tier != "classic" and remaining is not None:
                if remaining <= 0:
                    reasons.append(f"{tier}: skipped (deadline expired)")
                    continue
                est = self._estimate_ms(tier, n)
                if (est is not None
                        and est * self.policy.deadline_safety > remaining):
                    reasons.append(
                        f"{tier}: skipped (est {est:.1f}ms * "
                        f"{self.policy.deadline_safety:g} > "
                        f"{remaining:.1f}ms left)")
                    continue
            t0 = time.perf_counter()
            try:
                topo = tiers[tier](req, prof)
            except DEVICE_FAULTS:
                raise
            except Exception as exc:  # noqa: BLE001 — any tier failure → next rung
                self._record_ms(tier, n, (time.perf_counter() - t0) * 1e3)
                reasons.append(f"{tier}: {type(exc).__name__}: {exc}")
                continue
            self._record_ms(tier, n, (time.perf_counter() - t0) * 1e3)
            if topo is None:
                reasons.append(f"{tier}: produced no topology")
                continue
            bad = check_invariants(topo)
            if bad is not None:
                reasons.append(f"{tier}: invalid topology ({bad} violated)")
                continue
            prof["solve_s"] = time.perf_counter() - t0
            if tier == "full":
                self._seed_from_run(n, prof, req.restarts or self.cfg.restarts)
            self._cache_store(req, key, topo)
            return TopoResponse(
                req.request_id, "ok", topology=topo, quality_tier=tier,
                reason="; ".join(reasons) or None,
                latency_ms=(time.perf_counter() - t_sub) * 1e3,
                profile=prof)
        self.stats["failed"] += 1
        return TopoResponse(
            req.request_id, "rejected",
            reason="all tiers failed: " + "; ".join(reasons),
            latency_ms=(time.perf_counter() - t_sub) * 1e3, profile=prof)

    # ------------------------------------------------------------------
    # bucketed miss solve
    # ------------------------------------------------------------------

    def _solve_bucket(self, n: int, reqs: list[TopoRequest],
                      phases: dict | None = None) -> list[Topology | None]:
        """Solve a bucket of same-n homogeneous misses in one batched sweep.

        Mirrors the one-shot pipeline request by request — same restart
        indices, same SA warm starts (annealed together through the
        ``_anneal_edges`` edge-count grouping), same rounding/polish/
        selection helpers — but runs ALL (request × restart) ADMM instances
        as ONE ``solve_sweep_spec`` call on ``cfg.device`` from one
        ``init_state`` of the (B, m) warm starts, padded to a power of two
        only under ``policy.pad_pow2``. Its warm-start, ADMM, rounding,
        polish and evaluation times go to ``phases`` (``<phase>_s``, the
        whole bucket's) and seed the stage profile of ``n`` per instance
        (:meth:`_seed_from_run`).
        """
        phases = {} if phases is None else phases
        clock = time.perf_counter
        from ..core.engine import (check_solver, init_state, make_homo_spec,
                                   resolve_partition, solve_sweep_spec)

        cfg = self.cfg
        admm = replace(cfg.admm, device=cfg.device)
        check_solver(admm)
        resolve_partition(admm.partition, n)
        m = len(all_edges(n))
        n_restarts = max(1, cfg.restarts)
        t0 = clock()
        inits, seeds, rs_vec = [], [], []
        for req in reqs:
            r_eff = min(int(req.r), m)
            deg = _homo_degree_targets(n, r_eff)
            for k in range(n_restarts):
                edges0, seed = _init_graph(n, r_eff, "homo", None, deg,
                                           cfg, k)
                inits.append(edges0)
                seeds.append(seed)
                rs_vec.append(r_eff)
        warms = [_pack_warm(n, e)
                 for e in _anneal_edges(n, inits, seeds, None, cfg)]
        phases["warm_s"] = clock() - t0

        t0 = clock()
        spec = make_homo_spec(n, max(rs_vec), admm)
        b = len(warms)
        pad = ((1 << (b - 1).bit_length()) - b) if self.policy.pad_pow2 else 0
        rows = list(range(b)) + [b - 1] * pad
        states = init_state(spec, np.stack([warms[i][0] for i in rows]),
                            np.array([warms[i][2] for i in rows]))
        results = solve_sweep_spec(spec, [rs_vec[i] for i in rows], states,
                                   admm)[:b]
        phases["admm_s"] = clock() - t0

        out: list[Topology | None] = []
        phases.update(round_s=0.0, polish_s=0.0, eval_s=0.0)
        for i, req in enumerate(reqs):
            sl = slice(i * n_restarts, (i + 1) * n_restarts)
            r_eff = rs_vec[i * n_restarts]
            meta = {"scenario": "homo", "r": r_eff}
            t0 = clock()
            items, sources = _candidate_items(
                n, r_eff, warms[sl], results[sl], None, cfg, meta,
                use_z=False)
            t1 = clock()
            topos = _finalize_batch(n, items, cfg, None)
            t2 = clock()
            best, best_val, _ = _pick_best(n, items, topos, sources)
            phases["round_s"] += t1 - t0
            phases["polish_s"] += t2 - t1
            phases["eval_s"] += clock() - t2
            if best is not None:
                best.meta["r_asym"] = best_val
                best.meta["bucketed"] = True
            out.append(best)
        self._seed_from_run(n, phases, b)
        return out
