"""Elastic gossip training for the real model zoo (the port of
``repro/dsgd/elastic.py``, DESIGN.md §16).

One :class:`ElasticRuntime` wraps one train step whose every time-varying
input is a tensor argument, so nothing a fault or a re-optimization changes
rebuilds it:

  membership   ``ChaosSpec.alive``/``link_up`` rows feed ``degrade_matrix``
               inside the step: the effective mixing matrix is renormalized
               row-stochastic on the alive subgraph, dead workers freeze
               params AND optimizer state (``torch.where(alive, …)``) and
               rejoin at their frozen state. With the all-clear masks every
               mask op is an IEEE-exact identity, so the fault-free elastic
               step is bitwise ``dsgd_train_step`` (tested).
  watchdog     a per-round deadline from the Eq. 34 modeled latency
               (``node_step_latency_ms``): nodes whose modeled round latency
               exceeds ``deadline_factor ×`` the fault-free round are dropped
               from the round's exchange only — they keep their local update,
               survivors renormalize, the round clock is capped at the
               deadline. A non-finite loss walks a bounded retry ladder
               (``RungReport`` trail); exhausted, the round is skipped with
               the state frozen. Nothing else is classified: a device fault
               from the step or the re-solve leaves :meth:`ElasticRuntime.round`.
  re-optimize  a ``core.reopt.DriftDetector`` watches (B(t), alive) each
               round; on a trigger the incumbent is re-solved warm-started
               by ``reoptimize_topology`` on the runtime's device and the
               winner is adopted ``activation_lag_steps`` rounds later by
               swapping the W matrix and the deg-capped neighbour tables.
  resume       :class:`ElasticState` round-trips through the checkpoint
               extras (``to_extras``/``from_extras``): incumbent and pending
               topology, detector baselines, the key counter, the data-stream
               position and the membership counters — what a SIGKILLed run
               needs to reproduce the uninterrupted curve bitwise.

The kernel path (``use_kernel``, on by default in the port) mixes each leaf
with one ``gossip_mix_batched`` launch, its weights gathered on the device
from the degraded matrix over ``deg_cap = n − 1`` tables (padded slots
weigh 0). ``ElasticState.key`` is an int64 ``(seed, rounds)`` pair where the
reference folds a JAX PRNG key once per round; nothing consumes either.
``make_elastic_sharded_train_step`` is the same step with one worker a
rank of a process group, mixing by ``gossip_shard_elastic``'s rounds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from ..core.api import BATopoConfig
from ..core.bandwidth import PaperConstants, t_iter
from ..core.graph import Topology, degrees, weight_matrix_from_weights
from ..core.guard import RungReport
from ..core.reopt import DriftDetector, DriftPolicy, ReoptResult, reoptimize_topology
from ..device import resolve_device
from ..kernels.gossip_mix.ops import gossip_mix_batched
from ..optim import apply_updates
from .chaos import ChaosSpec, degrade_matrix
from .gossip import (elastic_neighbor_tables, gather_neighbor_weights, gossip_shard_elastic,
                     gossip_sim)
from .schedule import GossipSchedule
from .trainer import (DSGDState, _gossip_group, _gossip_rank_groups, _group_mean, _loss_fn,
                      _tp_rank_step)

__all__ = ["ElasticSpec", "ElasticState", "ElasticHooks", "RoundReport",
           "ElasticRuntime", "make_elastic_train_step",
           "make_elastic_sharded_train_step", "node_step_latency_ms",
           "fault_free_round_ms"]


# ---------------------------------------------------------------------------
# modeled per-node latency (the watchdog's clock)
# ---------------------------------------------------------------------------

def node_step_latency_ms(topo: Topology, chaos: ChaosSpec, t: int,
                         const: PaperConstants = PaperConstants()) -> np.ndarray:
    """Per-node modeled latency (ms) of round ``t``.

    Node i's comm time is Eq. 34 at the slowest of its *active* incident
    edges (both endpoints alive; degree-shared ``min(B_i/d_i, B_j/d_j)``
    with static degrees — ports are provisioned for the full graph); its
    round latency is ``(t_comm + t_comp) × straggler_i(t)``. Dead nodes
    report 0 — they are not waited on. Link drops cost accuracy, not time.
    """
    n = topo.n
    alive = np.asarray(chaos.alive[t]) > 0
    bw = np.asarray(chaos.bandwidth[t], np.float64)
    strag = np.asarray(chaos.straggler[t], np.float64)
    d = np.maximum(degrees(n, topo.edges).astype(np.float64), 1.0)
    comm = np.zeros(n)
    for i, j in topo.edges:
        if alive[i] and alive[j]:
            t_e = t_iter(min(bw[i] / d[i], bw[j] / d[j]), const)
            comm[i] = max(comm[i], t_e)
            comm[j] = max(comm[j], t_e)
    lat = (comm + const.t_comp_ms) * strag
    lat[~alive] = 0.0
    return lat


def fault_free_round_ms(topo: Topology, bandwidth: np.ndarray,
                        const: PaperConstants = PaperConstants()) -> float:
    """The fault-free modeled round time (ms) of ``topo`` under a static
    per-node ``bandwidth`` profile — the watchdog deadline's baseline."""
    n = topo.n
    bw = np.broadcast_to(np.asarray(bandwidth, np.float64), (n,))
    d = np.maximum(degrees(n, topo.edges).astype(np.float64), 1.0)
    comm = 0.0
    for i, j in topo.edges:
        comm = max(comm, t_iter(min(bw[i] / d[i], bw[j] / d[j]), const))
    return comm + const.t_comp_ms


# ---------------------------------------------------------------------------
# spec / state / reports
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ElasticSpec:
    """Static policy of an elastic run (the ChaosSpec carries the faults).

    ``deadline_factor``: round deadline = factor × the incumbent's
    fault-free modeled round time at the initial bandwidth profile.
    ``drop_stragglers``: watchdog authority to drop over-deadline nodes from
    a round's exchange (False = every round waits out the slowest
    straggler). ``max_round_retries``/``retry_backoff``: bounded retry
    ladder for non-finite rounds; retry k is modeled to cost ``backoff^k``
    extra round times. ``reopt``: close the DriftDetector →
    ``reoptimize_topology`` loop; adopted topologies activate
    ``activation_lag_steps`` rounds after the trigger (deterministic in
    steps, so a resumed run replays the same adoption schedule).
    ``reopt_budget``: ``"window"`` budgets the re-solve to the adoption
    window (``activation_lag_steps`` × the incumbent's modeled fault-free
    round time at the drifted profile), a float is an explicit ms budget,
    None (default) keeps the unbudgeted deterministic re-solve that a
    bitwise resume needs. ``topo_cfg``: the re-solve's ``BATopoConfig``;
    None takes the default config on the runtime's device.
    """

    chaos: ChaosSpec
    deadline_factor: float = 3.0
    drop_stragglers: bool = True
    max_round_retries: int = 1
    retry_backoff: float = 2.0
    reopt: bool = True
    reopt_scenario: str = "node"
    reopt_r: int | None = None
    reopt_budget: float | str | None = None
    activation_lag_steps: int = 1
    drift: DriftPolicy = field(default_factory=DriftPolicy)
    topo_cfg: Any = None              # BATopoConfig | None
    const: PaperConstants = field(default_factory=PaperConstants)


@dataclass
class ElasticState:
    """Host-side elastic runtime state — everything ``--resume`` must restore
    beyond the DSGDState pytree (see ``to_extras``/``from_extras``)."""

    topology: Topology
    W: torch.Tensor                                     # (n, n) float32, on the device
    nbr: tuple[torch.Tensor, torch.Tensor] | None       # deg-capped kernel tables
    detector: DriftDetector
    key: np.ndarray                                     # int64 (seed, rounds folded)
    data_step: int = 0                                  # batches consumed
    pending: tuple[int, Topology] | None = None         # (activate_step, topology)
    reopts: int = 0                                     # solver runs triggered
    adopted: int = 0                                    # topologies hot-swapped
    dropped_rounds: int = 0                             # rounds with ≥1 drop
    drops: int = 0                                      # node-rounds dropped
    events: list[dict] = field(default_factory=list)


@dataclass
class RoundReport:
    """What one elastic round did (the watchdog/membership trail)."""

    step: int
    alive: np.ndarray                 # (n,) bool — chaos membership this round
    dropped: np.ndarray               # (n,) bool — watchdog drops this round
    round_ms: float                   # modeled round time (deadline-capped)
    deadline_ms: float
    attempts: int                     # step executions (1 + retries)
    rungs: list[RungReport]
    reopt: ReoptResult | None = None  # set when the detector fired this round
    reopt_reason: str | None = None
    swapped: bool = False             # a pending topology activated this round


class ElasticHooks:
    """Fault-injection seams (tests only — production uses the defaults).

    ``on_attempt(step, attempt, batch) -> batch`` runs before every step
    execution; returning a poisoned batch exercises the retry ladder,
    returning a repaired one exercises recovery."""

    def on_attempt(self, step: int, attempt: int, batch):
        return batch


# ---------------------------------------------------------------------------
# the step (everything time-varying is a tensor argument)
# ---------------------------------------------------------------------------

def _bmask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n,) bool mask shaped to broadcast against a stacked (n, ...) leaf."""
    return mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def _masked_consensus_error(params, alive: torch.Tensor, n_alive: torch.Tensor) -> torch.Tensor:
    """‖x − x̄‖_F over the ALIVE replicas. With the all-ones mask this is
    bitwise ``trainer._consensus_error`` (multiplies by 1.0 are exact and
    the reductions are the same); dead nodes' frozen params are excluded so
    churn does not masquerade as divergence."""
    def leaf_err(x):
        m = _bmask(alive > 0, x).to(x.dtype)
        mean = (x * m).sum(dim=0, keepdim=True) / n_alive.to(x.dtype)
        return torch.sum(torch.square(((x - mean) * m).float()))
    return torch.sqrt(sum(leaf_err(x) for x in tree_leaves(params)))


def make_elastic_train_step(cfg, opt_update: Callable, *, use_kernel: bool = True):
    """The elastic stacked-worker step — ``dsgd_train_step``'s math with the
    fault tensors as arguments:

      step(state, batch, W, alive, link_up, mix_mask[, nbr_idx, nbr_mask])
        → (state, metrics)

    ``W (n,n)`` the incumbent mixing matrix (hot-swap = new tensor),
    ``alive (n,)`` chaos membership (dead ⇒ params and optimizer freeze),
    ``mix_mask (n,)`` round participation = alive ∧ ¬watchdog-dropped
    (dropped nodes keep their LOCAL update — they are late, not dead),
    ``link_up (n,n)`` packet-loss mask; every tensor on the state's device.
    Mixing runs over ``degrade_matrix(W, mix_mask, link_up)``. The kernel
    path gathers its weights from the degraded matrix over the deg-capped
    tables ``(nbr_idx, nbr_mask)`` and launches ``gossip_mix_batched`` once
    per leaf. The gradients of all workers come from one ``torch.func.vmap``
    of ``grad_and_value``, the optimizer is vmapped, and the update, the
    mix and the freezes run under ``torch.no_grad()``, leaf by leaf: each
    local leaf is dropped once it is mixed and frozen, so the step holds no
    more full copies of the parameters than ``dsgd_train_step``.
    """
    grad_fn = torch.func.vmap(torch.func.grad_and_value(_loss_fn(cfg)))
    opt_fn = torch.func.vmap(opt_update)

    def step(state: DSGDState, batch, W, alive, link_up, mix_mask, nbr_idx=None, nbr_mask=None):
        grads, losses = grad_fn(state.params, batch)
        with torch.no_grad():
            updates, opt = opt_fn(grads, state.opt, state.params)
            del grads
            local, spec = tree_flatten(apply_updates(state.params, updates))
            del updates
            W_eff = degrade_matrix(W, mix_mask, link_up)
            weights = gather_neighbor_weights(W_eff, nbr_idx, nbr_mask) if use_kernel else None
            mixes, lives = mix_mask > 0, alive > 0
            old = tree_leaves(state.params)
            out = []
            for i in range(len(local)):
                lc, local[i] = local[i], None
                mx = (gossip_mix_batched(lc, nbr_idx, weights) if use_kernel
                      else gossip_sim(lc, W_eff))
                out.append(torch.where(_bmask(mixes, mx), mx,
                                       torch.where(_bmask(lives, lc), lc, old[i])))
                del lc, mx
            params = tree_unflatten(out, spec)
            opt = tree_map(lambda nw, od: torch.where(_bmask(lives, nw), nw, od), opt, state.opt)
            n_alive = alive.sum()
            metrics = {"loss": (losses * alive).sum() / n_alive,
                       "loss_max": torch.where(lives, losses, -torch.inf).max(),
                       "consensus_err": _masked_consensus_error(params, alive, n_alive),
                       "n_alive": n_alive}
        return DSGDState(params, opt, state.step + 1), metrics

    return step


def make_elastic_sharded_train_step(cfg, sched: GossipSchedule, opt_update: Callable, mesh, *,
                                    gossip_axes=("data",)):
    """Elastic variant of ``make_sharded_train_step`` (one worker a rank, or
    a worker on a group of ranks: a mesh dim outside ``gossip_axes`` larger
    than 1 is tensor parallelism inside the worker, as there): schedule
    weights and membership are data,

      step(state, batch, alive, mix_mask, w_self, w_recv) -> (state, metrics)

    ``w_self (n,)`` / ``w_recv (rounds, n)`` from
    ``gossip.schedule_weight_arrays`` (a re-polished weight set swaps in as
    new tensors; a support change needs a new schedule and step),
    ``alive``/``mix_mask (n,)`` as in the stacked step, the same on every
    rank. A dead worker keeps its parameters and optimizer state bitwise
    (``torch.where``) but still takes part in every round, so the exchange
    pattern stays the schedule's; a dropped straggler keeps its local
    update, and the others renormalize inside ``gossip_shard_elastic``. The
    loss is ``Σ loss·alive / Σ alive`` over the workers.
    """
    _, tp = _gossip_rank_groups(mesh, tuple(gossip_axes))
    axis = _gossip_group(mesh, tuple(gossip_axes), sched.n)

    def masks(alive, mix_mask, dev):
        i = axis.ranks.index(dist.get_rank())
        a_i = torch.as_tensor(alive).to(dev)[i]
        return a_i, torch.as_tensor(mix_mask).to(dev)[i] > 0, a_i > 0

    def freeze(mixed, local, old, opt, opt_old, m_i, lives):
        params = tree_map(lambda mx, lc, od: torch.where(m_i, mx, torch.where(lives, lc, od)),
                          mixed, local, old)
        return params, tree_map(lambda nw, od: torch.where(lives, nw, od), opt, opt_old)

    if tp:
        def mix(local, old, opt, opt_old, extra):
            alive, mix_mask, w_self, w_recv = extra
            mixed = gossip_shard_elastic(local, sched, axis, mix_mask, w_self, w_recv)
            _, m_i, lives = masks(alive, mix_mask, tree_leaves(local)[0].device)
            return freeze(mixed, local, old, opt, opt_old, m_i, lives)

        inner = _tp_rank_step(cfg, opt_update, mesh, tuple(gossip_axes), tp, mix)

        def tp_step(state: DSGDState, batch, alive, mix_mask, w_self, w_recv):
            state, loss = inner(state, batch, alive, mix_mask, w_self, w_recv)
            a_i, _, _ = masks(alive, mix_mask, loss.device)
            return state, {"loss": _group_mean(loss, a_i.float(), axis.group)}

        return tp_step

    grad_fn = torch.func.vmap(torch.func.grad_and_value(_loss_fn(cfg)))
    opt_fn = torch.func.vmap(opt_update)

    def step(state: DSGDState, batch, alive, mix_mask, w_self, w_recv):
        grads, losses = grad_fn(state.params, batch)
        with torch.no_grad():
            updates, opt = opt_fn(grads, state.opt, state.params)
            del grads
            local = apply_updates(state.params, updates)
            del updates
            mixed = gossip_shard_elastic(local, sched, axis, mix_mask, w_self, w_recv)
            a_i, m_i, lives = masks(alive, mix_mask, losses.device)
            params, opt = freeze(mixed, local, state.params, opt, state.opt, m_i, lives)
            loss = _group_mean(losses[0], a_i.float(), axis.group)
        return DSGDState(params, opt, state.step + 1), {"loss": loss}

    return step


# ---------------------------------------------------------------------------
# the runtime (host-side orchestration around the one step)
# ---------------------------------------------------------------------------

class ElasticRuntime:
    """Watchdog + membership + re-optimization around one train step, on
    ``device`` (default ``"cuda"``).

    ``round()`` never raises on a classified failure (a non-finite loss): a
    poisoned round walks the retry ladder and, exhausted, freezes the state
    for that round — the ``RoundReport`` carries the rung trail. A device
    fault is not classified and leaves ``round()``.
    """

    def __init__(self, cfg, spec: ElasticSpec, topology: Topology,
                 opt_update: Callable, *, use_kernel: bool = True,
                 deg_cap: int | None = None, step_fn=None,
                 hooks: ElasticHooks | None = None,
                 device: str | torch.device = "cuda"):
        if spec.chaos.n != topology.n:
            raise ValueError(f"ChaosSpec is for n={spec.chaos.n} nodes but "
                             f"the topology has n={topology.n}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec
        self.n = topology.n
        self.use_kernel = use_kernel
        self.deg_cap = deg_cap if deg_cap is not None else max(self.n - 1, 1)
        self.topo_cfg = (spec.topo_cfg if spec.topo_cfg is not None
                         else BATopoConfig(device=str(self.device)))
        self.step_fn = step_fn if step_fn is not None else \
            make_elastic_train_step(cfg, opt_update, use_kernel=use_kernel)
        self.hooks = hooks or ElasticHooks()
        self.deadline_ms = spec.deadline_factor * fault_free_round_ms(
            topology, spec.chaos.bandwidth[0], spec.const)

    # -- state ------------------------------------------------------------

    def make_state(self, topology: Topology, seed: int = 0) -> ElasticState:
        ch = self.spec.chaos
        return ElasticState(
            topology=topology,
            W=self._matrix(topology),
            nbr=self._tables(topology),
            detector=DriftDetector.from_profile(ch.bandwidth[0], ch.alive[0],
                                                self.spec.drift),
            key=np.asarray([seed, 0], np.int64),
        )

    def _matrix(self, topo: Topology) -> torch.Tensor:
        return torch.tensor(weight_matrix_from_weights(topo.n, topo.edges, topo.g),
                            dtype=torch.float32, device=self.device)

    def _tables(self, topo: Topology):
        if not self.use_kernel:
            return None
        return elastic_neighbor_tables(self._matrix(topo), deg_cap=self.deg_cap)

    def _adopt(self, es: ElasticState, topo: Topology, t: int,
               bw: np.ndarray, alive: np.ndarray) -> None:
        es.topology = topo
        es.W = self._matrix(topo)
        es.nbr = self._tables(topo)
        es.detector.rebase(bw, alive)
        es.pending = None
        es.adopted += 1
        es.events.append({"step": t, "event": "adopt", "name": topo.name})

    def _mask(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    # -- one round --------------------------------------------------------

    def round(self, state: DSGDState, es: ElasticState, batch
              ) -> tuple[DSGDState, dict, RoundReport]:
        spec, ch = self.spec, self.spec.chaos
        t = int(state.step)
        ti = min(t, ch.steps - 1)
        alive_np = np.asarray(ch.alive[ti]) > 0
        bw_np = np.asarray(ch.bandwidth[ti], np.float64)

        swapped = False
        if es.pending is not None and t >= es.pending[0]:
            self._adopt(es, es.pending[1], t, bw_np, ch.alive[ti])
            swapped = True

        # watchdog: modeled latencies vs the round deadline
        lat = node_step_latency_ms(es.topology, ch, ti, spec.const)
        dropped = np.zeros(self.n, bool)
        if spec.drop_stragglers:
            dropped = alive_np & (lat > self.deadline_ms)
            if dropped.all() or not (alive_np & ~dropped).any():
                dropped[:] = False          # the watchdog cannot drop everyone
        mix_np = (alive_np & ~dropped).astype(np.float32)
        participants = lat[alive_np & ~dropped]
        round_ms = float(participants.max()) if participants.size else 0.0
        if dropped.any():
            # the watchdog waits until the deadline to declare the drop
            round_ms = max(round_ms, self.deadline_ms)
            es.dropped_rounds += 1
            es.drops += int(dropped.sum())

        # bounded retry/backoff ladder: classified rung reports; the
        # terminal rung freezes the round
        alive_d, link_d, mix_d = self._mask(ch.alive[ti]), self._mask(ch.link_up[ti]), \
            self._mask(mix_np)
        rungs: list[RungReport] = []
        new_state = metrics = None
        attempts = 0
        for k in range(spec.max_round_retries + 1):
            attempts = k + 1
            ab = self.hooks.on_attempt(t, k, batch)
            cand_state, cand_metrics = self._run(state, ab, es, alive_d, link_d, mix_d)
            loss = float(cand_metrics["loss"])
            name = "round" if k == 0 else f"retry{k}"
            if np.isfinite(loss):
                rungs.append(RungReport(name, "ok"))
                new_state, metrics = cand_state, cand_metrics
                break
            rungs.append(RungReport(name, "non_finite", f"loss={loss}"))
            round_ms += round_ms and self.deadline_ms * spec.retry_backoff ** k
        if new_state is None:
            rungs.append(RungReport("freeze", "ok",
                                    "retries exhausted — round skipped, state frozen"))
            new_state = DSGDState(state.params, state.opt, state.step + 1)
            nan = torch.tensor(np.nan, dtype=torch.float32, device=self.device)
            metrics = {"loss": nan, "loss_max": nan, "consensus_err": nan,
                       "n_alive": torch.tensor(float(alive_np.sum()), dtype=torch.float32,
                                               device=self.device)}

        # drift detection → warm re-optimization → deferred adoption
        reopt_res, reason = None, None
        if spec.reopt and es.pending is None:
            reason = es.detector.check(t, bw_np, ch.alive[ti])
            if reason is not None:
                reopt_res = self._reoptimize(es, t, bw_np, ch.alive[ti], reason)

        es.data_step += 1
        es.key = es.key + np.asarray([0, 1], np.int64)
        report = RoundReport(step=t, alive=alive_np, dropped=dropped,
                             round_ms=round_ms, deadline_ms=self.deadline_ms,
                             attempts=attempts, rungs=rungs, reopt=reopt_res,
                             reopt_reason=reason, swapped=swapped)
        return new_state, metrics, report

    def _run(self, state, batch, es: ElasticState, alive, link_up, mix):
        if self.use_kernel:
            return self.step_fn(state, batch, es.W, alive, link_up, mix, es.nbr[0], es.nbr[1])
        return self.step_fn(state, batch, es.W, alive, link_up, mix)

    def _reoptimize(self, es: ElasticState, t: int, bw: np.ndarray,
                    alive, reason: str) -> ReoptResult:
        spec = self.spec
        budget_ms = None
        if spec.reopt_budget is not None:
            if spec.reopt_budget == "window":
                budget_ms = (max(spec.activation_lag_steps, 1)
                             * fault_free_round_ms(es.topology, bw, spec.const))
            else:
                budget_ms = float(spec.reopt_budget)
        res = reoptimize_topology(
            es.topology, scenario=spec.reopt_scenario,
            node_bandwidths=bw if spec.reopt_scenario == "node" else None,
            r=spec.reopt_r, alive=np.asarray(alive), cfg=self.topo_cfg,
            policy=spec.drift, budget_ms=budget_ms)
        es.reopts += 1
        if res.reoptimized:
            es.pending = (t + max(spec.activation_lag_steps, 1), res.topology)
            es.events.append({"step": t, "event": "reopt", "reason": reason,
                              "time_to_reopt_s": res.time_to_reopt_s,
                              "r_asym_after": res.r_asym_after})
        else:
            es.events.append({"step": t, "event": "keep_incumbent",
                              "reason": res.fallback_reason})
        return res

    # -- crash-safe resume (checkpoint extras payload) --------------------

    def to_extras(self, es: ElasticState) -> dict[str, np.ndarray]:
        """ElasticState → named arrays for ``CheckpointManager.save(extra=)``:
        topology support and weights (edge counts change across reopts,
        hence the shape-free extras channel), detector baselines, pending
        adoption, key counter, stream position, counters."""
        topo = es.topology
        out = {
            "edges": np.asarray(topo.edges, np.int64).reshape(-1, 2),
            "g": np.asarray(topo.g, np.float64),
            **es.detector.to_state(),
            "key": np.asarray(es.key, np.int64),
            "data_step": np.asarray(es.data_step, np.int64),
            "counters": np.asarray([es.reopts, es.adopted, es.dropped_rounds,
                                    es.drops], np.int64),
            "pending_step": np.asarray(
                -1 if es.pending is None else es.pending[0], np.int64),
        }
        if es.pending is not None:
            ptopo = es.pending[1]
            out["pending_edges"] = np.asarray(ptopo.edges, np.int64).reshape(-1, 2)
            out["pending_g"] = np.asarray(ptopo.g, np.float64)
        return out

    def from_extras(self, extras: dict[str, np.ndarray],
                    name: str = "resumed") -> ElasticState:
        """Rebuild the ElasticState a checkpoint carried (inverse of
        ``to_extras``)."""
        edges = [tuple(int(v) for v in e) for e in extras["edges"]]
        topo = Topology(self.n, edges, np.asarray(extras["g"]), name=name)
        det = DriftDetector.from_state(extras, self.spec.drift)
        reopts, adopted, dropped_rounds, drops = (int(v) for v in extras["counters"])
        pending = None
        p_step = int(extras["pending_step"])
        if p_step >= 0:
            p_edges = [tuple(int(v) for v in e) for e in extras["pending_edges"]]
            pending = (p_step, Topology(self.n, p_edges, np.asarray(extras["pending_g"]),
                                        name=name + "-pending"))
        return ElasticState(
            topology=topo, W=self._matrix(topo), nbr=self._tables(topo),
            detector=det, key=np.asarray(extras["key"], np.int64).copy(),
            data_step=int(extras["data_step"]), pending=pending,
            reopts=reopts, adopted=adopted, dropped_rounds=dropped_rounds,
            drops=drops)
