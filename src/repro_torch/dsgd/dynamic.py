"""Time-varying gossip (numpy; the reference's ``repro/dsgd/dynamic.py``).

Instead of applying the full weight matrix every step (deg(i) sends per
node), the static topology is decomposed into its matching rounds and ONE
round is applied per optimizer step, cycling round-robin:

    x_{t+1} = W_{t mod R} x_t,   W_c = I − Σ_{(i,j)∈M_c} g_ij (e_i−e_j)(e_i−e_j)ᵀ

Each W_c is symmetric doubly stochastic (a matching step). The cycle
tensors built here are bit-identical to the reference's: the sim engines
of :mod:`repro_torch.dsgd.sim` select ``Wc[t % R]`` from them.

``gossip_shard_dynamic`` (the round selected inside ``shard_map``) is
multi-device work and is not ported yet (ROADMAP.md, Queue 1, item 7).
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Topology
from .schedule import GossipSchedule, edge_color, reconstruct_weight_matrix

__all__ = ["round_robin_schedules", "cycle_weight_matrices", "cycle_contraction",
           "cycle_tensor", "static_cycle", "stack_cycles", "gossip_shard_dynamic"]


def round_robin_schedules(topo: Topology) -> list[GossipSchedule]:
    """One single-round GossipSchedule per matching of the topology.

    Within a matching the pairwise step uses w_ij' = min(2·W_ij, 0.5) (a
    lazy pairwise average), which keeps each W_c doubly stochastic and
    PSD-contractive. Weights are read off the realized ``topo.W`` (so
    U-EquiStatic's override decomposes into its actual mixing weights); a
    directed W has no symmetric matching decomposition and is rejected.
    """
    n = topo.n
    W = np.asarray(topo.W)
    if not np.allclose(W, W.T):
        raise ValueError(
            f"{topo.name}: asymmetric W has no symmetric matching "
            "decomposition (round-robin gossip needs pairwise exchanges)")
    schedules = []
    for c, matching in enumerate(edge_color(n, list(topo.edges))):
        pairs: list[tuple[int, int]] = []
        recv = np.zeros(n)
        selfw = np.ones(n)
        for i, j in matching:
            w = min(2.0 * float(W[i, j]), 0.5)
            pairs.extend([(i, j), (j, i)])
            recv[i] = w
            recv[j] = w
            selfw[i] = 1.0 - w
            selfw[j] = 1.0 - w
        schedules.append(GossipSchedule(
            n=n, perms=(tuple(sorted(pairs)),), recv_weights=(tuple(recv),),
            self_weights=tuple(selfw), name=f"{topo.name}/round{c}"))
    return schedules


def cycle_weight_matrices(schedules: list[GossipSchedule]) -> list[np.ndarray]:
    return [reconstruct_weight_matrix(s) for s in schedules]


def cycle_contraction(schedules: list[GossipSchedule]) -> float:
    """ρ(Π W_c − 11ᵀ/n): per-cycle consensus contraction of the round-robin
    scheme."""
    Ws = cycle_weight_matrices(schedules)
    n = Ws[0].shape[0]
    prod = np.eye(n)
    for W in Ws:
        prod = W @ prod
    dev = prod - np.ones((n, n)) / n
    return float(np.max(np.abs(np.linalg.eigvals(dev))))


def cycle_tensor(topo: Topology) -> np.ndarray:
    """The round-robin matching cycle as one stacked ``(R, n, n)`` array:
    step ``t`` of the dynamic scheme applies ``Wc[t % R]``."""
    return np.stack(cycle_weight_matrices(round_robin_schedules(topo)))


def static_cycle(W: np.ndarray) -> np.ndarray:
    """A static topology as a length-1 cycle: every step applies the full W."""
    return np.asarray(W)[None]


def stack_cycles(cycles) -> tuple[np.ndarray, np.ndarray]:
    """Pad variable-length cycles to ``(B, R_max, n, n)`` float64 + lengths
    ``(B,)`` int32. Padding slots are identity matrices and unreachable (the
    engines select slot ``t % R_b``)."""
    cycles = [np.asarray(c, dtype=np.float64) for c in cycles]
    if not cycles:
        return np.zeros((0, 1, 0, 0)), np.zeros((0,), np.int32)
    n = cycles[0].shape[-1]
    r_max = max(c.shape[0] for c in cycles)
    out = np.broadcast_to(np.eye(n), (len(cycles), r_max, n, n)).copy()
    lens = np.empty(len(cycles), np.int32)
    for b, c in enumerate(cycles):
        out[b, :c.shape[0]] = c
        lens[b] = c.shape[0]
    return out, lens


def gossip_shard_dynamic(tree, schedules: list[GossipSchedule], step, axis):
    """Not ported: the reference applies round ``step % R`` inside
    ``shard_map`` over ``gossip_shard``'s collective permutes."""
    raise NotImplementedError(
        "gossip_shard_dynamic is multi-device gossip and is not ported yet "
        "(ROADMAP.md, Queue 1, item 7: core/shard.py on torch.distributed)")
