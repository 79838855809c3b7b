"""Decentralized SGD of the port on one device: gossip over stacked workers,
the DSGD train steps, and the §VI-B evaluation engines (``sim``) with their
schedules, round-robin cycles, CHOCO compressors and fault injection.

Not ported yet: the collective-permute gossip (``gossip_shard``,
``gossip_shard_elastic``, ``gossip_shard_dynamic``) and the multi-device
train steps (ROADMAP.md, Queue 1, item 7), and the elastic runtime
(``dsgd/elastic.py``, item 8).
"""
from .schedule import (
    GossipSchedule,
    bytes_per_sync,
    edge_color,
    reconstruct_weight_matrix,
    schedule_from_topology,
)
from .compression import (
    ChocoState,
    choco_gamma,
    choco_gossip_init,
    choco_gossip_step,
    choco_mix,
    compress_random_k,
    compress_top_k,
    identity_compressor,
    random_k_compressor,
    top_k_compressor,
)
from .chaos import (
    ChaosSpec,
    degrade_matrix,
    drift_profile,
    make_chaos,
    no_chaos,
    random_churn_windows,
)
from .dynamic import (
    cycle_contraction,
    cycle_tensor,
    round_robin_schedules,
    stack_cycles,
    static_cycle,
)
from .gossip import (
    elastic_neighbor_tables,
    gather_neighbor_weights,
    gossip_sim,
    gossip_sim_tree,
    gossip_sim_tree_rowloop,
    padded_neighbors,
    select_cycle_matrix,
)
from .sim import (
    CommSpec,
    DSGDSimConfig,
    accuracy_curve_host,
    accuracy_curve_host_chaos,
    accuracy_curve_host_cross,
    accuracy_curves,
    accuracy_curves_seeds,
    consensus_curve_host_chaos,
    consensus_curve_host_cross,
    consensus_curves_chaos,
    consensus_curves_cross,
    train_curves_chaos,
    train_curves_cross,
)
from .trainer import (
    DSGDState,
    allreduce_train_step,
    dsgd_train_step,
    init_dsgd_state,
    stack_workers,
)

__all__ = [
    "GossipSchedule", "bytes_per_sync", "edge_color",
    "reconstruct_weight_matrix", "schedule_from_topology",
    "gossip_sim", "gossip_sim_tree",
    "gossip_sim_tree_rowloop", "padded_neighbors", "elastic_neighbor_tables",
    "gather_neighbor_weights", "select_cycle_matrix",
    "DSGDSimConfig", "accuracy_curve_host", "accuracy_curves",
    "accuracy_curves_seeds",
    "CommSpec", "train_curves_cross", "accuracy_curve_host_cross",
    "consensus_curves_cross", "consensus_curve_host_cross",
    "ChaosSpec", "no_chaos", "make_chaos", "random_churn_windows",
    "drift_profile", "degrade_matrix",
    "train_curves_chaos", "accuracy_curve_host_chaos",
    "consensus_curves_chaos", "consensus_curve_host_chaos",
    "ChocoState", "choco_gamma", "choco_gossip_init", "choco_gossip_step",
    "choco_mix", "compress_top_k", "compress_random_k",
    "identity_compressor", "random_k_compressor", "top_k_compressor",
    "cycle_contraction", "cycle_tensor", "round_robin_schedules",
    "stack_cycles", "static_cycle",
    "DSGDState", "allreduce_train_step", "dsgd_train_step", "init_dsgd_state",
    "stack_workers",
]
