"""Decentralized SGD of the port: gossip over stacked workers on one device
and over the ranks of a ``torch.distributed`` process group (one worker a
rank: the collective-permute gossip and the sharded train steps, plain and
elastic, with tensor parallelism inside a worker over a mesh's other dims),
the DSGD train steps (stacked, rank-per-worker, the single-worker
tensor-parallel step and the W-matmul step of pod-sized workers, on
DTensor), the elastic runtime (churn, stragglers, packet loss, live
re-optimization and crash-safe resume around the real model's step), and
the §VI-B evaluation engines (``sim``) with their schedules, round-robin
cycles, CHOCO compressors and fault injection.
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
from .elastic import (
    ElasticHooks,
    ElasticRuntime,
    ElasticSpec,
    ElasticState,
    RoundReport,
    fault_free_round_ms,
    make_elastic_sharded_train_step,
    make_elastic_train_step,
    node_step_latency_ms,
)
from .dynamic import (
    cycle_contraction,
    cycle_tensor,
    gossip_shard_dynamic,
    round_robin_schedules,
    stack_cycles,
    static_cycle,
)
from .gossip import (
    elastic_neighbor_tables,
    gather_neighbor_weights,
    gossip_shard,
    gossip_shard_elastic,
    gossip_sim,
    gossip_sim_tree,
    gossip_sim_tree_rowloop,
    padded_neighbors,
    schedule_weight_arrays,
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
    make_matmul_gossip_train_step,
    make_sharded_train_step,
    make_tp_train_step,
    stack_workers,
)

__all__ = [
    "GossipSchedule", "bytes_per_sync", "edge_color",
    "reconstruct_weight_matrix", "schedule_from_topology",
    "gossip_shard", "gossip_shard_elastic", "gossip_sim", "gossip_sim_tree",
    "gossip_sim_tree_rowloop", "padded_neighbors", "elastic_neighbor_tables",
    "gather_neighbor_weights", "schedule_weight_arrays", "select_cycle_matrix",
    "ElasticSpec", "ElasticState", "ElasticHooks", "ElasticRuntime",
    "RoundReport", "make_elastic_train_step",
    "make_elastic_sharded_train_step", "node_step_latency_ms",
    "fault_free_round_ms",
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
    "stack_cycles", "static_cycle", "gossip_shard_dynamic",
    "DSGDState", "allreduce_train_step", "dsgd_train_step", "init_dsgd_state",
    "make_matmul_gossip_train_step", "make_sharded_train_step", "make_tp_train_step",
    "stack_workers",
]
