"""Decentralized SGD of the port: gossip over stacked workers on one device."""
from .gossip import (
    gossip_sim,
    gossip_sim_tree,
    gossip_sim_tree_rowloop,
    padded_neighbors,
    select_cycle_matrix,
)
from .trainer import (
    DSGDState,
    allreduce_train_step,
    dsgd_train_step,
    init_dsgd_state,
    stack_workers,
)

__all__ = [
    "gossip_sim", "gossip_sim_tree", "gossip_sim_tree_rowloop", "padded_neighbors",
    "select_cycle_matrix", "DSGDState", "allreduce_train_step", "dsgd_train_step",
    "init_dsgd_state", "stack_workers",
]
