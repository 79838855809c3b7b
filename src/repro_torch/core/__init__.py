"""The topology solve of the port: ``solve_topology(TopologyRequest)`` and the
stages under it (SA warm start, ADMM, rounding, polish, spectral scoring),
plus the §VI-A consensus evaluation."""
from .admm import ADMMConfig, ADMMResult, HeterogeneousADMM, HomogeneousADMM
from .anytime import PhaseProfile, TopologyRequest, TopologyResult, solve_topology
from .api import BATopoConfig
from .constraints import ConstraintSet, bcube_constraints, intra_server_constraints
from .consensus import simulate_consensus_batched, time_to_error
from .graph import Topology
from .guard import check_invariants

__all__ = [
    "ADMMConfig", "ADMMResult", "HeterogeneousADMM", "HomogeneousADMM",
    "PhaseProfile", "TopologyRequest", "TopologyResult", "solve_topology",
    "BATopoConfig", "ConstraintSet", "bcube_constraints",
    "intra_server_constraints", "simulate_consensus_batched", "time_to_error",
    "Topology", "check_invariants",
]
