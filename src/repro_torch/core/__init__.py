"""The topology solve of the port: ``solve_topology(TopologyRequest)`` and the
stages under it (SA warm start, ADMM, rounding, polish, spectral scoring),
the guard ladder, online re-optimization, and the §VI-A consensus
evaluation."""
from .admm import ADMMConfig, ADMMResult, HeterogeneousADMM, HomogeneousADMM
from .anytime import (AnytimeSolver, PhaseProfile, TopologyRequest, TopologyResult,
                      solve_topologies, solve_topology)
from .api import BATopoConfig, large_n_admm_config, optimize_topology, sweep_topologies
from .constraints import ConstraintSet, bcube_constraints, intra_server_constraints
from .consensus import simulate_consensus_batched, time_to_error
from .graph import Topology
from .guard import (GuardPolicy, LadderResult, SolveFailure, SolveOutcome,
                    TopologyInvariantError, check_invariants, classic_fallback,
                    classify_result, run_ladder, validate_topology)
from .reopt import DriftDetector, DriftPolicy, ReoptResult, first_drift, reoptimize_topology

__all__ = [
    "ADMMConfig", "ADMMResult", "HeterogeneousADMM", "HomogeneousADMM",
    "AnytimeSolver", "PhaseProfile", "TopologyRequest", "TopologyResult",
    "solve_topologies", "solve_topology",
    "BATopoConfig", "large_n_admm_config", "optimize_topology", "sweep_topologies",
    "ConstraintSet", "bcube_constraints", "intra_server_constraints",
    "simulate_consensus_batched", "time_to_error", "Topology",
    "GuardPolicy", "LadderResult", "SolveFailure", "SolveOutcome",
    "TopologyInvariantError", "check_invariants", "classic_fallback",
    "classify_result", "run_ladder", "validate_topology",
    "DriftDetector", "DriftPolicy", "ReoptResult", "first_drift",
    "reoptimize_topology",
]
