"""The topology solve of the port: ``solve_topology(TopologyRequest)`` and the
stages under it (SA warm start, ADMM, rounding, polish, spectral scoring),
the guard ladder, online re-optimization, and the §VI-A consensus
evaluation. Exports every name of ``repro.core``."""
from .admm import ADMMConfig, ADMMResult, HeterogeneousADMM, HomogeneousADMM
from .allocation import AllocationResult, allocate_edge_capacity
from .anytime import (AnytimeSolver, PhaseProfile, TopologyRequest, TopologyResult,
                      solve_topologies, solve_topology)
from .api import BATopoConfig, large_n_admm_config, optimize_topology, sweep_topologies
from .engine import ADMMState, ProblemSpec, resolve_partition, resolve_psd_backend
from .bandwidth import (PaperConstants, homo_edge_bandwidth, min_edge_bandwidth,
                        node_hetero_edge_bandwidth, t_epoch, t_iter)
from .constraints import (ConstraintSet, bcube_constraints, intra_server_constraints,
                          node_level_constraints, pod_boundary_constraints)
from .consensus import simulate_consensus, simulate_consensus_batched, time_to_error
from .graph import (Topology, all_edges, aspl, incidence_matrix, is_connected,
                    laplacian_from_weights, r_asym, r_asym_fast, weight_matrix_from_weights)
from .guard import (GuardPolicy, LadderResult, SolveFailure, SolveOutcome,
                    TopologyInvariantError, check_invariants, classic_fallback,
                    classify_result, run_ladder, validate_topology)
from .reopt import DriftDetector, DriftPolicy, ReoptResult, first_drift, reoptimize_topology
from .topologies import (BASELINES, exponential, grid2d, hypercube, make_baseline,
                         random_graph, ring, torus2d, u_equistatic)
from .warmstart import anneal_topology_batched, aspl_matmul
from .weights import (best_constant_weights, metropolis_weights, polish_weights,
                      polish_weights_batched)

__all__ = [
    "ADMMConfig", "ADMMResult", "HeterogeneousADMM", "HomogeneousADMM",
    "ADMMState", "ProblemSpec",
    "AllocationResult", "allocate_edge_capacity",
    "AnytimeSolver", "PhaseProfile", "TopologyRequest", "TopologyResult",
    "solve_topology", "solve_topologies",
    "BATopoConfig", "large_n_admm_config", "optimize_topology",
    "sweep_topologies", "resolve_psd_backend", "resolve_partition",
    "PaperConstants", "homo_edge_bandwidth", "min_edge_bandwidth",
    "node_hetero_edge_bandwidth", "t_epoch", "t_iter",
    "ConstraintSet", "bcube_constraints", "intra_server_constraints",
    "node_level_constraints", "pod_boundary_constraints",
    "simulate_consensus", "simulate_consensus_batched", "time_to_error",
    "Topology", "all_edges", "aspl", "incidence_matrix", "is_connected",
    "laplacian_from_weights", "r_asym", "r_asym_fast",
    "weight_matrix_from_weights",
    "GuardPolicy", "LadderResult", "SolveFailure", "SolveOutcome",
    "TopologyInvariantError", "check_invariants", "classic_fallback",
    "classify_result", "run_ladder", "validate_topology",
    "DriftPolicy", "DriftDetector", "ReoptResult", "first_drift",
    "reoptimize_topology",
    "BASELINES", "exponential", "grid2d", "hypercube", "make_baseline",
    "random_graph", "ring", "torus2d", "u_equistatic",
    "anneal_topology_batched", "aspl_matmul",
    "best_constant_weights", "metropolis_weights", "polish_weights",
    "polish_weights_batched",
]
