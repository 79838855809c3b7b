"""Serving runtimes of the port: the batched KV/SSM-cache decode engine and
the fault-tolerant topology-optimization service (DESIGN.md §15)."""
from .engine import (
    DecodeState,
    ServeConfig,
    ServingEngine,
    greedy_sample,
    make_functional_serve_step,
    make_serve_step,
)
from .topo_service import (
    QUALITY_TIERS,
    ServiceHooks,
    ServicePolicy,
    TopologyService,
    TopoRequest,
    TopoResponse,
)

__all__ = ["DecodeState", "ServeConfig", "ServingEngine", "greedy_sample",
           "make_functional_serve_step", "make_serve_step",
           "QUALITY_TIERS", "ServiceHooks", "ServicePolicy",
           "TopologyService", "TopoRequest", "TopoResponse"]
