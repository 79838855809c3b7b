"""Serving runtime of the port: the batched KV/SSM-cache decode engine.

The reference's topology-optimization service (``serve/topo_service.py``)
is not ported yet (ROADMAP.md, Queue 1, item 6)."""
from .engine import (
    DecodeState,
    ServeConfig,
    ServingEngine,
    greedy_sample,
    make_functional_serve_step,
    make_serve_step,
)

__all__ = ["DecodeState", "ServeConfig", "ServingEngine", "greedy_sample",
           "make_functional_serve_step", "make_serve_step"]
