"""Bandwidth → wall-clock models of §VI (Eqs. 34–35).

The paper measures, on its 8×2080Ti testbed:
  - b_avail = 9.76 GB/s  (max per-node bandwidth, PCIe measurement [42, 43]),
  - t_comm  = 5.01 ms    (ResNet-18 parameter exchange at 9.76 GB/s),
  - t_comp  = 15.21 ms   (ResNet-18 iteration compute on one 2080Ti),
then scales per-iteration time by the *minimum* per-edge bandwidth:
  t_iter  = b_avail / b_min × t_comm                      (Eq. 34)
  t_epoch = (b_avail / b_min × t_comm + t_comp) × c_iter  (Eq. 35)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import Topology, degrees

__all__ = ["PaperConstants", "homo_edge_bandwidth", "node_hetero_edge_bandwidth",
           "min_edge_bandwidth", "t_iter", "t_epoch"]


@dataclass(frozen=True)
class PaperConstants:
    b_avail: float = 9.76  # GB/s
    t_comm_ms: float = 5.01
    t_comp_ms: float = 15.21


def homo_edge_bandwidth(topo: Topology, b: float = 9.76) -> np.ndarray:
    """§VI-A1: bandwidth of edge {i,j} = min(b/d_i, b/d_j).

    For the directed exponential graph the paper uses out-degree; we honor
    ``meta['out_degree']`` when present.
    """
    n = topo.n
    if topo.meta.get("directed"):
        d = np.full(n, topo.meta["out_degree"], dtype=np.float64)
    else:
        d = degrees(n, topo.edges).astype(np.float64)
    d = np.maximum(d, 1.0)
    return np.array([min(b / d[i], b / d[j]) for i, j in topo.edges])


def node_hetero_edge_bandwidth(topo: Topology, b_nodes: np.ndarray) -> np.ndarray:
    """§VI-A2: bandwidth of edge {i,j} = min(b_i/d_i, b_j/d_j)."""
    n = topo.n
    if topo.meta.get("directed"):
        d = np.full(n, topo.meta["out_degree"], dtype=np.float64)
    else:
        d = degrees(n, topo.edges).astype(np.float64)
    d = np.maximum(d, 1.0)
    b = np.asarray(b_nodes, dtype=np.float64)
    return np.array([min(b[i] / d[i], b[j] / d[j]) for i, j in topo.edges])


def min_edge_bandwidth(edge_bw: np.ndarray) -> float:
    finite = edge_bw[np.isfinite(edge_bw)]
    return float(finite.min()) if finite.size else float("inf")


def t_iter(b_min: float, const: PaperConstants = PaperConstants()) -> float:
    """Eq. (34), in milliseconds."""
    return const.b_avail / b_min * const.t_comm_ms


def t_epoch(b_min: float, c_iter: int, const: PaperConstants = PaperConstants()) -> float:
    """Eq. (35), in milliseconds."""
    return (const.b_avail / b_min * const.t_comm_ms + const.t_comp_ms) * c_iter
