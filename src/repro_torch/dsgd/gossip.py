"""Gossip over stacked (n, ...) worker copies, one semantics: x ← W x (Eq. 1).

  gossip_sim               the dense W matmul over the leading worker axis
                           (the paper's Eq. 1 verbatim; ``torch.matmul``,
                           as the reference leaves it to XLA)
  gossip_sim_tree          gossip over a parameter dict, by default through
                           the ``gossip_mix_batched`` kernel: one launch per
                           leaf for all n workers
  gossip_sim_tree_rowloop  one ``gossip_mix`` launch per worker row, the
                           parity oracle of the batched path

The table helpers of the elastic kernel path (``elastic_neighbor_tables``,
``gather_neighbor_weights``) are here: the chaos engine of
:mod:`repro_torch.dsgd.sim` gathers each step's kernel weights from a
degraded W on the device. The collective-permute variants (``gossip_shard``,
``gossip_shard_elastic``) and ``schedule_weight_arrays``, which only
``gossip_shard_elastic`` reads, are multi-device work and are not ported
yet (ROADMAP.md, Queue 1, item 7).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..kernels.gossip_mix.ops import gossip_mix, gossip_mix_batched

__all__ = ["gossip_sim", "gossip_sim_tree", "gossip_sim_tree_rowloop", "padded_neighbors",
           "elastic_neighbor_tables", "gather_neighbor_weights", "select_cycle_matrix"]


def select_cycle_matrix(Wc: torch.Tensor, R, t) -> torch.Tensor:
    """``W_{t mod R}`` from a stacked ``(R_max, n, n)`` cycle tensor; ``R``
    and ``t`` may be tensors (an index on the device, no host read)."""
    i = torch.remainder(torch.as_tensor(t, device=Wc.device),
                        torch.as_tensor(R, device=Wc.device))
    return torch.index_select(Wc, 0, i.reshape(1).long())[0]


def gossip_sim(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """x: (n, ...) stacked worker copies; returns W x (Eq. 1). As in the
    reference, W is first rounded to x's dtype and the products are summed
    in float32, then rounded once to x's dtype."""
    if x.dim() == 1:
        return (W.float() @ x.float()).to(x.dtype)
    n = x.shape[0]
    out = W.to(x.dtype).float() @ x.reshape(n, -1).float()
    return out.to(x.dtype).reshape(x.shape)


def padded_neighbors(W) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed max-degree padded neighbour indexing for a concrete gossip matrix.

    Returns ``(nbr_idx (n, deg) int32, weights (n, deg+1) float32)`` on W's
    device (the CPU for a numpy W): ``deg`` is the graph's maximum degree,
    ``weights[:, 0]`` the self weight, and padded slots gather the row
    itself with weight 0, so the mix is exact for every degree. Neighbours
    are listed in increasing index. Build it once, at step construction.
    """
    device = W.device if isinstance(W, torch.Tensor) else torch.device("cpu")
    Wnp = W.detach().cpu().numpy() if isinstance(W, torch.Tensor) else np.asarray(W)
    n = Wnp.shape[0]
    off = Wnp.copy()
    np.fill_diagonal(off, 0.0)
    rows = [np.nonzero(off[i])[0] for i in range(n)]
    deg = max((len(r) for r in rows), default=0) or 1
    nbr_idx = np.empty((n, deg), np.int32)
    weights = np.zeros((n, deg + 1), np.float32)
    for i, r in enumerate(rows):
        nbr_idx[i, :len(r)] = r
        nbr_idx[i, len(r):] = i
        weights[i, 0] = Wnp[i, i]
        weights[i, 1:1 + len(r)] = off[i, r]
    return torch.from_numpy(nbr_idx).to(device), torch.from_numpy(weights).to(device)


def elastic_neighbor_tables(W, deg_cap: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour indexing whose weights are data: ``(nbr_idx (n, deg_cap)
    int32, nbr_mask (n, deg_cap) bool)`` for a concrete W, on W's device
    (the CPU for a numpy W). Real slots list the neighbours in increasing
    index, as :func:`padded_neighbors` does; padded slots point at the row
    itself with mask False. ``deg_cap`` defaults to n−1, every possible
    degree, so re-optimized topologies keep the table's shape."""
    device = W.device if isinstance(W, torch.Tensor) else torch.device("cpu")
    Wnp = W.detach().cpu().numpy() if isinstance(W, torch.Tensor) else np.asarray(W)
    n = Wnp.shape[0]
    off = Wnp.copy()
    np.fill_diagonal(off, 0.0)
    rows = [np.nonzero(off[i])[0] for i in range(n)]
    deg = deg_cap if deg_cap is not None else max(n - 1, 1)
    widest = max((len(r) for r in rows), default=0)
    if widest > deg:
        raise ValueError(f"deg_cap={deg} < max degree {widest} of W")
    nbr_idx = np.empty((n, deg), np.int32)
    nbr_mask = np.zeros((n, deg), bool)
    for i, r in enumerate(rows):
        nbr_idx[i, :len(r)] = r
        nbr_idx[i, len(r):] = i
        nbr_mask[i, :len(r)] = True
    return torch.from_numpy(nbr_idx).to(device), torch.from_numpy(nbr_mask).to(device)


def gather_neighbor_weights(W_eff: torch.Tensor, nbr_idx: torch.Tensor,
                            nbr_mask: torch.Tensor) -> torch.Tensor:
    """``(..., n, deg+1)`` float32 kernel weights gathered on the device from
    a (possibly degraded) ``(..., n, n)`` mixing matrix: column 0 the self
    weight, masked slots 0 — the layout ``gossip_mix_batched`` takes. Leading
    batch axes of W_eff, nbr_idx and nbr_mask broadcast; indices are local
    to each matrix."""
    lead = torch.broadcast_shapes(W_eff.shape[:-2], nbr_idx.shape[:-2])
    n = W_eff.shape[-1]
    Wb = W_eff.expand(lead + (n, n))
    idx = nbr_idx.long().expand(lead + tuple(nbr_idx.shape[-2:]))
    w = torch.where(nbr_mask, torch.gather(Wb, -1, idx), torch.zeros((), dtype=W_eff.dtype,
                                                                       device=W_eff.device))
    diag = torch.diagonal(Wb, dim1=-2, dim2=-1).unsqueeze(-1)
    return torch.cat([diag, w], dim=-1).to(torch.float32)


def gossip_sim_tree(tree, W: torch.Tensor, *, use_kernel: bool = True,
                    nbr: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Leaf-wise gossip over stacked (n, ...) parameter dicts.

    ``use_kernel`` (default on, unlike the reference) mixes each leaf with
    one ``gossip_mix_batched`` launch over the padded neighbour table; pass
    ``nbr=padded_neighbors(W)`` built once to keep the host out of the step.
    ``use_kernel=False`` is the dense :func:`gossip_sim`.
    """
    if not use_kernel:
        return tree_map(lambda x: gossip_sim(x, W), tree)
    nbr_idx, weights = padded_neighbors(W) if nbr is None else nbr
    return tree_map(lambda x: gossip_mix_batched(x, nbr_idx, weights), tree)


def gossip_sim_tree_rowloop(tree, W):
    """Per-worker-row ``gossip_mix`` loop — the parity oracle of
    ``gossip_sim_tree(use_kernel=True)``: n launches per leaf and a host
    read of W. Each row's neighbours are gathered into an (deg, ...) copy."""
    Wnp = W.detach().cpu().numpy() if isinstance(W, torch.Tensor) else np.asarray(W)
    n = Wnp.shape[0]

    def mix_leaf(x):
        rows = []
        for i in range(n):
            nbrs = [j for j in range(n) if j != i and Wnp[i, j] != 0.0]
            weights = torch.tensor([Wnp[i, i]] + [Wnp[i, j] for j in nbrs],
                                   dtype=torch.float32, device=x.device)
            idx = torch.tensor(nbrs, dtype=torch.long, device=x.device)
            rows.append(gossip_mix(x[i], x[idx], weights))
        return torch.stack(rows)

    return tree_map(mix_leaf, tree)
