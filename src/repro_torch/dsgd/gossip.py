"""Gossip, one semantics: x ← W x (Eq. 1).

Over stacked (n, ...) worker copies on one device:

  gossip_sim               the dense W matmul over the leading worker axis
                           (the paper's Eq. 1 verbatim; ``torch.matmul``,
                           as the reference leaves it to XLA)
  gossip_sim_tree          gossip over a parameter dict, by default through
                           the ``gossip_mix_batched`` kernel: one launch per
                           dtype for all leaves and all n workers
  gossip_sim_tree_rowloop  one ``gossip_mix`` launch per worker row, the
                           parity oracle of the batched path

Over the ranks of a process group, one worker a rank (the reference's
``ppermute`` matching rounds inside ``shard_map``):

  gossip_shard             the schedule's rounds as point-to-point sends
  gossip_shard_elastic     the same with membership and weights as data

The table helpers of the elastic kernel path (``elastic_neighbor_tables``,
``gather_neighbor_weights``) are here too: the chaos engine of
:mod:`repro_torch.dsgd.sim` gathers each step's kernel weights from a
degraded W on the device.

The exchange. ``lax.axis_index`` becomes the worker's rank in the group
and ``lax.ppermute`` one ``dist.batch_isend_irecv`` a round: the rank
sends its leaves to the worker it feeds in that round and receives from
the worker that feeds it; a rank that is neither sends and receives
nothing (the reference's ppermute delivers zeros there, weighted 0). The
leaves of one dtype travel packed in one contiguous buffer, so a round is
one send and one receive a dtype, tagged by round and dtype; the mix is
elementwise, so the packing does not change a bit of the result. What is
sent is the worker's own pre-gossip copy in every round, so it is packed
once a call. Every rank of the group must run the same rounds in the same
order, with buffers of the same sizes: an exception on one rank leaves the
others waiting until the group's timeout, so whoever starts the ranks
gives the group a timeout and takes the others down when one fails.

The transport follows the group's backend. NCCL sends device tensors,
one rank a card. NCCL leaves a group's first ``batch_isend_irecv``
undefined unless every rank takes part, and an idle rank posts nothing,
so a collective of the whole group must come before the first gossip: the
train steps' builders run a barrier
(``tests/test_torch_gossip_first_round.py`` runs it on four cards).
gloo's send and receive take host memory only (PyTorch lists them as CPU
operations for gloo), so on a gloo group a rank whose leaves lie on a card
stages: the packed buffers are copied once a call into pinned host memory,
and each received buffer back to the card (:func:`_to_host`,
:func:`_to_device`). A failed send or receive raises; nothing is retried.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..kernels.gossip_mix.ops import gossip_mix, gossip_mix_batched_leaves
from .schedule import GossipSchedule

__all__ = ["gossip_shard", "gossip_shard_elastic", "gossip_sim",
           "gossip_sim_tree", "gossip_sim_tree_rowloop", "padded_neighbors",
           "elastic_neighbor_tables", "gather_neighbor_weights",
           "schedule_weight_arrays", "select_cycle_matrix"]


def select_cycle_matrix(Wc: torch.Tensor, R, t) -> torch.Tensor:
    """``W_{t mod R}`` from a stacked ``(R_max, n, n)`` cycle tensor; ``R``
    and ``t`` may be tensors (an index on the device, no host read)."""
    i = torch.remainder(torch.as_tensor(t, device=Wc.device),
                        torch.as_tensor(R, device=Wc.device))
    return torch.index_select(Wc, 0, i.reshape(1).long())[0]


def _worker(axis, n: int):
    """(group, this rank's worker index) of the group hosting the n workers
    (``None``: the default group)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("gossip_shard needs a torch.distributed process group: one rank "
                           "a worker")
    group = dist.group.WORLD if axis is None else axis
    if dist.get_world_size(group) != n:
        raise ValueError(f"the schedule has {n} workers but the group has "
                         f"{dist.get_world_size(group)} ranks")
    return group, dist.get_rank(group)


def _peers(perm, i: int) -> tuple[int | None, int | None]:
    """(the worker i sends to, the worker i receives from) in one round's
    (src, dst) pairs; None where i has none."""
    dst = next((d for s, d in perm if s == i), None)
    src = next((s for s, d in perm if d == i), None)
    return dst, src


def _pack(leaves, extra: torch.Tensor | None = None):
    """The leaves as one flat buffer a dtype, in order of first appearance:
    ``[(buffer, [(leaf index, offset), ...]), ...]``. ``extra`` (a float32
    scalar) goes last in the float32 buffer, which it creates if no leaf is
    float32."""
    groups: dict = {}
    for k, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(k)
    if extra is not None:
        groups.setdefault(torch.float32, [])
    packs = []
    for dtype, idx in groups.items():
        parts = [leaves[k].reshape(-1) for k in idx]
        if extra is not None and dtype == torch.float32:
            parts.append(extra.reshape(1).to(torch.float32))
        slots, off = [], 0
        for k in idx:
            slots.append((k, off))
            off += leaves[k].numel()
        packs.append((torch.cat(parts) if len(parts) > 1 else parts[0].contiguous(), slots))
    return packs


def _to_host(buf: torch.Tensor) -> torch.Tensor:
    """A device buffer's copy in pinned host memory (gloo's staging out)."""
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    torch.cuda.current_stream(buf.device).synchronize()
    return host


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received host buffer's copy on the card (gloo's staging in)."""
    return host.to(device, non_blocking=True)


def _exchange(sends: list, peers, group, tag: int, pinned: bool) -> list | None:
    """One round: send every buffer of ``sends`` to ``peers[0]`` and receive
    a buffer of the same size and dtype for each from ``peers[1]`` (worker
    indices in ``group``; pinned host buffers when ``pinned``), one
    ``batch_isend_irecv``; the received buffers, or None when nothing is
    received. Buffer k travels under tag ``tag + k``."""
    dst, src = peers
    if dst is None and src is None:
        return None
    recvs = None if src is None else [
        torch.empty(b.shape, dtype=b.dtype, pin_memory=True) if pinned else torch.empty_like(b)
        for b in sends]
    ops = []
    for k, b in enumerate(sends):
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, b, dist.get_global_rank(group, dst), group,
                                  tag + k))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recvs[k], dist.get_global_rank(group, src), group,
                                  tag + k))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


def _rounds(packs, sched: GossipSchedule, group, i: int, device):
    """Yield ``(round, received buffers on the leaves' device or None)`` for
    each round of the schedule, exchanging the packed buffers."""
    # gloo sends host memory only: a rank on a card stages
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    sends = [_to_host(b) for b, _ in packs] if staged else [b for b, _ in packs]
    for r, perm in enumerate(sched.perms):
        recvs = _exchange(sends, _peers(perm, i), group, r * len(packs), staged)
        if recvs is not None and staged:
            recvs = [_to_device(h, device) for h in recvs]
        yield r, recvs


def _unpack(accs, packs, leaves) -> list:
    """Each leaf's slice of its float32 accumulator, cast to its dtype."""
    out = [None] * len(leaves)
    for acc, (_, slots) in zip(accs, packs):
        for k, off in slots:
            x = leaves[k]
            out[k] = acc[off:off + x.numel()].view(x.shape).to(x.dtype, copy=True)
    return out


def gossip_shard(tree, sched: GossipSchedule, axis=None):
    """One gossip sync of this worker's parameter tree over the ranks of a
    process group, one worker a rank.

    ``tree``: this worker's copy, any shapes (a leading worker axis of size
    1 is just data); ``axis``: the process group hosting the n workers
    (``None``: the default group), the worker's index its rank there. As the
    reference: ``acc = x · w_self[i]`` in float32, then for each round, in
    the schedule's order, ``acc += recv · w_recv[r][i]`` with the received
    copy in float32, and each leaf cast back to its dtype.
    """
    group, i = _worker(axis, sched.n)
    leaves, spec = tree_flatten(tree)
    if not leaves:
        return tree
    packs = _pack(leaves)
    w_self, w_recv = schedule_weight_arrays(sched)
    accs = [b.float() * float(w_self[i]) for b, _ in packs]
    for r, recvs in _rounds(packs, sched, group, i, leaves[0].device):
        if recvs is None:
            continue
        w = float(w_recv[r, i])
        for acc, rb in zip(accs, recvs):
            acc += rb.float() * w
    return tree_unflatten(_unpack(accs, packs, leaves), spec)


def gossip_shard_elastic(tree, sched: GossipSchedule, axis, mix_mask, self_weights,
                         recv_weights):
    """Elastic variant of :func:`gossip_shard`: weights and membership are
    data (tensors or arrays; read on the leaves' device, no host read).

    ``mix_mask (n,)``: 1 for the workers in this round's exchange (alive
    and not dropped by the watchdog). Each round a worker's flag ``a``
    travels with its float32 buffer (its last element). A receiver weighs
    a non-participant's copy 0 and folds the lost mass into its own term,
    as the reference: ``acc = x·w_self + Σ_r recv·(w_r·a_src) + x·lost``,
    ``lost = Σ_r w_r·(1 − a_src)``, with ``a_src = 0`` in a round where the
    worker receives nothing. The non-participant's own row is the caller's
    (freeze or keep-local). ``self_weights (n,)`` / ``recv_weights
    (rounds, n)``: see :func:`schedule_weight_arrays`; the rounds' pairs
    stay the schedule's.
    """
    group, i = _worker(axis, sched.n)
    leaves, spec = tree_flatten(tree)
    if not leaves:
        return tree
    device = leaves[0].device

    def f32(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.float32)

    a_i = f32(mix_mask)[i]
    w_self = f32(self_weights)[i]
    w_recv = f32(recv_weights).reshape(sched.rounds, sched.n)
    packs = _pack(leaves, extra=a_i)
    f = next(k for k, (b, _) in enumerate(packs) if b.dtype == torch.float32)
    sizes = [b.numel() - (k == f) for k, (b, _) in enumerate(packs)]
    accs = [b[:m].float() * w_self for (b, _), m in zip(packs, sizes)]
    lost = torch.zeros((), dtype=torch.float32, device=device)
    for r, recvs in _rounds(packs, sched, group, i, device):
        w = w_recv[r, i]
        if recvs is None:
            lost = lost + w
            continue
        a_src = recvs[f][-1]
        coef = w * a_src
        for acc, rb, m in zip(accs, recvs, sizes):
            acc += rb[:m].float() * coef
        lost = lost + w * (1.0 - a_src)
    for acc, (b, _), m in zip(accs, packs, sizes):
        acc += b[:m].float() * lost
    return tree_unflatten(_unpack(accs, packs, leaves), spec)


def schedule_weight_arrays(sched: GossipSchedule) -> tuple[np.ndarray, np.ndarray]:
    """A schedule's weights as ``(self (n,), recv (rounds, n))`` float32
    arrays: the data :func:`gossip_shard_elastic` takes (a re-polished
    weight set swaps in as new arrays)."""
    return (np.asarray(sched.self_weights, np.float32),
            np.asarray(sched.recv_weights, np.float32).reshape(sched.rounds, sched.n))


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

    ``use_kernel`` (default on, unlike the reference) mixes all leaves with
    one ``gossip_mix_batched`` launch per dtype over the padded neighbour
    table; pass ``nbr=padded_neighbors(W)`` built once to keep the host out
    of the step. ``use_kernel=False`` is the dense :func:`gossip_sim`.
    """
    if not use_kernel:
        return tree_map(lambda x: gossip_sim(x, W), tree)
    nbr_idx, weights = padded_neighbors(W) if nbr is None else nbr
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(gossip_mix_batched_leaves(leaves, nbr_idx, weights), spec)


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
