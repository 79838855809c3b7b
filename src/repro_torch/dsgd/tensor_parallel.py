"""Tensor parallelism inside a worker, on ``torch.distributed.tensor``
(DTensor): what GSPMD's automatic axes do for the reference's pjit steps.

A worker's leaves are DTensors on a ``DeviceMesh`` of the worker's ranks,
placed by the specs of ``launch/sharding.py``; DTensor's sharding
propagation inserts the collectives the model's ops need, as GSPMD does.
The helpers here place plain tensors, take the local shards that the
gossip mixes, and put them back:

  place / place_tree     a plain tensor (every rank holding the same value)
                         as a DTensor by its spec, sliced locally, no
                         communication; a DTensor passes as it is
  to_local_tree          the local shards of a tree
  rewrap                 a local shard as a DTensor on another mesh (the
                         worker's sub-mesh, or the whole mesh with the
                         worker axis over the gossip dims)
  full_value             a DTensor's global value on every rank
  tp_region              the context the TP steps run their model in

Two things the model needs under DTensor, both inside :func:`tp_region`
only: the plain tensors the model builds itself (rope's cos and sin, the
causal mask) join DTensor ops as replicated
(``implicit_replication()``), and on a gloo group whose ranks share a card
DTensor's all-gathers go through c10d's ``all_gather_into_tensor`` (see
:func:`_gloo_cuda_all_gather`; :func:`full_value` too).
"""
from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["is_dtensor", "place", "place_tree", "to_local_tree", "rewrap", "full_value",
           "tp_region", "sub_mesh"]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def place(x: torch.Tensor, mesh, spec: tuple):
    """``x`` as a DTensor on ``mesh`` by ``spec``: every rank holds the same
    global value and keeps its slice (no communication), as pjit's
    ``in_shardings`` place a host value. A DTensor is returned as it is."""
    from torch.distributed.tensor import distribute_tensor

    from ..launch.sharding import placements

    if is_dtensor(x):
        return x
    return distribute_tensor(x, mesh, placements(spec, mesh), src_data_rank=None)


def place_tree(tree, mesh, specs):
    """:func:`place` over a tree and its spec tree (tuples are spec leaves)."""
    from ..launch.sharding import spec_leaves

    leaves, tdef = tree_flatten(tree)
    return tree_unflatten([place(x, mesh, s) for x, s in zip(leaves, spec_leaves(specs, tree))],
                          tdef)


def to_local_tree(tree):
    """Every DTensor leaf replaced by its local shard."""
    return tree_map(lambda x: x.to_local() if is_dtensor(x) else x, tree)


def full_value(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value on every rank (a plain tensor as it is); on
    a gloo mesh of CUDA ranks its all-gathers rerouted as in
    :func:`tp_region`."""
    if not is_dtensor(x):
        return x
    with _gloo_cuda_all_gather() if _gloo_cuda(x.device_mesh) else contextlib.nullcontext():
        return x.full_tensor()


def rewrap(local: torch.Tensor, mesh, placements):
    """A local shard as a DTensor on ``mesh`` with ``placements`` (even
    shards: the global shape follows from the local one)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False)


def sub_mesh(mesh, dims: tuple[str, ...]):
    """The rank's sub-mesh over ``dims`` (in mesh order)."""
    names = tuple(mesh.mesh_dim_names)
    ordered = tuple(d for d in names if d in dims)
    return mesh[ordered if len(ordered) > 1 else ordered[0]]


#: the library that reroutes the all-gathers while a tp_region of a gloo
#: CUDA mesh is open, and how many such regions are open
_REROUTE: dict = {"lib": None, "depth": 0}


@contextlib.contextmanager
def _gloo_cuda_all_gather():
    """For the block, the functional all-gathers that DTensor issues on
    CUDA tensors go through c10d's ``all_gather_into_tensor``.

    On gloo ranks sharing a card (torch 2.11, an H100), the functional
    ``_c10d_functional.all_gather_into_tensor`` of a CUDA tensor ends the
    process with SIGSEGV, while c10d's ``all_gather_into_tensor`` of the
    same tensor on the same group, and the functional all-reduce,
    reduce-scatter and all-to-all, run (a chip probe of each). DTensor
    gathers with the functional op (Shard → Replicate), so while the block
    runs its CUDA kernel is one that calls c10d's collective and returns the
    gathered tensor complete; the bits are the collective's, and the wait
    DTensor issues after it finds nothing pending. The kernel is registered
    in a library of its own, made when the outermost block opens and
    destroyed when it closes, which gives torch's kernel back: code outside
    the block, and NCCL groups there, keep it."""
    if _REROUTE["depth"] == 0:
        from torch.distributed.distributed_c10d import _resolve_process_group

        def gather(inp: torch.Tensor, group_size: int, group_name: str) -> torch.Tensor:
            out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
            dist.all_gather_into_tensor(out, inp.contiguous(),
                                        group=_resolve_process_group(group_name))
            return out

        def gather_coalesced(inputs, group_size: int, group_name: str):
            return [gather(x, group_size, group_name) for x in inputs]

        lib = torch.library.Library("_c10d_functional", "IMPL")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)      # "overriding a registered kernel"
            lib.impl("all_gather_into_tensor", gather, "CUDA")
            lib.impl("all_gather_into_tensor_coalesced", gather_coalesced, "CUDA")
        _REROUTE["lib"] = lib
    _REROUTE["depth"] += 1
    try:
        yield
    finally:
        _REROUTE["depth"] -= 1
        if _REROUTE["depth"] == 0:
            lib, _REROUTE["lib"] = _REROUTE["lib"], None
            lib._destroy()


@contextlib.contextmanager
def tp_region(mesh):
    """The context of a TP step's model: plain tensors join DTensor ops as
    replicated, and on a gloo mesh of CUDA ranks the all-gathers are
    rerouted (:func:`_gloo_cuda_all_gather`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with _gloo_cuda_all_gather() if _gloo_cuda(mesh) else contextlib.nullcontext(), \
            implicit_replication():
        yield


def _gloo_cuda(mesh) -> bool:
    """Whether ``mesh`` is a gloo group of CUDA ranks."""
    return mesh.device_type == "cuda" and dist.get_backend(mesh.get_group(0)) == "gloo"
