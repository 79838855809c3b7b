"""Device meshes of the port, as ``repro/launch/mesh.py``: a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the reference's dim names.

Factory functions (not module-level constants): importing this module
touches no process group and no device.

  single-pod  (data, model)          dims ("data", "model")
  multi-pod   (pod, data, model)     dims ("pod", "data", "model")

The ``"data"`` dim hosts the decentralized gossip workers, ``"model"`` is
tensor parallelism inside a worker, ``"pod"`` is the slow boundary between
pods. Ranks fill the mesh row-major in rank order. Whoever starts the ranks
gives the default group its address, world size and rank; on one card
several ranks share it over gloo (NCCL refuses two ranks on one card).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "POD_SHAPE", "MULTIPOD_SHAPE"]

#: The reference's target, a TPU v5e pod (16 × 16 chips) and two of them;
#: kept under the reference's names for ``make_production_mesh``. They
#: describe that target, not a cluster of H100 cards.
POD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)


def _check_devices(shape: tuple[int, ...], axes: tuple[str, ...]) -> None:
    """Fail early, with an actionable message, when the mesh does not fit
    the ranks of the default group."""
    need = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks but no torch.distributed process "
            "group is initialized: start one rank a mesh position and call "
            "init_process_group(backend, init_method='tcp://localhost:<port>', rank=r, "
            f"world_size={need}) in each before building the mesh")
    have = dist.get_world_size()
    if need > have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks but the default group has "
            f"{have} ({dist.get_backend()} backend); start {need} ranks")


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device):
    from torch.distributed.device_mesh import DeviceMesh

    _check_devices(shape, axes)
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    """The reference's production mesh shape (:data:`POD_SHAPE` or
    :data:`MULTIPOD_SHAPE`) over the default group's ranks."""
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, *, device: str | torch.device = "cuda"):
    """A small (data, model) mesh over the default group's first
    ``data · model`` ranks (CPU tests pass ``device="cpu"``)."""
    return _mesh((data, model), ("data", "model"), device)
