"""The one place that turns a device name into a ``torch.device``, and the
exception the port raises when the card or its kernels fail."""
from __future__ import annotations

import os

import torch

__all__ = ["DeviceFault", "DEVICE_FAULTS", "resolve_device"]


class DeviceFault(RuntimeError):
    """The card, or a kernel of the port, failed: no card where one was
    asked for, no ``nvcc``, a kernel that does not build, load or launch.
    The guard ladders and the topology service record a solver's failures
    and move on to the next rung; they re-raise this, so a broken card never
    turns into a quiet fallback answer."""


#: What every catch-all of the guard ladders, the topology service and
#: re-optimization re-raises: the port's own device faults and CUDA runtime
#: errors as PyTorch surfaces them.
DEVICE_FAULTS = (DeviceFault, torch.AcceleratorError)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises :class:`DeviceFault` when a
    CUDA device is asked for and ``torch.cuda.is_available()`` is false.
    There is no silent fallback to the CPU: a caller that wants the CPU says
    so. In a rank of a ``torch.distributed`` process group, ``"cuda"``
    without an index is the rank's card, ``cuda:<local rank % device
    count>`` (the local rank from ``LOCAL_RANK``, else the group rank), made
    the current device, since the kernels launch on the current device;
    several ranks on one card share it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceFault(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(dev)
    return dev
