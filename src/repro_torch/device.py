"""The one place that turns a device name into a ``torch.device``, and the
exception the port raises when the card or its kernels fail."""
from __future__ import annotations

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
    so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceFault(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
