"""The one place that turns a device name into a ``torch.device``."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when a CUDA
    device is asked for and ``torch.cuda.is_available()`` is false. There is
    no silent fallback to the CPU: a caller that wants the CPU says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
