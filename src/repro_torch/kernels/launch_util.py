"""What every kernel wrapper needs on its launch path, kept off the
per-call cost: the loaded library (looked up once per process, not under
the build lock on every call), the SM count per device, the current
stream as a raw handle, and zeroed per-device workspaces that a kernel
leaves zeroed again."""
from __future__ import annotations

import ctypes

import torch

from ..device import DeviceFault
from . import build as _build

__all__ = ["library", "sm_count", "raw_stream", "raise_launch_error", "workspace"]

_libs: dict[str, ctypes.CDLL] = {}
_sms: dict[int, int] = {}
_ws: dict[tuple, list] = {}
_INVALID_DEVICE = 101            # cudaErrorInvalidDevice


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s loaded library (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = _build.load(name, signatures)
    return lib


def sm_count(index: int) -> int:
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def raw_stream(index: int) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on device ``index``."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


def raise_launch_error(kernel: str, err: int, index: int) -> None:
    if err == _INVALID_DEVICE:
        raise ValueError(f"{kernel}: the tensors lie on cuda:{index}, but the current "
                         f"CUDA device is cuda:{torch.cuda.current_device()}")
    raise DeviceFault(f"{kernel} kernel launch failed with CUDA error {err}")


def workspace(name: str, dev: torch.device, *specs: tuple[int, torch.dtype]) -> tuple:
    """Data pointers of ``name``'s zeroed buffers on ``dev``, one per
    ``(numel, dtype)`` in ``specs``, each at least that long. The buffers
    are made with ``torch.zeros`` only when they grow (to at least twice
    their old size), never on a call that fits, so the kernel that uses
    them must leave them as it found them where that matters. An outgrown
    set is kept alive: a captured CUDA graph may still point at it. Calls
    that share a workspace must run in order on one stream."""
    held = _ws.setdefault((name, dev.index), [])
    if held and all(t.numel() >= n for t, (n, _) in zip(held[-1][0], specs)):
        return held[-1][1]
    bufs = tuple(torch.zeros(max(n, 2 * old.numel() if held else 0), dtype=dt, device=dev)
                 for (n, dt), old in zip(specs, held[-1][0] if held else specs))
    held.append((bufs, tuple(t.data_ptr() for t in bufs)))
    return held[-1][1]
