"""Build the port's CUDA kernels from ``src/repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a
content hash of the sources and flags: an unchanged source is never rebuilt,
and a second load in one process reuses the loaded library.

Nothing here runs at import time; the first launch of a kernel builds it.
:func:`build` compiles several sources at once, one ``nvcc`` each, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from ..device import DeviceFault

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "parse_ptxas"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("edge_laplacian", "hop_bfs", "gossip_mix", "decode_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ``nvcc -Xptxas -v`` output of every source this process compiled.
ptxas_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise DeviceFault("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, all
    ``nvcc`` processes running at once. Returns name → library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        ptxas_logs[name] = log
    if failed:
        raise DeviceFault("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` and every ``restype`` ``c_int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise DeviceFault(f"kernel library {path} does not load: {exc}") from exc
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(log: str) -> list[dict]:
    """Registers, static shared memory and spills of each kernel in an
    ``nvcc -Xptxas -v`` log."""
    out: list[dict] = []
    for line in log.splitlines():
        if (m := _ENTRY.search(line)):
            out.append({"kernel": m.group(1), "registers": None,
                        "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0})
        elif out and (m := _SPILL.search(line)):
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        elif out and (m := _USED.search(line)):
            out[-1]["registers"] = int(m.group(1))
            out[-1]["smem_bytes"] = int(m.group(2) or 0)
    return out
