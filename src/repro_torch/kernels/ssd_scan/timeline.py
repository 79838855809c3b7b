"""Where a launch of the tensor-core ``ssd_intra_chunk`` kernel spends its
time, block by block, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.timeline

Builds a copy of ``csrc/ssd_scan.cu`` into the build directory with
``%globaltimer`` stamps taken by each block's thread 0 — at its start,
when each s tile's data is in shared memory and when the block is done
with it — launches it once at mamba2-780m's prefill shape (B 8, one chunk
of Q 256, H 48, P 64, N 128, bf16 column slices of one conv output), and
prints one JSON object: the launch's span and, for each kind of block
(state blocks, and y blocks by row tile), the median and largest wait for
the first tiles, time on one s tile and wait between two, in µs. Stamps
cost a few instructions a step; the span is a little above the kernel's
own time.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import build, launch_util
from . import ops

_STAMPS = r'''
__device__ unsigned long long g_stamp[1 << 16];
#define STAMP(k) if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_stamp[((blockIdx.x + gridDim.x * blockIdx.y) * 16 + (k)) % (1 << 16)] = t_; }
extern "C" int read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n * 8);
}
'''
# (anchor in csrc/ssd_scan.cu, stamp put just before it): a block's start
# (0), its s tile j's data in shared memory (1 + 2j), done with it (2 + 2j)
_AT = [
    ("  tc_load(Cs, ldN, Cb + t0 * d.c_s2, d.c_s2, TC_TILE, S_end - t0, NK, N, vec);", "STAMP(0);"),
    ("    const __nv_bfloat16* Bs = st0 + (d.stages == 2 ? (j & 1) : 0) * stage_elems;",
     "STAMP(1 + 2 * j);"),
    ("    if (d.stages == 1 && j < tile) {", "STAMP(2 + 2 * j);"),
    ("  for (int i = threadIdx.x; i < TC_HG * S_pad; i += TC_THREADS) {\n"
     "    const int hh = i / S_pad, s = i - hh * S_pad, h = h0 + hh;", "STAMP(0);"),
    ("      const __nv_bfloat16* Xs = st0 + (d.stages == 2 ? (j & 1) : 0) * stage_elems;",
     "STAMP(1 + 2 * j);"),
    ("      if (d.stages == 1 && j + 1 < n_s) {", "STAMP(2 + 2 * j);"),
]


def _stamped_library() -> ctypes.CDLL:
    src = (build.CSRC / "ssd_scan.cu").read_text()
    i = src.index("namespace {")
    src = src[:i] + _STAMPS + src[i:]
    for anchor, stamp in _AT:
        if anchor not in src:
            raise RuntimeError(f"timeline: anchor not found in ssd_scan.cu: {anchor!r}")
        src = src.replace(anchor, stamp + "\n" + anchor, 1)
    out = build.BUILD_DIR / "ssd_scan_timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_scan.cu").write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "ssd_scan.so"),
                    str(out / "ssd_scan.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "ssd_scan.so"))
    for fn, argtypes in ops._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _stats(v) -> dict:
    return {"median_us": float(np.median(v)), "max_us": float(np.max(v)), "n": len(v)}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("timeline: needs an NVIDIA card")
    Bsz, Q, H, P, N = 8, 256, 48, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    di = H * P
    xbc = torch.randn((Bsz, 2 * Q, di + 2 * N), generator=gen, device="cuda").to(torch.bfloat16)
    chunk = xbc[:, :Q].unflatten(1, (1, Q))
    x = chunk[..., :di].unflatten(-1, (H, P))
    Bm, Cm = chunk[..., di:di + N], chunk[..., di + N:]
    dt = torch.nn.functional.softplus(torch.randn((Bsz, 1, Q, H), generator=gen, device="cuda"))
    la = torch.cumsum((-torch.rand(H, generator=gen, device="cuda") - 0.05) * dt, dim=2)
    lib = _stamped_library()
    real = launch_util._libs.get("ssd_scan")
    launch_util._libs["ssd_scan"] = lib
    try:
        for _ in range(20):
            ops.ssd_intra_chunk(x, dt, la, Bm, Cm)
        torch.cuda.synchronize()
        stamps = np.zeros(1 << 16, dtype=np.uint64)
        ops.ssd_intra_chunk(x, dt, la, Bm, Cm)
        torch.cuda.synchronize()
        lib.read_stamps(stamps.ctypes.data, 1 << 16)
    finally:
        if real is None:
            launch_util._libs.pop("ssd_scan", None)
        else:
            launch_util._libs["ssd_scan"] = real
    plan = ops.kernel_plan(Q, H, P, N, torch.bfloat16)
    roles = plan["n_state"] + plan["n_y"]
    t = stamps[:Bsz * roles * 16].reshape(roles, Bsz, 16).astype(np.int64)
    t0, end = t[t > 0].min(), t.max()
    kinds: dict = {}
    for r in range(roles):
        kind = ("state" if r < plan["n_state"] else
                f"y_tile_{plan['n_tiles'] - 1 - (r - plan['n_state']) // plan['n_hg']}")
        k = kinds.setdefault(kind, {"first_wait": [], "step": [], "between": []})
        for v in (t[r] - t0) / 1e3:
            k["first_wait"].append(v[1] - v[0])
            n_steps = sum(1 for j in range(7) if v[1 + 2 * j] > 0 and v[2 + 2 * j] > 0)
            for j in range(n_steps):
                k["step"].append(v[2 + 2 * j] - v[1 + 2 * j])
                if j + 1 < n_steps:
                    k["between"].append(v[3 + 2 * j] - v[2 + 2 * j])
    out = {"shape": dict(B=Bsz, nc=1, Q=Q, H=H, P=P, N=N, dtype="bfloat16"),
           "card": torch.cuda.get_device_name(0), "span_us": float((end - t0) / 1e3),
           "blocks": {kind: {name: _stats(v) for name, v in k.items() if v}
                      for kind, k in kinds.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
