"""Whether ``gossip_mix_batched``'s time grows with the table's degree at
the same bytes, on one card.

    python3 tools/gossip_deg.py [--kernels witness,kernel] [--json-out PATH]

One leaf of smollm-135m's DSGD step at n = 8 in bfloat16, the embedding
(8, 49,152 × 576), mixed over tables of degree 1, 4 and 7 whose slots all
hold distinct other workers (row i's slot k reads worker (i + k + 1) mod
8), and over a degree-7 table whose last 3 slots are padded (they point at
the row itself with weight 0, as the elastic step's ``deg_cap = 7`` tables
do for a degree-4 graph). Every case reads x once and writes the output
once at the least, the same bytes, so a time that grows with the degree
is the cost of reading x's rows again (``deg + 1`` requests of each
element) and not of the traffic the function needs. ``witness`` is the
first-cut kernel (``gossip_mix_batched_witness``), ``kernel`` the one the
paths launch (``gossip_mix_batched``). Each case: 2 warm-up calls, then 10
back-to-back calls timed by CUDA events. Prints the card's ``nvidia-smi``
name and power limit, then one JSON line. ``chip_smoke.py`` runs
:func:`measure` as its ``gossip_deg`` phase.

It needs a card and imports only torch, numpy and ``repro_torch`` (from
``src/`` beside this directory).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N, ROWS = 8, 49_152 * 576
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
CASES = (("deg1", 1, 1), ("deg4", 4, 4), ("deg7", 7, 7), ("deg7_padded3", 7, 4))


def table(deg: int, real: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, deg) int32 neighbours and (n, deg+1) float32 weights: ``real``
    distinct other workers per row, the other slots the row itself with
    weight 0; the weights of a row sum to 1."""
    idx = np.empty((N, deg), np.int32)
    w = np.zeros((N, deg + 1), np.float32)
    for i in range(N):
        idx[i, :real] = [(i + k + 1) % N for k in range(real)]
        idx[i, real:] = i
        w[i, :real + 1] = 1.0 / (real + 1)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def timed_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def measure(names=("witness", "kernel")) -> list[dict]:
    """One row a case: its bound and each kernel's ms (CUDA events), and
    whether the kernels' outputs are bitwise equal."""
    from repro_torch.kernels.gossip_mix import ops

    fns = {"witness": ops.gossip_mix_batched_witness, "kernel": ops.gossip_mix_batched}
    dev = torch.device("cuda")
    x = torch.randn((N, ROWS), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev, dtype=torch.float32).to(torch.bfloat16)
    nbytes = 2 * x.numel() * x.element_size()
    rows = []
    for label, deg, real in CASES:
        idx, w = table(deg, real, dev)
        row = dict(case=label, deg=deg, real_neighbours=real,
                   bound_ms=1e3 * (nbytes + idx.numel() * 4 + w.numel() * 4) / HBM_BYTES_PER_S)
        outs = {}
        for name in names:
            row[f"{name}_ms"] = timed_ms(lambda: fns[name](x, idx, w))
            outs[name] = fns[name](x, idx, w)
        if len(outs) == 2:
            row["bitwise_equal"] = bool(torch.equal(*outs.values()))
        del outs
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="witness,kernel",
                    help="comma-separated: witness (the first-cut kernel), kernel")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gossip_deg: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    rows = measure(tuple(k for k in args.kernels.split(",") if k))
    out = dict(tool="gossip_deg", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
               shape=[N, ROWS], dtype="bfloat16", bytes=2 * N * ROWS * 2, rows=rows)
    print(json.dumps(out), flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
