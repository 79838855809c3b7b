"""The plan constants of ``gossip_mix_batched`` (``kernels/gossip_mix/ops.py``:
STAGE_TARGET, RING_TARGET, MIN_BLOCKS, BULK_MIN_BYTES, MIN_SPLIT_BYTES),
each varied alone around the shipped plan, at the paths' shapes on one card.

    python3 tools/gossip_tune.py [--src PATH] [--shipped-only] [--json-out PATH]

Shapes (tables whose real slots hold distinct other workers of the row's
block of ``BLOCK`` rows; padded slots point at the row itself, weight 0):

- ``smollm_step``: smollm-135m's DSGD step at n = 8 in bfloat16, its 11
  stacked leaves in one launch over a degree-4 table (PERF.md row 4);
- ``elastic_leaves``: the same leaves a launch each over a ``deg_cap = 7``
  table with 3 padded slots a row (row 4c);
- ``sim_step``: the §VI-B sim's four MLP leaves (b1, b2, w1, w2) at main_sim's
  144 fp32 rows (9 topologies × 16 workers), degree 6, one launch (row 4b's
  step); ``sim_w1``, ``sim_b1``, ``sim_b2`` the leaves alone (b2's 40-byte
  rows are not 16-byte aligned: they take the element-wise load route);
- ``choco_step``: the four leaves at main_sim_cross's 272 rows (17 runs ×
  16), one launch, as a CHOCO step mixes x̂;
- ``ragged_fp32``, ``ragged_bf16``: one (8, 1,000,003) leaf, degree 4: the
  element-wise load routes at scale (no path has such a leaf).

Each case of under 64 MB: 50 calls captured in one CUDA graph, replayed
once after a warm-up and timed by CUDA events, so the host's launch cost is
out of the number; larger ones: 3 warm-up calls, then 20 back-to-back
calls timed by CUDA events. The shipped plan is timed first and again
last (its spread), and
every other plan's outputs must equal the shipped plan's bitwise. The
first-cut kernel (``gossip_mix_batched_witness``, a launch a leaf) is timed
beside it. ``--shipped-only`` times the shipped plan alone, and ``--src``
names the ``src`` directory whose ``repro_torch`` is timed (default: the
one beside this directory), so that two trees' kernels can be timed in
turn in one call. Prints the card's ``nvidia-smi`` name and power
limit, then one JSON line.

It needs a card and imports only torch, numpy and ``repro_torch``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BLOCK = 16
SMOLLM_ROWS = [49152 * 576, 576] + [30 * m for m in (576, 576, 576 * 576, 576 * 192, 576 * 192,
                                                     576 * 576, 576 * 1536, 576 * 1536,
                                                     1536 * 576)]
SIM_ROWS = {"b1": 128, "b2": 10, "w1": 64 * 128, "w2": 128 * 10}
KNOBS = (("STAGE_TARGET", (10 << 10, 40 << 10)),
         ("RING_TARGET", (60 << 10, 80 << 10)),
         ("MIN_BLOCKS", (1, 2, 3)),
         ("BULK_MIN_BYTES", (256, 4096, 1 << 30)),
         ("MIN_SPLIT_BYTES", (16, 64, 512)))


def table(n: int, deg: int, real: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, deg) int32 neighbours and (n, deg+1) float32 weights: row i's
    first ``real`` slots are the next workers of its block (cyclically),
    the rest the row itself with weight 0; a row's weights sum to 1."""
    b = min(n, BLOCK)
    idx = np.empty((n, deg), np.int32)
    w = np.zeros((n, deg + 1), np.float32)
    for i in range(n):
        base = i - i % b
        idx[i, :real] = [base + (i - base + k + 1) % b for k in range(real)]
        idx[i, real:] = i
        w[i, :real + 1] = 1.0 / (real + 1)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def cases(device) -> dict:
    """name → (leaves, (idx, w), grouped): one launch for all leaves when
    ``grouped``, else a launch a leaf."""
    gen = torch.Generator(device=device).manual_seed(0)

    def leaves(n, rows, dtype):
        return [torch.randn((n, m), generator=gen, device=device).to(dtype) for m in rows]

    smollm = leaves(8, SMOLLM_ROWS, torch.bfloat16)
    sim = dict(zip(SIM_ROWS, leaves(144, SIM_ROWS.values(), torch.float32)))
    return {
        "smollm_step": (smollm, table(8, 4, 4, device), True),
        "elastic_leaves": (smollm, table(8, 7, 4, device), False),
        "sim_step": (list(sim.values()), table(144, 6, 6, device), True),
        "sim_w1": ([sim["w1"]], table(144, 6, 6, device), True),
        "sim_b1": ([sim["b1"]], table(144, 6, 6, device), True),
        "sim_b2": ([sim["b2"]], table(144, 6, 6, device), True),
        "choco_step": (leaves(272, SIM_ROWS.values(), torch.float32), table(272, 6, 6, device),
                       True),
        "ragged_fp32": (leaves(8, [1_000_003], torch.float32), table(8, 4, 4, device), True),
        "ragged_bf16": (leaves(8, [1_000_003], torch.bfloat16), table(8, 4, 4, device), True),
    }


def timed_ms(fn, graph: bool, reps: int = 20, warmup: int = 3, launches: int = 50) -> float:
    """Mean device time of one ``fn()``: replayed from a CUDA graph of
    ``launches`` calls when ``graph``, else ``reps`` eager calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if not graph:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(stop) / launches


@contextlib.contextmanager
def constants(ops, **values):
    """The plan's module constants set to ``values`` for the block."""
    old = {k: getattr(ops, k) for k in values}
    for k, v in values.items():
        setattr(ops, k, v)
    ops._plan.cache_clear()
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(ops, k, v)
        ops._plan.cache_clear()


def measure(shipped_only: bool = False) -> dict:
    from repro_torch.kernels.gossip_mix import ops

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    all_cases = cases(dev)

    def call(name):
        xs, (idx, w), grouped = all_cases[name]
        if grouped:
            return lambda: ops.gossip_mix_batched_leaves(xs, idx, w)
        return lambda: [ops.gossip_mix_batched(x, idx, w) for x in xs]

    def small(name):
        return sum(x.numel() * x.element_size() for x in all_cases[name][0]) < 64 << 20

    def plan_of(name):
        xs, (idx, _), _ = all_cases[name]
        p = ops.gossip_plan(xs[0].shape[0], idx.shape[1], [x.numel() // x.shape[0] for x in xs],
                            xs[0].element_size(), sms)
        return dict(tile_bytes=p.tile_bytes, stages=p.stages, blocks=p.blocks, tiles=p.tiles,
                    bulk=p.bulk)

    shapes = {}
    for name, (xs, (idx, w), _) in all_cases.items():
        want = call(name)()
        wit = [ops.gossip_mix_batched_witness(x, idx, w) for x in xs]
        nbytes = sum(2 * x.numel() * x.element_size() for x in xs)
        shapes[name] = dict(leaves=len(xs), rows=xs[0].shape[0], deg=int(idx.shape[1]),
                            dtype=str(xs[0].dtype).removeprefix("torch."), bytes=nbytes,
                            plan=plan_of(name), shipped_ms=timed_ms(call(name), small(name)),
                            witness_ms=timed_ms(lambda: [ops.gossip_mix_batched_witness(x, idx, w)
                                                         for x in xs], small(name)),
                            equal_to_witness=all(torch.equal(a, b) for a, b in zip(want, wit)))
        del wit
        shapes[name]["_want"] = want
    sweep = []
    if not shipped_only:
        for knob, values in KNOBS:
            for v in values:
                with constants(ops, **{knob: v}):
                    for name in all_cases:
                        got = call(name)()
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, shapes[name]["_want"]))
                        del got
                        sweep.append(dict(knob=knob, value=v, shape=name, plan=plan_of(name),
                                          ms=timed_ms(call(name), small(name)), equal=same))
    for name in all_cases:
        shapes[name]["shipped_again_ms"] = timed_ms(call(name), small(name))
        del shapes[name]["_want"]
    shipped = {k: getattr(ops, k) for k, _ in KNOBS}
    return dict(shipped=shipped, sm_count=sms, shapes=shapes, sweep=sweep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--shipped-only", action="store_true", help="time the shipped plan only")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gossip_tune: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = dict(tool="gossip_tune", card=smi, src=str(Path(args.src).resolve()),
               torch=torch.__version__, cuda=torch.version.cuda,
               **measure(args.shipped_only))
    bad = [r for r in out["sweep"] if not r["equal"]]
    bad += [dict(shape=k) for k, s in out["shapes"].items() if not s["equal_to_witness"]]
    out["all_bitwise_equal"] = not bad
    print(json.dumps(out), flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1) + "\n")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
