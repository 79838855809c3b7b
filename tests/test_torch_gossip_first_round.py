"""The rank-per-worker gossip's first exchange, when every round leaves
ranks idle: ``trainer._gossip_group`` (what both rank-per-worker train
steps build their group with) and then ``gossip_shard``, on 4 ranks of a
gloo group on the CPU, and of an NCCL group over 4 cards.

An idle rank posts nothing in a round. NCCL leaves a group's first
``batch_isend_irecv`` undefined unless every rank of the group takes part,
so ``_gossip_group`` runs a barrier of the whole group before it returns.
The topology is a star on 4 workers: each of its 3 rounds pairs the centre
with one leaf and leaves the other two ranks idle, the first round
included. Each rank checks its result against the same float32 per-round
accumulation over every worker's copy (all made from one seed on every
rank), on its own device: the same operations, so the bits must agree.
No JAX: the NCCL case runs on a machine with 4 cards
(``python -m pytest -m cuda tests/test_torch_gossip_first_round.py``).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
RANK_TIMEOUT_S = 180

WORKER = r'''
import datetime, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, init, backend, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
dev = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
if dev.type == "cuda":
    torch.cuda.set_device(dev)
dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.graph import Topology
from repro_torch.dsgd import gossip_shard, schedule_from_topology, schedule_weight_arrays, trainer
from repro_torch.dsgd.gossip import _peers

topo = Topology(world, [(0, k) for k in range(1, world)],
                np.array([0.2, 0.3, 0.35][:world - 1]), "star")
sched = schedule_from_topology(topo)
rng = np.random.default_rng(0)
X = {"w": rng.standard_normal((world, 3, 5)).astype(np.float32),
     "h": rng.standard_normal((world, 7)).astype(np.float32)}
dtypes = {"w": torch.float32, "h": torch.bfloat16}
tree = {k: torch.from_numpy(X[k][rank]).to(dev, dtypes[k]) for k in X}
mesh = DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=("data",))
got = gossip_shard(tree, sched, trainer._gossip_group(mesh))
ws, wr = schedule_weight_arrays(sched)
bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
same = {}
for k, x in tree.items():
    every = torch.from_numpy(X[k]).to(dev, x.dtype)
    acc = every[rank].float() * float(ws[rank])
    for r, perm in enumerate(sched.perms):
        src = _peers(perm, rank)[1]
        if src is not None:
            acc += every[src].float() * float(wr[r, rank])
    b = bits[x.dtype]
    same[k] = bool(torch.equal(got[k].view(b), acc.to(x.dtype).view(b)))
out = dict(idle=[world - len({s for s, _ in p}) for p in sched.perms], same=same,
           device=str(got["w"].device), moved=not torch.equal(got["w"], tree["w"]))
pickle.dump(out, open(f"{out_dir}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
'''


def _run(backend: str, tmp: Path) -> list:
    """Start the 4 ranks; wait for all of them, taking the others down if
    one fails."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), init, backend,
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed (rc {p.returncode}):\n{logs[r][-4000:]}"
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]


def _check(outs: list, device: str) -> None:
    for r, o in enumerate(outs):
        assert o["idle"] == [2, 2, 2], o["idle"]
        assert o["same"] == {"w": True, "h": True}, (r, o["same"])
        assert o["device"] == device.format(r=r) and o["moved"], (r, o)


def test_first_round_with_idle_ranks_on_gloo(tmp_path):
    _check(_run("gloo", tmp_path), "cpu")


@pytest.mark.cuda
def test_first_round_with_idle_ranks_on_nccl(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} cards (one NCCL rank a card); "
                    f"{torch.cuda.device_count()} found")
    _check(_run("nccl", tmp_path), "cuda:{r}")
