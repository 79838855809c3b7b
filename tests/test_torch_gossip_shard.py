"""The port's collective-permute gossip and its rank-per-worker DSGD train
steps (``repro_torch.dsgd``: ``gossip_shard``, ``gossip_shard_elastic``,
``gossip_shard_dynamic``, ``make_sharded_train_step``,
``make_elastic_sharded_train_step``) on 5 gloo ranks against the JAX
package's ``shard_map`` versions on 5 host devices, on the CPU.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=5``,
as the reference's own multi-device tests start theirs) and one group of 5
gloo ranks (one torch thread each, a ``file://`` rendezvous in
``tmp_path``, started as ``tests/test_torch_shard.py`` starts its ranks)
run at once for the module, on the same seed-made inputs:

- the topology is ``make_baseline("ring", 5)`` with its edge weights
  redrawn, unequal, in [0.1, 0.45) (W stays doubly stochastic with a
  positive diagonal), so a wrong index into ``w_self`` or ``w_recv`` shows;
  its schedule has three rounds, leaving 1, 1 and 3 ranks idle;
- the gossip tree has two float32 leaves and one bfloat16 leaf (two packed
  buffers a round); ``gossip_shard_dynamic`` runs steps 0..3 of the ring's
  round-robin cycle (R = 3, so step 3 is round 0 again);
- the train steps run ``reduced_for_smoke(smollm-135m)`` (float32) with
  ``sgd_momentum(0.05)`` for one step from the same state, each worker's
  start perturbed so the exchange matters; ``sync`` in gossip, allreduce,
  none, and the elastic step fault-free, with worker 1 dropped as a
  straggler, and with worker 4 dead. The JAX outputs are read whole
  (``np.asarray(leaf)``) before any indexing.

Tolerances: the gossip's float32 leaves within 1e-6 (the same float32
products and sums; XLA may contract a product and a sum into one fused
multiply-add), its bfloat16 leaf within one bfloat16 ulp (accumulators that
close round apart at most across one rounding boundary). The train steps'
parameters and momentum within 3e-5 (the reference's own sharded-vs-sim
bound, ``tests/test_sharded_runtime.py``), the loss within rtol 1e-5. The
port's elastic step without faults is bitwise its plain step, as the
reference asserts of its own; a dead worker's parameters and optimizer
state come back bitwise, in the port and in the reference.
"""
import os
import pickle
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.topologies import make_baseline as j_baseline  # noqa: E402
from repro.dsgd import gossip as jgossip  # noqa: E402
from repro.dsgd import schedule as jsched  # noqa: E402
import repro_torch.dsgd as tdsgd  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.core import make_baseline as t_baseline  # noqa: E402
from repro_torch.dsgd import gossip as tgossip  # noqa: E402
from repro_torch.dsgd import schedule as tsched  # noqa: E402
from repro_torch.dsgd import trainer as ttrainer  # noqa: E402
from repro_torch.optim import sgd_momentum  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
N = 5
SEED = 27
STEPS = ("gossip", "allreduce", "none")
ELASTIC = ("faultfree", "straggler", "dead")
STRAGGLER, DEAD = 1, 4
GOSSIP_ATOL = 1e-6
PARAM_ATOL = 3e-5
LOSS_RTOL = 1e-5
RANK_TIMEOUT_S = 240


def _ring_g() -> np.ndarray:
    """The ring's 5 edge weights redrawn from the seed, unequal."""
    return np.random.default_rng(SEED).uniform(0.1, 0.45, size=N)


def _masks() -> dict:
    """(alive, mix_mask) of each elastic case."""
    ones = np.ones(N, np.float32)
    drop, dead = ones.copy(), ones.copy()
    drop[STRAGGLER] = 0.0
    dead[DEAD] = 0.0
    return {"faultfree": (ones, ones), "straggler": (ones, drop), "dead": (dead, dead)}


def _inputs() -> dict:
    """Everything both sides read: the topology's weights, the gossip tree
    (stacked (n, ...); the bfloat16 leaf as its float32 values), the train
    state (stacked, numpy, from the port's initializer, each worker's
    parameters perturbed) and the batch."""
    rng = np.random.default_rng(SEED)
    tree = {"w": rng.standard_normal((N, 6, 32)).astype(np.float32),
            "b": rng.standard_normal((N, 7)).astype(np.float32),
            "h": torch.from_numpy(rng.standard_normal((N, 3, 4)).astype(np.float32))
            .bfloat16().float().numpy()}
    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    opt_init, _ = sgd_momentum(0.05)
    state = ttrainer.init_dsgd_state(0, cfg, N, opt_init, device="cpu")

    def np_tree(t):
        return {k: np_tree(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()

    params = np_tree(state.params)
    perturb = lambda t: {k: perturb(v) if isinstance(v, dict) else
                         v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
                         for k, v in t.items()}
    params = perturb(params)
    tokens = rng.integers(0, cfg.vocab_size, size=(N, 2, 17)).astype(np.int32)
    return dict(g=_ring_g(), tree=tree, masks=_masks(),
                state=dict(params=params, momentum=np_tree(state.opt.momentum),
                           opt_step=state.opt.step.numpy(), step=state.step.numpy()),
                batch=dict(tokens=tokens[:, :, :-1], labels=tokens[:, :, 1:].copy()))


JAX_SCRIPT = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=5"
import dataclasses, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch, reduced_for_smoke
from repro.core.topologies import make_baseline
from repro.dsgd import (gossip_shard, gossip_shard_elastic, make_elastic_sharded_train_step,
                        make_sharded_train_step, round_robin_schedules, schedule_from_topology,
                        schedule_weight_arrays)
from repro.dsgd.dynamic import gossip_shard_dynamic
from repro.dsgd.trainer import DSGDState
from repro.optim import sgd_momentum
from repro.optim.optimizers import SGDState

inp = pickle.load(open(sys.argv[1], "rb"))
n = 5
mesh = jax.make_mesh((n,), ("data",))
topo = dataclasses.replace(make_baseline("ring", n), g=np.asarray(inp["g"]))
sched = schedule_from_topology(topo)
scheds = round_robin_schedules(topo)
tree = {k: jnp.asarray(v) for k, v in inp["tree"].items()}
tree["h"] = tree["h"].astype(jnp.bfloat16)
out = {}
host = lambda t: jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)
                                                   if a.dtype == jnp.bfloat16 else a), t)


def smap(fn, n_rep):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("data"),) + (P(),) * n_rep,
                                 out_specs=P("data"), axis_names={"data"}, check_vma=False))


with jax.set_mesh(mesh):
    out["gossip"] = host(smap(lambda t: gossip_shard(t, sched, "data"), 0)(tree))
    ws, wr = (jnp.asarray(a) for a in schedule_weight_arrays(sched))
    el = smap(lambda t, m, a, b: gossip_shard_elastic(t, sched, "data", m, a, b), 3)
    for name, (alive, mix) in inp["masks"].items():
        out[f"gossip_elastic/{name}"] = host(el(tree, jnp.asarray(mix), ws, wr))
    dyn = smap(lambda t, s: gossip_shard_dynamic(t, scheds, s, "data"), 1)
    for s in range(len(scheds) + 1):
        out[f"dynamic/{s}"] = host(dyn(tree, jnp.int32(s)))

cfg = reduced_for_smoke(get_arch("smollm-135m"))
opt_init, opt_update = sgd_momentum(0.05)
st = inp["state"]
as_j = lambda t: jax.tree.map(jnp.asarray, t)
state = DSGDState(as_j(st["params"]), SGDState(as_j(st["momentum"]), jnp.asarray(st["opt_step"])),
                  jnp.asarray(st["step"]))
batch = as_j(inp["batch"])
with jax.set_mesh(mesh):
    for sync in ("gossip", "allreduce", "none"):
        fn = jax.jit(make_sharded_train_step(cfg, sched, opt_update, mesh, sync=sync))
        s1, m = fn(state, batch)
        out[f"step/{sync}"] = dict(params=host(s1.params), momentum=host(s1.opt.momentum),
                                   loss=np.asarray(m["loss"]))
    fn = jax.jit(make_elastic_sharded_train_step(cfg, sched, opt_update, mesh))
    for name, (alive, mix) in inp["masks"].items():
        s1, m = fn(state, batch, jnp.asarray(alive), jnp.asarray(mix), ws, wr)
        out[f"elastic/{name}"] = dict(params=host(s1.params), momentum=host(s1.opt.momentum),
                                      loss=np.asarray(m["loss"]))
pickle.dump(out, open(sys.argv[2], "wb"))
'''


WORKER = r'''
import datetime, pickle, sys, types
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, init, inp_path, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

from repro_torch import convert
from repro_torch.configs import get_arch, reduced_for_smoke
from repro_torch.core import make_baseline
from repro_torch.core.graph import Topology
from repro_torch.dsgd import (gossip_shard, gossip_shard_dynamic, gossip_shard_elastic,
                              make_elastic_sharded_train_step, make_sharded_train_step,
                              round_robin_schedules, schedule_from_topology,
                              schedule_weight_arrays)
from repro_torch.optim import sgd_momentum

inp = pickle.load(open(inp_path, "rb"))
ring = make_baseline("ring", world)
topo = Topology(world, ring.edges, np.asarray(inp["g"]), ring.name)
sched = schedule_from_topology(topo)
scheds = round_robin_schedules(topo)
tree = {k: torch.from_numpy(v[rank]) for k, v in inp["tree"].items()}
tree["h"] = tree["h"].bfloat16()
host = lambda t: tree_map(lambda a: a.float().numpy() if a.dtype == torch.bfloat16
                          else a.numpy(), t)
out = {}
mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
group = None

out["gossip"] = host(gossip_shard(tree, sched, group))
# leaf by leaf: one buffer a round, the same bits as the packed exchange
out["gossip_by_leaf"] = {k: host(gossip_shard({k: v}, sched, group))[k] for k, v in tree.items()}
ws, wr = schedule_weight_arrays(sched)
for name, (alive, mix) in inp["masks"].items():
    out[f"gossip_elastic/{name}"] = host(gossip_shard_elastic(
        tree, sched, group, torch.from_numpy(mix), torch.from_numpy(ws), torch.from_numpy(wr)))
for s in range(len(scheds) + 1):
    out[f"dynamic/{s}"] = host(gossip_shard_dynamic(tree, scheds, s, group))
    out[f"dynamic_tensor/{s}"] = host(gossip_shard_dynamic(tree, scheds, torch.tensor(s), group))

cfg = reduced_for_smoke(get_arch("smollm-135m"))
opt_init, opt_update = sgd_momentum(0.05)
st = inp["state"]
mine = lambda t: tree_map(lambda a: a[rank:rank + 1], t)
ref = types.SimpleNamespace(params=mine(st["params"]),
                            opt=types.SimpleNamespace(momentum=mine(st["momentum"]),
                                                      step=st["opt_step"][rank:rank + 1]),
                            step=st["step"])
state = convert.dsgd_state_from_numpy(ref, device="cpu")
batch = {k: torch.from_numpy(np.ascontiguousarray(v[rank:rank + 1])) for k, v in
         inp["batch"].items()}


def record(s1, m):
    return dict(params=host(s1.params), momentum=host(s1.opt.momentum),
                opt_step=s1.opt.step.numpy(), step=s1.step.numpy(), loss=m["loss"].numpy())


for sync in ("gossip", "allreduce", "none"):
    out[f"step/{sync}"] = record(*make_sharded_train_step(cfg, sched, opt_update, mesh,
                                                          sync=sync)(state, batch))
elastic = make_elastic_sharded_train_step(cfg, sched, opt_update, mesh)
for name, (alive, mix) in inp["masks"].items():
    out[f"elastic/{name}"] = record(*elastic(state, batch, torch.from_numpy(alive),
                                             torch.from_numpy(mix), torch.from_numpy(ws),
                                             torch.from_numpy(wr)))
out["start"] = dict(params=host(state.params), momentum=host(state.opt.momentum),
                    opt_step=state.opt.step.numpy())
# the same step over two-dim meshes whose second dim has size 1
for label, shape, axes in (("data,model/data", (world, 1), ("data",)),
                           ("data,model/both", (world, 1), ("data", "model"))):
    m2 = DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=("data", "model"))
    out[f"mesh/{label}"] = record(*make_sharded_train_step(cfg, sched, opt_update, m2,
                                                           gossip_axes=axes)(state, batch))
# a second dim larger than 1 is tensor parallelism inside a worker: a
# (1, world) mesh hosts one worker of world ranks, not the schedule's world
m3 = DeviceMesh("cpu", torch.arange(world).reshape(1, world), mesh_dim_names=("data", "model"))
try:
    make_sharded_train_step(cfg, sched, opt_update, m3, gossip_axes=("data",))
    out["tp_raise"] = None
except ValueError as e:
    out["tp_raise"] = str(e)
# a mesh over a part of the world: its gossip groups cannot be built on every rank
part = types.SimpleNamespace(mesh_dim_names=("data",), mesh=torch.arange(world - 1))
try:
    make_sharded_train_step(cfg, sched, opt_update, part)
    out["part_raise"] = None
except (NotImplementedError, ValueError) as e:
    out["part_raise"] = str(e)
pickle.dump(out, open(f"{out_dir}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
'''


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _run_all(tmp) -> tuple[list, dict]:
    """Start the JAX subprocess and the 5 ranks together; wait for all of
    them, taking every other process down if one fails."""
    inp_path = tmp / "inputs.pkl"
    inp_path.write_bytes(pickle.dumps(_inputs()))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    jproc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(inp_path),
                              str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(N), init,
                               str(inp_path), str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(N)]
    procs = ranks + [jproc]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        _kill(procs)
    logs = [p.stdout.read() for p in procs]
    for k, p in enumerate(procs):
        who = "the JAX subprocess" if p is jproc else f"rank {k}"
        assert p.returncode == 0, f"{who} failed (rc {p.returncode}):\n{logs[k][-4000:]}"
    outs = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(N)]
    return outs, pickle.loads((tmp / "jax.pkl").read_bytes())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' outputs, one dict a rank; the JAX outputs, stacked (n, ...))."""
    return _run_all(tmp_path_factory.mktemp("gossip_shard"))


def _stack(outs, key, field=None):
    """Rank outputs of ``key`` on the worker axis: a gossip tree (no worker
    axis) stacked, a state's ``field`` (a worker axis of size 1)
    concatenated."""
    trees = [o[key] if field is None else o[key][field] for o in outs]
    join = np.stack if field is None else np.concatenate
    return _join(trees, join)


def _join(trees, join):
    if isinstance(trees[0], dict):
        return {k: _join([t[k] for t in trees], join) for k in trees[0]}
    return join(trees)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _check_gossip(got: dict, want: dict):
    for k in ("w", "b"):
        assert np.abs(got[k] - want[k]).max() <= GOSSIP_ATOL, k
    err = np.abs(got["h"] - want["h"])
    assert (err <= _bf16_ulp(np.maximum(np.abs(got["h"]), np.abs(want["h"])))).all()


def _check_params(got: dict, want: dict, atol=PARAM_ATOL):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].shape == w[k].shape, k
        assert np.abs(g[k] - w[k]).max() <= atol, (k, np.abs(g[k] - w[k]).max())


# ---------------------------------------------------------------------------
# no process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n", [("ring", 5), ("exponential", 8), ("torus", 9)])
def test_schedule_weight_arrays_are_the_reference_bits(kind, n):
    js = jsched.schedule_from_topology(j_baseline(kind, n))
    ts = tsched.schedule_from_topology(t_baseline(kind, n))
    for got, want in zip(tgossip.schedule_weight_arrays(ts), jgossip.schedule_weight_arrays(js)):
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_a_tensor_parallel_mesh_dim_raises_naming_7c():
    """A mesh dim outside ``gossip_axes`` larger than 1 is tensor parallelism
    inside a worker (ported; ROADMAP.md item 7c is closed): its gossip
    groups are the columns of the other dims, the "model" dim the TP dim,
    read from the mesh's rank grid alone; building a step needs a process
    group and says so (a stand-in mesh). Dims that are not the mesh's, and
    an unknown ``sync``, still raise before any of that."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.arange(8).reshape(4, 2))
    cols, tp = ttrainer._gossip_rank_groups(mesh, ("data",))
    assert tp == ("model",) and cols == [[0, 2, 4, 6], [1, 3, 5, 7]]
    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    sched = tsched.schedule_from_topology(t_baseline("ring", 4))
    _, upd = sgd_momentum(0.05)
    for make in (tdsgd.make_sharded_train_step, tdsgd.make_elastic_sharded_train_step):
        with pytest.raises(RuntimeError, match="process group"):
            make(cfg, sched, upd, mesh)
    with pytest.raises(ValueError, match="not dims of the mesh"):
        tdsgd.make_sharded_train_step(cfg, sched, upd, mesh, gossip_axes=("pod",))
    with pytest.raises(ValueError, match="sync"):
        tdsgd.make_sharded_train_step(cfg, sched, upd, mesh, sync="ring")


@pytest.mark.parametrize("axes,ranks", [(("b", "a"), range(8)), (("a", "b"), range(2, 10))])
def test_a_gossip_sub_group_raises_naming_7c(axes, ranks):
    """Gossip dims flatten the mesh row-major in the order given (as
    ``ppermute`` flattens a tuple of axes): out of mesh order, the workers'
    ranks come in that order, a group of their own (ported, item 7c). Both
    builders need a process group for it and say so (a stand-in mesh)."""
    mesh = types.SimpleNamespace(mesh_dim_names=("a", "b"),
                                 mesh=torch.tensor(list(ranks)).reshape(2, 4))
    cols, tp = ttrainer._gossip_rank_groups(mesh, axes)
    grid = np.asarray(list(ranks)).reshape(2, 4)
    want = grid.T.reshape(-1) if axes == ("b", "a") else grid.reshape(-1)
    assert tp == () and cols == [want.tolist()]
    cfg = reduced_for_smoke(get_arch("smollm-135m"))
    sched = tsched.schedule_from_topology(t_baseline("ring", 8))
    _, upd = sgd_momentum(0.05)
    for make in (tdsgd.make_sharded_train_step, tdsgd.make_elastic_sharded_train_step):
        with pytest.raises(RuntimeError, match="process group"):
            make(cfg, sched, upd, mesh, gossip_axes=axes)


def test_gossip_shard_without_a_process_group_raises():
    sched = tsched.schedule_from_topology(t_baseline("ring", 4))
    with pytest.raises(RuntimeError, match="process group"):
        tgossip.gossip_shard({"x": torch.zeros(3)}, sched)


def test_the_ring_schedule_leaves_ranks_idle():
    """The test topology's schedule: three rounds, 1, 1 and 3 ranks idle,
    its weights the redrawn g (unequal)."""
    ring = t_baseline("ring", N)
    topo = type(ring)(N, ring.edges, _ring_g(), ring.name)
    sched = tsched.schedule_from_topology(topo)
    idle = [N - len({s for s, _ in perm}) for perm in sched.perms]
    assert sched.rounds == 3 and sorted(idle) == [1, 1, 3]
    ws, wr = tgossip.schedule_weight_arrays(sched)
    assert len(set(np.round(ws, 6))) == N and (ws > 0).all()
    np.testing.assert_allclose(tsched.reconstruct_weight_matrix(sched).sum(axis=1), 1.0)


# ---------------------------------------------------------------------------
# 5 gloo ranks against 5 JAX host devices
# ---------------------------------------------------------------------------

def test_gossip_shard_matches_the_reference(results):
    outs, want = results
    _check_gossip(_stack(outs, "gossip"), want["gossip"])


def test_packing_does_not_change_a_bit(results):
    """Leaf by leaf (one buffer a round) equals the packed exchange bitwise."""
    outs, _ = results
    for o in outs:
        for k, v in o["gossip"].items():
            assert v.tobytes() == o["gossip_by_leaf"][k].tobytes(), k


@pytest.mark.parametrize("case", ELASTIC)
def test_gossip_shard_elastic_matches_the_reference(results, case):
    outs, want = results
    got = _stack(outs, f"gossip_elastic/{case}")
    _check_gossip(got, want[f"gossip_elastic/{case}"])
    if case == "faultfree":       # all flags 1: the plain exchange's bits
        for k in got:
            assert got[k].tobytes() == _stack(outs, "gossip")[k].tobytes(), k


@pytest.mark.parametrize("step", range(4))
def test_gossip_shard_dynamic_matches_the_reference(results, step):
    """Round ``step % 3``; a tensor step is read once and gives the same bits."""
    outs, want = results
    got = _stack(outs, f"dynamic/{step}")
    _check_gossip(got, want[f"dynamic/{step}"])
    for k, v in _stack(outs, f"dynamic_tensor/{step}").items():
        assert v.tobytes() == got[k].tobytes()
    if step == 3:
        for k, v in _stack(outs, "dynamic/0").items():
            assert v.tobytes() == got[k].tobytes()


@pytest.mark.parametrize("sync", STEPS)
def test_sharded_train_step_matches_the_reference(results, sync):
    outs, want = results
    ref = want[f"step/{sync}"]
    _check_params(_stack(outs, f"step/{sync}", "params"), ref["params"])
    _check_params(_stack(outs, f"step/{sync}", "momentum"), ref["momentum"])
    losses = [float(o[f"step/{sync}"]["loss"]) for o in outs]
    assert len({np.float32(x).tobytes() for x in losses}) == 1, losses   # the same bits
    np.testing.assert_allclose(losses[0], float(ref["loss"]), rtol=LOSS_RTOL)
    assert all(int(o[f"step/{sync}"]["step"]) == 1 for o in outs)


def test_sync_none_and_allreduce_are_what_they_say(results):
    """``none`` leaves each worker's update local (workers differ);
    ``allreduce`` leaves every worker the same float32 mean."""
    outs, _ = results
    none = _leaves(_stack(outs, "step/none", "params"))
    mean = _leaves(_stack(outs, "step/allreduce", "params"))
    for k in none:
        assert np.abs(none[k] - none[k][:1]).max() > 0, k
        assert all(mean[k][i].tobytes() == mean[k][0].tobytes() for i in range(N)), k
        np.testing.assert_allclose(mean[k][0], none[k].mean(axis=0), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ELASTIC)
def test_elastic_sharded_step_matches_the_reference(results, case):
    outs, want = results
    ref = want[f"elastic/{case}"]
    _check_params(_stack(outs, f"elastic/{case}", "params"), ref["params"])
    _check_params(_stack(outs, f"elastic/{case}", "momentum"), ref["momentum"])
    np.testing.assert_allclose(float(outs[0][f"elastic/{case}"]["loss"]), float(ref["loss"]),
                               rtol=LOSS_RTOL)


def test_fault_free_elastic_step_is_the_plain_step_bitwise(results):
    outs, _ = results
    for r, o in enumerate(outs):
        a, b = o["elastic/faultfree"], o["step/gossip"]
        for f in ("params", "momentum"):
            la, lb = _leaves(a[f]), _leaves(b[f])
            for k in la:
                assert la[k].tobytes() == lb[k].tobytes(), (r, f, k)
        assert a["loss"].tobytes() == b["loss"].tobytes() and a["opt_step"] == b["opt_step"]


def test_a_dead_worker_is_frozen_bitwise(results):
    """Worker 4 dead: its parameters and optimizer state come back bitwise
    in the port and in the reference (its outputs read whole, then indexed)."""
    outs, want = results
    o = outs[DEAD]
    for f in ("params", "momentum"):
        got, start = _leaves(o["elastic/dead"][f]), _leaves(o["start"][f])
        ref = _leaves(want["elastic/dead"][f])
        for k in got:
            assert got[k].tobytes() == start[k].tobytes(), (f, k)
            assert ref[k][DEAD].tobytes() == start[k][0].tobytes(), (f, k)
    assert o["elastic/dead"]["opt_step"].tobytes() == o["start"]["opt_step"].tobytes()
    assert np.isfinite(float(o["elastic/dead"]["loss"]))


@pytest.mark.parametrize("label", ["data,model/data", "data,model/both"])
def test_a_two_dim_mesh_with_a_size_one_dim_is_the_one_dim_step(results, label):
    outs, _ = results
    for o in outs:
        for f in ("params", "momentum"):
            la, lb = _leaves(o[f"mesh/{label}"][f]), _leaves(o["step/gossip"][f])
            for k in la:
                assert la[k].tobytes() == lb[k].tobytes(), (label, f, k)


def test_a_tensor_parallel_mesh_raises_in_a_group(results):
    """A (1, 5) mesh is one worker over five "model" ranks (tensor
    parallelism, ported): its gossip dim hosts one worker, not the
    schedule's five, and the builder says so on every rank."""
    outs, _ = results
    for o in outs:
        assert o["tp_raise"] is not None and "the schedule has 5 workers" in o["tp_raise"] \
            and "host 1" in o["tp_raise"]


def test_a_mesh_over_part_of_the_world_raises_in_a_group(results):
    """A mesh over 4 of the 5 ranks: the gossip groups are built on every
    rank of the default group, so a mesh spans it, and every rank says so."""
    outs, _ = results
    for o in outs:
        assert o["part_raise"] is not None and "spans the whole default group" in o["part_raise"]
