"""Tensor parallelism inside a worker (``repro_torch.dsgd.trainer``:
``_accum_value_and_grad``, ``make_tp_train_step``,
``make_matmul_gossip_train_step``, the rank-per-worker steps over a
``model`` mesh dim; ``repro_torch.launch.steps.build_step``) against the JAX
package, on the CPU.

Two JAX subprocesses (``XLA_FLAGS=--xla_force_host_platform_device_count=4``;
each computes half of the references) and one group of 4 gloo ranks (one
torch thread each, a ``file://`` rendezvous in ``tmp_path``) run at once
for the module, on the same seed-made inputs: ``reduced_for_smoke(qwen1.5-0.5b)`` in float32 (4 heads,
so a "model" dim of 2 splits them), two workers whose parameters are the
port's seed-0 weights, each perturbed, ``sgd_momentum(0.05)``, 4 × 16
random tokens a worker, the topology the pair with edge weight 0.3. The
ranks build DTensor meshes over themselves (``data=2 × model=2`` and
``pod=2 × data=1 × model=2``); the subprocess the same meshes of host
devices. The JAX outputs are read whole (``np.asarray``) before any
indexing.

- (b) ``_accum_value_and_grad`` at 1, 2 and 4 microbatches, in this
  process, against the reference's: loss within rtol 1e-5, gradients
  within the reference test's 2e-4;
- (c) ``make_tp_train_step`` (accumulating 2 microbatches) unsharded in
  this process, and as one pod-sized worker over ``data=2 × model=2``, 2
  steps, against the reference's jitted step on the same weights;
- (d) ``make_sharded_train_step`` (``sync`` gossip, allreduce, none) and
  ``make_elastic_sharded_train_step`` (no fault, a dropped straggler, a
  dead worker) on ``data=2 × model=2`` against the reference's
  ``shard_map`` steps on a (2, 2) host mesh; the dead worker frozen
  bitwise in both;
- (e) ``make_matmul_gossip_train_step`` on ``pod=2 × data=1 × model=2``
  against the reference's;
- (f) ``build_step``'s ``meta`` and its args' shapes, dtypes and specs
  against the reference's on equal meshes, with the reference's budget of
  a chip (``hbm_bytes=16e9``); its ``fn`` run on the reduced config
  (``_build_train``) against the reference's; prefill and decode raise
  naming item 7c′.

Tolerances: parameters and momentum within 3e-5 (the reference's own
sharded-vs-sim bound, ``tests/test_sharded_runtime.py``; the sharded sums
add the shards' partial products in another order), losses within rtol
1e-5.
"""
import os
import pickle
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.dsgd import init_dsgd_state, make_tp_train_step, trainer  # noqa: E402
from repro_torch.optim import sgd_momentum  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
N = 2
SEED = 28
B, S = 4, 16
STEPS = ("gossip", "allreduce", "none")
ELASTIC = ("faultfree", "straggler", "dead")
STRAGGLER, DEAD = 0, 1
ACCUM = (1, 2, 4)
BUILDS = (("qwen1.5-0.5b", "22"), ("mixtral-8x22b", "22"), ("qwen1.5-0.5b", "212"),
          ("mixtral-8x22b", "212"))
PARAM_ATOL = 3e-5
LOSS_RTOL = 1e-5
GRAD_ATOL = 2e-4
RANK_TIMEOUT_S = 240
MOE_ARCHS = ("granite-moe-1b-a400m", "mixtral-8x22b")


def _cfg():
    return replace(reduced_for_smoke(get_arch("qwen1.5-0.5b")), dtype="float32")


def _np_tree(t):
    return {k: _np_tree(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()


def _masks() -> dict:
    """(alive, mix_mask) of each elastic case."""
    ones = np.ones(N, np.float32)
    drop, dead = ones.copy(), ones.copy()
    drop[STRAGGLER] = 0.0
    dead[DEAD] = 0.0
    return {"faultfree": (ones, ones), "straggler": (ones, drop), "dead": (dead, dead)}


def _inputs() -> dict:
    """The stacked start (the port's seed-0 weights, each worker's
    perturbed), two batches of (N, B, S) tokens, the elastic masks."""
    rng = np.random.default_rng(SEED)
    cfg = _cfg()
    opt_init, _ = sgd_momentum(0.05)
    state = init_dsgd_state(0, cfg, N, opt_init, device="cpu")

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else
                v + 0.01 * rng.standard_normal(v.shape).astype(np.float32) for k, v in t.items()}

    batches = []
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab_size, size=(N, B, S + 1)).astype(np.int32)
        batches.append(dict(tokens=np.ascontiguousarray(tok[..., :-1]),
                            labels=np.ascontiguousarray(tok[..., 1:])))
    return dict(state=dict(params=perturb(_np_tree(state.params)),
                           momentum=_np_tree(state.opt.momentum),
                           opt_step=state.opt.step.numpy(), step=state.step.numpy()),
                batches=batches, masks=_masks(), seed=SEED, moe_archs=MOE_ARCHS)


JAX_SCRIPT = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle, sys
from dataclasses import replace
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import InputShape, get_arch, reduced_for_smoke
from repro.core.graph import Topology
from repro.dsgd import (make_elastic_sharded_train_step, make_matmul_gossip_train_step,
                        make_sharded_train_step, make_tp_train_step, schedule_from_topology,
                        schedule_weight_arrays)
from repro.dsgd.trainer import DSGDState, _accum_value_and_grad
from repro.launch import steps
from repro.models import transformer
from repro.optim import sgd_momentum
from repro.optim.optimizers import SGDState

inp = pickle.load(open(sys.argv[1], "rb"))
cfg = replace(reduced_for_smoke(get_arch("qwen1.5-0.5b")), dtype="float32")
opt_init, opt_update = sgd_momentum(0.05)
as_j = lambda t: jax.tree.map(jnp.asarray, t)
host = lambda t: jax.tree.map(np.asarray, t)
st = inp["state"]
state = DSGDState(as_j(st["params"]), SGDState(as_j(st["momentum"]), jnp.asarray(st["opt_step"])),
                  jnp.asarray(st["step"]))
b0, b1 = (as_j(b) for b in inp["batches"])
first = lambda t: jax.tree.map(lambda x: x[0], t)
topo = Topology(2, [(0, 1)], np.array([0.3]), name="pair")
sched = schedule_from_topology(topo)
out = {}


def record(s, metrics):
    return dict(params=host(s.params), momentum=host(s.opt.momentum),
                loss=[float(m["loss"]) for m in metrics])


part = sys.argv[3]         # "a": (b), (c), (e); "b": (d), (f)
if part == "a":
    # (b) gradient accumulation
    loss_fn = lambda p, b: transformer.train_loss(p, cfg, b)
    for k in (1, 2, 4):
        loss, grads = jax.jit(lambda p, b: _accum_value_and_grad(loss_fn, p, b, k))(
            first(state.params), first(b0))
        out[f"accum/{k}"] = dict(loss=float(loss), grads=host(grads))
    # (c) the TP step, 2 steps, accumulating
    one = DSGDState(first(state.params), SGDState(first(state.opt.momentum), state.opt.step[0]),
                    state.step)
    tp = jax.jit(make_tp_train_step(cfg, opt_update, accum_steps=2))
    s1, m1 = tp(one, first(b0))
    s2, m2 = tp(s1, first(b1))
    out["tp"] = record(s2, [m1, m2])
    # (e) the W-matmul step
    s, m = jax.jit(make_matmul_gossip_train_step(cfg, topo, opt_update))(state, b0)
    out["matmul"] = record(s, [m])
    pickle.dump(out, open(sys.argv[2], "wb"))
    sys.exit(0)

# (d) the shard_map steps on a (2, 2) host mesh
mesh = jax.make_mesh((2, 2), ("data", "model"))
ws, wr = (jnp.asarray(a) for a in schedule_weight_arrays(sched))
with jax.set_mesh(mesh):
    for sync in ("gossip", "allreduce", "none"):
        s, m = jax.jit(make_sharded_train_step(cfg, sched, opt_update, mesh, sync=sync))(state, b0)
        out[f"step/{sync}"] = record(s, [m])
    el = jax.jit(make_elastic_sharded_train_step(cfg, sched, opt_update, mesh))
    for name, (alive, mix) in inp["masks"].items():
        s, m = el(state, b0, jnp.asarray(alive), jnp.asarray(mix), ws, wr)
        out[f"elastic/{name}"] = record(s, [m])

# (f) build_step's meta and args, and its fn at the reduced size
meshes = {"22": mesh, "212": jax.make_mesh((2, 1, 2), ("pod", "data", "model"))}


def args_of(built):
    pairs = jax.tree_util.tree_flatten_with_path(built.args)[0]
    return {jax.tree_util.keystr(k): (tuple(a.shape), str(a.dtype), tuple(a.sharding.spec))
            for k, a in pairs}


for arch, label in (("qwen1.5-0.5b", "22"), ("mixtral-8x22b", "22"), ("qwen1.5-0.5b", "212"),
                    ("mixtral-8x22b", "212")):
    built = steps.build_step(arch, "train_4k", meshes[label])
    out[f"build/{arch}/{label}"] = dict(meta=built.meta, args=args_of(built))
tiny = InputShape("tiny", 16, 4, "train")
bfn = jax.tree.map(lambda x: x[:, :2], b0)
for label, m in meshes.items():
    built = steps._build_train(cfg, tiny, m, sync="gossip", topo_kind="ba", topo_r=None)
    with jax.set_mesh(m):
        s, metrics = jax.jit(built.fn)(state, bfn)
    out[f"fn/{label}"] = dict(record(s, [metrics]), meta=built.meta)
pickle.dump(out, open(sys.argv[2], "wb"))
'''


WORKER = r'''
import datetime, pickle, sys, types
from dataclasses import asdict, replace
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, init, inp_path, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import keystr, tree_flatten_with_path, tree_map

from repro_torch import convert
from repro_torch.configs import InputShape, get_arch, reduced_for_smoke
from repro_torch.core.graph import Topology
from repro_torch.dsgd import (make_elastic_sharded_train_step, make_matmul_gossip_train_step,
                              make_sharded_train_step, make_tp_train_step, schedule_from_topology,
                              schedule_weight_arrays)
from repro_torch.dsgd.tensor_parallel import full_value, place_tree
from repro_torch.dsgd.trainer import DSGDState
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import DistPlan, batch_specs, spec_of, tree_param_specs
from repro_torch.optim import sgd_momentum

inp = pickle.load(open(inp_path, "rb"))
SEED, MOE_ARCHS = inp["seed"], inp["moe_archs"]
cfg = replace(reduced_for_smoke(get_arch("qwen1.5-0.5b")), dtype="float32")
opt_init, opt_update = sgd_momentum(0.05)
st = inp["state"]
ref = types.SimpleNamespace(params=st["params"], step=st["step"],
                            opt=types.SimpleNamespace(momentum=st["momentum"], step=st["opt_step"]))
state = convert.dsgd_state_from_numpy(ref, device="cpu")
b0, b1 = ({k: torch.from_numpy(v) for k, v in b.items()} for b in inp["batches"])
topo = Topology(2, [(0, 1)], np.array([0.3]), "pair")
sched = schedule_from_topology(topo)
mesh = make_host_mesh(2, 2, device="cpu")
mesh3 = DeviceMesh("cpu", torch.arange(4).reshape(2, 1, 2), mesh_dim_names=("pod", "data", "model"))
full = lambda t: tree_map(lambda x: full_value(x).numpy(), t)
out = {}


def record(s, metrics):
    return dict(params=full(s.params), momentum=full(s.opt.momentum),
                loss=[float(m["loss"]) for m in metrics])


# (c) one pod-sized worker over data x model, 2 steps, accumulating
plan = DistPlan((), ("data", "model"), ("data",), 1)
first = lambda t: tree_map(lambda x: x[0], t)
one = DSGDState(first(state.params), first(state.opt), state.step)
placed = DSGDState(place_tree(one.params, mesh, tree_param_specs(one.params, plan, mesh)),
                   place_tree(one.opt, mesh, tree_param_specs(one.opt, plan, mesh)), one.step)
bsp = batch_specs(cfg, plan, mesh, {k: tuple(v.shape[1:]) for k, v in b0.items()})
tp = make_tp_train_step(cfg, opt_update, accum_steps=2)
s1, m1 = tp(placed, place_tree(first(b0), mesh, bsp))
s2, m2 = tp(s1, place_tree(first(b1), mesh, bsp))
out["tp"] = record(s2, [m1, m2])
out["tp_placements"] = {keystr(k): [p.dim if p.is_shard() else None for p in x.placements]
                        for k, x in tree_flatten_with_path(s2.params)[0]}

# (d) one worker on each data row, TP over model
w = rank // 2
mine = DSGDState(tree_map(lambda x: x[w:w + 1], state.params),
                 tree_map(lambda x: x[w:w + 1], state.opt), state.step)
bw = {k: v[w:w + 1] for k, v in b0.items()}
for sync in ("gossip", "allreduce", "none"):
    s, m = make_sharded_train_step(cfg, sched, opt_update, mesh, sync=sync)(mine, bw)
    out[f"step/{sync}"] = record(s, [m])
elastic = make_elastic_sharded_train_step(cfg, sched, opt_update, mesh)
ws, wr = (torch.from_numpy(a) for a in schedule_weight_arrays(sched))
for name, (alive, mix) in inp["masks"].items():
    s, m = elastic(mine, bw, torch.from_numpy(alive), torch.from_numpy(mix), ws, wr)
    out[f"elastic/{name}"] = record(s, [m])
out["start"] = dict(params=full(mine.params), momentum=full(mine.opt.momentum))

# (e) the W-matmul step on pod x data x model
plan3 = DistPlan(("pod",), ("data", "model"), ("data",), 2)
placed = DSGDState(place_tree(state.params, mesh3, tree_param_specs(state.params, plan3, mesh3,
                                                                    stacked=True)),
                   place_tree(state.opt, mesh3, tree_param_specs(state.opt, plan3, mesh3,
                                                                 stacked=True)), state.step)
b3 = place_tree(b0, mesh3, batch_specs(cfg, plan3, mesh3, {k: tuple(v.shape) for k, v in b0.items()},
                                       stacked=True))
s, m = make_matmul_gossip_train_step(cfg, topo, opt_update)(placed, b3)
out["matmul"] = record(s, [m])
out["matmul_steps"] = (full_value(s.opt.step).numpy(), int(s.step))

# the MoE family's TP step on the pod-worker layout, one batch row a "data"
# rank, against the same step on plain tensors
from repro_torch.dsgd import init_dsgd_state
from repro_torch.models import transformer

for arch in MOE_ARCHS:
    mcfg = replace(reduced_for_smoke(get_arch(arch)), dtype="float32")
    s0 = init_dsgd_state(0, mcfg, 1, opt_init, device="cpu")
    m1 = DSGDState(first(s0.params), first(s0.opt), s0.step)
    g = torch.Generator().manual_seed(SEED)
    tok = torch.randint(0, mcfg.vocab_size, (2, 17), generator=g, dtype=torch.int32)
    mb = {"tokens": tok[:, :-1].contiguous(), "labels": tok[:, 1:].contiguous()}
    plain, mp = make_tp_train_step(mcfg, opt_update)(m1, mb)
    mplaced = DSGDState(place_tree(m1.params, mesh, tree_param_specs(m1.params, plan, mesh)),
                        place_tree(m1.opt, mesh, tree_param_specs(m1.opt, plan, mesh)), m1.step)
    mbp = place_tree(mb, mesh, batch_specs(mcfg, plan, mesh, {k: tuple(v.shape) for k, v in mb.items()}))
    sm, mm = make_tp_train_step(mcfg, opt_update)(mplaced, mbp)
    out[f"moe/{arch}"] = dict(got=record(sm, [mm]), plain=record(plain, [mp]))

# the vocab-parallel lookup by the pod-worker spec (the vocab over "data",
# gathered where the tokens are sharded there), against F.embedding, with
# the table's gradient
emb = first(state.params)["embed"]
espec = tree_param_specs({"embed": emb}, plan, mesh)["embed"]
tokens = first(b0)["tokens"]
cot = torch.randn(tokens.shape + (emb.shape[1],), generator=torch.Generator().manual_seed(SEED))
looked = {}
for tspec in ((None, None), ("data", None)):
    table = place_tree(emb, mesh, espec).detach().requires_grad_()
    got = transformer._sharded_lookup(table, place_tree(tokens, mesh, tspec))
    (grad,) = torch.autograd.grad((got * place_tree(cot, mesh, tspec + (None,))).sum(), table)
    looked[tspec] = (full_value(got).detach().numpy(), full_value(grad).numpy(),
                     [p.dim if p.is_shard() else ("partial" if p.is_partial() else None)
                      for p in got.placements])
plain_t = emb.detach().requires_grad_()
want_rows = torch.nn.functional.embedding(tokens.long(), plain_t)
(want_grad,) = torch.autograd.grad((want_rows * cot).sum(), plain_t)
out["lookup"] = dict(got=looked, rows=want_rows.detach().numpy(), grad=want_grad.numpy(),
                     table_spec=espec)

# (f) build_step: meta and args on equal meshes, its fn at the reduced size
meshes = {"22": mesh, "212": mesh3}


def dt(d):
    return str(d).replace("torch.", "")


def args_of(built):
    return {keystr(k): (tuple(a.shape), dt(a.dtype), spec_of(a))
            for k, a in tree_flatten_with_path(built.args)[0]}


for arch, label in (("qwen1.5-0.5b", "22"), ("mixtral-8x22b", "22"), ("qwen1.5-0.5b", "212"),
                    ("mixtral-8x22b", "212")):
    built = steps.build_step(arch, "train_4k", meshes[label], hbm_bytes=16e9)
    out[f"build/{arch}/{label}"] = dict(meta=built.meta, args=args_of(built),
                                        plan=asdict(built.plan))
raises = {}
for shape in ("prefill_32k", "decode_32k"):
    try:
        steps.build_step("qwen1.5-0.5b", shape, mesh, hbm_bytes=16e9)
        raises[shape] = None
    except NotImplementedError as e:
        raises[shape] = str(e)
out["raises"] = raises
tiny = InputShape("tiny", 16, 4, "train")
bfn = {k: v[:, :2] for k, v in b0.items()}
for label, m in meshes.items():
    built = steps._build_train(cfg, tiny, m, sync="gossip", topo_kind="ba", topo_r=None,
                               hbm_bytes=16e9)
    s, metrics = built.fn(state, bfn)
    s2, metrics2 = built.fn(s, bfn)
    out[f"fn/{label}"] = dict(record(s, [metrics]), meta=built.meta,
                              step2_loss=float(metrics2["loss"]),
                              placements={keystr(k): [p.dim if p.is_shard() else None
                                                      for p in x.placements]
                                          for k, x in tree_flatten_with_path(s.params)[0]})
pickle.dump(out, open(f"{out_dir}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
'''


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _run_all(tmp) -> tuple[list, dict]:
    """Start the JAX subprocess and the 4 ranks together; wait for all of
    them, taking every other process down if one fails."""
    inp_path = tmp / "inputs.pkl"
    inp_path.write_bytes(pickle.dumps(_inputs()))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    jprocs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(inp_path),
                                str(tmp / f"jax_{part}.pkl"), part], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for part in "ab"]
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "4", init,
                               str(inp_path), str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    procs = ranks + jprocs
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        _kill(procs)
    logs = []
    for p in procs:
        logs.append(p.stdout.read())
        p.stdout.close()
    for k, p in enumerate(procs):
        who = f"rank {k}" if k < len(ranks) else "a JAX subprocess"
        assert p.returncode == 0, f"{who} failed (rc {p.returncode}):\n{logs[k][-4000:]}"
    outs = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(4)]
    want = {}
    for part in "ab":
        want.update(pickle.loads((tmp / f"jax_{part}.pkl").read_bytes()))
    return outs, want


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' outputs, one dict a rank; the JAX outputs)."""
    return _run_all(tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check(got: dict, want: dict, atol=PARAM_ATOL):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].shape == w[k].shape, k
        assert np.abs(g[k] - w[k]).max() <= atol, (k, np.abs(g[k] - w[k]).max())


def _check_record(got: dict, want: dict):
    _check(got["params"], want["params"])
    _check(got["momentum"], want["momentum"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


def _workers(outs, key):
    """A rank-per-worker result over the workers: the rank of model
    coordinate 0 of each data row (ranks 0 and 2) holds its worker (a
    worker axis of 1)."""
    join = lambda a, b: {k: join(a[k], b[k]) if isinstance(a[k], dict) else
                         np.concatenate([a[k], b[k]]) for k in a}
    a, b = outs[0][key], outs[2][key]
    return dict(params=join(a["params"], b["params"]), momentum=join(a["momentum"], b["momentum"]),
                loss=a["loss"])


def _state(inputs, device="cpu"):
    st = inputs["state"]
    import types

    ref = types.SimpleNamespace(params=st["params"], step=st["step"],
                                opt=types.SimpleNamespace(momentum=st["momentum"],
                                                          step=st["opt_step"]))
    return convert.dsgd_state_from_numpy(ref, device=device)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", ACCUM)
def test_accum_value_and_grad_matches_the_reference(results, inputs, k):
    """``_accum_value_and_grad`` over k microbatches of worker 0's batch."""
    _, want = results
    cfg = _cfg()
    state = _state(inputs)
    from torch.utils._pytree import tree_map

    params = tree_map(lambda x: x[0], state.params)
    batch = {kk: torch.from_numpy(v[0]) for kk, v in inputs["batches"][0].items()}
    loss_fn = trainer._loss_fn(cfg)
    loss, grads = trainer._accum_value_and_grad(loss_fn, params, batch, k)
    ref = want[f"accum/{k}"]
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL)
    _check({kk: v.detach().numpy() for kk, v in _leaves_t(grads).items()},
           _leaves(ref["grads"]), atol=GRAD_ATOL)


def _leaves_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves_t(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_tp_step_unsharded_matches_the_reference(results, inputs):
    """``make_tp_train_step`` on one device (plain tensors), 2 steps."""
    _, want = results
    from torch.utils._pytree import tree_map

    cfg = _cfg()
    _, upd = sgd_momentum(0.05)
    state = _state(inputs)
    one = trainer.DSGDState(tree_map(lambda x: x[0], state.params),
                            tree_map(lambda x: x[0], state.opt), state.step)
    b0, b1 = ({k: torch.from_numpy(v[0]) for k, v in b.items()} for b in inputs["batches"])
    step = make_tp_train_step(cfg, upd, accum_steps=2)
    s1, m1 = step(one, b0)
    s2, m2 = step(s1, b1)
    got = dict(params=_np_tree(s2.params), momentum=_np_tree(s2.opt.momentum),
               loss=[float(m1["loss"]), float(m2["loss"])])
    _check_record(got, want["tp"])
    assert int(s2.step) == 2 and int(s2.opt.step) == 2


# ---------------------------------------------------------------------------
# 4 gloo ranks against 4 JAX host devices
# ---------------------------------------------------------------------------

def test_tp_step_on_a_two_by_two_mesh_matches_the_reference(results):
    """One pod-sized worker, its leaves 2-D sharded over data × model (the
    reference's specs), its batch over data: 2 steps, on every rank."""
    outs, want = results
    for o in outs:
        _check_record(o["tp"], want["tp"])
    # the embedding: vocab over data, d_model over model (the size rule)
    assert outs[0]["tp_placements"]["['embed']"] == [0, 1]


@pytest.mark.parametrize("sync", STEPS)
def test_sharded_step_with_a_model_dim_matches_the_reference(results, sync):
    """``make_sharded_train_step`` on data=2 × model=2: each worker's leaves
    DTensors over its two "model" ranks, the gossip on local shards; the
    loss the same bits on every rank."""
    outs, want = results
    _check_record(_workers(outs, f"step/{sync}"), want[f"step/{sync}"])
    losses = [o[f"step/{sync}"]["loss"][0] for o in outs]
    assert len({np.float32(x).tobytes() for x in losses}) == 1, losses
    for r in (1, 3):      # a worker's two model ranks hold the same values
        a, b = _leaves(outs[r - 1][f"step/{sync}"]["params"]), _leaves(
            outs[r][f"step/{sync}"]["params"])
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("case", ELASTIC)
def test_elastic_sharded_step_with_a_model_dim_matches_the_reference(results, case):
    outs, want = results
    _check_record(_workers(outs, f"elastic/{case}"), want[f"elastic/{case}"])


def test_a_dead_worker_is_frozen_bitwise_with_a_model_dim(results):
    """Worker 1 dead: its params and momentum come back bitwise on both of
    its ranks, in the port and in the reference (read whole, then
    indexed)."""
    outs, want = results
    for r in (2, 3):
        o = outs[r]
        for f in ("params", "momentum"):
            got, start = _leaves(o["elastic/dead"][f]), _leaves(o["start"][f])
            ref = _leaves(want["elastic/dead"][f])
            for k in got:
                assert got[k].tobytes() == start[k].tobytes(), (r, f, k)
                assert ref[k][DEAD].tobytes() == start[k][0].tobytes(), (f, k)


def test_fault_free_elastic_step_is_the_plain_step_with_a_model_dim(results):
    outs, _ = results
    for o in outs:
        a, b = o["elastic/faultfree"], o["step/gossip"]
        for f in ("params", "momentum"):
            la, lb = _leaves(a[f]), _leaves(b[f])
            assert all(la[k].tobytes() == lb[k].tobytes() for k in la), f
        assert a["loss"] == b["loss"]


def test_matmul_gossip_step_matches_the_reference(results):
    """The W-matmul step on pod=2 × data=1 × model=2, the workers over
    "pod", on every rank."""
    outs, want = results
    for o in outs:
        _check_record(o["matmul"], want["matmul"])
        opt_steps, step = o["matmul_steps"]
        assert opt_steps.tolist() == [1] * N and step == 1    # every worker's counter


@pytest.mark.parametrize("arch,label", BUILDS)
def test_build_step_meta_and_args_are_the_references(results, arch, label):
    """``meta`` (the pod-worker auto-microbatching, topology, rounds, the
    rules) and every abstract arg's shape, dtype and spec."""
    outs, want = results
    got, ref = outs[0][f"build/{arch}/{label}"], want[f"build/{arch}/{label}"]
    assert got["meta"] == ref["meta"]
    assert got["args"] == ref["args"]
    for o in outs[1:]:
        assert o[f"build/{arch}/{label}"]["meta"] == got["meta"]


def test_build_step_picks_the_references_steps(results):
    """The standard plan takes the rank-per-worker schedule step, a
    pod-sized worker on one pod the TP step, pod-sized workers over "pod"
    the W-matmul step."""
    outs, _ = results
    o = outs[0]
    assert o["build/qwen1.5-0.5b/22"]["meta"]["gossip_impl"] == "ppermute-schedule"
    assert o["build/qwen1.5-0.5b/212"]["plan"]["gossip_axes"] == ("pod", "data")
    assert "gossip_impl" not in o["build/mixtral-8x22b/22"]["meta"]
    assert o["build/mixtral-8x22b/22"]["meta"]["accum_steps"] == 8
    assert o["build/mixtral-8x22b/212"]["meta"]["gossip_impl"] == "W-matmul"


def test_build_step_moe_groups_deviation_is_recorded(results):
    """A deviation, pinned: a pod-worker plan's rules ask for one MoE
    dispatch group a "data" rank (``moe_groups`` = the data size), as the
    reference's do; the port's MoE keeps one group (ROADMAP.md item 7d),
    so the rules are recorded in ``meta`` and not applied."""
    outs, want = results
    rules = outs[0]["build/mixtral-8x22b/22"]["meta"]["rules"]
    assert rules == want["build/mixtral-8x22b/22"]["meta"]["rules"]
    assert rules["moe_groups"] == 2 and rules["moe_group"] == "data"


@pytest.mark.parametrize("label", ["22", "212"])
def test_build_step_fn_matches_the_references(results, label):
    """The standard plan's ``fn`` at the reduced size on data=2 × model=2
    and on pod=2 × data=1 × model=2 (gossip over two mesh dims: a group of
    its own): plain (n, ...) inputs placed at entry, the state back as
    DTensors on the mesh (worker axis over the gossip dims), a second call
    taking them as they are."""
    outs, want = results
    ref = want[f"fn/{label}"]
    for o in outs:
        got = o[f"fn/{label}"]
        assert got["meta"] == ref["meta"]
        _check_record(got, ref)
        assert np.isfinite(got["step2_loss"])
    # the worker axis over the gossip dims, the heads over "model"
    assert outs[0][f"fn/{label}"]["placements"]["['layers']['attn']['wq']"] == \
        ([0, 3] if label == "22" else [0, 0, 3])


def test_serving_shapes_raise_naming_7c_prime(results):
    outs, _ = results
    for o in outs:
        for shape, msg in o["raises"].items():
            assert msg is not None and "item 7c′" in msg, (shape, msg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_tp_step_on_the_pod_worker_layout_matches_the_plain_step(results, arch):
    """The MoE family's TP step over data=2 × model=2, its batch sharded
    over "data" (one row a rank: the layout whose backward failed while
    DTensor's views sharded the token dim over the expert dims), against
    the same step on plain tensors on one device (held to the reference by
    ``tests/test_torch_moe.py``): params and momentum within 3e-5, the loss
    within rtol 1e-5, on every rank."""
    outs, _ = results
    for o in outs:
        _check_record(o[f"moe/{arch}"]["got"], o[f"moe/{arch}"]["plain"])


@pytest.mark.parametrize("tokens", ["replicated", "sharded over data"])
def test_vocab_parallel_lookup_is_the_embedding(results, tokens):
    """``transformer._sharded_lookup`` of the table by the pod-worker spec
    (the vocab over "data", d over "model") gives ``F.embedding``'s rows
    bitwise: of replicated tokens from the rank's vocab rows, all-reduced
    over "data"; of tokens sharded over "data" from the table gathered
    there, the rows sharded with the tokens. The table's gradient within
    1e-6 (the ranks' partial sums add in another order)."""
    outs, _ = results
    spec = (None, None) if tokens == "replicated" else ("data", None)
    for o in outs:
        lk = o["lookup"]
        assert lk["table_spec"] == ("data", "model")
        rows, grad, placements = lk["got"][spec]
        assert np.array_equal(rows, lk["rows"])
        np.testing.assert_allclose(grad, lk["grad"], rtol=0, atol=1e-6)
        assert placements == ([None, None] if tokens == "replicated" else [0, None])


def test_the_all_gather_reroute_is_scoped_to_tp_region():
    """The CUDA kernel that reroutes the functional all-gather is registered
    only while a reroute block is open (nested blocks share it; an error
    inside closes it), and torch's own registration is back after."""
    from repro_torch.dsgd import tensor_parallel as tpar

    def cuda_kernels():
        dump = torch._C._dispatch_dump("_c10d_functional::all_gather_into_tensor")
        return [ln for ln in dump.splitlines() if ln.startswith("CUDA")]

    before = cuda_kernels()
    assert not any("tensor_parallel.py" in ln for ln in before)
    with pytest.raises(RuntimeError, match="inside"):
        with tpar._gloo_cuda_all_gather():
            with tpar._gloo_cuda_all_gather():
                assert any("tensor_parallel.py" in ln for ln in cuda_kernels())
            assert any("tensor_parallel.py" in ln for ln in cuda_kernels())
            raise RuntimeError("inside")
    assert cuda_kernels() == before and tpar._REROUTE == {"lib": None, "depth": 0}
