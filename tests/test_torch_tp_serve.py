"""Serving over DTensor (``repro_torch.launch.steps.build_step`` for the
prefill and decode shapes of the dense family, the DTensor branches of
``models/{attention,transformer}.py``, ``serve.engine.greedy_sample`` over
vocab-sharded logits) against the JAX package, on the CPU.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
and one group of 4 gloo ranks (one torch thread each, a ``file://``
rendezvous in ``tmp_path``) run at once for the module, on the same
seed-made inputs: the reduced dense configs in float32 with the port's
seed-0 weights, random prompts.

- Records: ``build_step``'s ``plan``, ``meta`` and every abstract arg's
  shape, dtype and spec for ``prefill_32k``, ``decode_32k`` and (gemma2-9b)
  ``long_500k`` of the four dense archs, on ``data=2 × model=2`` and
  ``pod=2 × data=1 × model=2``, with the reference's budget of a chip
  (``hbm_bytes=16e9``), equal to the reference's.
- Serving: the reference's ``_build_prefill`` and ``_build_decode`` at a tiny
  ``InputShape``, jitted on the host mesh, against the port's ``fn`` on the
  ranks: the prefill's logits and the gathered caches, then 3 decode steps'
  greedy tokens, logits (``transformer.decode_step`` on the same state) and
  caches. Cases: reduced qwen1.5-0.5b (4/4 heads; also on the pod mesh),
  reduced smollm-135m (4/1: the kv head replicated over "model"), reduced
  gemma2-9b (softcaps, local/global windows, a cache of 32 past a window of
  16) and its ``long_500k`` (B = 1, the ring of 16 slots over all 4 ranks,
  the prefill through ``transformer.prefill(long_context=True)``), and a
  qwen decode whose upper "model" slice holds nothing. No rank's cache
  ever holds more than its slice.
- A decode step's collectives (``CommDebugMode``, with their bytes) are the
  same at cache lengths 16 and 32: the cache is never gathered; its
  all-gathers are one a layer (q, k and v packed) and one a norm-scale
  leaf. Caches laid out otherwise than by ``cache_specs`` raise.
- ``greedy_sample`` over vocab-sharded logits with ties across the shards
  picks the lowest index, as ``jnp.argmax`` does.
- The other families' serving shapes raise naming item 7c″.

Tolerance: float32, 3e-5 absolute (the reference's sharded-vs-sim bound, as
in ``tests/test_torch_tp.py``; the sharded sums add in another order);
greedy tokens equal. The file takes about 35 s alone on 8 cores.
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

from repro_torch.configs import get_arch, reduced_for_smoke  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SEED = 30
ATOL = 3e-5
STEPS = 3
RANK_TIMEOUT_S = 240
DENSE = ("qwen1.5-0.5b", "smollm-135m", "gemma2-9b", "minitron-8b")
RECORDS = [(a, s, m) for a in DENSE for s in ("prefill_32k", "decode_32k") for m in ("22", "212")] \
    + [("gemma2-9b", "long_500k", m) for m in ("22", "212")]
#: case → (arch, mesh, batch, prompt length, cache slots, long context)
CASES = {
    "qwen": ("qwen1.5-0.5b", "22", 4, 8, 16, False),
    "qwen_pod": ("qwen1.5-0.5b", "212", 4, 8, 16, False),
    "smollm": ("smollm-135m", "22", 4, 8, 16, False),
    "gemma2": ("gemma2-9b", "22", 4, 20, 32, False),
    "gemma2_long": ("gemma2-9b", "22", 1, 20, 16, True),
    "upper_empty": ("qwen1.5-0.5b", "22", 4, 4, 16, False),
}
RAISES = (("mamba2-780m", "prefill_32k"), ("granite-moe-1b-a400m", "decode_32k"),
          ("internvl2-1b", "prefill_32k"), ("zamba2-2.7b", "decode_32k"))


def _cfg(arch):
    return replace(reduced_for_smoke(get_arch(arch)), dtype="float32")


def _np_tree(t):
    return {k: _np_tree(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()


def _inputs() -> dict:
    rng = np.random.default_rng(SEED)
    params = {a: _np_tree(transformer.init_params(0, _cfg(a))) for a in DENSE[:3]}
    prompts = {c: rng.integers(0, _cfg(a).vocab_size, size=(b, s)).astype(np.int32)
               for c, (a, _, b, s, _, _) in CASES.items()}
    return dict(params=params, prompts=prompts, cases=CASES, steps=STEPS, records=RECORDS,
                raises=RAISES)


JAX_SCRIPT = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle, sys
from dataclasses import asdict, replace
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import InputShape, get_arch, reduced_for_smoke
from repro.launch import steps
from repro.models import transformer
from repro.serve import DecodeState, greedy_sample

inp = pickle.load(open(sys.argv[1], "rb"))
meshes = {"22": jax.make_mesh((2, 2), ("data", "model")),
          "212": jax.make_mesh((2, 1, 2), ("pod", "data", "model"))}
host = lambda t: jax.tree.map(np.asarray, t)
out = {}


def args_of(built):
    pairs = jax.tree_util.tree_flatten_with_path(built.args)[0]
    return {jax.tree_util.keystr(k): (tuple(a.shape), str(a.dtype), tuple(a.sharding.spec))
            for k, a in pairs}


for arch, shape, label in inp["records"]:
    built = steps.build_step(arch, shape, meshes[label])
    out[f"build/{arch}/{shape}/{label}"] = dict(meta=built.meta, args=args_of(built),
                                                plan=asdict(built.plan))


def kv(caches):
    return dict(k=np.asarray(caches.kv.k), v=np.asarray(caches.kv.v))


for case, (arch, label, B, S, C, long) in inp["cases"].items():
    cfg = replace(reduced_for_smoke(get_arch(arch)), dtype="float32")
    mesh = meshes[label]
    params = jax.tree.map(jnp.asarray, inp["params"][arch])
    batch = {"tokens": jnp.asarray(inp["prompts"][case])}
    with jax.set_mesh(mesh):
        if long:
            logits, caches = jax.jit(lambda p, b: transformer.prefill(
                p, cfg, b, long_context=True))(params, batch)
            dshape = InputShape("long_500k", S, B, "decode")
        else:
            bp = steps._build_prefill(cfg, InputShape("tiny", C, B, "prefill"), mesh)
            logits, caches = jax.jit(bp.fn)(params, batch)
            dshape = InputShape("tiny", C, B, "decode")
        out[f"{case}/prefill"] = dict(logits=np.asarray(logits), **kv(caches))
        bd = steps._build_decode(cfg, dshape, mesh)
        step = jax.jit(bd.fn)
        dec = jax.jit(lambda p, t, c, pos: transformer.decode_step(p, cfg, t, c, pos,
                                                                   long_context=long))
        state = DecodeState(tokens=greedy_sample(logits, None, 0.0), caches=caches,
                            pos=jnp.int32(S), rng=jnp.zeros((2,), jnp.uint32),
                            done=jnp.zeros((B,), bool))
        out[f"{case}/first"] = np.asarray(state.tokens)
        for t in range(inp["steps"]):
            lg, _ = dec(params, state.tokens, state.caches, state.pos)
            state = step(params, state)
            out[f"{case}/step{t}"] = dict(logits=np.asarray(lg), tokens=np.asarray(state.tokens),
                                          pos=int(state.pos), **kv(state.caches))
pickle.dump(out, open(sys.argv[2], "wb"))
'''


WORKER = r'''
import datetime, pickle, sys
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
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
from torch.utils._pytree import keystr, tree_flatten_with_path, tree_leaves, tree_map

from repro_torch import convert
from repro_torch.configs import InputShape, get_arch, reduced_for_smoke
from repro_torch.dsgd.tensor_parallel import full_value, place, place_tree, tp_region
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import spec_of
from repro_torch.models import transformer
from repro_torch.serve import DecodeState, greedy_sample

inp = pickle.load(open(inp_path, "rb"))
meshes = {"22": make_host_mesh(2, 2, device="cpu"),
          "212": DeviceMesh("cpu", torch.arange(4).reshape(2, 1, 2),
                            mesh_dim_names=("pod", "data", "model"))}
out = {}


class CommBytes(CommDebugMode):
    """CommDebugMode that also adds up the bytes of every collective's
    tensor arguments."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = super().__torch_dispatch__(func, types, args, kwargs)
        if res is not NotImplemented and not isinstance(func, torch._ops.HigherOrderOperator):
            packet = func._overloadpacket
            if packet in self.comm_registry or packet in c10d_collective_ops:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs or {}))
                                  if isinstance(t, torch.Tensor))
        return res


def dt(d):
    return str(d).replace("torch.", "")


def args_of(built):
    return {keystr(k): (tuple(a.shape), dt(a.dtype), spec_of(a))
            for k, a in tree_flatten_with_path(built.args)[0]}


for arch, shape, label in inp["records"]:
    built = steps.build_step(arch, shape, meshes[label], hbm_bytes=16e9)
    out[f"build/{arch}/{shape}/{label}"] = dict(meta=built.meta, args=args_of(built),
                                                plan=asdict(built.plan))
raises = {}
for arch, shape in inp["raises"]:
    try:
        steps.build_step(arch, shape, meshes["22"], hbm_bytes=16e9)
        raises[(arch, shape)] = None
    except NotImplementedError as e:
        raises[(arch, shape)] = str(e)
out["raises"] = raises


def kv(caches):
    return dict(k=full_value(caches.kv.k).numpy(), v=full_value(caches.kv.v).numpy(),
                local=tuple(caches.kv.k.to_local().shape))


params_of = {a: convert.model_params_from_numpy(p, device="cpu")
             for a, p in inp["params"].items()}
for case, (arch, label, B, S, C, long) in inp["cases"].items():
    cfg = replace(reduced_for_smoke(get_arch(arch)), dtype="float32")
    mesh = meshes[label]
    params = params_of[arch]
    batch = {"tokens": torch.from_numpy(inp["prompts"][case])}
    if long:
        bd = steps._build_decode(cfg, InputShape("long_500k", S, B, "decode"), mesh,
                                 hbm_bytes=16e9)
        pspecs = tree_map(spec_of, bd.args[0])
        with tp_region(mesh):
            zeros = steps._zero_caches(cfg, bd.plan, mesh, B, bd.meta["cache_cap"], "cpu")
            logits, caches = transformer.prefill(place_tree(params, mesh, pspecs), cfg,
                                                 place_tree(batch, mesh, {"tokens": (None, None)}),
                                                 long_context=True, caches=zeros)
    else:
        bp = steps._build_prefill(cfg, InputShape("tiny", C, B, "prefill"), mesh, hbm_bytes=16e9)
        logits, caches = bp.fn(params, batch)
        bd = steps._build_decode(cfg, InputShape("tiny", C, B, "decode"), mesh, hbm_bytes=16e9)
        pspecs = tree_map(spec_of, bd.args[0])
    out[f"{case}/prefill"] = dict(logits=full_value(logits).numpy(), **kv(caches))
    first = full_value(greedy_sample(logits, None, 0.0))
    out[f"{case}/first"] = first.numpy()
    state = DecodeState(first, caches, S, None, torch.zeros(B, dtype=torch.bool))
    placed = None
    for t in range(inp["steps"]):
        with tp_region(mesh):
            placed = placed or place_tree(params, mesh, pspecs)
            copy = tree_map(lambda x: x.clone(), state.caches)
            tok = place(state.tokens, mesh, spec_of(bd.args[1].tokens))
            lg, _ = transformer.decode_step(placed, cfg, tok, copy, state.pos, long_context=long)
        state = bd.fn(params, state)
        out[f"{case}/step{t}"] = dict(logits=full_value(lg).numpy(),
                                      tokens=full_value(state.tokens).numpy(), pos=state.pos,
                                      **kv(state.caches))
    out[f"{case}/rank_slice"] = dict(
        k=state.caches.kv.k.to_local().numpy(), v=state.caches.kv.v.to_local().numpy(),
        coordinate=tuple(mesh.get_coordinate()))

# a decode step's collectives at two cache lengths
cfg = replace(reduced_for_smoke(get_arch("qwen1.5-0.5b")), dtype="float32")
mesh = meshes["22"]
batch = {"tokens": torch.from_numpy(inp["prompts"]["upper_empty"])}
comm = {}
for C in (16, 32):
    bp = steps._build_prefill(cfg, InputShape("tiny", C, 4, "prefill"), mesh, hbm_bytes=16e9)
    logits, caches = bp.fn(params_of["qwen1.5-0.5b"], batch)
    bd = steps._build_decode(cfg, InputShape("tiny", C, 4, "decode"), mesh, hbm_bytes=16e9)
    state = DecodeState(greedy_sample(logits, None, 0.0), caches, 4, None,
                        torch.zeros(4, dtype=torch.bool))
    with CommBytes() as mode:
        bd.fn(params_of["qwen1.5-0.5b"], state)
    comm[C] = dict(counts={str(k): v for k, v in mode.get_comm_counts().items()},
                   total=mode.get_total_counts(), bytes=mode.bytes)
out["comm"] = comm

# a decode given caches laid out otherwise than by cache_specs (replicated)
from torch.distributed.tensor import Replicate
mislaid = state._replace(caches=tree_map(
    lambda x: x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim), state.caches))
try:
    bd.fn(params_of["qwen1.5-0.5b"], mislaid)
    out["mislaid"] = None
except ValueError as e:
    out["mislaid"] = str(e)

# the argmax over vocab shards: ties across the shards, and within one
V = 16
full = torch.zeros(4, 1, V)
full[0, 0, [3, 11]] = 5.0          # a tie across the two vocab shards
full[1, 0, [9, 12]] = 5.0          # a tie inside the upper shard
full[2, 0, 15] = 1.0
full[3, 0, :] = -2.0               # every entry equal
ties = {}
for spec in ((None, None, "model"), ("data", None, "model")):
    with tp_region(mesh):
        got = greedy_sample(place(full, mesh, spec), None, 0.0)
    ties[spec] = (full_value(got).numpy(), [p.dim if p.is_shard() else None
                                            for p in got.placements])
out["ties"] = dict(got=ties, logits=full.numpy())
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
    jproc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(inp_path),
                              str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "4", init,
                               str(inp_path), str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
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
    logs = []
    for p in procs:
        logs.append(p.stdout.read())
        p.stdout.close()
    for k, p in enumerate(procs):
        who = f"rank {k}" if k < len(ranks) else "the JAX subprocess"
        assert p.returncode == 0, f"{who} failed (rc {p.returncode}):\n{logs[k][-4000:]}"
    outs = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(4)]
    return outs, pickle.loads((tmp / "jax.pkl").read_bytes())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' outputs, one dict a rank; the JAX outputs)."""
    return _run_all(tmp_path_factory.mktemp("tp_serve"))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= ATOL, (what, err)


@pytest.mark.parametrize("arch,shape,label", RECORDS)
def test_build_step_records_are_the_references(results, arch, shape, label):
    """``plan``, ``meta`` (batch, lengths, the long-context cache, the
    serving rules) and every abstract arg's shape, dtype and spec: the
    parameters by the inference plan, the tokens and ``done`` over the batch
    dims, the caches by ``cache_specs``, ``pos`` and ``rng`` replicated."""
    outs, want = results
    key = f"build/{arch}/{shape}/{label}"
    got, ref = outs[0][key], want[key]
    assert got["plan"] == ref["plan"]
    assert got["meta"] == ref["meta"]
    assert got["args"] == ref["args"]
    for o in outs[1:]:
        assert o[key]["meta"] == got["meta"] and o[key]["args"] == got["args"]


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_matches_the_reference(results, case):
    """The last position's logits and the caches gathered, on every rank."""
    outs, want = results
    ref = want[f"{case}/prefill"]
    for o in outs:
        got = o[f"{case}/prefill"]
        for what in ("logits", "k", "v"):
            _close(got[what], ref[what], (case, what))
        np.testing.assert_array_equal(o[f"{case}/first"], want[f"{case}/first"])


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_the_reference(results, case):
    """Three decode steps of ``build_step``'s decode ``fn``: the greedy
    tokens equal, the logits and the caches within 3e-5, on every rank."""
    outs, want = results
    for t in range(STEPS):
        ref = want[f"{case}/step{t}"]
        for o in outs:
            got = o[f"{case}/step{t}"]
            np.testing.assert_array_equal(got["tokens"], ref["tokens"])
            assert got["pos"] == ref["pos"]
            for what in ("logits", "k", "v"):
                _close(got[what], ref[what], (case, t, what))


@pytest.mark.parametrize("case", list(CASES))
def test_no_rank_holds_more_than_its_slice(results, case):
    """Each rank's cache is its slice by ``cache_specs``, after the prefill
    and after every decode step: the batch over the batch dims and the
    sequence over "model" (B/2 × C/2), or, at B = 1, the sequence over
    "data" and "model" (C/4)."""
    outs, _ = results
    arch, _, B, _, C, long = CASES[case]
    cfg = _cfg(arch)
    want = (cfg.num_layers, B, C // 4, cfg.num_kv_heads, cfg.resolved_head_dim) if long else \
        (cfg.num_layers, B // 2, C // 2, cfg.num_kv_heads, cfg.resolved_head_dim)
    for o in outs:
        assert o[f"{case}/prefill"]["local"] == want
        for t in range(STEPS):
            assert o[f"{case}/step{t}"]["local"] == want


def test_an_empty_upper_slice_stays_empty_and_the_merge_is_exact(results):
    """A prompt of 4 and 3 decode steps fill slots 0–6 of 16: the "model"
    rank of the upper half holds no valid key in any step (its slice stays
    zero) and the merged steps match the reference (above)."""
    outs, _ = results
    for o in outs:
        sl = o["upper_empty/rank_slice"]
        upper = sl["coordinate"][-1] == 1
        assert (not np.any(sl["k"])) == upper and (not np.any(sl["v"])) == upper


def test_ring_slots_move_across_the_ranks(results):
    """long_500k: B = 1, the ring of 16 slots over the 4 ranks (4 each); a
    prompt of 20 wraps it and the three tokens at 20–22 go to slots 4–6,
    the second rank's, in both packages."""
    outs, want = results
    for t in range(STEPS):
        assert want[f"gemma2_long/step{t}"]["pos"] == 21 + t
    owner = [o for o in outs if o["gemma2_long/rank_slice"]["coordinate"] == (0, 1)][0]
    k = owner["gemma2_long/rank_slice"]["k"]
    ref = want[f"gemma2_long/step{STEPS - 1}"]["k"][:, :, 4:8]
    _close(k, ref, "ring slice")


def test_decode_collectives_do_not_grow_with_the_cache(results):
    """One decode step at C = 16 and at C = 32: the same collectives, of the
    same bytes (``CommDebugMode`` counts, their tensors' bytes)."""
    outs, _ = results
    for o in outs:
        a, b = o["comm"][16], o["comm"][32]
        assert a["total"] > 0
        assert a["counts"] == b["counts"] and a["bytes"] == b["bytes"], (a, b)


def test_decode_refuses_caches_laid_out_otherwise(results):
    """The decode ``fn`` lays out the caches it is given by ``cache_specs``:
    replicated DTensor caches raise rather than be taken as they are."""
    outs, _ = results
    for o in outs:
        assert o["mislaid"] is not None and "cache_specs" in o["mislaid"], o["mislaid"]


def test_decode_gathers_heads_and_norm_scales_once(results):
    """One decode step's all-gathers: one a layer (q, k and v packed), one a
    stacked norm-scale leaf (ln1, ln2) and the final norm's, nothing else."""
    outs, _ = results
    L = reduced_for_smoke(get_arch("qwen1.5-0.5b")).num_layers
    for o in outs:
        counts = o["comm"][16]["counts"]
        gathers = {k: v for k, v in counts.items() if "allgather" in k or "all_gather" in k}
        assert sum(gathers.values()) == L + 3, counts


@pytest.mark.parametrize("spec", [(None, None, "model"), ("data", None, "model")])
def test_greedy_sample_breaks_ties_to_the_lowest_index(results, spec):
    """Over vocab shards, ties across and inside the shards and a row of
    equal entries go to the lowest index, as ``np.argmax`` (and
    ``jnp.argmax``); the tokens keep the batch's sharding."""
    outs, _ = results
    for o in outs:
        got, placements = o["ties"]["got"][spec]
        want = np.argmax(o["ties"]["logits"][:, -1], axis=-1)[:, None]
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        assert placements == ([0, None] if spec[0] == "data" else [None, None])


def test_other_families_raise_naming_7c_double_prime(results):
    outs, _ = results
    for o in outs:
        for key, msg in o["raises"].items():
            assert msg is not None and "item 7c″" in msg, (key, msg)
