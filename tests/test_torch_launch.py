"""The port's launch layer (``repro_torch.launch.{mesh,sharding}``) against
the JAX package's, on the CPU.

The distribution plans and every spec the plans assign (``plan_for``,
``_leaf_spec`` through ``tree_param_specs``, ``batch_specs``,
``cache_specs``) and ``params_bytes`` equal the reference's, exactly, for
every architecture × input shape of ``configs.INPUT_SHAPES`` that the
supported matrix holds, on the shape-only mesh stand-in of
``tests/test_launch.py`` at the reference's production shapes, with the
reference's budget of a chip (``hbm_bytes=16e9``). The H100 defaults are
pinned apart: the budget then follows the card's memory, and where it
changes a plan (mixtral-8x22b's inference layout), that deviation is
pinned. Nothing here needs a process group or a card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS, INPUT_SHAPES, get_arch as j_arch, shape_supported  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_arch as t_arch  # noqa: E402
from repro_torch.device import DeviceFault  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

#: the reference's budget of one chip (a TPU v5e's 16 GB)
V5E_HBM = 16e9
#: an H100 80GB HBM3's memory as ``torch.cuda.get_device_properties`` reads it
H100_HBM = 85_017_493_504


class FakeMesh:
    """Shape-only stand-in (``tests/test_launch.py``'s): dim names and an
    array of the mesh's shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)
        self.shape = dict(zip(names, shape))


MESHES = {"pod": FakeMesh(jmesh.POD_SHAPE, ("data", "model")),
          "multipod": FakeMesh(jmesh.MULTIPOD_SHAPE, ("pod", "data", "model"))}
CASES = [(a, s) for a in ARCHS for s in INPUT_SHAPES if shape_supported(a, s)]


@functools.lru_cache(maxsize=None)
def _j_params_bytes(cfg):
    return _ORIG_J_PARAMS_BYTES(cfg)


_ORIG_J_PARAMS_BYTES = jsh.params_bytes


@pytest.fixture(scope="module", autouse=True)
def _memo_reference_params_bytes():
    """The reference's ``params_bytes`` is a pure function of the config
    that traces the model on every call; it is memoized for this module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsh, "params_bytes", _j_params_bytes)
    yield
    mp.undo()


@functools.lru_cache(maxsize=None)
def _j_shapes(arch):
    cfg = j_arch(arch)
    return jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _t_shapes(arch):
    with torch.device("meta"):
        return ttr.init_params(0, t_arch(arch))


def _j_stacked(tree, n):
    return jax.tree.map(lambda l: jax.ShapeDtypeStruct((n,) + l.shape, l.dtype), tree)


def _t_stacked(tree, n):
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), tree)


def _j_specs(tree) -> dict:
    """{key path: spec} of a reference spec tree (JAX orders dict keys)."""
    pairs = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): tuple(p) for k, p in pairs}


def _t_specs(specs, like) -> dict:
    """{key path: spec} of a port spec tree over the tree it describes."""
    from torch.utils._pytree import keystr, tree_flatten_with_path

    paths = [keystr(k) for k, _ in tree_flatten_with_path(like)[0]]
    return dict(zip(paths, tsh.spec_leaves(specs, like)))


def _plan_fields(plan) -> tuple:
    return (tuple(plan.gossip_axes), tuple(plan.tensor_axes), tuple(plan.batch_axes),
            plan.n_workers, plan.expert_axis)


def _j_cache_shapes(arch, shape):
    cfg = j_arch(arch)
    return jax.eval_shape(lambda: jtr.init_caches(cfg, shape.global_batch, shape.seq_len))


def _t_cache_shapes(arch, shape):
    return ttr.init_caches(t_arch(arch), shape.global_batch, shape.seq_len, device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bytes_is_the_references(arch):
    """From the meta device, nothing allocated."""
    assert tsh.params_bytes(t_arch(arch)) == _j_params_bytes(j_arch(arch))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", CASES)
def test_plan_and_specs_are_the_references(arch, shape_name, mesh_name):
    """The plan, the parameter specs (stacked over the workers where the
    plan gossips, as ``build_step`` lays them out), the batch specs and,
    for decode shapes, the cache specs, spec for spec."""
    mesh = MESHES[mesh_name]
    shape = INPUT_SHAPES[shape_name]
    mode = shape.kind
    jp = jsh.plan_for(j_arch(arch), mesh, mode=mode)
    tp = tsh.plan_for(t_arch(arch), mesh, mode=mode, hbm_bytes=V5E_HBM)
    assert _plan_fields(tp) == _plan_fields(jp)
    stacked = mode == "train" and bool(jp.gossip_axes)
    jt, tt = _j_shapes(arch), _t_shapes(arch)
    if stacked:
        jt, tt = _j_stacked(jt, jp.n_workers), _t_stacked(tt, tp.n_workers)
    want = _j_specs(jsh.tree_param_specs(jt, jp, mesh, stacked=stacked))
    got = _t_specs(tsh.tree_param_specs(tt, tp, mesh, stacked=stacked), tt)
    assert got == want
    lead = (jp.n_workers,) if stacked else ()
    bshape = {"tokens": lead + (shape.global_batch, shape.seq_len),
              "labels": lead + (shape.global_batch, shape.seq_len)}
    jb = jsh.batch_specs(j_arch(arch), jp, mesh, bshape, stacked=stacked)
    tb = tsh.batch_specs(t_arch(arch), tp, mesh, bshape, stacked=stacked)
    assert {k: tuple(v) for k, v in jb.items()} == tb
    if mode == "decode":
        jc, tc = _j_cache_shapes(arch, shape), _t_cache_shapes(arch, shape)
        want = _j_specs(jsh.cache_specs(j_arch(arch), jp, mesh, jc, shape.global_batch))
        got = _t_specs(tsh.cache_specs(t_arch(arch), tp, mesh, tc, shape.global_batch), tc)
        assert got == want


@pytest.mark.parametrize("path,shape", [
    ("['layers']['moe']['w_gate']", (24, 32, 1024, 512)),
    ("['layers']['moe']['w_down']", (24, 32, 512, 1024)),
    ("['layers']['attn']['wq']", (24, 1024, 2048)),
    ("['layers']['attn']['wo']", (24, 2048, 1024)),
    ("['layers']['mlp']['w_up']", (30, 576, 1536)),
    ("['final_norm']", (7,)),
    ("['embed']", (49152, 576)),
])
@pytest.mark.parametrize("expert", [False, True])
def test_leaf_spec_is_the_references(path, shape, expert):
    """The Megatron pattern, the size heuristic, the protected layer axis
    and expert parallelism, on ``tests/test_launch.py``'s leaves."""
    sizes = {"data": 16, "model": 16}
    jp = jsh.DistPlan((), ("model",), ("data",), 1, "model" if expert else None)
    tp = tsh.DistPlan((), ("model",), ("data",), 1, "model" if expert else None)
    assert tsh._leaf_spec(path, shape, tp, sizes) == tuple(jsh._leaf_spec(path, shape, jp, sizes))


def test_the_card_sets_the_budget():
    """With ``hbm_bytes`` the H100's memory the budgets follow it: a 9B
    model fits one "model" slice of 16 cards in bf16 as it does under a
    v5e's budget, and so does the standard train plan of every dense
    model. Without a card and without ``hbm_bytes`` plan_for raises."""
    mesh = MESHES["pod"]
    for arch in ("smollm-135m", "qwen1.5-0.5b", "gemma2-9b"):
        plan = tsh.plan_for(t_arch(arch), mesh, mode="train", hbm_bytes=H100_HBM)
        assert plan.gossip_axes == ("data",) and plan.tensor_axes == ("model",)
    assert tsh.replica_budget_bytes(16, H100_HBM) == 16 * H100_HBM * tsh.BUDGET_SHARE
    if not torch.cuda.is_available():
        with pytest.raises(DeviceFault, match="hbm_bytes"):
            tsh.plan_for(t_arch("smollm-135m"), mesh, mode="train")


def test_mixtral_inference_layout_follows_the_cards_memory():
    """A deviation, pinned: mixtral-8x22b's 281 GB replica does not fit a
    16-chip slice's 60 % of 16 × 16 GB, so the reference shards its
    prefill 2-D; under the H100's 80 GB a card it fits, and the port's
    plan is TP-only."""
    mesh, cfg = MESHES["pod"], t_arch("mixtral-8x22b")
    assert tsh.plan_for(cfg, mesh, mode="prefill", hbm_bytes=V5E_HBM).tensor_axes == \
        ("data", "model") == tuple(jsh.plan_for(j_arch("mixtral-8x22b"), mesh,
                                                mode="prefill").tensor_axes)
    assert tsh.plan_for(cfg, mesh, mode="prefill", hbm_bytes=H100_HBM).tensor_axes == ("model",)
    # training stays pod-sized either way: 281 GB + 8 bytes a parameter of state
    assert tsh.plan_for(cfg, mesh, mode="train", hbm_bytes=H100_HBM).tensor_axes == \
        ("data", "model")


def test_placements_map_specs_onto_mesh_dims():
    """Shard(d) on the mesh dims a tensor dim names (a tuple splits it
    row-major over dims in mesh order), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = type("M", (), {"mesh_dim_names": ("pod", "data", "model")})()
    assert tsh.placements(("data", None, "model"), mesh) == [Replicate(), Shard(0), Shard(2)]
    assert tsh.placements((("pod", "data"), None), mesh) == [Shard(0), Shard(0), Replicate()]
    assert tsh.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements((("data", "pod"),), mesh)


def test_meshes_keep_the_references_names_and_check_the_world():
    """``POD_SHAPE``/``MULTIPOD_SHAPE`` are the reference's values; without a
    process group, or with too few ranks, a mesh fails early with its own
    message."""
    assert (tmesh.POD_SHAPE, tmesh.MULTIPOD_SHAPE) == (jmesh.POD_SHAPE, jmesh.MULTIPOD_SHAPE)
    with pytest.raises(ValueError, match="no torch.distributed process group"):
        tmesh.make_host_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")


def test_with_sharding_allocates_nothing():
    """Abstract leaves: meta tensors of the leaf's shape and dtype carrying
    its spec."""
    tree = {"w": torch.empty((2, 8, 4), device="meta", dtype=torch.bfloat16),
            "s": torch.empty((), device="meta", dtype=torch.int32)}
    out = tsh.with_sharding(None, tree, {"w": ("data", None, "model"), "s": ()})
    assert out["w"].is_meta and out["w"].shape == (2, 8, 4) and out["w"].dtype == torch.bfloat16
    assert tsh.spec_of(out["w"]) == ("data", None, "model") and tsh.spec_of(out["s"]) == ()
