"""The port's checkpoint store (``repro_torch.checkpoint``) on the CPU.

- A round trip of a ``DSGDState``-shaped tree (NamedTuples of nested dicts,
  an SGD state, int32 steps) with a bfloat16 leaf: every leaf comes back
  bitwise, in its dtype, on the template's device. numpy has no bfloat16,
  so the archive holds that leaf's int16 bits (the reduced configs the
  other tests train are float32, so this is the only bf16 coverage).
- Extras come back shape-free; ``__step__`` round-trips.
- Leaf-set and shape mismatches raise ``CheckpointError``.
- ``CheckpointManager.restore`` skips a truncated newest file with
  ``CheckpointCorruptionWarning`` and restores the next older one; an
  explicit step raises instead; keep-k pruning keeps the newest k.
- An archive the reference wrote from a JAX tree restores into the port's
  template under the same key paths.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptionWarning, CheckpointError,  # noqa: E402
                                    CheckpointManager, load_checkpoint, save_checkpoint)
from repro_torch.dsgd.trainer import DSGDState  # noqa: E402
from repro_torch.optim.optimizers import SGDState  # noqa: E402


def _state(seed: int) -> DSGDState:
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(4, 16, 8, generator=g).to(torch.bfloat16),
              "layers": {"w": torch.randn(4, 2, 8, 8, generator=g),
                         "ln": torch.randn(4, 2, 8, generator=g).to(torch.bfloat16)}}
    mom = {"embed": torch.randn(4, 16, 8, generator=g),
           "layers": {"w": torch.randn(4, 2, 8, 8, generator=g),
                      "ln": torch.randn(4, 2, 8, generator=g)}}
    return DSGDState(params, SGDState(mom, torch.full((4,), seed, dtype=torch.int32)),
                     torch.tensor(seed, dtype=torch.int32))


def _template() -> DSGDState:
    return torch.utils._pytree.tree_map(torch.zeros_like, _state(0))


def _bits(t: torch.Tensor) -> bytes:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _same(a, b) -> bool:
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and _bits(x) == _bits(y)
        for x, y in zip(la, lb))


def test_round_trip_with_a_bfloat16_leaf_is_bitwise(tmp_path):
    state = _state(3)
    # values no float32 → bfloat16 cast can hold would show a lossy path
    state.params["embed"].view(torch.int16)[0, 0, :3] = torch.tensor(
        [0x7f80, -0x0080, 0x0001], dtype=torch.int16)       # +inf, -inf, a subnormal
    path = tmp_path / "ck.npz"
    save_checkpoint(str(path), state, step=7)
    with np.load(path) as z:
        assert z[".params['embed']"].dtype == np.int16
        assert sorted(z["__bfloat16__"].tolist()) == [".params['embed']",
                                                       ".params['layers']['ln']"]
    tree, step = load_checkpoint(str(path), _template())
    assert step == 7 and isinstance(tree, DSGDState) and isinstance(tree.opt, SGDState)
    assert _same(tree, state)
    assert tree.params["embed"].dtype == torch.bfloat16
    assert tree.params["layers"]["w"].device == torch.device("cpu")


def test_extras_come_back_shape_free(tmp_path):
    path = str(tmp_path / "ck.npz")
    extra = {"edges": np.arange(14, dtype=np.int64).reshape(7, 2),
             "g": np.linspace(0, 1, 7), "key": np.asarray([5, 2], np.int64)}
    save_checkpoint(path, _state(1), step=2, extra=extra)
    tree, step, got = load_checkpoint(path, _template(), with_extra=True)
    assert step == 2 and _same(tree, _state(1)) and set(got) == set(extra)
    for k, v in extra.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    # a re-optimized topology has another edge count: the extras follow it
    extra["edges"] = np.zeros((9, 2), np.int64)
    save_checkpoint(path, _state(1), step=3, extra=extra)
    assert load_checkpoint(path, _template(), with_extra=True)[2]["edges"].shape == (9, 2)


@pytest.mark.parametrize("drift", ["missing", "unexpected", "shape"])
def test_mismatched_templates_raise(tmp_path, drift):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _state(1), step=1)
    tmpl = _template()
    if drift == "missing":
        tmpl.params["extra_leaf"] = torch.zeros(3)
    elif drift == "unexpected":
        del tmpl.params["layers"]["ln"]
    else:
        tmpl.params["layers"]["w"] = torch.zeros(4, 2, 8, 9)
    with pytest.raises(CheckpointError, match=drift if drift != "shape" else "shape mismatch"):
        load_checkpoint(path, tmpl)


def test_truncated_newest_falls_back_with_a_warning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(_state(1), 1, extra={"a": np.arange(3)})
    newest = mgr.save(_state(2), 2)
    with open(newest, "rb") as f:
        head = f.read(100)
    with open(newest, "wb") as f:
        f.write(head)                                  # a crash mid-write
    with pytest.warns(CheckpointCorruptionWarning, match="ckpt_2"):
        tree, step, extras = mgr.restore(_template(), with_extra=True)
    assert step == 1 and _same(tree, _state(1)) and np.array_equal(extras["a"], np.arange(3))
    with pytest.raises(CheckpointError, match="unreadable"):
        mgr.restore(_template(), step=2)
    os.unlink(mgr._path(1))
    with pytest.warns(CheckpointCorruptionWarning):
        assert mgr.restore(_template()) == (None, None)


def test_keep_k_prunes_all_but_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (3, 6, 9, 12):
        mgr.save(_state(s), s)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_12.npz", "ckpt_9.npz"]
    assert mgr.latest_step() == 12
    assert _same(mgr.restore(_template())[0], _state(12))
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep=0)


def test_reads_the_reference_archive_under_the_same_key_paths(tmp_path):
    """The reference's key-path strings (``jax.tree_util.keystr``) are the
    port's (``torch.utils._pytree.keystr``): a float32 archive the JAX
    package wrote restores into the port's template."""
    from repro.dsgd.trainer import DSGDState as JState
    from repro.optim.optimizers import SGDState as JSGD

    state = _state(4)
    f32 = torch.utils._pytree.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                                       state)
    jtree = JState(*jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                 (f32.params, JSGD(*f32.opt), f32.step)))
    path = str(tmp_path / "ref.npz")
    j_save(path, jtree, step=4, extra={"k": np.arange(2)})
    tree, step, extras = load_checkpoint(path, _template(), with_extra=True)
    assert step == 4 and np.array_equal(extras["k"], np.arange(2))
    assert _same(tree.opt, state.opt)
    # the bf16 leaves were float32 in that archive: cast exactly back
    assert torch.equal(tree.params["embed"], state.params["embed"])
