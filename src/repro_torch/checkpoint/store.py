"""Pytree checkpoints as flat .npz archives (the port of
``repro/checkpoint/store.py``).

Leaves are addressed by their key-path string (``torch.utils._pytree``'s
``keystr``, the same strings as ``jax.tree_util.keystr``: ``.params['embed']``),
so any nest of dict/NamedTuple/tuple round-trips without pickling. The tree
*structure* is restored from a template (the freshly-initialized state),
and every leaf lands on its template leaf's device and dtype.

numpy has no bfloat16: a bf16 leaf is stored as its int16 bits, and the
archive's reserved ``__bfloat16__`` key lists those leaves, so a restore
gives the same bits back (a deviation from the reference's archive, whose
numpy carries JAX's bfloat16 type).

Beyond the model/optimizer pytree, a checkpoint can carry an ``extra``
payload of named numpy arrays (``__extra__<name>`` keys in the archive):
data-stream positions, drift-detector baselines, elastic membership state —
everything a crash-safe ``--resume`` needs to reproduce the uninterrupted
run bit-exactly. Extras are restored *without* template shape-matching,
because their shapes legitimately change across a run (a re-optimized
topology has a different edge count).

Failure handling (the restore path of a run that just crashed): a truncated
or unreadable archive, or one whose leaf set no longer matches the template,
raises :class:`CheckpointError`; ``CheckpointManager.restore`` catches it,
emits a :class:`CheckpointCorruptionWarning` naming the file and the cause,
and falls back to the newest older checkpoint that loads cleanly.
"""
from __future__ import annotations

import os
import re
import tempfile
import warnings
import zipfile

import numpy as np
import torch
from torch.utils._pytree import keystr, tree_flatten_with_path, tree_unflatten

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "CheckpointError", "CheckpointCorruptionWarning"]

_EXTRA_PREFIX = "__extra__"
_STEP = "__step__"
_BF16 = "__bfloat16__"


class CheckpointError(ValueError):
    """A checkpoint file that cannot be restored: unreadable/truncated
    archive, or a leaf set that mismatches the restore template."""


class CheckpointCorruptionWarning(UserWarning):
    """Emitted when ``CheckpointManager.restore`` skips an unusable
    checkpoint and falls back to an older one."""


def _to_numpy(leaf) -> tuple[np.ndarray, bool]:
    """A leaf as a host array, and whether it holds bfloat16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _flatten(tree) -> tuple[dict[str, np.ndarray], list[str]]:
    flat, bf16 = {}, []
    for path, leaf in tree_flatten_with_path(tree)[0]:
        key = keystr(path)
        flat[key], is_bf16 = _to_numpy(leaf)
        if is_bf16:
            bf16.append(key)
    return flat, bf16


def save_checkpoint(path: str, tree, step: int | None = None,
                    extra: dict[str, np.ndarray] | None = None) -> None:
    """Atomic write (tmp + rename) of a pytree to ``path`` (.npz).

    ``extra``: named side-state arrays stored under reserved
    ``__extra__<name>`` keys (restored shape-free by ``load_checkpoint``)."""
    flat, bf16 = _flatten(tree)
    if step is not None:
        flat[_STEP] = np.asarray(step)
    if bf16:
        flat[_BF16] = np.asarray(bf16)
    for k, v in (extra or {}).items():
        flat[_EXTRA_PREFIX + k] = np.asarray(v)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _restore_leaf(arr: np.ndarray, leaf, bits: bool):
    """``arr`` as the template leaf's type: a tensor on the leaf's device in
    its dtype (bfloat16 bits reinterpreted, never cast through a wider
    float), else a numpy array of the leaf's dtype."""
    if not isinstance(leaf, torch.Tensor):
        return arr.astype(np.asarray(leaf).dtype)
    t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    if bits:
        t = t.view(torch.bfloat16)
    return t.to(device=leaf.device, dtype=leaf.dtype)


def load_checkpoint(path: str, template, *, with_extra: bool = False):
    """Restore a pytree saved by save_checkpoint into ``template``'s structure.

    Returns ``(tree, step|None)``, or ``(tree, step|None, extras)`` when
    ``with_extra`` is True. Raises :class:`CheckpointError` for a truncated/
    unreadable archive, a leaf set that mismatches the template (missing OR
    unexpected leaves — a template drift is as unrestorable as a truncation),
    or a per-leaf shape mismatch."""
    try:
        with np.load(path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
    except (OSError, EOFError, ValueError, zipfile.BadZipFile) as exc:
        raise CheckpointError(
            f"unreadable checkpoint {path!r}: {type(exc).__name__}: {exc}"
        ) from exc
    step = int(data.pop(_STEP)) if _STEP in data else None
    bf16 = {str(k) for k in data.pop(_BF16, np.asarray([], dtype=str)).tolist()}
    extras = {k[len(_EXTRA_PREFIX):]: data.pop(k)
              for k in list(data) if k.startswith(_EXTRA_PREFIX)}
    paths, treedef = tree_flatten_with_path(template)
    tmpl_keys = [keystr(p) for p, _ in paths]
    missing = [k for k in tmpl_keys if k not in data]
    unexpected = [k for k in data if k not in set(tmpl_keys)]
    if missing or unexpected:
        raise CheckpointError(
            f"checkpoint {path!r} leaf set mismatches the template: "
            f"missing={missing or '[]'} unexpected={unexpected or '[]'}")
    new_leaves = []
    for (_, leaf), key in zip(paths, tmpl_keys):
        arr = data[key]
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        if arr.shape != shape:
            raise CheckpointError(f"shape mismatch at {key} in {path!r}: "
                                  f"ckpt {arr.shape} vs template {shape}")
        new_leaves.append(_restore_leaf(arr, leaf, key in bf16))
    tree = tree_unflatten(new_leaves, treedef)
    return (tree, step, extras) if with_extra else (tree, step)


class CheckpointManager:
    """Rolling checkpoints: ckpt_<step>.npz under a directory, keep last k."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def save(self, tree, step: int,
             extra: dict[str, np.ndarray] | None = None) -> str:
        path = self._path(step)
        save_checkpoint(path, tree, step=step, extra=extra)
        for s in self._steps()[:-self.keep]:
            if s != step:            # never prune what we just wrote
                os.unlink(self._path(s))
        return path

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, *,
                with_extra: bool = False):
        """Restore the checkpoint at ``step`` (raises on a bad file — an
        explicit step is an explicit ask), or the newest restorable one:
        corrupt/truncated/mismatched archives are skipped with a
        :class:`CheckpointCorruptionWarning` and the next older checkpoint
        is tried. Returns ``(None, None[, {}])`` when nothing restores."""
        none = (None, None, {}) if with_extra else (None, None)
        if step is not None:
            return load_checkpoint(self._path(step), template,
                                   with_extra=with_extra)
        for s in reversed(self._steps()):
            try:
                return load_checkpoint(self._path(s), template,
                                       with_extra=with_extra)
            except CheckpointError as exc:
                warnings.warn(
                    f"skipping unusable checkpoint {self._path(s)!r} ({exc}); "
                    "falling back to the previous one",
                    CheckpointCorruptionWarning, stacklevel=2)
        return none
