"""Deterministic synthetic data, bit-identical to ``repro/data/pipeline.py``.

1. ``synthetic_lm_batch`` — language-model batches {tokens, labels} drawn
   from a hidden bigram Markov chain, so training loss can decrease.

   The reference rebuilds a dense V×V float64 transition table on every
   call, which cannot be held at a real vocabulary (19.3 GB per temporary
   at V = 49152). Each row of that table has exactly four nonzero entries
   (``exp(-1e9)`` underflows to 0 everywhere else), so the port keeps only
   those: the four columns, sorted, and the running sums of their
   probabilities, which are the reference's cdf at those columns. The
   table is drawn from the same PCG64 stream in row chunks, the row sum is
   taken over a zero row holding the four values (the reference's pairwise
   summation order, hence its rounding), and the result, V×4 columns and
   V×4 cdf values, is built once per (vocab, seed) and kept in memory and
   on disk under ``build/bigram/`` at the root of the checkout.

   Sampling copies the reference's ``argmax(cdf_row > u)``, including its
   edge case: where ``u ≥ cdf_row[-1]`` (rounding leaves the last cdf value
   below 1 in about a fifth of the rows) no entry is true and the token is 0.

2. ``make_classification_data``, ``class_balanced_partition`` and
   ``epoch_permutations`` — the paper's §VI-B classification substrate,
   plain numpy copied as it is.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

__all__ = ["DataConfig", "token_pipeline", "synthetic_lm_batch", "lm_batch_numpy",
           "synthetic_batches", "bigram_table", "TABLE_STATS",
           "make_classification_data", "class_balanced_partition", "epoch_permutations"]

TABLE_DIR = Path(__file__).resolve().parents[3] / "build" / "bigram"
_TABLE_ROWS = 256          # rows drawn per chunk: 2 × 256 × V × 8 bytes of scratch
_TABLES: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
#: (vocab, seed) → {"seconds": time to get the table, "source": "built" | "disk"}
TABLE_STATS: dict[tuple[int, int], dict] = {}


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int           # per-node batch
    frontend_tokens: int = 0  # > 0 → provide stub embeds (vlm/audio)
    d_model: int = 0          # embed dim for stub embeds
    seed: int = 0


def _build_table(vocab: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's ``normal(size=(V, V)) * 2.0`` rows, drawn chunk by
    chunk into one reused buffer: ``standard_normal`` takes the same draws
    as ``normal`` (which adds 0.0 and scales by 1.0), and the four largest
    of a row are the same set whichever end ``argpartition`` is asked for."""
    rng = np.random.default_rng(seed)
    cols = np.empty((vocab, 4), np.int32)
    cdf = np.empty((vocab, 4), np.float64)
    zero_rows = np.zeros((min(_TABLE_ROWS, vocab), vocab))
    draws = np.empty_like(zero_rows)
    for r0 in range(0, vocab, _TABLE_ROWS):
        k = min(_TABLE_ROWS, vocab - r0)
        logits = draws[:k]
        rng.standard_normal(out=logits)
        logits *= 2.0
        top = np.sort(np.argpartition(logits, vocab - 4, axis=1)[:, -4:], axis=1)
        e = np.exp(np.take_along_axis(logits, top, axis=1))
        rows = zero_rows[:k]
        np.put_along_axis(rows, top, e, axis=1)
        total = rows.sum(axis=1, keepdims=True)
        np.put_along_axis(rows, top, 0.0, axis=1)
        cols[r0:r0 + k] = top
        cdf[r0:r0 + k] = np.cumsum(e / total, axis=1)
    return cols, cdf


def bigram_table(vocab: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(cols (V, 4) int32, cdf (V, 4) float64)``: each token's four
    successors, ascending, and the reference cdf at those columns."""
    key = (vocab, seed)
    if key in _TABLES:
        return _TABLES[key]
    t0 = time.perf_counter()
    path = TABLE_DIR / f"bigram_v{vocab}_s{seed}.npz"
    source = "disk"
    try:
        with np.load(path) as f:
            cols, cdf = f["cols"], f["cdf"]
    except (OSError, KeyError, ValueError):
        source = "built"
        cols, cdf = _build_table(vocab, seed)
        TABLE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
        np.savez(tmp, cols=cols, cdf=cdf)
        os.replace(tmp, path)
    _TABLES[key] = (cols, cdf)
    TABLE_STATS[key] = {"seconds": time.perf_counter() - t0, "source": source}
    return cols, cdf


def lm_batch_numpy(cfg: DataConfig, step: int, node: int = 0) -> dict:
    """One {tokens, labels(, embeds)} batch as numpy arrays. A pure
    function of (cfg, step, node), so every DSGD worker regenerates its
    own shard without host state."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, node, step]))
    cols, cdf = bigram_table(cfg.vocab_size, cfg.seed)
    B, S = cfg.batch_size, cfg.seq_len
    toks = np.empty((B, S), dtype=np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab_size, size=B)
    u = rng.random((B, S))
    for t in range(1, S):
        prev = toks[:, t - 1]
        hit = cdf[prev] > u[:, t, None]
        first = hit.argmax(axis=1)
        toks[:, t] = np.where(hit.any(axis=1), cols[prev, first], 0)
    batch = {"tokens": toks,
             "labels": np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)}
    if cfg.frontend_tokens:
        batch["embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def synthetic_lm_batch(cfg: DataConfig, step: int, node: int = 0) -> dict:
    """:func:`lm_batch_numpy` as CPU tensors."""
    return {k: torch.from_numpy(v) for k, v in lm_batch_numpy(cfg, step, node).items()}


def token_pipeline(cfg: DataConfig, node: int = 0):
    """Infinite iterator of LM batches for one worker."""
    step = 0
    while True:
        yield synthetic_lm_batch(cfg, step, node)
        step += 1


def synthetic_batches(cfg: DataConfig, steps: int, node: int = 0) -> list[dict]:
    return [synthetic_lm_batch(cfg, s, node) for s in range(steps)]


# ---------------------------------------------------------------------------
# classification substrate for the DSGD topology experiments (paper §VI-B)
# ---------------------------------------------------------------------------

def make_classification_data(num_classes: int = 10, dim: int = 64,
                             samples_per_class: int = 512, seed: int = 0,
                             class_sep: float = 3.0, noise_seed: int | None = None):
    """Gaussian-mixture classification set (CIFAR-10 stand-in, offline).

    ``seed`` fixes the class means (the task); ``noise_seed`` draws the
    samples. Returns (X (N, dim) f32, y (N,) i32)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)) * class_sep / np.sqrt(dim)
    rng = np.random.default_rng(seed if noise_seed is None else noise_seed)
    noise = rng.normal(size=(num_classes, samples_per_class, dim))
    X = (means[:, None, :] + noise).reshape(-1, dim).astype(np.float32)
    y = np.repeat(np.arange(num_classes, dtype=np.int32), samples_per_class)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def epoch_permutations(parts: list[np.ndarray], epochs: int, batch: int,
                       seed: int = 0) -> np.ndarray:
    """Per-worker minibatch gather indices for a whole run, ``(epochs,
    iters, n, batch)`` int32, drawn from the same numpy stream as the
    reference's per-epoch loop."""
    n = len(parts)
    per = min(len(p) for p in parts)
    iters = per // batch
    rng = np.random.default_rng(seed)
    out = np.empty((epochs, iters, n, batch), np.int32)
    for e in range(epochs):
        for w, p in enumerate(parts):
            order = rng.permutation(p)[: iters * batch]
            out[e, :, w, :] = order.reshape(iters, batch)
    return out


def class_balanced_partition(y: np.ndarray, n_nodes: int, seed: int = 0) -> list[np.ndarray]:
    """Paper §VI-B: each node samples the same number of samples per class."""
    rng = np.random.default_rng(seed)
    parts: list[list[int]] = [[] for _ in range(n_nodes)]
    for c in np.unique(y):
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        take = (len(idx) // n_nodes) * n_nodes
        for k, chunk in enumerate(np.split(idx[:take], n_nodes)):
            parts[k].extend(chunk.tolist())
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]
