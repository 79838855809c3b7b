"""DSGD evaluation engines of the port (paper §VI-B — Table II, Figs 7–10).

The reference's ``repro/dsgd/sim.py`` on one device, in torch:

  - ``accuracy_curves`` trains every topology on the same data, init and
    batch order, and ``accuracy_curves_seeds`` adds seeds (each its own
    init and batch order). The runs are stacked on ONE worker axis of
    (S·T·n, ...) leaves where the reference vmaps, so each training step
    is one batch gather, one ``torch.func.vmap`` of the MLP's gradient, and
    one ``gossip_mix_batched`` launch per parameter leaf for all runs over
    a block-diagonal neighbour table (run b's rows and neighbour indices
    offset by b·n, padded to the widest degree of any run; a padded slot
    adds an exact 0·x).
  - ``train_curves_cross`` runs the cross product {static, round-robin
    dynamic} × {dense, top-k CHOCO, random-k CHOCO}: one neighbour table
    per cycle slot, built once, and each step run b's rows are gathered
    from slot ``t % R_b`` with an index the host computed beforehand from
    the numpy cycle lengths — no device value is read in the loop.
  - ``train_curves_chaos`` adds faults: each step the selected cycle
    matrices are degraded on the device (``degrade_matrix``), the kernel
    weights are gathered from them over the same tables
    (``gather_neighbor_weights``), and dead workers are frozen with
    ``torch.where``. Without faults it is bit-equal to the cross engine.
  - ``consensus_curves_cross`` / ``consensus_curves_chaos``: x ← W_t x (or
    one CHOCO step) on an (n, dim) value, by ``torch.matmul`` as the
    reference leaves it to XLA.

The reference compiles a run into one ``lax.scan``; here a Python loop over
epochs × iterations keeps everything on the device: the batch-index tensor
is uploaded once, the per-epoch accuracies stay on the device and the host
reads them once, at the end. The ``*_host`` functions keep the reference's
per-iteration shape (per-worker gathers stacked on the host, one read per
epoch or step) on the same kernels, and are the engines' parity oracles.

Deviations from the reference: the training curves mix through the
``gossip_mix_batched`` kernel (the reference passes ``use_kernel=False``);
random-k masks come from a ``torch.Generator`` seeded ``seed + 1`` (one
draw per iteration, one column range of it per leaf), since
``jax.random.bernoulli`` cannot be reproduced; the initial weights come
from a ``torch.Generator`` seeded ``cfg.seed`` unless ``init=`` gives them
(:func:`repro_torch.convert.mlp_params_from_numpy` carries the reference's
over). Every entry point runs on ``cuda`` unless ``device="cpu"`` is asked.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..data import epoch_permutations
from ..device import resolve_device
from ..kernels.gossip_mix.ops import gossip_mix_batched
from .chaos import ChaosSpec, degrade_matrix
from .compression import (
    Compressor,
    choco_gossip_init,
    choco_gossip_step,
    choco_mix,
    choco_weights,
    compress_random_k,
    compress_top_k,
    compression_ratio,
    identity_compressor,
    random_k_compressor,
    random_k_mask,
    top_k_compressor,
)
from .dynamic import stack_cycles
from .gossip import elastic_neighbor_tables, gather_neighbor_weights

__all__ = [
    "DSGDSimConfig", "init_mlp", "mlp_logits", "mlp_loss",
    "train_curve", "accuracy_curves", "accuracy_curves_seeds",
    "accuracy_curve_host",
    "CommSpec", "train_curves_cross", "accuracy_curve_host_cross",
    "consensus_curves_cross", "consensus_curve_host_cross",
    "train_curves_chaos", "accuracy_curve_host_chaos",
    "consensus_curves_chaos", "consensus_curve_host_chaos",
]

#: The MLP's leaves in the reference's ``jax.tree.flatten`` order.
LEAVES = ("b1", "b2", "w1", "w2")


@dataclass(frozen=True)
class DSGDSimConfig:
    """Hyperparameters of the §VI-B time-to-accuracy protocol."""
    epochs: int = 30
    batch: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    hidden: int = 128
    seed: int = 0


# ---------------------------------------------------------------------------
# model: 2-layer MLP on the Gaussian-mixture task (CIFAR-10 stand-in)
# ---------------------------------------------------------------------------

def init_mlp(seed: int, dim: int, hidden: int, classes: int) -> dict:
    """Float32 weights on the CPU, uniform in ±1/√fan_in, drawn from a
    ``torch.Generator`` seeded ``seed`` (so every device starts from the
    same ones); zero biases."""
    gen = torch.Generator().manual_seed(int(seed))
    s1 = 1.0 / np.sqrt(dim)
    s2 = 1.0 / np.sqrt(hidden)
    return {"w1": torch.empty((dim, hidden), dtype=torch.float32).uniform_(-s1, s1, generator=gen),
            "b1": torch.zeros((hidden,), dtype=torch.float32),
            "w2": torch.empty((hidden, classes), dtype=torch.float32).uniform_(-s2, s2,
                                                                                generator=gen),
            "b2": torch.zeros((classes,), dtype=torch.float32)}


def mlp_logits(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def mlp_loss(p, x, y):
    lp = torch.log_softmax(mlp_logits(p, x), dim=-1)
    return -torch.mean(torch.gather(lp, 1, y[:, None]))


# ---------------------------------------------------------------------------
# communication spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CommSpec:
    """The compressor half of the communication config.

    ``compressor`` ∈ {"dense", "top_k", "random_k"}: dense applies x ← W_t x
    directly; the CHOCO modes gossip on compressed-innovation estimates with
    the error-feedback state x̂ kept per leaf. ``frac`` is the kept fraction.
    """
    compressor: str = "dense"
    frac: float = 1.0

    def __post_init__(self):
        if self.compressor not in ("dense", "top_k", "random_k"):
            raise ValueError(f"unknown compressor {self.compressor!r}")

    @property
    def choco(self) -> bool:
        return self.compressor != "dense"

    @property
    def ratio(self) -> float:
        """Transmitted fraction ω of the dense bytes (Eq. 34 time scaling)."""
        return 1.0 if not self.choco else compression_ratio(self.frac)

    @property
    def name(self) -> str:
        if not self.choco:
            return "dense"
        tag = "top" if self.compressor == "top_k" else "rand"
        return f"{tag}{int(self.frac * 100)}%"

    def to_compressor(self) -> Compressor:
        """The equivalent step-loop :class:`Compressor` (oracle paths)."""
        if not self.choco:
            return identity_compressor()
        if self.compressor == "top_k":
            return top_k_compressor(self.frac)
        return random_k_compressor(self.frac)


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    """The random-k stream: one generator seeded ``seed + 1`` on ``dev``."""
    return torch.Generator(device=dev).manual_seed(int(seed) + 1)


def _random_masks(spec: CommSpec, gen, n: int, widths: list[int], runs: int):
    """One draw for this iteration: an (n, Σ widths) uniform, cut into one
    Bernoulli(frac) keep-mask per leaf and shared by every run, as the
    reference's vmap shares one key stream. None unless random-k."""
    if spec.compressor != "random_k":
        return None
    keep = random_k_mask((n, sum(widths)), spec.frac, gen)
    masks, at = [], 0
    for w in widths:
        m = keep[:, at:at + w].unsqueeze(0).expand(runs, n, w)
        masks.append(m.reshape(runs * n, w))
        at += w
    return masks


def _mix_pytree(spec: CommSpec, x: dict, hat: dict, nbr, gamma, masks):
    """One CHOCO exchange on stacked ``(rows, ...)`` leaf dicts → (x', x̂').

    ``nbr = (idx, w)`` is the step's neighbour table with the weights of W;
    the product (W − I)x̂ is one ``gossip_mix_batched`` launch per leaf over
    it (column 0 made float32(W_ii − 1)). ``gamma`` broadcasts over the rows;
    ``masks`` are the random-k keep-masks, leaf by leaf."""
    table = (nbr[0], choco_weights(nbr[1]))
    out_x, out_h = {}, {}
    for i, k in enumerate(LEAVES):
        xl, hl = x[k], hat[k]
        if spec.compressor == "top_k":
            q = compress_top_k(xl - hl, spec.frac)
        else:
            q = compress_random_k(xl - hl, spec.frac, None, mask=masks[i])
        hl = hl + q
        g = gamma.reshape((-1,) + (1,) * (xl.dim() - 1))
        out_x[k] = choco_mix(xl, hl, None, g, nbr=table)
        out_h[k] = hl
    return out_x, out_h


# ---------------------------------------------------------------------------
# the batched engine: S seeds × B cycles stacked on one worker axis
# ---------------------------------------------------------------------------

def _data(X, y, Xte, yte, dev):
    def t(a, dt):
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                               dtype=dt).to(dev)
    return t(X, torch.float32), t(y, torch.int64), t(Xte, torch.float32), t(yte, torch.int64)


def _classes(y) -> int:
    y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    return int(y.max()) + 1


def _p0(init, seed: int, dim: int, hidden: int, classes: int) -> dict:
    """The run's initial weights as float32 CPU tensors: ``init`` when given
    (a dict of arrays), else :func:`init_mlp` from ``seed``."""
    if init is None:
        return init_mlp(seed, dim, hidden, classes)
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               dtype=torch.float32).cpu() for k, v in init.items()}


def _stack_params(p0s: list[dict], runs_per_seed: int, n: int, dev) -> dict:
    """(S·T·n, ...) leaves: seed s's p0 copied to its T·n worker rows."""
    reps = runs_per_seed * n
    return {k: torch.cat([p[k].unsqueeze(0).expand((reps,) + tuple(p[k].shape))
                          for p in p0s]).to(dev).contiguous() for k in LEAVES}


class _Tables:
    """Neighbour tables of B runs' cycles, built once from the concrete
    (B, R_max, n, n) float32 cycle tensor.

    Every slot's table lists the neighbours in increasing index and is
    padded (self index, mask False) to ``deg``, the widest degree of any run
    and slot: ``local`` indexes within a run, ``glob`` is offset by b·n for
    the block-diagonal kernel table, ``w`` holds the undegraded weights.
    ``sel[t]`` (device, (B,)) picks slot ``t % R_b`` of each run, computed on
    the host from the numpy lengths for every step up front."""

    def __init__(self, Wc32: np.ndarray, lens: np.ndarray, steps: int, dev):
        B, R, n, _ = Wc32.shape
        offd = [(np.count_nonzero(Wc32[b, r] * (1 - np.eye(n)), axis=1).max(initial=0))
                for b in range(B) for r in range(R)]
        deg = max(int(max(offd, default=0)), 1)
        local = np.empty((B, R, n, deg), np.int32)
        mask = np.zeros((B, R, n, deg), bool)
        for b in range(B):
            for r in range(R):
                i, m = elastic_neighbor_tables(Wc32[b, r], deg_cap=deg)
                local[b, r], mask[b, r] = i.numpy(), m.numpy()
        glob = local + (np.arange(B, dtype=np.int32) * n)[:, None, None, None]
        self.B, self.R, self.n, self.deg = B, R, n, deg
        self.static = bool(np.all(lens == 1))
        self.Wc = torch.as_tensor(Wc32, dtype=torch.float32).to(dev).reshape(B * R, n, n)
        self.local = torch.from_numpy(local.reshape(B * R, n, deg)).to(dev)
        self.mask = torch.from_numpy(mask.reshape(B * R, n, deg)).to(dev)
        self.glob = torch.from_numpy(glob.reshape(B * R, n, deg)).to(dev)
        self.w = gather_neighbor_weights(self.Wc, self.local, self.mask)
        t = np.arange(steps)[:, None]
        sel = np.arange(B)[None, :] * R + t % lens[None, :].astype(np.int64)
        self.sel = torch.from_numpy(sel.astype(np.int64)).to(dev)

    def at(self, t: int, alive_t=None, link_t=None):
        """The kernel table (idx (B·n, deg) int32, w (B·n, deg+1) float32)
        of step t; with fault masks (B, n) / (B, n, n) the weights come from
        the degraded matrices."""
        rows = self.B * self.n
        if alive_t is not None:
            s = self.sel[t]
            Wd = degrade_matrix(self.Wc.index_select(0, s), alive_t, link_t)
            w = gather_neighbor_weights(Wd, self.local.index_select(0, s),
                                        self.mask.index_select(0, s))
            return self.glob.index_select(0, s).reshape(rows, self.deg), \
                w.reshape(rows, self.deg + 1)
        if self.static:
            return self.glob.reshape(rows, self.deg), self.w.reshape(rows, self.deg + 1)
        s = self.sel[t]
        return (self.glob.index_select(0, s).reshape(rows, self.deg),
                self.w.index_select(0, s).reshape(rows, self.deg + 1))


def _make_step(spec: CommSpec, cfg: DSGDSimConfig, n: int, runs: int, gamma_rows):
    """One DSGD step on stacked (runs·n, ...) leaves, shared by the batched
    engines and the host oracles: momentum SGD, then the gossip (dense or
    CHOCO) over the step's kernel table, then the freeze of dead workers."""
    grad_fn = torch.func.vmap(torch.func.grad(mlp_loss))
    lr, momentum = cfg.lr, cfg.momentum

    def step(params, mom, hat, xb, yb, table, keep=None, gen=None):
        g = grad_fn(params, xb, yb)
        mom_new = {k: momentum * mom[k] + g[k] for k in LEAVES}
        p_new = {k: params[k] - lr * mom_new[k] for k in LEAVES}
        if spec.choco:
            widths = [params[k][0].numel() for k in LEAVES]
            masks = _random_masks(spec, gen, n, widths, runs)
            p_mix, hat_new = _mix_pytree(spec, p_new, hat, table, gamma_rows, masks)
        else:
            p_mix = {k: gossip_mix_batched(p_new[k], *table) for k in LEAVES}
            hat_new = hat
        if keep is None:
            return p_mix, mom_new, hat_new
        return (_freeze(keep, p_mix, params), _freeze(keep, mom_new, mom),
                _freeze(keep, hat_new, hat) if spec.choco else hat)

    return step


def _freeze(keep, new: dict, old: dict) -> dict:
    """``where(alive, new, old)`` leaf by leaf: dead workers keep their
    previous state bit for bit."""
    return {k: torch.where(keep.reshape((-1,) + (1,) * (new[k].dim() - 1)), new[k], old[k])
            for k in new}


def _correct(params, runs: int, n: int, Xte, yte) -> torch.Tensor:
    """(runs,) int64: test samples the mean model of each run classifies right."""
    mean = {k: v.reshape((runs, n) + tuple(v.shape[1:])).mean(dim=1) for k, v in params.items()}
    h = torch.relu(Xte @ mean["w1"] + mean["b1"][:, None, :])
    logits = h @ mean["w2"] + mean["b2"][:, None, :]
    return (logits.argmax(dim=-1) == yte).sum(dim=-1)


def _gammas(gammas, runs: int, n: int, dev) -> torch.Tensor:
    g = torch.as_tensor(np.asarray(gammas, dtype=np.float32), dtype=torch.float32)
    return g.reshape(runs).repeat_interleave(n).to(dev)


def _stack_chaos(chaos, runs: int, steps: int, n: int, dev):
    """The runs' fault masks on ``dev``, truncated to ``steps``: alive
    (steps, runs, n) and link_up (steps, runs, n, n) float32, so step t's
    rows are one index. ``chaos`` is one ChaosSpec shared by every run or a
    sequence of one per run."""
    specs = [chaos] * runs if isinstance(chaos, ChaosSpec) else list(chaos)
    if len(specs) != runs:
        raise ValueError(f"got {len(specs)} ChaosSpecs for {runs} runs")
    for s in specs:
        if s.n != n:
            raise ValueError(f"ChaosSpec is for n={s.n}, engine runs n={n}")
        if s.steps < steps:
            raise ValueError(f"ChaosSpec covers {s.steps} steps, run needs {steps}")
    leaves = [s.device_leaves(dev) for s in specs]
    return (torch.stack([a[:steps] for a, _ in leaves], dim=1),
            torch.stack([lk[:steps] for _, lk in leaves], dim=1))


def _train_runs(cycles, gammas, spec: CommSpec, X, y, Xte, yte, perms: np.ndarray,
                p0s: list[dict], cfg: DSGDSimConfig, dev, chaos=None) -> np.ndarray:
    """The batched engine: S = len(p0s) seeds × B = len(cycles) // S runs
    each, perms (S, epochs, iters, n, batch). Returns accs (S·T, epochs)."""
    S = len(p0s)
    Wc, R = stack_cycles(cycles)
    B, _, n, _ = Wc.shape
    T = B // S
    epochs, iters = perms.shape[1], perms.shape[2]
    Xd, yd, Xted, yted = _data(X, y, Xte, yte, dev)
    tables = _Tables(Wc.astype(np.float32), R, epochs * iters, dev)
    # batch rows of every run for every step, uploaded once: seed s's
    # (n, batch) indices repeated for its T runs
    rows = np.repeat(perms.transpose(1, 2, 0, 3, 4)[:, :, :, None], T, axis=3)
    rows = torch.from_numpy(rows.reshape(epochs, iters, B * n, -1).astype(np.int64)).to(dev)
    keep = None
    if chaos is not None:
        alive, link = _stack_chaos(chaos, B, epochs * iters, n, dev)
    params = _stack_params(p0s, T, n, dev)
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    hat = {k: torch.zeros_like(v) for k, v in params.items()} if spec.choco else None
    gen = _generator(cfg.seed, dev) if spec.compressor == "random_k" else None
    step = _make_step(spec, cfg, n, B, _gammas(gammas, B, n, dev) if spec.choco else None)
    correct = torch.empty((epochs, B), dtype=torch.int64, device=dev)
    t = 0
    for e in range(epochs):
        for it in range(iters):
            idx = rows[e, it]
            if chaos is not None:
                table = tables.at(t, alive[t], link[t])
                keep = alive[t].reshape(B * n) > 0
            else:
                table = tables.at(t)
            params, mom, hat = step(params, mom, hat, Xd[idx], yd[idx], table, keep, gen)
            t += 1
        correct[e] = _correct(params, B, n, Xted, yted)
    return correct.cpu().numpy().T.astype(np.float64) / yted.numel()


def _perm(parts, cfg: DSGDSimConfig) -> np.ndarray:
    return epoch_permutations(parts, cfg.epochs, cfg.batch, seed=cfg.seed)


def _static_cycles(Ws) -> tuple[list[np.ndarray], bool]:
    Ws = Ws.detach().cpu().numpy() if isinstance(Ws, torch.Tensor) else np.asarray(Ws)
    Ws = Ws.astype(np.float32)
    single = Ws.ndim == 2
    return [W[None] for W in (Ws[None] if single else Ws)], single


def train_curve(W, X, y, Xte, yte, perm, cfg: DSGDSimConfig = DSGDSimConfig(), *,
                init=None, device: str | torch.device = "cuda"):
    """One topology's run over a given ``perm`` (epochs, iters, n, batch);
    returns accs (epochs,)."""
    dev = resolve_device(device)
    cycles, _ = _static_cycles(W)
    n = cycles[0].shape[-1]
    p0 = _p0(init, cfg.seed, np.shape(X)[-1], cfg.hidden, _classes(y))
    perm = perm.cpu().numpy() if isinstance(perm, torch.Tensor) else np.asarray(perm)
    if perm.ndim != 4 or perm.shape[2] != n:
        raise ValueError(f"perm must be (epochs, iters, n={n}, batch), got {perm.shape}")
    return _train_runs(cycles, np.ones(1), CommSpec(), X, y, Xte, yte, perm[None], [p0],
                       cfg, dev)[0]


def accuracy_curves(Ws, X, y, parts, Xte, yte, cfg: DSGDSimConfig = DSGDSimConfig(), *,
                    init=None, device: str | torch.device = "cuda"):
    """Train all topologies in one batched loop.

    Ws: (T, n, n) stacked gossip matrices (or (n, n) for a single run),
    rounded to float32. Returns (accs (T, epochs) [or (epochs,)], iters)."""
    dev = resolve_device(device)
    cycles, single = _static_cycles(Ws)
    perm = _perm(parts, cfg)
    p0 = _p0(init, cfg.seed, np.shape(X)[-1], cfg.hidden, _classes(y))
    accs = _train_runs(cycles, np.ones(len(cycles)), CommSpec(), X, y, Xte, yte, perm[None],
                       [p0], cfg, dev)
    return (accs[0] if single else accs), perm.shape[1]


def accuracy_curves_seeds(Ws, X, y, parts, Xte, yte, seeds,
                          cfg: DSGDSimConfig = DSGDSimConfig(), *, init=None,
                          device: str | torch.device = "cuda"):
    """Seeds × topologies in one batched loop; returns (accs (S, T, epochs),
    iters). Each seed has its own init and batch order; the topologies of a
    seed share both. ``init``: one p0 dict per seed, or None."""
    dev = resolve_device(device)
    cycles, _ = _static_cycles(Ws)
    T = len(cycles)
    dim, classes = np.shape(X)[-1], _classes(y)
    inits = [None] * len(seeds) if init is None else list(init)
    perms, p0s = [], []
    for s, ini in zip(seeds, inits):
        c = dataclasses.replace(cfg, seed=int(s))
        perms.append(_perm(parts, c))
        p0s.append(_p0(ini, c.seed, dim, c.hidden, classes))
    accs = _train_runs(cycles * len(seeds), np.ones(T * len(seeds)), CommSpec(), X, y, Xte,
                       yte, np.stack(perms), p0s, cfg, dev)
    return accs.reshape(len(seeds), T, -1), perms[0].shape[1]


def train_curves_cross(cycles, gammas, spec: CommSpec, X, y, parts, Xte, yte,
                       cfg: DSGDSimConfig = DSGDSimConfig(), *, init=None,
                       device: str | torch.device = "cuda"):
    """Train B = len(cycles) cross-product runs in one batched loop.

    ``cycles``: list of (R_b, n, n) arrays — ``static_cycle(W)`` or
    ``cycle_tensor(topo)``; lengths may differ. ``gammas``: (B,) CHOCO step
    sizes, ignored for dense. Returns (accs (B, epochs), iters)."""
    dev = resolve_device(device)
    perm = _perm(parts, cfg)
    p0 = _p0(init, cfg.seed, np.shape(X)[-1], cfg.hidden, _classes(y))
    return _train_runs(cycles, gammas, spec, X, y, Xte, yte, perm[None], [p0], cfg,
                       dev), perm.shape[1]


def train_curves_chaos(cycles, gammas, spec: CommSpec, chaos, X, y, parts, Xte, yte,
                       cfg: DSGDSimConfig = DSGDSimConfig(), *, init=None,
                       device: str | torch.device = "cuda"):
    """``train_curves_cross`` under injected faults: ``chaos`` is one
    ChaosSpec shared by all runs or one per run (each covering ≥ epochs ×
    iters steps). Dead workers freeze and rejoin at their last params; a
    fault-free spec reproduces :func:`train_curves_cross` bit for bit.
    Returns (accs (B, epochs), iters)."""
    dev = resolve_device(device)
    perm = _perm(parts, cfg)
    p0 = _p0(init, cfg.seed, np.shape(X)[-1], cfg.hidden, _classes(y))
    return _train_runs(cycles, gammas, spec, X, y, Xte, yte, perm[None], [p0], cfg, dev,
                       chaos=chaos), perm.shape[1]


# ---------------------------------------------------------------------------
# host-loop oracles: the reference's per-iteration shape, the same kernels
# ---------------------------------------------------------------------------

def _host_curve(cycle, gamma, spec: CommSpec, X, y, parts, Xte, yte, cfg, init, device,
                chaos=None):
    """One run, one step dispatch per iteration with per-worker batch
    gathers stacked on the host, one accuracy read per epoch; the cycle
    slot ``cycle[t % R]`` and the fault rows are picked on the host, and
    each slot's neighbour table is its own (n−1 wide), not the engines'
    block table."""
    dev = resolve_device(device)
    cyc = np.asarray(cycle.detach().cpu() if isinstance(cycle, torch.Tensor) else cycle)
    cyc = cyc.astype(np.float32).reshape((-1,) + cyc.shape[-2:])
    n = cyc.shape[-1]
    Xd, yd, Xted, yted = _data(X, y, Xte, yte, dev)
    p0 = _p0(init, cfg.seed, Xd.shape[-1], cfg.hidden, _classes(y))
    params = _stack_params([p0], 1, n, dev)
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    hat = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = _generator(cfg.seed, dev) if spec.compressor == "random_k" else None
    step = _make_step(spec, cfg, n, 1, _gammas([gamma], 1, n, dev))
    slots = [torch.from_numpy(W).to(dev) for W in cyc]
    tables = [elastic_neighbor_tables(W, deg_cap=max(n - 1, 1)) for W in slots]
    perm = _perm(parts, cfg)
    iters = perm.shape[1]
    if chaos is not None:
        alive, link = (m[:, 0] for m in _stack_chaos(chaos, 1, cfg.epochs * iters, n, dev))
    accs, t = [], 0
    for e in range(cfg.epochs):
        for it in range(iters):
            idx = perm[e, it]                              # (n, batch)
            xb = torch.stack([Xd[torch.from_numpy(idx[w]).to(dev).long()] for w in range(n)])
            yb = torch.stack([yd[torch.from_numpy(idx[w]).to(dev).long()] for w in range(n)])
            r = t % len(slots)
            W = slots[r] if chaos is None else degrade_matrix(slots[r], alive[t], link[t])
            table = (tables[r][0], gather_neighbor_weights(W, *tables[r]))
            keep = None if chaos is None else alive[t] > 0
            params, mom, hat = step(params, mom, hat, xb, yb, table, keep, gen)
            t += 1
        accs.append(int(_correct(params, 1, n, Xted, yted)[0]) / yted.numel())
    return np.asarray(accs, dtype=np.float64), iters


def accuracy_curve_host(W, X, y, parts, Xte, yte, cfg: DSGDSimConfig = DSGDSimConfig(), *,
                        init=None, device: str | torch.device = "cuda"):
    """Per-iteration host loop for one topology — the parity oracle of
    :func:`accuracy_curves`. Returns (accs (epochs,), iters)."""
    return _host_curve(np.asarray(W.detach().cpu() if isinstance(W, torch.Tensor) else W)[None],
                       1.0, CommSpec(), X, y, parts, Xte, yte, cfg, init, device)


def accuracy_curve_host_cross(cycle, gamma, spec: CommSpec, X, y, parts, Xte, yte,
                              cfg: DSGDSimConfig = DSGDSimConfig(), *, init=None,
                              device: str | torch.device = "cuda"):
    """Per-iteration host loop for one cross-product run — the parity oracle
    of :func:`train_curves_cross`. Returns (accs (epochs,), iters)."""
    return _host_curve(cycle, gamma, spec, X, y, parts, Xte, yte, cfg, init, device)


def accuracy_curve_host_chaos(cycle, gamma, spec: CommSpec, chaos: ChaosSpec, X, y, parts,
                              Xte, yte, cfg: DSGDSimConfig = DSGDSimConfig(), *, init=None,
                              device: str | torch.device = "cuda"):
    """Per-iteration host loop for one chaos run — the parity oracle of
    :func:`train_curves_chaos`. Returns (accs (epochs,), iters)."""
    return _host_curve(cycle, gamma, spec, X, y, parts, Xte, yte, cfg, init, device,
                       chaos=chaos)


# ---------------------------------------------------------------------------
# consensus curves (the §VI-A-style workload of the dynamic / compression
# benches): dense matmul, as the reference computes it outside any kernel
# ---------------------------------------------------------------------------

def _consensus_err(x: torch.Tensor) -> torch.Tensor:
    """‖x − x̄‖_F over the last two axes (workers, dim)."""
    return torch.linalg.vector_norm(x - x.mean(dim=-2, keepdim=True), dim=(-2, -1))


def _consensus_runs(cycles, gammas, spec: CommSpec, x0, iters: int, seed: int, device,
                    chaos=None) -> np.ndarray:
    dev = resolve_device(device)
    x0 = torch.as_tensor(x0.detach().cpu() if isinstance(x0, torch.Tensor) else np.asarray(x0))
    dt = x0.dtype
    Wc, lens = stack_cycles(cycles)
    B, R, n, _ = Wc.shape
    Wc = torch.from_numpy(Wc).to(dt).to(dev).reshape(B * R, n, n)
    sel = np.arange(B)[None, :] * R + np.arange(iters)[:, None] % lens[None, :].astype(np.int64)
    sel = torch.from_numpy(sel).to(dev)
    x = x0.to(dev).unsqueeze(0).expand((B,) + tuple(x0.shape)).contiguous()
    hat = torch.zeros_like(x)
    g = torch.as_tensor(np.asarray(gammas), dtype=dt).reshape(B, 1, 1).to(dev)
    gen = _generator(seed, dev) if spec.compressor == "random_k" else None
    if chaos is not None:
        alive, link = _stack_chaos(chaos, B, iters, n, dev)
    errs = torch.empty((iters + 1, B), dtype=dt, device=dev)
    errs[0] = _consensus_err(x0.to(dev))
    for t in range(iters):
        W = Wc.index_select(0, sel[t])
        if chaos is not None:
            W = degrade_matrix(W, alive[t], link[t])
        if spec.choco:
            rows = x.reshape(B * n, -1)
            innov = rows - hat.reshape(B * n, -1)
            if spec.compressor == "top_k":
                q = compress_top_k(innov, spec.frac)
            else:
                q = compress_random_k(innov, spec.frac, None,
                                      mask=_random_masks(spec, gen, n, [x.shape[-1]], B)[0])
            hat_new = hat + q.reshape(x.shape)
            x_new = choco_mix(x, hat_new, W, g)
        else:
            x_new, hat_new = W @ x, hat
        if chaos is not None:
            keep = (alive[t] > 0)[..., None]
            x_new = torch.where(keep, x_new, x)
            hat_new = torch.where(keep, hat_new, hat)
        x, hat = x_new, hat_new
        errs[t + 1] = _consensus_err(x)
    return errs.cpu().numpy().T


def consensus_curves_cross(cycles, gammas, spec: CommSpec, x0, iters: int, seed: int = 0, *,
                           device: str | torch.device = "cuda"):
    """Consensus curves for B = len(cycles) runs in one batched loop: shared
    x0 (n, dim) in its own dtype, random-k stream seeded ``seed + 1``.
    Returns errors (B, iters+1) as numpy."""
    return _consensus_runs(cycles, gammas, spec, x0, iters, seed, device)


def consensus_curves_chaos(cycles, gammas, spec: CommSpec, chaos, x0, iters: int,
                           seed: int = 0, *, device: str | torch.device = "cuda"):
    """``consensus_curves_cross`` under injected faults; the error is taken
    against the full network mean (frozen dead nodes included). Returns
    (B, iters+1) numpy."""
    return _consensus_runs(cycles, gammas, spec, x0, iters, seed, device, chaos=chaos)


def _host_consensus(cycle, gamma, spec: CommSpec, x0, iters: int, seed: int, device,
                    chaos=None, stop_rel: float | None = None) -> np.ndarray:
    dev = resolve_device(device)
    x0 = torch.as_tensor(x0.detach().cpu() if isinstance(x0, torch.Tensor)
                         else np.asarray(x0)).to(dev)
    cyc = np.asarray(cycle.detach().cpu() if isinstance(cycle, torch.Tensor) else cycle)
    slots = [torch.from_numpy(np.asarray(W, np.float64)).to(x0.dtype).to(dev)
             for W in cyc.reshape((-1,) + cyc.shape[-2:])]
    n = x0.shape[0]
    gamma = torch.as_tensor(gamma, dtype=x0.dtype, device=dev)
    comp = spec.to_compressor()
    gen = _generator(seed, dev) if spec.compressor == "random_k" else None
    if chaos is not None:
        alive, link = (m[:, 0] for m in _stack_chaos(chaos, 1, iters, n, dev))
    state = choco_gossip_init(x0)
    errs = [float(_consensus_err(x0))]
    for t in range(iters):
        W = slots[t % len(slots)]
        if chaos is not None:
            W = degrade_matrix(W, alive[t], link[t])
        new = (choco_gossip_step(state, W, comp, gamma, gen) if spec.choco
               else state._replace(x=W @ state.x))
        if chaos is not None:
            keep = (alive[t] > 0)[:, None]
            new = new._replace(x=torch.where(keep, new.x, state.x),
                               x_hat=torch.where(keep, new.x_hat, state.x_hat))
        state = new
        errs.append(float(_consensus_err(state.x)))
        if stop_rel is not None and errs[-1] <= stop_rel * errs[0]:
            break
    return np.asarray(errs)


def consensus_curve_host_cross(cycle, gamma, spec: CommSpec, x0, iters: int, seed: int = 0,
                               stop_rel: float | None = None, *,
                               device: str | torch.device = "cuda"):
    """Per-iteration host loop for one consensus run (one step and one host
    read per iteration) — the parity oracle of :func:`consensus_curves_cross`.
    ``stop_rel`` stops once the relative error reaches it. Returns errors
    (≤ iters+1,) numpy."""
    return _host_consensus(cycle, gamma, spec, x0, iters, seed, device, stop_rel=stop_rel)


def consensus_curve_host_chaos(cycle, gamma, spec: CommSpec, chaos: ChaosSpec, x0,
                               iters: int, seed: int = 0, *,
                               device: str | torch.device = "cuda"):
    """Per-iteration host loop for one chaos consensus run — the parity
    oracle of :func:`consensus_curves_chaos`."""
    return _host_consensus(cycle, gamma, spec, x0, iters, seed, device, chaos=chaos)
