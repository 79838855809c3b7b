"""Algorithm 2 — ADMM solvers for the network-topology problems, in PyTorch.

Thin wrappers over ``engine``: each class builds a
:class:`~repro_torch.core.engine.ProblemSpec` once and runs single solves
through ``engine.solve_spec`` and batched restarts (``solve_batched``)
through ``engine.solve_batched_spec``: every step of the batch serves all
restarts at once.

``ADMMConfig.partition`` dispatches as the reference does: ``"edges"``
solves through ``shard.solve_spec_sharded`` (a batch one instance at a
time), ``"instances"`` a batch through ``shard.solve_batched_spec_sharded``,
``"auto"`` by ``shard.resolve_partition`` (``"none"`` on one process).

Drivers (``ADMMConfig.driver``), as in the reference: ``"scan"`` (default,
the chunked driver) and ``"python"`` (``engine.solve_python``, one host
read an iteration), which also carries the scipy-ILU backend
(``solver="kkt_bicgstab_ilu"``: homogeneous and float64 only; a
heterogeneous solver falls back to ``schur_cg``). ``solve_batched`` takes
the device backends only.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .engine import (
    ADMMConfig,
    ADMMResult,
    ADMMState,
    ProblemSpec,
    check_solver,
    init_state,
    make_hetero_spec,
    make_homo_spec,
    make_ilu_step,
    solve_batched_spec,
    solve_python,
    solve_spec,
)
from . import shard

__all__ = ["ADMMConfig", "ADMMResult", "HomogeneousADMM", "HeterogeneousADMM"]


class _ADMMBase:
    spec: ProblemSpec
    cfg: ADMMConfig

    @property
    def m(self) -> int:
        return self.spec.m

    @property
    def r(self) -> int:
        return int(self.spec.r)

    def _device_cfg(self) -> ADMMConfig:
        """The config with its backend checked. The scipy-ILU backend
        exists only for the homogeneous problem; like the reference, the
        heterogeneous solver falls back to schur_cg when it is asked for."""
        check_solver(self.cfg)
        if self.spec.hetero and self.cfg.solver == "kkt_bicgstab_ilu":
            return replace(self.cfg, solver="schur_cg")
        if self.cfg.solver == "kkt_bicgstab_ilu" and self.cfg.dtype != "float64":
            raise ValueError("the scipy-ILU backend is float64-only; use solver='schur_cg' "
                             "with dtype='float32'")
        return self.cfg

    def _solve_state(self, state: ADMMState) -> ADMMResult:
        cfg = self._device_cfg()
        if cfg.solver == "kkt_bicgstab_ilu":
            return solve_python(self.spec, state, cfg, step_fn=self._ilu_step())
        if cfg.driver == "python":
            return solve_python(self.spec, state, cfg)
        # a single solve has no instance batch: "instances" degenerates
        if shard.resolve_partition(cfg.partition, self.spec.n) == "edges":
            return shard.solve_spec_sharded(self.spec, state, cfg)
        return solve_spec(self.spec, state, cfg)

    def _batched_cfg(self) -> ADMMConfig:
        """The config of ``solve_batched`` (always the chunked driver)."""
        cfg = self._device_cfg()
        if cfg.solver == "kkt_bicgstab_ilu":
            raise ValueError("solve_batched needs a device backend (schur_cg or "
                             "kkt_bicgstab); the scipy-ILU backend is host-side")
        return cfg

    def _solve_states_batched(self, states: ADMMState) -> list[ADMMResult]:
        cfg = self._batched_cfg()
        batch = int(states.X[0].shape[0])
        part = shard.resolve_partition(cfg.partition, self.spec.n, batch=batch)
        if part == "instances":
            return shard.solve_batched_spec_sharded(self.spec, states, cfg)
        if part == "edges":
            return [shard.solve_spec_sharded(self.spec, states.map(lambda a, b=b: a[b]), cfg)
                    for b in range(batch)]
        return solve_batched_spec(self.spec, states, cfg)

    def _ilu_step(self):
        raise ValueError("the ILU backend supports the homogeneous problem only")


def _as_f64(a):
    return None if a is None else torch.as_tensor(np.asarray(a, dtype=np.float64))


def _batch_of(name: str, a, shape: tuple) -> torch.Tensor:
    t = _as_f64(a)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    return t


class HomogeneousADMM(_ADMMBase):
    """Eq. (20) solver. ``r`` is the cardinality budget on the edge set."""

    def __init__(self, n: int, r: int, cfg: ADMMConfig | None = None,
                 edge_ok: np.ndarray | None = None):
        self.n, self.cfg = n, cfg or ADMMConfig()
        self.spec = make_homo_spec(n, r, self.cfg, edge_ok)
        self._ilu_step_fn = None

    def init_state(self, g0=None, lam0: float = 0.5) -> ADMMState:
        g = torch.zeros(self.spec.m, dtype=torch.float64) if g0 is None else _as_f64(g0)
        return init_state(self.spec, g, lam0)

    def solve(self, g0=None, lam0: float = 0.5) -> ADMMResult:
        return self._solve_state(self.init_state(g0, lam0))

    def solve_batched(self, g0s, lam0s) -> list[ADMMResult]:
        """Solve a batch of warm starts together: ``g0s`` (B, m) edge
        weights, ``lam0s`` (B,) λ̃ starts. One result per warm start."""
        self._batched_cfg()
        B = len(lam0s)
        states = init_state(self.spec, _batch_of("g0s", g0s, (B, self.spec.m)),
                            _batch_of("lam0s", lam0s, (B,)))
        return self._solve_states_batched(states)

    def _ilu_step(self):
        """The ILU step, built (sparse KKT matrix and its ILU) once a solver."""
        if self._ilu_step_fn is None:
            self._ilu_step_fn = make_ilu_step(self.spec)
        return self._ilu_step_fn


class HeterogeneousADMM(_ADMMBase):
    """Eq. (28) solver with binary edge selection z and capacity rows M z = e
    (equality) or M z + s = e, s ≥ 0 (inequality capacities)."""

    def __init__(self, n: int, r: int, M: np.ndarray, e_cap: np.ndarray,
                 cfg: ADMMConfig | None = None, equality: bool = True,
                 edge_ok: np.ndarray | None = None):
        self.n, self.cfg = n, cfg or ADMMConfig()
        self.spec = make_hetero_spec(n, r, np.asarray(M), np.asarray(e_cap),
                                     self.cfg, equality=equality, edge_ok=edge_ok)
        self.equality = equality

    def init_state(self, g0=None, z0=None, lam0: float = 0.5) -> ADMMState:
        g = torch.zeros(self.spec.m, dtype=torch.float64) if g0 is None else _as_f64(g0)
        return init_state(self.spec, g, lam0, z=_as_f64(z0))

    def solve(self, g0=None, z0=None, lam0: float = 0.5) -> ADMMResult:
        return self._solve_state(self.init_state(g0, z0, lam0))

    def solve_batched(self, g0s, z0s, lam0s) -> list[ADMMResult]:
        """Batched restarts: (B, m) ``g0s``, (B, m) ``z0s``, (B,) ``lam0s``."""
        self._batched_cfg()
        B, m = len(lam0s), self.spec.m
        states = init_state(self.spec, _batch_of("g0s", g0s, (B, m)),
                            _batch_of("lam0s", lam0s, (B,)), z=_batch_of("z0s", z0s, (B, m)))
        return self._solve_states_batched(states)
