"""Carry solver state, model weights and DSGD state between the JAX
reference and the port.

The functions take and give plain numpy leaves, so this module imports
neither JAX nor ``repro``: the caller turns a reference ``ProblemSpec`` /
``ADMMState`` / parameter dict / ``DSGDState`` into numpy with
``jax.tree.map(np.asarray, ...)`` (which keeps the dataclass / NamedTuple
and its static fields) and hands it here.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .core.constraints import ConstraintSet
from .core.engine import ADMMState, ProblemSpec, split_lam
from .device import resolve_device
from .dsgd.trainer import DSGDState
from .models.attention import KVCache
from .models.ssm import SSMCache
from .models.transformer import Caches
from .optim import AdamWState, SGDState

__all__ = ["spec_from_numpy", "state_from_numpy", "state_to_numpy",
           "lam_to_numpy", "constraints_from_numpy", "model_params_from_numpy",
           "model_params_to_numpy", "dsgd_state_from_numpy", "caches_from_numpy",
           "caches_to_numpy", "mlp_params_from_numpy"]


def _t(a, dtype, dev):
    return None if a is None else torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def spec_from_numpy(ref, device: str = "cuda", dtype: str | None = None,
                    edge_kernel: bool = True) -> ProblemSpec:
    """Port :class:`ProblemSpec` from a reference spec with numpy leaves.

    ``dtype`` overrides the reference's spec dtype (default: keep it);
    ``edge_kernel`` selects the port's L(g)/quadform route (the reference's
    own flag is not carried over: the port routes through its kernels by
    default)."""
    dev = resolve_device(device)
    dtype = dtype or ref.dtype
    dt = getattr(torch, dtype)
    jd = None
    if ref.jd is not None:
        jd = torch.cat([_t(b, dt, dev).reshape(-1) for b in ref.jd])
    return ProblemSpec(
        n=int(ref.n), m=int(ref.m), q=int(ref.q), hetero=bool(ref.hetero),
        equality=bool(ref.equality), cg_tol=float(ref.cg_tol),
        cg_maxiter=int(ref.cg_maxiter),
        r=_t(ref.r, torch.int64, dev), rho=_t(ref.rho, dt, dev),
        edge_ok=_t(ref.edge_ok, torch.bool, dev), c=_t(ref.c, dt, dev),
        ei=_t(ref.ei, torch.int64, dev), ej=_t(ref.ej, torch.int64, dev),
        B0=_t(ref.B0, dt, dev), I=_t(ref.I, dt, dev),
        M=_t(ref.M, dt, dev), e_cap=_t(ref.e_cap, dt, dev),
        jd=jd, lidx=_t(ref.lidx, torch.int64, dev) if ref.lidx is not None else None,
        dtype=dtype, psd_backend=ref.psd_backend, psd_iters=int(ref.psd_iters),
        cg_inexact=bool(ref.cg_inexact), edge_kernel=edge_kernel)


def state_from_numpy(ref, spec: ProblemSpec) -> ADMMState:
    """Port :class:`ADMMState` from a reference state with numpy leaves, on
    ``spec``'s device and in its dtype (``res`` float64, ``cg`` int32)."""
    dt, dev = getattr(torch, spec.dtype), spec.I.device

    def blocks(tup):
        return tuple(_t(a, dt, dev) for a in tup)

    return ADMMState(X=blocks(ref.X), Y=blocks(ref.Y), D=blocks(ref.D),
                     lam=blocks(ref.lam), res=_t(ref.res, torch.float64, dev),
                     cg=_t(ref.cg, torch.int32, dev))


def state_to_numpy(state: ADMMState) -> SimpleNamespace:
    """The port's state as numpy leaves, laid out as the reference's
    ``ADMMState`` (fields X, Y, D, lam, res, cg)."""
    def blocks(tup):
        return tuple(b.detach().cpu().numpy() for b in tup)

    return SimpleNamespace(X=blocks(state.X), Y=blocks(state.Y), D=blocks(state.D),
                           lam=blocks(state.lam), res=state.res.cpu().numpy(),
                           cg=state.cg.cpu().numpy())


def lam_to_numpy(spec: ProblemSpec, lam: torch.Tensor) -> tuple:
    """A flat constraint-space vector of the port as the reference's block
    tuple (P, Q, w (, u, v))."""
    return tuple(b.detach().cpu().numpy() for b in split_lam(spec, lam))


def constraints_from_numpy(n: int, M, e_cap, edge_ok, equality: bool,
                           name: str = "converted",
                           resource_bw=None) -> ConstraintSet:
    """A port :class:`ConstraintSet` from the reference's ``M``, ``e_cap``,
    ``edge_ok`` and ``equality`` fields (``edge_bandwidth`` is not carried:
    it is a closure of the reference's builder)."""
    M = np.asarray(M, dtype=np.int64)
    return ConstraintSet(
        n=int(n), M=M, e_cap=np.asarray(e_cap, dtype=np.int64),
        equality=bool(equality), name=name,
        edge_ok=np.asarray(edge_ok, dtype=bool),
        resource_bw=(np.zeros(M.shape[0]) if resource_bw is None
                     else np.asarray(resource_bw, dtype=np.float64)))


def _leaf(a, dev) -> torch.Tensor:
    """One numpy leaf as a tensor of the same dtype; a bfloat16 array (as
    numpy holds JAX's bfloat16) keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def model_params_from_numpy(tree, device: str = "cuda") -> dict:
    """The port's nested parameter dict from the reference's, leaf for
    leaf (dtypes kept, layer leaves stacked (L, ...) in both)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: model_params_from_numpy(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def model_params_to_numpy(params) -> dict:
    """The port's parameter dict as numpy leaves, with the reference's keys;
    bfloat16 leaves come back as float32 (exact)."""
    if isinstance(params, dict):
        return {k: model_params_to_numpy(v) for k, v in params.items()}
    return _to_numpy(params)


def caches_from_numpy(ref, device: str = "cuda") -> Caches:
    """The port's :class:`Caches` from the reference's ``Caches`` with numpy
    leaves (``kv`` a ``KVCache`` (k, v), ``ssm`` an ``SSMCache`` (conv,
    state), unused fields ``()``); dtypes kept, bfloat16 bit for bit."""
    dev = resolve_device(device)
    kv = KVCache(*(_leaf(a, dev) for a in ref.kv)) if len(ref.kv) else ()
    ssm = SSMCache(*(_leaf(a, dev) for a in ref.ssm)) if len(ref.ssm) else ()
    if len(ref.shared_kv) or len(ref.cross_kv):
        raise NotImplementedError("hybrid and audio caches are not ported yet (ROADMAP.md, "
                                  "Queue 1, 'Non-dense model families')")
    return Caches(kv=kv, ssm=ssm)


def caches_to_numpy(caches: Caches) -> Caches:
    """The port's caches as numpy leaves in the same ``Caches`` / ``KVCache``
    / ``SSMCache`` layout (field names as the reference's); bfloat16 leaves
    come back as float32 (exact)."""
    return Caches(*(type(f)(*(_to_numpy(t) for t in f)) if len(f) else ()
                    for f in caches))


def dsgd_state_from_numpy(ref, device: str = "cuda") -> DSGDState:
    """The port's :class:`DSGDState` from a reference ``DSGDState`` with
    numpy leaves: stacked (n, ...) params, the SGD (momentum, step) or AdamW
    (mu, nu, step) state, and the step counter."""
    dev = resolve_device(device)
    opt = ref.opt
    if hasattr(opt, "momentum"):
        opt = SGDState(model_params_from_numpy(opt.momentum, dev), _leaf(opt.step, dev))
    else:
        opt = AdamWState(model_params_from_numpy(opt.mu, dev),
                         model_params_from_numpy(opt.nu, dev), _leaf(opt.step, dev))
    return DSGDState(model_params_from_numpy(ref.params, dev), opt, _leaf(ref.step, dev))


def mlp_params_from_numpy(tree) -> dict:
    """The §VI-B MLP's p0 dict (``w1``, ``b1``, ``w2``, ``b2``) from the
    reference's ``repro.dsgd.sim.init_mlp`` with numpy leaves, as float32
    CPU tensors: the ``init=`` of the port's curve functions, which move it
    to their device."""
    return {k: torch.from_numpy(np.array(tree[k], dtype=np.float32))
            for k in ("w1", "b1", "w2", "b2")}
