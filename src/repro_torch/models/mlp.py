"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper), as in
``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, tp_matmul

__all__ = ["init_swiglu", "swiglu", "init_gelu_mlp", "gelu_mlp"]


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype, lead: tuple = ()) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_up": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, lead),
    }


def swiglu(params, x):
    """On DTensor weights the products take Megatron's layouts
    (``tp_matmul``; ``x @ w`` on plain tensors)."""
    gate, up = tp_matmul(x, params["w_gate"]), tp_matmul(x, params["w_up"])
    return tp_matmul(F.silu(gate) * up, params["w_down"])


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, lead: tuple = ()) -> dict:
    return {
        "w_in": dense_init(gen, d_model, d_ff, dtype, lead),
        "b_in": torch.zeros(lead + (d_ff,), dtype=dtype),
        "w_out": dense_init(gen, d_ff, d_model, dtype, lead),
        "b_out": torch.zeros(lead + (d_model,), dtype=dtype),
    }


def gelu_mlp(params, x):
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    return h @ params["w_out"] + params["b_out"]
