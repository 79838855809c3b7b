"""PyTorch/CUDA port of ``repro``, the JAX package: the BA-Topo topology
solver, DSGD training over the solved topology, and serving (prefill and
KV/SSM-cache decode).

The package mirrors ``src/repro/`` module for module and never imports JAX
or ``repro``: ``repro/core/__init__.py`` pulls in JAX, and the machine with
the card has none. The entry points run on ``cuda`` unless the caller asks
for ``device="cpu"`` (:mod:`repro_torch.device`).

TF32 is switched off here, for every module of the package: the ADMM's
Newton–Schulz projection and its eigh reconstruction ``(U*ev) @ U.T`` are
float32 products that must keep full float32 precision, as the JAX
reference's do.

cuBLAS may also sum bf16 products partly in bf16
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``).
That is switched off too, so the models' bf16 matmuls accumulate fully in
float32, as XLA's bf16 dots do in the reference.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__all__ = ["configs", "convert", "core", "data", "device", "dsgd", "kernels", "launch",
           "models", "optim", "serve"]
