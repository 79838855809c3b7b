"""PyTorch/CUDA port of the BA-Topo topology solver (``repro``'s JAX package).

The package mirrors ``src/repro/`` module for module and never imports JAX
or ``repro``: ``repro/core/__init__.py`` pulls in JAX, and the machine with
the card has none. The entry points run on ``cuda`` unless the caller asks
for ``device="cpu"`` (:mod:`repro_torch.device`).

TF32 is switched off here, for every module of the package: the ADMM's
Newton–Schulz projection and its eigh reconstruction ``(U*ev) @ U.T`` are
float32 products that must keep full float32 precision, as the JAX
reference's do.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["core", "device", "kernels", "convert"]
