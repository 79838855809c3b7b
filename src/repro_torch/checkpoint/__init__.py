"""Checkpointing of the port: pytrees of tensors as flat ``.npz`` archives."""
from .store import (
    CheckpointCorruptionWarning,
    CheckpointError,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint",
           "CheckpointError", "CheckpointCorruptionWarning"]
