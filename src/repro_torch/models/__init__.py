"""Model zoo of the port: the dense transformer family's train path."""
from .transformer import init_params, layer_windows, loss_chunk_for, param_count, train_loss

__all__ = ["init_params", "layer_windows", "loss_chunk_for", "param_count", "train_loss"]
