"""Model zoo of the port: the dense transformer family (train, prefill, KV-cache
decode) and the Mamba-2 family (prefill, recurrent decode)."""
from .transformer import (
    Caches,
    decode_step,
    init_caches,
    init_params,
    layer_windows,
    loss_chunk_for,
    param_count,
    prefill,
    train_loss,
)

__all__ = ["Caches", "decode_step", "init_caches", "init_params", "layer_windows",
           "loss_chunk_for", "param_count", "prefill", "train_loss"]
