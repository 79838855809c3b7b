"""Model zoo of the port: the six families of the reference's zoo — dense
(train, prefill, KV-cache decode), moe, ssm (Mamba-2), hybrid (zamba2), vlm
and audio (prefill and decode)."""
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
