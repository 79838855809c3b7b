"""Mamba-2 780M [arXiv:2405.21060] — attention-free SSD (state-space duality),
d_state 128, expand 2, head dim 64 (48 SSD heads over d_inner 3072)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", arch_type="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    dtype="bfloat16", source="arXiv:2405.21060",
)
