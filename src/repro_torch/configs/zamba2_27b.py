"""Zamba2-2.7B [arXiv:2411.15242] — hybrid: 54 Mamba2 blocks + ONE shared
attention block applied every 6 layers (32H MHA), ssm_state 64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    shared_attn_every=6,
    dtype="bfloat16", source="arXiv:2411.15242",
)
