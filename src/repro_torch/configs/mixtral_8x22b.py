"""Mixtral 8x22B [arXiv:2401.04088] — MoE 8 experts top-2, SWA, GQA 48H/8KV."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", arch_type="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, experts_per_token=2,
    sliding_window=4096, attn_pattern="swa",
    tie_embeddings=False, dtype="bfloat16", source="arXiv:2401.04088",
)
