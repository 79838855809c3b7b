"""Granite 3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] — MoE
32 experts top-8, GQA 16H/8KV."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", arch_type="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=32, experts_per_token=8,
    dtype="bfloat16", source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
