"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — MHA (16H/16KV) with QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", arch_type="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True,
    dtype="bfloat16", source="hf:Qwen/Qwen1.5-0.5B",
)
