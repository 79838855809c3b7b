"""InternVL2-1B [arXiv:2404.16821] — language backbone (Qwen2-0.5B-style,
GQA 14H/2KV); InternViT vision frontend is a STUB per the brief:
input_specs provides 256 precomputed patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", arch_type="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, qkv_bias=True,
    frontend="vision", frontend_tokens=256,
    dtype="bfloat16", source="arXiv:2404.16821",
)
