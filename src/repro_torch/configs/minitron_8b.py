"""Minitron-8B [arXiv:2407.14679] — pruned Nemotron-4, GQA 32H/8KV."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128,
    tie_embeddings=False, dtype="bfloat16", source="arXiv:2407.14679",
)
