"""Gemma-2 9B [arXiv:2408.00118] — dense, local+global alternating attention,
attention-score softcap 50, final-logit softcap 30, GQA 16H/8KV, head_dim 256."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", arch_type="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
    d_ff=14336, vocab_size=256000, head_dim=256,
    sliding_window=4096, attn_pattern="local_global",
    logit_softcap=30.0, attn_logit_softcap=50.0,
    dtype="bfloat16", source="arXiv:2408.00118",
)
