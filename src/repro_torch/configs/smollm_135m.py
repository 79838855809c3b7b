"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small, GQA 9H/3KV."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", arch_type="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152,
    dtype="bfloat16", source="hf:HuggingFaceTB/SmolLM-135M",
)
