"""Whisper tiny [arXiv:2212.04356] — encoder-decoder audio backbone; the
mel-spectrogram + conv frontend is a STUB per the brief: input_specs provides
1500 precomputed frame embeddings. Decoder positions use RoPE (repro liberty,
see DESIGN.md §8)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, cross_attention=True,
    frontend="audio", frontend_tokens=1500,
    dtype="float32", source="arXiv:2212.04356",
)
