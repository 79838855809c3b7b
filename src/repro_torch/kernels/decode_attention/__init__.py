"""Single-token GQA attention over a KV cache (``csrc/decode_attention.cu``)."""
from . import ops  # noqa: F401
