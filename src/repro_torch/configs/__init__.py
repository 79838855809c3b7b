"""Architecture registry: ``--arch <id>`` resolves through ARCHS."""
from .base import INPUT_SHAPES, InputShape, ModelConfig, reduced_for_smoke
from .gemma2_9b import CONFIG as GEMMA2_9B
from .mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from .granite_moe_1b import CONFIG as GRANITE_MOE_1B
from .mamba2_780m import CONFIG as MAMBA2_780M
from .internvl2_1b import CONFIG as INTERNVL2_1B
from .whisper_tiny import CONFIG as WHISPER_TINY
from .smollm_135m import CONFIG as SMOLLM_135M
from .minitron_8b import CONFIG as MINITRON_8B
from .qwen15_05b import CONFIG as QWEN15_05B
from .zamba2_27b import CONFIG as ZAMBA2_27B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        GEMMA2_9B, MIXTRAL_8X22B, GRANITE_MOE_1B, MAMBA2_780M, INTERNVL2_1B,
        WHISPER_TINY, SMOLLM_135M, MINITRON_8B, QWEN15_05B, ZAMBA2_27B,
    ]
}

# long_500k requires sub-quadratic attention (see DESIGN.md §8): run it for
# SSM/hybrid and for SWA-capable archs; skip pure full-attention archs.
LONG_CONTEXT_ARCHS = {"mamba2-780m", "zamba2-2.7b", "gemma2-9b", "mixtral-8x22b"}

def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(
            f"unknown arch {name!r}; the config zoo has: "
            + ", ".join(sorted(ARCHS)))
    return ARCHS[name]

def shape_supported(arch: str, shape: str) -> bool:
    """Whether (arch × input-shape) is in the supported matrix (DESIGN.md §8)."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True

__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "get_arch", "reduced_for_smoke", "shape_supported"]
