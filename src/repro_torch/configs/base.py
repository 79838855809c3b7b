"""Architecture config schema. One frozen dataclass per assigned architecture
lives in ``repro_torch/configs/<id>.py`` with the exact figures from the
assignment (source paper / model card cited in each file). A copy of the JAX
package's configs: plain dataclasses, no framework imports.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["ModelConfig", "reduced_for_smoke", "INPUT_SHAPES", "InputShape"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int            # 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 → d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- attention flavor ---
    sliding_window: int = 0           # 0 → full attention
    attn_pattern: str = "global"      # global | local_global (gemma2) | swa (mixtral)
    logit_softcap: float = 0.0        # final-logit softcap (gemma2: 30)
    attn_logit_softcap: float = 0.0   # attention-score softcap (gemma2: 50)
    qkv_bias: bool = False            # qwen1.5
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0        # one SHARED attention block every N mamba blocks
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend stubs (brief's carve-out) ---
    frontend: str = ""                # "" | "vision" | "audio"
    frontend_tokens: int = 0          # patch/frame embeddings provided by input_specs
    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: str = "float32"            # activation/param dtype for smoke tests
    source: str = ""                  # citation from the assignment

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests:
    2 layers, d_model ≤ 512 (usually 128), ≤ 4 experts, small vocab."""
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    if heads:
        ratio = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
        kv = max(heads // ratio, 1)
        while heads % kv:  # keep GQA grouping exact
            kv -= 1
    else:
        kv = 0
    d_model = 128
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=max(kv, 1) if heads else 0,
        head_dim=(d_model // heads if heads else 0),
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",
    )
    if cfg.num_experts:
        kw["num_experts"] = min(cfg.num_experts, 4)
        kw["experts_per_token"] = min(cfg.experts_per_token, 2)
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
        kw["ssm_head_dim"] = 32
        kw["ssm_chunk"] = 32
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
        kw["num_layers"] = 4
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.frontend_tokens:
        kw["frontend_tokens"] = 8
    return replace(cfg, name=cfg.name + "-smoke", **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
