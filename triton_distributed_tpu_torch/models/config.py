"""Model configuration — the port's own copy of the JAX package's
``models/config.py`` (a plain dataclass with Qwen3-family presets; the
port imports nothing of the JAX package, not even host-only modules)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Dense (or MoE) decoder-only transformer shape.

    Defaults follow the Qwen3 family (qk-norm GQA, SwiGLU, untied lm_head
    for the larger variants).
    """

    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_layers: int = 4
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 64
    vocab_size: int = 1024
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    qk_norm: bool = True           # Qwen3 per-head q/k RMSNorm
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    # MoE (0 experts = dense). The port's first slice serves dense models.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


# Published Qwen3 shapes (config.json of the HF checkpoints).
QWEN3_8B = ModelConfig(
    hidden_size=4096, intermediate_size=12288, num_layers=36,
    num_heads=32, num_kv_heads=8, head_dim=128, vocab_size=151_936,
)

QWEN3_4B = ModelConfig(
    hidden_size=2560, intermediate_size=9728, num_layers=36,
    num_heads=32, num_kv_heads=8, head_dim=128, vocab_size=151_936,
    tie_word_embeddings=True,
)

QWEN3_14B = ModelConfig(
    hidden_size=5120, intermediate_size=17_408, num_layers=40,
    num_heads=40, num_kv_heads=8, head_dim=128, vocab_size=151_936,
)

QWEN3_32B = ModelConfig(
    hidden_size=5120, intermediate_size=25_600, num_layers=64,
    num_heads=64, num_kv_heads=8, head_dim=128, vocab_size=151_936,
)

QWEN3_30B_A3B = ModelConfig(  # Qwen3-MoE: 128 experts, top-8
    hidden_size=2048, intermediate_size=6144, num_layers=48,
    num_heads=32, num_kv_heads=4, head_dim=128, vocab_size=151_936,
    num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
)


def tiny_config(**overrides) -> ModelConfig:
    """Small config for CPU tests."""
    base = dict(hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=8, num_kv_heads=8, head_dim=16, vocab_size=256,
                dtype="float32")
    base.update(overrides)
    return ModelConfig(**base)
