"""Model architecture configs (own copy of the JAX package's presets).

Dense decoder-only transformers in the Qwen3 family: QK-norm, GQA,
SwiGLU, RoPE.  Only the presets the ported serve path uses are kept:
``qwen3-tiny`` (tests) and ``qwen3-8b`` (the full-width model served on
the card).  The MoE fields stay so a config reads like its JAX
counterpart, but this port serves dense models only and refuses MoE.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "qwen3-tiny"
    vocab_size: int = 4096
    d_model: int = 256
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 512
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    qk_norm: bool = True  # Qwen3-style per-head RMSNorm on Q and K
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    max_seq_len: int = 4096
    # mixture of experts (0 experts == dense); not served by this port
    n_experts: int = 0
    n_experts_active: int = 2
    moe_d_ff: int = 0
    # sliding-window attention: each token attends to the previous
    # `sliding_window` positions (itself included); None = full causal
    sliding_window: int | None = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def validate(self) -> "ModelConfig":
        if self.n_heads % self.n_kv_heads:
            raise ValueError("GQA requires n_heads % n_kv_heads == 0")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError("sliding_window must be >= 1")
        if self.is_moe:
            raise NotImplementedError(
                f"{self.name}: mixture-of-experts models are not ported yet")
        return self


_PRESETS: dict[str, ModelConfig] = {}


def register_preset(cfg: ModelConfig) -> ModelConfig:
    _PRESETS[cfg.name] = cfg.validate()
    return cfg


def get_preset(name: str) -> ModelConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown model preset {name!r}; known: {sorted(_PRESETS)}") from None


# Tiny config: CPU parity tests.
register_preset(ModelConfig(name="qwen3-tiny"))

# Qwen3-8B shapes: the model `engine serve` brings up on one H100.
register_preset(
    ModelConfig(
        name="qwen3-8b",
        vocab_size=151_936,
        d_model=4096,
        n_layers=36,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12_288,
        qk_norm=True,
        tie_embeddings=False,
        max_seq_len=32_768,
    )
)
