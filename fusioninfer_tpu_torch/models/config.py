"""Model architecture configs (own copy of the JAX package's presets).

Dense decoder-only transformers: GQA, SwiGLU, RoPE, with the Qwen3
family's QK-norm and the Mistral family's sliding window.  The dense
presets of the JAX package are kept field for field: ``qwen3-tiny`` and
``mistral-tiny`` (tests), ``qwen3-1.7b`` (tied head, the JAX bench's
batch-32 model), ``qwen3-8b`` and ``mistral-7b`` (window 4096).  The MoE
fields stay so a config reads like its JAX counterpart, but this port
serves dense models only: the MoE presets and ``llama3-70b`` (which needs
tensor parallelism) are known by name and refused.
:func:`config_from_hf` derives a config from a HuggingFace
``config.json`` (:mod:`models.loader` reads the weights).
"""

from __future__ import annotations

import dataclasses
import json
import os

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

# presets of the JAX package this port does not serve yet, with what they
# wait for (ROADMAP queue 1)
_MOE_WAITS = "mixture-of-experts models wait for the MoE port (ROADMAP queue 1 item 9)"
_NOT_PORTED = {
    "moe-tiny": _MOE_WAITS,
    "qwen3-30b-a3b": _MOE_WAITS,
    "llama3-70b": "141 GB of bf16 weights need tensor parallelism (ROADMAP queue 1 item 10)",
}


def register_preset(cfg: ModelConfig) -> ModelConfig:
    _PRESETS[cfg.name] = cfg.validate()
    return cfg


def get_preset(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name}: {_NOT_PORTED[name]}")
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown model preset {name!r}; known: {sorted(_PRESETS)}") from None


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def config_from_hf(path: str, name: str | None = None) -> ModelConfig:
    """A :class:`ModelConfig` from the HuggingFace ``config.json`` under
    ``path``, read as the JAX package's ``config_from_hf`` reads it
    (QK-norm for the Qwen3 family, the window of Mistral-family configs
    unless ``use_sliding_window`` is false).  MoE and quantized
    checkpoints raise ``NotImplementedError``."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    if int(hf.get("num_experts") or hf.get("num_local_experts") or 0):
        raise NotImplementedError(f"{path}: {_MOE_WAITS}")
    if hf.get("quantization_config"):
        raise NotImplementedError(
            f"{path}: quantized checkpoints wait for int8 weights (ROADMAP queue 1 item 7)")
    arch = (hf.get("architectures") or [""])[0].lower()
    qk_norm = "qwen3" in arch or "qwen3" in str(hf.get("model_type", "")).lower()
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    return ModelConfig(
        name=name or hf.get("fusioninfer_name") or hf.get("model_type", "hf-model"),
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        d_ff=hf["intermediate_size"],
        rope_theta=float(hf.get("rope_theta", 10_000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
        qk_norm=qk_norm,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        max_seq_len=int(hf.get("max_position_embeddings", 4096)),
        sliding_window=((hf.get("sliding_window") or None)
                        if hf.get("use_sliding_window", True) else None),
    ).validate()


# Tiny configs: CPU parity tests.
register_preset(ModelConfig(name="qwen3-tiny"))
register_preset(
    ModelConfig(
        name="mistral-tiny",
        qk_norm=False,
        tie_embeddings=False,
        rope_theta=10_000.0,
        sliding_window=24,  # small enough that tests exercise the window
    )
)

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

# Qwen3-1.7B shapes: tied head, GQA group 2; the JAX bench's batch-32 model.
register_preset(
    ModelConfig(
        name="qwen3-1.7b",
        vocab_size=151_936,
        d_model=2048,
        n_layers=28,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        qk_norm=True,
        tie_embeddings=True,
        max_seq_len=32_768,
    )
)

# Mistral-7B shapes: no QK-norm, each token attends to the trailing 4096
# positions, so a sequence's pages below that window are freed as it decodes.
register_preset(
    ModelConfig(
        name="mistral-7b",
        vocab_size=32_768,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        rope_theta=1_000_000.0,
        qk_norm=False,
        tie_embeddings=False,
        max_seq_len=32_768,
        sliding_window=4096,
    )
)
