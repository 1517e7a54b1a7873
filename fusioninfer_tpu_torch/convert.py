"""Carry the JAX package's parameter tree into the port.

``params_from_jax`` takes the tree ``fusioninfer_tpu.models.transformer.
init_params`` builds (leaves as numpy arrays: ``embed``,
``layers.{attn_norm,wq,wk,wv,wo,mlp_norm,q_norm,k_norm,w_gate,w_up,
w_down}`` stacked on axis 0, ``final_norm``, and ``lm_head`` when
untied) and returns the port's dict on ``device``.  Both packages keep
weights ``[in, out]``, so nothing is transposed.  This module never
imports JAX: callers convert leaves with ``numpy.asarray`` first.
"""

from __future__ import annotations

import numpy as np
import torch

from fusioninfer_tpu_torch.models.config import ModelConfig

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device,
                                                         dtype=dtype)


def params_from_jax(tree: dict, cfg: ModelConfig, device) -> dict:
    cfg.validate()
    dtype = cfg.torch_dtype
    layer_keys = _LAYER_KEYS + (("q_norm", "k_norm") if cfg.qk_norm else ())
    layers = tree["layers"]
    missing = [k for k in layer_keys if k not in layers]
    if missing:
        raise KeyError(f"JAX layer tree lacks {missing}")
    out = {
        "embed": _tensor(tree["embed"], dtype, device),
        "layers": {k: _tensor(layers[k], dtype, device) for k in layer_keys},
        "final_norm": _tensor(tree["final_norm"], dtype, device),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(tree["lm_head"], dtype, device)
    wq = out["layers"]["wq"]
    want = (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    if tuple(wq.shape) != want:
        raise ValueError(f"wq shape {tuple(wq.shape)} does not match {cfg.name} {want}")
    return out
