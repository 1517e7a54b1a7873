"""HuggingFace safetensors checkpoints (port of the HF half of
``fusioninfer_tpu/models/loader.py``).

* :func:`load_hf_checkpoint`: a HuggingFace-format directory
  (``*.safetensors`` + ``config.json``) of a dense Qwen3-, Llama- or
  Mistral-family decoder → ``(cfg, params)``, the parameter dict of
  :func:`models.transformer.init_params` on ``device``: HF ``[out, in]``
  linears become ``[in, out]``, layers stack on axis 0, a tied model has
  no ``lm_head``.
* :func:`save_hf_checkpoint`: the inverse, with the JAX package's tensor
  names and ``config.json`` keys, so each package reads the other's files.
* :func:`config_from_hf` (re-exported from :mod:`models.config`).

The ``safetensors`` package is not used (the card's machine has none):
the format is read and written here.  A file is an 8-byte little-endian
header length, a JSON header ``{name: {"dtype", "shape", "data_offsets":
[begin, end]}}`` (offsets into the data after the header, padded with
spaces to 8 bytes), then the raw little-endian tensors.  ``F32``,
``BF16`` and ``F16`` are handled; numpy has no bfloat16, so BF16 passes
through an ``int16`` view.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch

from fusioninfer_tpu_torch.models.config import ModelConfig, config_from_hf

__all__ = ["config_from_hf", "load_hf_checkpoint", "save_hf_checkpoint"]

Params = dict

# safetensors dtype tag -> (numpy dtype of the raw bytes, torch dtype)
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
}
_TAGS = {t: tag for tag, (_, t) in _DTYPES.items()}

# HF tensor-name suffix -> (the port's layer key, transpose?)
_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}

_TOP_MAP = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}


# -- the safetensors format ----------------------------------------------------


def _read_header(path: str) -> tuple[dict, int]:
    """``({name: entry}, offset of the data)`` of one safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _tensors(path: str):
    """Yield ``(name, CPU tensor)`` over every ``*.safetensors`` file under
    ``path``, in file order, each tensor a view of a copy-on-write map of
    its file."""
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    for fp in files:
        header, start = _read_header(fp)
        data = np.memmap(fp, dtype=np.uint8, mode="c", offset=start)
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise ValueError(f"{fp}: {name} has dtype {e['dtype']}; "
                                 f"handled: {sorted(_DTYPES)}")
            raw, dtype = _DTYPES[e["dtype"]]
            begin, end = e["data_offsets"]
            arr = data[begin:end].view(raw).reshape(e["shape"])
            yield name, torch.from_numpy(arr).view(dtype)


def _write_safetensors(path: str, tensors: list[tuple[str, torch.Tensor]]) -> None:
    """Write ``[(name, tensor)]`` (CPU or device tensors of F32 / BF16 /
    F16) as one safetensors file, one tensor in host memory at a time."""
    header, offset = {}, 0
    for name, t in tensors:
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors tag here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in tensors:
            host = t.detach().contiguous().cpu()
            f.write(host.view(torch.uint8).reshape(-1).numpy().data)


# -- loading -------------------------------------------------------------------


def load_hf_checkpoint(path: str, cfg: ModelConfig | None = None,
                       dtype: str | None = None,
                       device=None) -> tuple[ModelConfig, Params]:
    """A dense HF decoder checkpoint → ``(cfg, params)`` on ``device``
    (None: ``cuda``, raising without it).  ``cfg`` defaults to
    :func:`config_from_hf`; ``dtype`` overrides its dtype, and the
    returned config carries the dtype the parameters are in.  Each stacked
    weight is allocated once on the device and filled a layer at a time,
    so the host holds one HF tensor at a time.  Layers past the config's
    are skipped, as the JAX loader skips them.  A missing layer tensor
    (the q / k norms under a QK-norm config) or a missing ``lm_head``
    under an untied one raises ``ValueError``."""
    from fusioninfer_tpu_torch.engine.engine import resolve_device

    cfg = cfg or config_from_hf(path)
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    cfg.validate()
    dev = resolve_device(device)
    target, L = cfg.torch_dtype, cfg.n_layers
    top: Params = {}
    stacked: dict[str, torch.Tensor] = {}
    seen: dict[str, set[int]] = {}
    for name, t in _tensors(path):
        if name in _TOP_MAP:
            ours, transpose = _TOP_MAP[name]
            t = t.to(dev)
            t = t.T if transpose else t
            top[ours] = torch.empty(t.shape, dtype=target, device=dev).copy_(t)
            continue
        if not name.startswith("model.layers."):
            continue
        idx_s, _, suffix = name[len("model.layers."):].partition(".")
        if suffix not in _LAYER_MAP:
            continue
        ours, transpose = _LAYER_MAP[suffix]
        i = int(idx_s)
        if i >= L:
            continue  # a config of fewer layers loads the first ones
        t = t.to(dev)
        t = t.T if transpose else t
        if ours not in stacked:
            stacked[ours] = torch.empty((L, *t.shape), dtype=target, device=dev)
        stacked[ours][i].copy_(t)
        seen.setdefault(ours, set()).add(i)
    required = [k for k, _ in _LAYER_MAP.values()
                if cfg.qk_norm or k not in ("q_norm", "k_norm")]
    for key in required:
        missing = [i for i in range(L) if i not in seen.get(key, ())]
        if missing:
            raise ValueError(f"checkpoint missing layer tensors {key} for layers {missing}")
    params: Params = {"embed": top["embed"], "layers": stacked,
                      "final_norm": top["final_norm"]}
    if not cfg.tie_embeddings:
        if "lm_head" not in top:
            raise ValueError("config says untied embeddings but checkpoint has no lm_head")
        params["lm_head"] = top["lm_head"]
    return cfg, params


# -- saving --------------------------------------------------------------------


def save_hf_checkpoint(path: str, cfg: ModelConfig, params: Params) -> None:
    """Write ``params`` as an HF checkpoint under ``path``
    (``model.safetensors`` in the parameters' own dtype, ``config.json``
    with the JAX package's keys: ``mistral`` labels for a windowed model
    without QK-norm, ``qwen3`` with it, ``llama`` otherwise).  A tied
    model writes no ``lm_head``, whatever ``params`` holds."""
    cfg.validate()
    os.makedirs(path, exist_ok=True)
    tensors: list[tuple[str, torch.Tensor]] = []
    for name, (ours, transpose) in _TOP_MAP.items():
        if ours == "lm_head" and cfg.tie_embeddings:
            continue
        t = params[ours]
        tensors.append((name, t.T if transpose else t))
    for suffix, (ours, transpose) in _LAYER_MAP.items():
        if ours not in params["layers"]:
            continue
        for i in range(cfg.n_layers):
            t = params["layers"][ours][i]
            tensors.append((f"model.layers.{i}.{suffix}", t.T if transpose else t))
    _write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    hf_cfg = {
        "architectures": ["Qwen3ForCausalLM" if cfg.qk_norm else "LlamaForCausalLM"],
        "model_type": "qwen3" if cfg.qk_norm else "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.d_ff,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "max_position_embeddings": cfg.max_seq_len,
        "fusioninfer_name": cfg.name,
    }
    if cfg.sliding_window is not None:
        hf_cfg["sliding_window"] = cfg.sliding_window
        if not cfg.qk_norm:
            # HF consumers honor the window only under the mistral labels
            hf_cfg["architectures"] = ["MistralForCausalLM"]
            hf_cfg["model_type"] = "mistral"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
