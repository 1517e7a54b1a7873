"""Functional decoder-only transformer over a plain parameter dict.

Port of ``fusioninfer_tpu/models/transformer.py`` (dense path).  Layer
weights are stacked on a leading ``n_layers`` axis and kept in the JAX
package's ``[in, out]`` layout, so ``x @ w`` reads the same on both
sides; the forward loops over layers in Python where the JAX package
scans.  Every projection goes through :func:`ops.gemm.matmul` and every
norm through :func:`ops.rms_norm.rms_norm`: on the card their kernels
reduce each row in an order fixed by the weight's shape, so a row's bits
never depend on how many rows share the forward; on the CPU they are
``x @ w`` and the plain norm.  Attention goes through
:mod:`fusioninfer_tpu_torch.ops.flash_attention`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fusioninfer_tpu_torch.models.config import ModelConfig
from fusioninfer_tpu_torch.ops.flash_attention import flash_attention
from fusioninfer_tpu_torch.ops.gemm import matmul
from fusioninfer_tpu_torch.ops.rms_norm import rms_norm

Params = dict


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) ``[..., seq, 1, head_dim/2]`` for ``positions [..., seq]``.
    Eager PyTorch does not hoist loop invariants as XLA does, so a forward
    builds these once and every layer's q and k reuse them."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, rope) -> torch.Tensor:
    """Rotary embedding, NeoX half-rotation layout, from
    :func:`rope_tables`.  x: [..., seq, heads, head_dim]."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding at ``positions [..., seq]``."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def swiglu(x, w_gate, w_up, w_down):
    return matmul(F.silu(matmul(x, w_gate)) * matmul(x, w_up), w_down)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens]


def layer_params(params: Params, l: int) -> Params:
    """Views of layer ``l``'s weights (no copy)."""
    return {name: w[l] for name, w in params["layers"].items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random-init parameters on ``device``, layer weights stacked on axis
    0, drawn from ``generator`` (which must live on ``device``).  Same
    shapes and scaling as the JAX package's ``init_params``; the numbers
    differ (different generators)."""
    cfg.validate()
    dtype = cfg.torch_dtype
    L, D, H, KV, Hd, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)

    def dense(shape, fan_in):
        # draw in slabs of at most 2**26 values so a full-width model
        # never holds a whole f32 copy of a weight
        out = torch.empty(shape, dtype=dtype, device=device)
        row = 1
        for n in shape[1:]:
            row *= n
        step = max(1, (1 << 26) // row)
        for i in range(0, shape[0], step):
            w = torch.randn((min(step, shape[0] - i), *shape[1:]),
                            generator=generator, dtype=torch.float32,
                            device=device)
            out[i:i + step] = (w / fan_in ** 0.5).to(dtype)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones(L, D),
        "wq": dense((L, D, H * Hd), D),
        "wk": dense((L, D, KV * Hd), D),
        "wv": dense((L, D, KV * Hd), D),
        "wo": dense((L, H * Hd, D), H * Hd),
        "mlp_norm": ones(L, D),
        "w_gate": dense((L, D, Fd), D),
        "w_up": dense((L, D, Fd), D),
        "w_down": dense((L, Fd, D), Fd),
    }
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, Hd)
        layers["k_norm"] = ones(L, Hd)
    params = {
        "embed": dense((cfg.vocab_size, D), D),
        "layers": layers,
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size), D)
    return params


def qkv_proj(cfg: ModelConfig, layer: Params, x: torch.Tensor, rope):
    """Pre-norm + QKV projection + QK-norm + RoPE, shared by every path.
    x: [B, S, D], ``rope`` from :func:`rope_tables` at the tokens'
    positions → q [B, S, H, Hd], k/v [B, S, KV, Hd]."""
    B, S, _ = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    q = matmul(h, layer["wq"]).reshape(B, S, H, Hd)
    k = matmul(h, layer["wk"]).reshape(B, S, KV, Hd)
    v = matmul(h, layer["wv"]).reshape(B, S, KV, Hd)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.rms_eps)
        k = rms_norm(k, layer["k_norm"], cfg.rms_eps)
    return rotate(q, rope), rotate(k, rope), v


def mlp_block(cfg: ModelConfig, layer: Params, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm + dense SwiGLU; residual NOT added."""
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    return swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"])


def layer_forward(cfg: ModelConfig, layer: Params, x: torch.Tensor, rope):
    """One block of fresh causal self-attention → (output, (k, v))."""
    q, k, v = qkv_proj(cfg, layer, x, rope)
    attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, window=cfg.sliding_window)
    x = x + matmul(attn, layer["wo"])
    return x + mlp_block(cfg, layer, x), (k, v)


def lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Hidden states → f32 logits; tied embeddings use the transposed table
    (on the card a contiguous copy of it, :func:`tied_head`)."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return matmul(x, head).float()


def tied_head(params: Params) -> Params:
    """``params`` with a tied model's head as a contiguous ``[D, V]`` copy of
    the embedding table's transpose, which the GEMM kernel reads in place;
    a model with its own head is returned as it is."""
    if "lm_head" in params:
        return params
    return {**params, "lm_head": params["embed"].T.contiguous()}


def hidden_states(cfg: ModelConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal trunk → final hidden states [B, S, D]."""
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    rope = rope_tables(torch.arange(S, device=tokens.device), cfg.head_dim,
                       cfg.rope_theta)
    for l in range(cfg.n_layers):
        x, _ = layer_forward(cfg, layer_params(params, l), x, rope)
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward → logits [B, S, V] (no KV cache)."""
    return lm_head(cfg, params, hidden_states(cfg, params, tokens))
