"""Functional decoder-only transformer over a plain parameter dict.

Port of ``fusioninfer_tpu/models/transformer.py`` (dense path).  Layer
weights are stacked on a leading ``n_layers`` axis and kept in the JAX
package's ``[in, out]`` layout, so ``x @ w`` reads the same on both
sides; the forward loops over layers in Python where the JAX package
scans.  Every projection goes through :func:`ops.gemm.matmul` and every
norm through :mod:`ops.rms_norm`: on the card their kernels reduce each
row in an order fixed by the weight's shape, so a row's bits never
depend on how many rows share the forward; on the CPU they are ``x @ w``
and the plain norm.  A norm runs fused into its neighbours: the first
layer's attention norm alone (:func:`rms_norm`), every other one with
the residual add before it (:func:`add_rms_norm`, whose normed output
the loop carries into the next block), and the q and k norms with RoPE
and the K/V page write (:func:`qk_norm_rope_kv`).  Attention goes
through :mod:`fusioninfer_tpu_torch.ops.flash_attention`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fusioninfer_tpu_torch.models.config import ModelConfig
from fusioninfer_tpu_torch.ops.flash_attention import flash_attention
from fusioninfer_tpu_torch.ops.gemm import matmul
from fusioninfer_tpu_torch.ops.rms_norm import add_rms_norm, qk_norm_rope_kv, rms_norm, rotate

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


def qkv_proj(cfg: ModelConfig, layer: Params, h: torch.Tensor, rope, *,
             k_out: bool = True, pages: dict | None = None):
    """QKV projection of the attention-normed hidden states ``h [..., D]``,
    then QK-norm and RoPE (and, with ``pages``, the K/V page write: the
    keywords ``cache``, ``layer``, ``write_page``, ``write_slot`` of
    :func:`qk_norm_rope_kv`) in one launch, shared by every path.  ``rope``
    from :func:`rope_tables` at the tokens' positions → q [..., H, Hd], k
    [..., KV, Hd] (None without ``k_out``), v [..., KV, Hd]."""
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = h.shape[:-1]
    q = matmul(h, layer["wq"]).reshape(*lead, H, Hd)
    k = matmul(h, layer["wk"]).reshape(*lead, KV, Hd)
    v = matmul(h, layer["wv"]).reshape(*lead, KV, Hd)
    norms = (layer["q_norm"], layer["k_norm"]) if cfg.qk_norm else (None, None)
    q, k = qk_norm_rope_kv(q, k, v, *norms, rope, cfg.rms_eps, k_out=k_out,
                           **(pages or {}))
    return q, k, v


def mlp_block(cfg: ModelConfig, layer: Params, h: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU of the MLP-normed hidden states ``h``; residual NOT
    added (the caller adds it in :func:`add_rms_norm` with the next norm)."""
    return swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"])


def next_norm(params: Params, l: int) -> torch.Tensor:
    """The norm after layer ``l``: layer ``l + 1``'s attention norm, or the
    final norm after the last layer."""
    norms = params["layers"]["attn_norm"]
    return norms[l + 1] if l + 1 < norms.shape[0] else params["final_norm"]


def layer_forward(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                  h: torch.Tensor, rope, after: torch.Tensor, pages: dict | None = None):
    """One block of fresh causal self-attention over the residual stream
    ``x [B, S, D]``, ``h`` its attention-normed form → ``(x', h')``: the
    stream after the block and ``x'`` normed by ``after``
    (:func:`next_norm`); with ``pages`` (see :func:`qkv_proj`) the
    block's K/V land in the pages."""
    q, k, v = qkv_proj(cfg, layer, h, rope, pages=pages)
    attn = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    x, h = add_rms_norm(x, matmul(attn, layer["wo"]), layer["mlp_norm"], cfg.rms_eps)
    return add_rms_norm(x, mlp_block(cfg, layer, h), after, cfg.rms_eps)


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
    h = rms_norm(x, params["layers"]["attn_norm"][0], cfg.rms_eps)
    for l in range(cfg.n_layers):
        x, h = layer_forward(cfg, layer_params(params, l), x, h, rope,
                             next_norm(params, l))
    return h


@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward → logits [B, S, V] (no KV cache)."""
    return lm_head(cfg, params, hidden_states(cfg, params, tokens))
