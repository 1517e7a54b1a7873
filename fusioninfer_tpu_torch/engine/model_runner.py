"""KV-cache-aware prefill and decode (port of the serve path of
``fusioninfer_tpu/engine/model_runner.py``).

* :func:`prefill`: B prompts padded to one bucket length run the causal
  forward (flash attention per layer) while their fresh K/V scatter into
  the sequences' pages; returns logits at each row's last real token.
* :func:`decode_step`: B sequences × one token; each token's K/V lands in
  its page slot, then attention goes through the one ragged dispatch
  (:func:`_ragged_attn`) over the pages in place.

The pool is updated in place (PyTorch tensors are mutable; the JAX
package donates and rebinds).  Layers run as a Python loop where the JAX
package scans.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.engine.kv_cache import CacheConfig
from fusioninfer_tpu_torch.models.config import ModelConfig
from fusioninfer_tpu_torch.models.quantization import kv_quantize
from fusioninfer_tpu_torch.models.transformer import (
    embed_lookup,
    layer_forward,
    layer_params,
    lm_head,
    mlp_block,
    qkv_proj,
    rms_norm,
    rope_tables,
)
from fusioninfer_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_kvsplit,
)


def _scatter_kv(cache: dict, l: int, k: torch.Tensor, v: torch.Tensor,
                write_page: torch.Tensor, write_slot: torch.Tensor,
                head_axis: int) -> None:
    """Write fresh K/V (``[..., KV, Hd]``, head axis at ``head_axis``) into
    layer ``l`` of the head-major pools ``[L, KV, n_pages, ps, Hd]`` in
    place, at ``(write_page, write_slot)`` (int64 index tensors of the
    leading shape).  An int8 pool quantizes on the way; the per-token
    scales land in the squeezed ``[KV, n_pages, ps]`` view of layer
    ``l``'s ``[KV, n_pages, 1, ps]`` scale pool."""
    if "k_scale" in cache:
        (k, k_s), (v, v_s) = kv_quantize(k), kv_quantize(v)
        cache["k_scale"][l, :, :, 0][:, write_page, write_slot] = torch.movedim(
            k_s, head_axis, 0)
        cache["v_scale"][l, :, :, 0][:, write_page, write_slot] = torch.movedim(
            v_s, head_axis, 0)
    cache["k"][l][:, write_page, write_slot] = torch.movedim(k, head_axis, 0).to(
        cache["k"].dtype)
    cache["v"][l][:, write_page, write_slot] = torch.movedim(v, head_axis, 0).to(
        cache["v"].dtype)


def _ragged_attn(q, cache, page_tables, row_starts, q_begins, q_lens, *,
                 layer: int, window, kv_splits: int) -> torch.Tensor:
    """The one ragged dispatch every paged forward routes through: the
    split walk when the engine's static heuristic engaged it
    (``kv_splits > 0``), else the single walk; an int8 pool passes its
    scale pools along."""
    walk = ragged_paged_attention_kvsplit if kv_splits > 0 else ragged_paged_attention
    return walk(q, cache["k"], cache["v"], page_tables, row_starts, q_begins,
                q_lens, cache.get("k_scale"), cache.get("v_scale"),
                window=window, layer=layer)


@torch.no_grad()
def prefill(cfg: ModelConfig, cache_cfg: CacheConfig, params: dict,
            cache: dict, tokens: torch.Tensor, true_lens: torch.Tensor,
            page_rows: torch.Tensor) -> torch.Tensor:
    """Prefill B sequences in one forward → last-token logits [B, V].

    tokens [B, S] (padded to one bucket), true_lens [B], page_rows
    [B, max_pages_per_seq].  Padded positions write to the trash page."""
    B, S = tokens.shape
    ps = cache_cfg.page_size
    x = embed_lookup(params["embed"], tokens)
    token_idx = torch.arange(S, device=tokens.device)
    rope = rope_tables(token_idx, cfg.head_dim, cfg.rope_theta)
    page_of_token = torch.where(
        token_idx[None, :] < true_lens[:, None],
        torch.gather(page_rows, 1, (token_idx // ps).expand(B, S)),
        torch.full_like(page_rows[:, :1], cache_cfg.trash_page),
    ).long()
    slot_of_token = (token_idx % ps).expand(B, S)
    for l in range(cfg.n_layers):
        x, (k, v) = layer_forward(cfg, layer_params(params, l), x, rope)
        _scatter_kv(cache, l, k, v, page_of_token, slot_of_token, head_axis=2)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    last = x[torch.arange(B, device=x.device), (true_lens - 1).clamp(min=0)]
    return lm_head(cfg, params, last)


@torch.no_grad()
def decode_step(cfg: ModelConfig, cache_cfg: CacheConfig, params: dict,
                cache: dict, tokens: torch.Tensor, positions: torch.Tensor,
                page_tables: torch.Tensor, active: torch.Tensor,
                kv_splits: int = 0) -> torch.Tensor:
    """One decode step for the whole batch → logits [B, V].

    tokens [B] (the input token of each row), positions [B] int32 (the
    index it lands at), page_tables [B, max_pages_per_seq] int32, active
    [B] bool; inactive rows write to the trash page and attend nothing."""
    B = tokens.shape[0]
    ps = cache_cfg.page_size
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens)[:, None, :]  # [B, 1, D]
    rows = torch.arange(B, device=dev)
    write_page = torch.where(
        active, page_tables[rows, (positions // ps).long()],
        torch.full_like(positions, cache_cfg.trash_page)).long()
    write_slot = (positions % ps).long()
    rope = rope_tables(positions[:, None], cfg.head_dim, cfg.rope_theta)
    q_begins = rows.to(torch.int32)
    q_lens = active.to(torch.int32)
    for l in range(cfg.n_layers):
        layer = layer_params(params, l)
        q, k, v = qkv_proj(cfg, layer, x, rope)
        _scatter_kv(cache, l, k[:, 0], v[:, 0], write_page, write_slot,
                    head_axis=1)
        attn = _ragged_attn(q[:, 0].contiguous(), cache, page_tables,
                            positions, q_begins, q_lens, layer=l,
                            window=cfg.sliding_window, kv_splits=kv_splits)
        x = x + attn[:, None, :] @ layer["wo"]
        x = x + mlp_block(cfg, layer, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return lm_head(cfg, params, x[:, 0])


def prefill_buckets(max_len: int, smallest: int = 32) -> list[int]:
    """Power-of-two padding buckets up to ``max_len``."""
    out = []
    b = smallest
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def pick_bucket(buckets: list[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds max bucket {buckets[-1]}")
