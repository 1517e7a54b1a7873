"""KV-cache-aware forwards (port of the serve path of
``fusioninfer_tpu/engine/model_runner.py``).

* :func:`prefill`: B fresh prompts padded to one bucket length run the
  causal forward (flash attention per layer) while their fresh K/V
  scatter into the sequences' pages; returns logits at each row's last
  real token.
* :func:`fused_step`: ONE forward over a flat ragged token axis that
  carries decode rows and prefill-chunk rows (cache-hit suffixes, chunk
  advances, or both beside decode rows); each token's K/V lands in its
  page slot, then attention goes through the one ragged dispatch
  (:func:`_ragged_attn`) over the pages in place.  Every engine forward
  that reads paged context comes here.
* :func:`decode_step`: the zero-chunk case of :func:`fused_step`, one
  token per batch slot.
* :func:`decode_burst`: ``n_steps`` decode + sample steps with the
  sampled tokens fed back on the device (the JAX package's
  ``decode_burst``); :mod:`engine.graphs` replays it as a CUDA graph.

The pool is updated in place (PyTorch tensors are mutable; the JAX
package donates and rebinds).  Layers run as a Python loop where the JAX
package scans.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.engine.kv_cache import CacheConfig
from fusioninfer_tpu_torch.engine.sampler import apply_penalties, sample
from fusioninfer_tpu_torch.models.config import ModelConfig
from fusioninfer_tpu_torch.models.transformer import (
    add_rms_norm,
    embed_lookup,
    layer_forward,
    layer_params,
    lm_head,
    mlp_block,
    next_norm,
    qkv_proj,
    rms_norm,
    rope_tables,
)
from fusioninfer_tpu_torch.ops.gemm import matmul
from fusioninfer_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_kvsplit,
    ragged_token_rows,
)


def _ragged_attn(q, cache, page_tables, row_starts, q_begins, q_lens, *,
                 layer: int, window, kv_splits: int,
                 cluster: int | None = None) -> torch.Tensor:
    """The one ragged dispatch every paged forward routes through: the
    split walk when the engine's static heuristic engaged it
    (``kv_splits > 0``), else the single walk at the engine's fixed
    ``cluster`` size; an int8 pool passes its scale pools along."""
    scales = (cache.get("k_scale"), cache.get("v_scale"))
    if kv_splits > 0:
        return ragged_paged_attention_kvsplit(
            q, cache["k"], cache["v"], page_tables, row_starts, q_begins,
            q_lens, *scales, window=window, layer=layer)
    return ragged_paged_attention(
        q, cache["k"], cache["v"], page_tables, row_starts, q_begins, q_lens,
        *scales, window=window, layer=layer, cluster=cluster)


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
    slot_of_token = (token_idx % ps).repeat(B, 1)
    h = rms_norm(x, params["layers"]["attn_norm"][0], cfg.rms_eps)
    for l in range(cfg.n_layers):
        # the layer's fresh K/V land in its pages inside qkv_proj's launch
        x, h = layer_forward(cfg, layer_params(params, l), x, h, rope,
                             next_norm(params, l),
                             dict(cache=cache, layer=l, write_page=page_of_token,
                                  write_slot=slot_of_token))
    last = h[torch.arange(B, device=h.device), (true_lens - 1).clamp(min=0)]
    return lm_head(cfg, params, last)


@torch.no_grad()
def fused_step(cfg: ModelConfig, cache_cfg: CacheConfig, params: dict,
               cache: dict, tokens: torch.Tensor, row_starts: torch.Tensor,
               q_begins: torch.Tensor, q_lens: torch.Tensor,
               page_tables: torch.Tensor, sel: torch.Tensor,
               chunk_sel: torch.Tensor, kv_splits: int = 0,
               cluster: int | None = None, *, n_tokens: int):
    """ONE weight pass over a flat ragged token axis → ``(logits [B, W,
    V], chunk_logits [NC, V])``.

    tokens [T] (the flat axis, :func:`engine.fused.pack_ragged_batch`);
    per row ``r``: row_starts [R] int32 (global position of its token 0),
    q_begins [R] int32 (flat offset of its segment), q_lens [R] int32 (its
    token count, 0 = inert), page_tables [R, mp] int32; sel [B, W] the
    decode slots' flat window indices, chunk_sel [NC] the chunk rows' flat
    last-token indices.  Tokens in no row write to the trash page and
    attend nothing.

    Decode rows (one token), cache-hit suffixes and prefill chunks (many
    tokens from a mid-sequence start) ride one embed → layers → lm_head
    pass; attention is the one ragged dispatch, whose per-token bits do
    not depend on the other rows (the split walk's fixed chunks, the
    single walk's fixed ``cluster``).  The two groups project through
    SEPARATE lm_head calls, the decode group ``[B·W, D]`` (constant per
    engine) and the chunk group ``[NC, D]`` (the power-of-two chunk
    count).

    ``n_tokens``: the rows of the flat axis the forward runs over, a
    prefix of it (the engine passes the live packed tokens; the pow2
    padding after them launches nothing).  On the card every projection
    and norm reduces each row in an order fixed by the weight's shape
    (:mod:`ops.gemm`, :mod:`ops.rms_norm`) and the walks' per-token bits
    do not depend on the other rows, so a row's logits are the same
    whatever else rides the forward: alone, in a batch, beside a chunk
    or beside spec windows, as on the CPU."""
    T = n_tokens
    tokens = tokens[:T]
    ps = cache_cfg.page_size
    dev = tokens.device
    row_of, off, live = ragged_token_rows(q_begins, q_lens, T)
    positions = torch.where(live, row_starts[row_of] + off,
                            torch.zeros_like(off))
    tables_tok = page_tables[row_of]  # [T, mp]: each token's row's pages
    write_page = torch.where(
        live, tables_tok[torch.arange(T, device=dev), (positions // ps).long()],
        torch.full_like(positions, cache_cfg.trash_page)).long()
    write_slot = (positions % ps).long()
    x = embed_lookup(params["embed"], tokens)  # [T, D]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    h = rms_norm(x, params["layers"]["attn_norm"][0], cfg.rms_eps)
    for l in range(cfg.n_layers):
        layer = layer_params(params, l)
        # q [T, H, Hd], the walk's layout; k and v go straight to the pages
        q, _, _ = qkv_proj(cfg, layer, h, rope, k_out=False,
                           pages=dict(cache=cache, layer=l, write_page=write_page,
                                      write_slot=write_slot))
        attn = _ragged_attn(q, cache, page_tables, row_starts, q_begins, q_lens,
                            layer=l, window=cfg.sliding_window, kv_splits=kv_splits,
                            cluster=cluster)
        x, h = add_rms_norm(x, matmul(attn, layer["wo"]), layer["mlp_norm"], cfg.rms_eps)
        x, h = add_rms_norm(x, mlp_block(cfg, layer, h), next_norm(params, l), cfg.rms_eps)
    # h [T, D]: the final norm of the last layer's stream
    idx = sel.long().clamp(0, T - 1)  # [B, W]
    V = cfg.vocab_size
    chunk_logits = (lm_head(cfg, params, h[chunk_sel.long().clamp(0, T - 1)])
                    if chunk_sel.shape[0] else h.new_zeros((0, V), dtype=torch.float32))
    logits = lm_head(cfg, params, h[idx.reshape(-1)])
    return logits.reshape(*idx.shape, logits.shape[-1]), chunk_logits


def decode_step(cfg: ModelConfig, cache_cfg: CacheConfig, params: dict,
                cache: dict, tokens: torch.Tensor, positions: torch.Tensor,
                page_tables: torch.Tensor, active: torch.Tensor,
                kv_splits: int = 0, cluster: int | None = None) -> torch.Tensor:
    """One decode step for the whole batch → logits [B, V]: the
    zero-chunk :func:`fused_step`, token ``b`` being slot ``b``'s input,
    all B rows through the GEMMs and the walk (``q_len = active``), as
    the JAX ``decode_step`` scores them.

    tokens [B] (the input token of each row), positions [B] int32 (the
    index it lands at), page_tables [B, max_pages_per_seq] int32, active
    [B] bool; inactive rows write to the trash page and attend nothing."""
    rows = torch.arange(tokens.shape[0], dtype=torch.int32, device=tokens.device)
    logits, _ = fused_step(cfg, cache_cfg, params, cache, tokens, positions,
                           rows, active.to(torch.int32), page_tables,
                           rows[:, None], rows[:0], kv_splits, cluster,
                           n_tokens=tokens.shape[0])
    return logits[:, 0]


# ctl_i / ctl_f column layout of decode_burst's packed control tensors:
# every per-row scalar rides one int32 and one float32 tensor (the JAX
# package's layout; seeds are uint32 bits in an int32 column, adapter ids
# stay 0 until LoRA is ported)
CTL_I_COLS = ("tokens", "positions", "top_k", "min_tokens", "gen_count",
              "seed_bits", "adapter_id", "active")
CTL_F_COLS = ("temperature", "top_p", "min_p", "presence", "frequency",
              "repetition")


@torch.no_grad()
def decode_burst(cfg: ModelConfig, cache_cfg: CacheConfig, params: dict,
                 cache: dict, ctl_i: torch.Tensor, ctl_f: torch.Tensor,
                 token_counts: torch.Tensor, output_counts: torch.Tensor,
                 suppress: torch.Tensor, page_tables: torch.Tensor,
                 n_steps: int = 8, sample_mode: str = "filtered",
                 kv_splits: int = 0, cluster: int | None = None):
    """``n_steps`` decode + sample steps with on-device token feedback →
    ``(sampled [n_steps, B] int64, next_ctl_i [B, 8] int32)``.

    ``ctl_i`` [B, 8] int32 and ``ctl_f`` [B, 6] f32 hold the rows'
    controls (:data:`CTL_I_COLS`, :data:`CTL_F_COLS`); ``token_counts``,
    ``output_counts`` [B, V] int32 are bumped in place by each active
    row's sampled token, ``suppress`` [B, V] bool is the min-tokens
    stop-id mask; page_tables [B, mp] int32.  Each step runs
    :func:`decode_step` over all B slots (the graph's shapes are fixed), :func:`sampler.apply_penalties`,
    the min-tokens suppression from the device ``gen_count``, and
    :func:`sampler.sample` (static ``sample_mode``) at counter
    ``gen_count``: the single-step path's math, so a burst gives what
    ``n_steps`` sequential decode + sample calls give.  A row whose next
    position falls past its page table is deactivated for the step
    (``pos_ok``): its write goes to the trash page instead of indexing
    past the table.  Rows that finish mid-burst keep decoding until it
    ends; the engine discards those tokens.

    On a sliding-window model a row's table entries below page ``(len -
    window) // page_size`` (``len`` its length at dispatch) are trash
    placeholders: every page this burst touches lies at or above it, a
    step's write at its own position (``>= len - 1``) and its walk from
    the page of key ``pos - window + 1``.

    ``next_ctl_i`` carries the advanced tokens, positions and
    ``gen_count`` (other columns copied): a successor burst dispatches
    from it without a host round trip.  Nothing is read back to the
    host, so :mod:`engine.graphs` captures this call as it stands."""
    # column-major copies: the walk takes the positions as a contiguous
    # int32 row
    cols_i, cols_f = ctl_i.t().contiguous(), ctl_f.t().contiguous()
    tokens, pos, top_k, min_toks, gcounts = cols_i[:5]
    seeds = cols_i[5].long() & 0xFFFF_FFFF
    active = cols_i[7] > 0
    temps, top_ps, min_ps, presence, frequency, repetition = cols_f
    covered = page_tables.shape[1] * cache_cfg.page_size
    sampled = []
    for _ in range(n_steps):
        act = active & (pos < covered)
        logits = decode_step(cfg, cache_cfg, params, cache, tokens, pos,
                             page_tables, act, kv_splits, cluster)
        logits = apply_penalties(logits, token_counts, output_counts,
                                 presence, frequency, repetition)
        logits = logits.masked_fill((gcounts < min_toks)[:, None] & suppress,
                                    float("-inf"))
        tok = sample(logits, temps, top_k, top_ps, min_ps, seeds, gcounts,
                     mode=sample_mode)
        inc = act.to(torch.int32)
        token_counts.scatter_add_(1, tok[:, None], inc[:, None])
        output_counts.scatter_add_(1, tok[:, None], inc[:, None])
        tokens = torch.where(act, tok.to(torch.int32), tokens)
        pos = pos + inc
        gcounts = gcounts + inc
        sampled.append(tok)
    next_ctl = torch.stack([tokens, pos, ctl_i[:, 2], ctl_i[:, 3], gcounts,
                            ctl_i[:, 5], ctl_i[:, 6], ctl_i[:, 7]], dim=1)
    return torch.stack(sampled), next_ctl


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
