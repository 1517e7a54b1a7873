"""Ragged paged attention over the head-major KV pool: CUDA kernel
wrappers + plain versions.

Replaces two Pallas TPU kernels of ``fusioninfer_tpu/ops/paged_attention.py``:

* ``ragged_paged_attention`` (the single page walk) and
* ``ragged_paged_attention_kvsplit`` (the page walk split over
  ``KV_SPLIT_CHUNKS`` fixed virtual chunks, with f32 ``(acc, m, l)``
  partials folded left to right by a log-sum-exp combine).

Contract (shared by both): q ``[T, H, Hd]`` is a flat ragged axis of
tokens.  Token ``t`` belongs to the row ``r`` whose segment
``[q_begins[r], q_begins[r] + q_lens[r])`` holds it, sits at global
position ``row_starts[r] + t - q_begins[r]`` and attends causally (and
within ``window``) over row ``r``'s pages ``page_tables[r]`` of the pool
``[(L,) KV, n_pages, ps, Hd]``.  Tokens covered by no row come out as
zeros.  Output ``[T, H·Hd]``.

Kernel (``csrc/paged_attention.cu``): one block of four warps per
(token, KV head[, virtual chunk]); the block carries the token's
``G = H // KV`` query heads, resolves its row from the descriptors
itself, and walks only the live keys of that row's pages (32 keys per
warp step, one key per lane) with an online softmax in f32.  The four
warps' states merge in shared memory; the split variant writes them as
f32 partials and a second small kernel runs the fixed-order combine.
Blocks per token (not per 8-token tile, as on the TPU) because a decode
step's tokens each belong to a different row with different pages, and
the GPU needs many blocks in flight to reach its memory rate.

Bound on an H100: decode attention reads every live K/V byte once and
does ~4·G·Hd FLOP per key and head, far below the 295 FLOP/byte ridge,
so it is bound by bytes (3.35 TB/s).  The design reads each live page
row once per (token, KV head) with 16-byte loads and keeps the scores
out of device memory; the split variant multiplies the blocks in
flight by ``KV_SPLIT_CHUNKS`` for long contexts.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.ops import dispatch
from fusioninfer_tpu_torch.ops.masks import attend

NEG_INF = -1e30

# flat-token tile of the TPU kernel's grid; kept as the flat-axis
# padding granule callers use for the ragged layout
RAGGED_BLOCK_Q = 8

# fixed virtual-chunk count: a row's page range always partitions into
# this many accumulation windows, and the combine folds them left to
# right, as the TPU kernel does for every split count.
KV_SPLIT_CHUNKS = 8

# engines whose max context (max_pages_per_seq × page_size) is below this
# keep the single walk; the choice is static engine config, never batch
# content, so a row's bits never depend on its neighbours
KV_SPLIT_MIN_CTX_TOKENS = 4096

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


def pick_kv_splits(max_pages_per_seq: int, page_size: int) -> int:
    """0 (single walk) below the long-context floor, else the full
    ``KV_SPLIT_CHUNKS`` fan-out.  A pure function of static cache config."""
    if max_pages_per_seq * page_size < KV_SPLIT_MIN_CTX_TOKENS:
        return 0
    return KV_SPLIT_CHUNKS


def ragged_token_rows(q_begins: torch.Tensor, q_lens: torch.Tensor,
                      n_tokens: int):
    """Per-token (row, offset, live) maps for a flat ragged layout, robust
    to zero-length rows sharing a begin with a neighbour."""
    ends = (q_begins + q_lens).contiguous()
    t_idx = torch.arange(n_tokens, device=q_begins.device,
                         dtype=q_begins.dtype)
    row_of = torch.searchsorted(ends, t_idx, right=True).clamp(
        0, q_begins.shape[0] - 1)
    off = t_idx - q_begins[row_of]
    live = (t_idx >= q_begins[row_of]) & (t_idx < ends[row_of])
    return row_of, off, live


def _gathered(q, k_pages, v_pages, page_tables, row_starts, q_begins,
              q_lens, window):
    """f32 scores ``[KV, T, G, mp·ps]`` over each token's gathered row
    context, the visibility mask, the context values and token liveness."""
    T, H, Hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    mp = page_tables.shape[1]
    row_of, off, live = ragged_token_rows(q_begins, q_lens, T)
    pos = row_starts[row_of] + off
    tables = page_tables[row_of].long()  # [T, mp]
    k_ctx = k_pages[:, tables].reshape(KV, T, mp * ps, Hd).float()
    v_ctx = v_pages[:, tables].reshape(KV, T, mp * ps, Hd).float()
    qg = q.reshape(T, KV, G, Hd).float()
    s = torch.einsum("tkgd,ktsd->ktgs", qg, k_ctx) / (Hd ** 0.5)
    ctx = torch.arange(mp * ps, device=q.device)
    mask = attend(pos[:, None], ctx[None, :], window) & live[:, None]
    return s, mask[None, :, None, :], v_ctx, live


def reference_ragged_paged_attention(q, k_pages, v_pages, page_tables,
                                     row_starts, q_begins, q_lens,
                                     window=None) -> torch.Tensor:
    """Plain gathered-context version of the single walk (pages
    ``[KV, n_pages, ps, Hd]``).  Tokens covered by no row are zeros."""
    T, H, Hd = q.shape
    s, mask, v_ctx, live = _gathered(q, k_pages, v_pages, page_tables,
                                     row_starts, q_begins, q_lens, window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1) * live[None, :, None, None]
    out = torch.einsum("ktgs,ktsd->tkgd", probs, v_ctx)
    return out.reshape(T, H * Hd).to(q.dtype)


def reference_kvsplit_partials(q, k_pages, v_pages, page_tables, row_starts,
                               q_begins, q_lens, window=None):
    """Plain version of the split walk's f32 partials: for each of the
    ``KV_SPLIT_CHUNKS`` virtual chunks (``ceil(mp / chunks)`` pages each),
    the chunk's raw ``(acc [C, T, KV, G, Hd], m [C, T, KV, G],
    l [C, T, KV, G])`` over its visible keys; an empty chunk is
    ``(0, -inf, 0)``."""
    T, H, Hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    mp = page_tables.shape[1]
    C = KV_SPLIT_CHUNKS
    chunk_keys = -(-mp // C) * ps
    s, mask, v_ctx, _ = _gathered(q, k_pages, v_pages, page_tables,
                                  row_starts, q_begins, q_lens, window)
    pad = C * chunk_keys - mp * ps
    s = torch.nn.functional.pad(s, (0, pad))
    mask = torch.nn.functional.pad(mask, (0, pad))
    v_ctx = torch.nn.functional.pad(v_ctx, (0, 0, 0, pad))
    s = s.reshape(KV, T, G, C, chunk_keys)
    mask = mask.reshape(1, T, 1, C, chunk_keys)
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1)  # [KV, T, G, C]
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("ktgcs,ktcsd->ktgcd", p,
                       v_ctx.reshape(KV, T, C, chunk_keys, Hd))
    return (acc.permute(3, 1, 0, 2, 4).contiguous(),
            m.permute(3, 1, 0, 2).contiguous(),
            l.permute(3, 1, 0, 2).contiguous())


def combine_kvsplit_partials(acc, m, l, dtype) -> torch.Tensor:
    """The fixed left-to-right log-sum-exp fold over the chunk axis, with
    the dead-lane guard (``-inf - -inf`` is NaN) → ``[T, H·Hd]``."""
    C, T = m.shape[0], m.shape[1]
    mc, lc, ac = m[0], l[0], acc[0]
    for c in range(1, C):
        m_new = torch.maximum(mc, m[c])
        dead = m_new == float("-inf")
        alpha = torch.where(dead, 0.0, torch.exp(mc - m_new))
        beta = torch.where(dead, 0.0, torch.exp(m[c] - m_new))
        lc = alpha * lc + beta * l[c]
        ac = alpha[..., None] * ac + beta[..., None] * acc[c]
        mc = m_new
    out = ac / torch.clamp(lc, min=1e-20)[..., None]
    return out.reshape(T, -1).to(dtype)


def reference_ragged_paged_attention_kvsplit(q, k_pages, v_pages,
                                             page_tables, row_starts,
                                             q_begins, q_lens,
                                             window=None) -> torch.Tensor:
    """Plain version of the split walk: the same partials, the same
    combine (pages ``[KV, n_pages, ps, Hd]``)."""
    acc, m, l = reference_kvsplit_partials(q, k_pages, v_pages, page_tables,
                                           row_starts, q_begins, q_lens,
                                           window)
    return combine_kvsplit_partials(acc, m, l, q.dtype)


def _layer_pages(k_pages, v_pages, layer):
    """(k, v, layer) with stacked ``[L, KV, ...]`` pools: a 4-D pool takes
    no layer, a stacked one requires it."""
    if k_pages.dim() == 5:
        if layer is None:
            raise ValueError("stacked [L, KV, n_pages, ps, Hd] pools require layer")
        return k_pages, v_pages, int(layer)
    if layer is not None:
        raise ValueError("layer only applies to stacked [L, ...] pools")
    return k_pages[None], v_pages[None], 0


def _check_operands(q, k_pages, v_pages, descriptors, k_scales, v_scales,
                    layer):
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("int8 KV pages are not ported yet")
    T, H, Hd = q.shape
    L, KV, n_pages, ps, Hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or Hd_k != Hd:
        raise ValueError(f"page pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if H % KV or H // KV not in _GROUPS:
        raise ValueError(f"query group {H}/{KV} not in {_GROUPS}")
    if Hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {Hd} not in {_HEAD_DIMS}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    tables, row_starts, q_begins, q_lens = descriptors
    R = tables.shape[0]
    for name, t in (("page_tables", tables), ("row_starts", row_starts),
                    ("q_begins", q_begins), ("q_lens", q_lens)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32")
        if t.shape[0] != R:
            raise ValueError(f"{name} has {t.shape[0]} rows, page_tables {R}")
    return T, H, Hd, KV, n_pages, ps, R, tables.shape[1]


def _launch_args(q, k_pages, v_pages, descriptors):
    return [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *(t.data_ptr() for t in descriptors)]


def ragged_paged_attention(q, k_pages, v_pages, page_tables, row_starts,
                           q_begins, q_lens, k_scales=None, v_scales=None,
                           *, window: int | None = None,
                           layer: int | None = None) -> torch.Tensor:
    """The single page walk → ``[T, H·Hd]``: the CUDA kernel for CUDA
    tensors, :func:`reference_ragged_paged_attention` for CPU tensors."""
    descriptors = (page_tables, row_starts, q_begins, q_lens)
    if not dispatch.use_kernel(q, k_pages, v_pages, *descriptors):
        if k_scales is not None or v_scales is not None:
            raise NotImplementedError("int8 KV pages are not ported yet")
        kp, vp, li = _layer_pages(k_pages, v_pages, layer)
        return reference_ragged_paged_attention(
            q, kp[li], vp[li], *descriptors, window=window)
    kp, vp, li = _layer_pages(k_pages, v_pages, layer)
    T, H, Hd, KV, n_pages, ps, R, mp = _check_operands(
        q, kp, vp, descriptors, k_scales, v_scales, li)
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("paged_attention.cu", "ragged_paged_attention_bf16")
    out = torch.empty((T, H * Hd), dtype=q.dtype, device=q.device)
    if T == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*_launch_args(q, kp, vp, descriptors), out.data_ptr(),
             T, R, KV, H // KV, Hd, n_pages, ps, mp, li, Hd ** -0.5,
             window or 0, stream)
    _build.check(err, "ragged_paged_attention_bf16")
    dispatch.count_launch("ragged_paged_attention")
    return out


def ragged_paged_attention_kvsplit(q, k_pages, v_pages, page_tables,
                                   row_starts, q_begins, q_lens,
                                   k_scales=None, v_scales=None, *,
                                   window: int | None = None,
                                   layer: int | None = None) -> torch.Tensor:
    """The split page walk → ``[T, H·Hd]``: the CUDA kernels (partials,
    then combine) for CUDA tensors, the plain split version for CPU
    tensors.  Every one of the ``KV_SPLIT_CHUNKS`` virtual chunks is its
    own block."""
    descriptors = (page_tables, row_starts, q_begins, q_lens)
    if not dispatch.use_kernel(q, k_pages, v_pages, *descriptors):
        if k_scales is not None or v_scales is not None:
            raise NotImplementedError("int8 KV pages are not ported yet")
        kp, vp, li = _layer_pages(k_pages, v_pages, layer)
        return reference_ragged_paged_attention_kvsplit(
            q, kp[li], vp[li], *descriptors, window=window)
    kp, vp, li = _layer_pages(k_pages, v_pages, layer)
    T, H, Hd, KV, n_pages, ps, R, mp = _check_operands(
        q, kp, vp, descriptors, k_scales, v_scales, li)
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("paged_attention.cu",
                      "ragged_paged_attention_kvsplit_bf16")
    C = KV_SPLIT_CHUNKS
    G = H // KV
    out = torch.empty((T, H * Hd), dtype=q.dtype, device=q.device)
    if T == 0:
        return out
    acc = torch.empty((C, T, KV, G, Hd), dtype=torch.float32, device=q.device)
    m = torch.empty((C, T, KV, G), dtype=torch.float32, device=q.device)
    l = torch.empty((C, T, KV, G), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*_launch_args(q, kp, vp, descriptors), acc.data_ptr(),
             m.data_ptr(), l.data_ptr(), out.data_ptr(),
             T, R, KV, G, Hd, n_pages, ps, mp, li, Hd ** -0.5,
             window or 0, C, -(-mp // C), stream)
    _build.check(err, "ragged_paged_attention_kvsplit_bf16")
    dispatch.count_launch("ragged_paged_attention_kvsplit")
    return out
