"""Paged attention over the head-major KV pool: CUDA kernel wrappers +
plain versions.

Replaces the five Pallas TPU kernels of
``fusioninfer_tpu/ops/paged_attention.py`` that read cache pages:

* ``ragged_paged_attention`` (the single page walk) and
* ``ragged_paged_attention_kvsplit`` (the page walk split over
  ``KV_SPLIT_CHUNKS`` fixed virtual chunks, with f32 ``(acc, m, l)``
  partials folded left to right by a log-sum-exp combine), the serve
  path's decode attention;
* ``paged_decode_attention`` (one query token per sequence),
  ``paged_prefill_attention`` (one sequence's suffix of queries) and
  ``paged_verify_attention`` (per-sequence query windows), standalone
  primitives no engine path calls.

Ragged contract (both walks): q ``[T, H, Hd]`` is a flat ragged axis of
tokens.  Token ``t`` belongs to the row ``r`` whose segment
``[q_begins[r], q_begins[r] + q_lens[r])`` holds it, sits at global
position ``row_starts[r] + t - q_begins[r]`` and attends causally (and
within ``window``) over row ``r``'s pages ``page_tables[r]`` of the pool
``[(L,) KV, n_pages, ps, Hd]``.  Tokens covered by no row come out as
zeros.  Output ``[T, H·Hd]``.

Pages are bf16, or int8 with f32 scales ``[(L,) KV, n_pages, 1, ps]``
(one per token and head, :func:`models.quantization.kv_quantize`).  The
K scale multiplies the scores after the dot and the V scale the
probabilities before P·V, in the kernels and in the plain versions, so
no page is ever dequantized into memory.

Kernels (``csrc/paged_attention.cu``): the three walks share one kernel
that runs a thread-block cluster of ``CL`` blocks per (token or
sequence, KV head), with a partition rule per walk
(:func:`cluster_key_ranges`).  In the single walk and paged decode,
``CL`` comes from :func:`pick_cluster_size` (shapes only, so a launch
reads nothing back from the card and a CUDA graph can capture it) and
rank ``r`` walks the ``r``-th share of the pages the query sees; a row's
bits then depend on ``CL`` and on nothing else of the launch.  The
engine fixes the single walk's ``CL`` once from its static shapes
(:func:`engine_cluster_size`), so a decode row comes out bit for bit the
same whether it runs alone, with other decode rows or beside a prefill
chunk; a standalone call takes ``CL`` from its own token count.  In
the split walk ``CL`` is ``KV_SPLIT_CHUNKS`` and rank ``c`` walks virtual
chunk ``c``, the ``ceil(mp / 8)`` pages from page ``c·ceil(mp / 8)`` of
the row's table, cut to the visible keys, so a row's bits depend only on
its positions and ``mp``, never on ``T`` or on the other rows; a rank
whose chunk holds no visible key leaves at once.  Each rank's keys are
streamed into shared memory by bulk copies, one per page segment, through
an mbarrier ring; four warps (eight in the split walk) score each key
against the ``G = H // KV`` query heads and accumulate P·V in f32; the
ranks' f32 ``(acc, m, l)`` are folded left to right from rank 0 through
distributed shared memory, each rank folding a slice of the outputs
(:func:`reference_cluster_partials` is the plain version of those
partials, :func:`combine_kvsplit_partials` of the fold).  One launch, no
scratch.  Blocks per token (not per 8-token tile, as on the TPU) because
a decode step's tokens each belong to a different row with different
pages, and the GPU needs many blocks in flight to reach its memory rate.

Suffix prefill and verify share ``csrc/paged_window_attention.cu``,
built on Hopper's own machinery (``csrc/hopper_attention.cuh``): tiles
of 64 (query, group head) rows per consumer warpgroup run Q·Kᵀ and P·V
as ``wgmma`` against K/V tiles that a producer warp streams through an
mbarrier ring — by TMA, one copy per page segment, where a tile lies
whole in one page, else gathered row by row with ``cp.async`` — with
int8 pages widened to bf16 by the producer warpgroup.  Each query
window's key range is cut into fixed chunks of ``WINDOW_CHUNK``
positions, each chunk its own block; a range spanning several chunks is
folded left to right from f32 partials (scratch for the chunks that the
live windows touch, and no more), with the split walk's
arithmetic (:func:`combine_kvsplit_partials`), so the result depends
only on key positions (:func:`reference_window_partials` is the plain
version of those partials).

Bound on an H100: decode attention reads every live K/V byte once and
does ~4·G·Hd FLOP per key and head, far below the 295 FLOP/byte ridge,
so it is bound by bytes (3.35 TB/s); int8 pages move Hd + 4 bytes per
token and head instead of 2·Hd.  The walks read each live page row once
per (token, KV head) and keep the scores out of device memory; the split
walk gives every (token, KV head) ``KV_SPLIT_CHUNKS`` blocks whatever the
batch.
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

# fixed key-position chunk of the query-window kernel's split (the
# ``CHUNK`` of ``csrc/paged_window_attention.cu``): a window whose keys
# span several chunks is folded from per-chunk partials
WINDOW_CHUNK = 1024

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)

# portable thread-block cluster sizes of the single walk and paged decode
CLUSTER_SIZES = (1, 2, 4, 8)


def pick_kv_splits(max_pages_per_seq: int, page_size: int) -> int:
    """0 (single walk) below the long-context floor, else the full
    ``KV_SPLIT_CHUNKS`` fan-out.  A pure function of static cache config."""
    if max_pages_per_seq * page_size < KV_SPLIT_MIN_CTX_TOKENS:
        return 0
    return KV_SPLIT_CHUNKS


def pick_cluster_size(n_items: int, kv_heads: int, max_pages: int,
                      sm_count: int) -> int:
    """Blocks per cluster of the single walk and paged decode: the
    smallest of ``CLUSTER_SIZES`` that gives at least two blocks per SM
    (``n_items · kv_heads · CL >= 2 · sm_count``), capped at 8 and at
    ``max_pages`` (a share is at least a page).  Shapes only: the choice
    never reads a tensor, so it costs no copy from the card."""
    cap = max(c for c in CLUSTER_SIZES if c <= max(max_pages, 1))
    for cl in CLUSTER_SIZES:
        if cl == cap or n_items * kv_heads * cl >= 2 * sm_count:
            return cl
    raise AssertionError("unreachable: cap is one of CLUSTER_SIZES")


def cluster_key_ranges(k_lo: torch.Tensor, k_hi: torch.Tensor,
                       page_size: int, cluster: int,
                       chunk_pages: int | None = None):
    """Each rank's keys ``(lo, hi)``, each ``[cluster, *k_lo.shape]``, for
    queries that see keys ``[k_lo, k_hi)``, by the kernel's rules.  The
    single walk and paged decode (``chunk_pages`` None): of the ``n`` pages
    holding the keys, rank ``r`` takes pages ``[p0 + r·s, p0 + (r + 1)·s)``
    with ``p0`` the first such page and ``s = ceil(n / cluster)``.  The
    split walk (``chunk_pages = ceil(mp / KV_SPLIT_CHUNKS)``, ``cluster =
    KV_SPLIT_CHUNKS``): rank ``c`` takes chunk ``c``, pages ``[c·chunk_pages,
    (c + 1)·chunk_pages)`` counted from page 0 of the table.  Either is cut
    to the visible keys; a rank with none gets ``lo == hi``."""
    ps = page_size
    r = torch.arange(cluster, device=k_lo.device).reshape(
        (cluster,) + (1,) * k_lo.dim())
    if chunk_pages is not None:
        pa = r * chunk_pages
        pb = pa + chunk_pages
    else:
        p_lo = k_lo // ps
        p_hi = torch.where(k_hi > k_lo, (k_hi + ps - 1) // ps, p_lo)
        share = (p_hi - p_lo + cluster - 1) // cluster
        pa = p_lo + r * share
        pb = torch.minimum(pa + share, p_hi)
    lo = torch.maximum(k_lo, pa * ps)
    return lo, torch.maximum(torch.minimum(k_hi, pb * ps), lo)


def reference_cluster_partials(q, k_pages, v_pages, page_tables, row_starts,
                               q_begins, q_lens, k_scales=None, v_scales=None,
                               window=None, cluster: int = 1,
                               chunk_pages: int | None = None):
    """Plain version of the cluster walk's per-rank f32 partials: for each
    rank, the raw ``(acc [CL, T, KV, G, Hd], m [CL, T, KV, G], l [CL, T,
    KV, G])`` over exactly the keys :func:`cluster_key_ranges` gives it
    (with ``chunk_pages``, the split walk's fixed chunks; pages ``[KV,
    n_pages, ps, Hd]``); a rank with no keys, and every rank of a token in
    no row, is ``(0, -inf, 0)``.  The V scale weights ``acc``, not ``l``.
    :func:`combine_kvsplit_partials` folds them in rank order into the
    walk's output."""
    T = q.shape[0]
    ps = k_pages.shape[2]
    mp = page_tables.shape[1]
    s, mask, v_ctx, vs, live = _gathered(q, k_pages, v_pages, page_tables,
                                         row_starts, q_begins, q_lens,
                                         k_scales, v_scales, window)
    row_of, off, _ = ragged_token_rows(q_begins, q_lens, T)
    pos = (row_starts[row_of] + off).long()
    k_hi = torch.where(live, torch.clamp(pos + 1, max=mp * ps), 0)
    k_lo = torch.clamp(pos - window + 1, min=0) if window else torch.zeros_like(pos)
    lo, hi = cluster_key_ranges(torch.where(live, k_lo, 0), k_hi, ps, cluster,
                                chunk_pages)
    key = torch.arange(mp * ps, device=q.device)
    ranks = (key >= lo[..., None]) & (key < hi[..., None]) & mask[0, :, 0]  # [CL, T, S]
    s = torch.where(ranks[:, None, :, None, :], s[None], float("-inf"))  # [CL, KV, T, G, S]
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    if vs is not None:
        p = p * vs[None]
    acc = torch.einsum("cktgs,ktsd->cktgd", p, v_ctx)
    return (acc.permute(0, 2, 1, 3, 4).contiguous(), m.permute(0, 2, 1, 3).contiguous(),
            l.permute(0, 2, 1, 3).contiguous())


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


def _context(pages, scales, tables):
    """Each table row's pages gathered into a flat f32 context
    ``[KV, N, mp·ps, Hd]``, with its per-key scales ``[KV, N, mp·ps]``
    (None for unquantized pages)."""
    KV, _, ps, Hd = pages.shape
    N, mp = tables.shape
    t = tables.long()
    ctx = pages[:, t].reshape(KV, N, mp * ps, Hd).float()
    if scales is None:
        return ctx, None
    return ctx, scales[:, t, 0].reshape(KV, N, mp * ps)


def _gathered(q, k_pages, v_pages, page_tables, row_starts, q_begins,
              q_lens, k_scales, v_scales, window):
    """f32 scores ``[KV, T, G, mp·ps]`` over each token's gathered row
    context (the K scale folded in after the dot), the visibility mask,
    the context values, their V scales ``[KV, T, 1, mp·ps]`` (or None)
    and token liveness."""
    T, H, Hd = q.shape
    KV = k_pages.shape[0]
    G = H // KV
    mp = page_tables.shape[1]
    ps = k_pages.shape[2]
    row_of, off, live = ragged_token_rows(q_begins, q_lens, T)
    pos = row_starts[row_of] + off
    tables = page_tables[row_of]  # [T, mp]
    k_ctx, ks = _context(k_pages, k_scales, tables)
    v_ctx, vs = _context(v_pages, v_scales, tables)
    qg = q.reshape(T, KV, G, Hd).float()
    s = torch.einsum("tkgd,ktsd->ktgs", qg, k_ctx) / (Hd ** 0.5)
    if ks is not None:
        s = s * ks[:, :, None, :]
    ctx = torch.arange(mp * ps, device=q.device)
    mask = attend(pos[:, None], ctx[None, :], window) & live[:, None]
    return (s, mask[None, :, None, :], v_ctx,
            None if vs is None else vs[:, :, None, :], live)


def reference_ragged_paged_attention(q, k_pages, v_pages, page_tables,
                                     row_starts, q_begins, q_lens,
                                     k_scales=None, v_scales=None,
                                     window=None) -> torch.Tensor:
    """Plain gathered-context version of the single walk (pages
    ``[KV, n_pages, ps, Hd]``; int8 pages with scales ``[KV, n_pages, 1,
    ps]``).  Tokens covered by no row are zeros."""
    T, H, Hd = q.shape
    s, mask, v_ctx, vs, live = _gathered(q, k_pages, v_pages, page_tables,
                                         row_starts, q_begins, q_lens,
                                         k_scales, v_scales, window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1) * live[None, :, None, None]
    if vs is not None:
        probs = probs * vs
    out = torch.einsum("ktgs,ktsd->tkgd", probs, v_ctx)
    return out.reshape(T, H * Hd).to(q.dtype)


def reference_kvsplit_partials(q, k_pages, v_pages, page_tables, row_starts,
                               q_begins, q_lens, k_scales=None, v_scales=None,
                               window=None):
    """Plain version of the split walk's f32 partials: for each of the
    ``KV_SPLIT_CHUNKS`` virtual chunks (``ceil(mp / chunks)`` pages each),
    the chunk's raw ``(acc [C, T, KV, G, Hd], m [C, T, KV, G],
    l [C, T, KV, G])`` over its visible keys; an empty chunk is
    ``(0, -inf, 0)``.  The V scale weights ``acc``, not ``l``."""
    T, H, Hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    mp = page_tables.shape[1]
    C = KV_SPLIT_CHUNKS
    chunk_keys = -(-mp // C) * ps
    s, mask, v_ctx, vs, _ = _gathered(q, k_pages, v_pages, page_tables,
                                      row_starts, q_begins, q_lens,
                                      k_scales, v_scales, window)
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
    if vs is not None:
        p = p * torch.nn.functional.pad(vs, (0, pad)).reshape(KV, T, 1, C, chunk_keys)
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
                                             q_begins, q_lens, k_scales=None,
                                             v_scales=None,
                                             window=None) -> torch.Tensor:
    """Plain version of the split walk: the same partials, the same
    combine (pages ``[KV, n_pages, ps, Hd]``)."""
    acc, m, l = reference_kvsplit_partials(q, k_pages, v_pages, page_tables,
                                           row_starts, q_begins, q_lens,
                                           k_scales, v_scales, window)
    return combine_kvsplit_partials(acc, m, l, q.dtype)


def reference_paged_verify_attention(q, k_pages, v_pages, page_tables,
                                     starts, counts, k_scales=None,
                                     v_scales=None, window=None) -> torch.Tensor:
    """Plain gathered-context version of the verify window → ``[B, C,
    H·Hd]``: query ``i`` of sequence ``b`` sits at ``starts[b] + i`` and
    attends causally over ``page_tables[b]``'s pages.  Rows at or past
    ``counts[b]`` (all of an inactive slot's) are zeros."""
    B, C, H, Hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    mp = page_tables.shape[1]
    k_ctx, ks = _context(k_pages, k_scales, page_tables)
    v_ctx, vs = _context(v_pages, v_scales, page_tables)
    qg = q.reshape(B, C, KV, G, Hd).float()
    s = torch.einsum("bckgd,kbtd->bkgct", qg, k_ctx) / (Hd ** 0.5)
    if ks is not None:
        s = s * ks.transpose(0, 1)[:, :, None, None, :]
    i = torch.arange(C, device=q.device)
    live = i[None, :] < counts[:, None]  # [B, C]
    pos = starts[:, None] + i[None, :]
    ctx = torch.arange(mp * ps, device=q.device)
    mask = attend(pos[:, :, None], ctx, window) & live[:, :, None]  # [B, C, S]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1) * live[:, None, None, :, None]
    if vs is not None:
        probs = probs * vs.transpose(0, 1)[:, :, None, None, :]
    out = torch.einsum("bkgct,kbtd->bckgd", probs, v_ctx)
    return out.reshape(B, C, H * Hd).to(q.dtype)


def reference_window_partials(q, k_pages, v_pages, page_tables, starts, counts,
                              k_scales=None, v_scales=None, window=None,
                              chunk: int = WINDOW_CHUNK):
    """Plain version of the query-window kernel's split partials: for each
    of the ``ceil(mp·ps / chunk)`` chunks of ``chunk`` key positions, the
    raw f32 ``(acc [n, B·C, KV, G, Hd], m [n, B·C, KV, G], l [n, B·C, KV,
    G])`` of every query row over the chunk's visible keys (natural-log
    units), ready for :func:`combine_kvsplit_partials`.  A chunk a row
    sees nothing of, and every chunk of a row at or past ``counts[b]``, is
    ``(0, -inf, 0)``.  The V scale weights ``acc``, not ``l``."""
    B, C, H, Hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    mp = page_tables.shape[1]
    n = -(-(mp * ps) // chunk)
    pad = n * chunk - mp * ps
    k_ctx, ks = _context(k_pages, k_scales, page_tables)
    v_ctx, vs = _context(v_pages, v_scales, page_tables)
    qg = q.reshape(B, C, KV, G, Hd).float()
    s = torch.einsum("bckgd,kbtd->bckgt", qg, k_ctx) / (Hd ** 0.5)
    if ks is not None:
        s = s * ks.transpose(0, 1)[:, None, :, None, :]
    i = torch.arange(C, device=q.device)
    live = i[None, :] < counts[:, None]  # [B, C]
    pos = starts[:, None] + i[None, :]
    ctx = torch.arange(mp * ps, device=q.device)
    mask = attend(pos[:, :, None], ctx, window) & live[:, :, None]  # [B, C, S]
    s = torch.nn.functional.pad(s, (0, pad)).reshape(B, C, KV, G, n, chunk)
    mask = torch.nn.functional.pad(mask, (0, pad)).reshape(B, C, 1, 1, n, chunk)
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1)  # [B, C, KV, G, n]
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    if vs is not None:
        vs = torch.nn.functional.pad(vs, (0, pad)).transpose(0, 1)
        p = p * vs.reshape(B, 1, KV, 1, n, chunk)
    v_ctx = torch.nn.functional.pad(v_ctx, (0, 0, 0, pad)).reshape(KV, B, n, chunk, Hd)
    acc = torch.einsum("bckgnt,kbntd->bckgnd", p, v_ctx)
    return (acc.permute(4, 0, 1, 2, 3, 5).reshape(n, B * C, KV, G, Hd),
            m.permute(4, 0, 1, 2, 3).reshape(n, B * C, KV, G),
            l.permute(4, 0, 1, 2, 3).reshape(n, B * C, KV, G))


def reference_paged_prefill_attention(q, k_pages, v_pages, page_row, start,
                                      true_len, k_scales=None, v_scales=None,
                                      window=None) -> torch.Tensor:
    """Plain version of the suffix prefill → ``[C, H·Hd]``: the verify
    window of one sequence.  Rows at or past ``true_len`` are zeros."""
    dev = q.device
    return reference_paged_verify_attention(
        q[None], k_pages, v_pages, page_row[None],
        torch.as_tensor(start, device=dev).reshape(1),
        torch.as_tensor(true_len, device=dev).reshape(1),
        k_scales, v_scales, window)[0]


def reference_paged_attention(q, k_pages, v_pages, page_tables, lengths,
                              k_scales=None, v_scales=None,
                              window=None) -> torch.Tensor:
    """Plain version of paged decode → ``[B, H·Hd]``: one query per
    sequence at position ``lengths[b] - 1``; ``lengths[b] = 0`` (an
    inactive slot) gives zeros."""
    return reference_paged_verify_attention(
        q[:, None], k_pages, v_pages, page_tables, lengths - 1,
        (lengths > 0).to(lengths.dtype), k_scales, v_scales, window)[:, 0]


def _layer_pages(k_pages, v_pages, k_scales, v_scales, layer):
    """(k, v, k_scales, v_scales, layer) with stacked ``[L, KV, ...]``
    pools: a 4-D pool takes no layer, a stacked one requires it.  Checks
    the pairing of page dtype and scales on either route: int8 pages come
    with both scale pools, other pages with none."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    quantized = k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8
    if quantized != (k_scales is not None):
        raise ValueError("int8 KV pages need their f32 scales, and only int8 "
                         f"pages take scales (pages {k_pages.dtype}, scales "
                         f"{'given' if k_scales is not None else 'absent'})")
    if k_pages.dim() == 5:
        if layer is None:
            raise ValueError("stacked [L, KV, n_pages, ps, Hd] pools require layer")
        return k_pages, v_pages, k_scales, v_scales, int(layer)
    if layer is not None:
        raise ValueError("layer only applies to stacked [L, ...] pools")
    if quantized:
        k_scales, v_scales = k_scales[None], v_scales[None]
    return k_pages[None], v_pages[None], k_scales, v_scales, 0


def _plain_pages(k_pages, v_pages, k_scales, v_scales, layer):
    """Layer ``layer``'s 4-D pages and scales for the plain versions."""
    kp, vp, ks, vs, li = _layer_pages(k_pages, v_pages, k_scales, v_scales, layer)
    if ks is None:
        return kp[li], vp[li], None, None
    return kp[li], vp[li], ks[li], vs[li]


def _check_pages(q, k_pages, v_pages, k_scales, v_scales, layer):
    """What every kernel takes: bf16 q ``[..., H, Hd]``; stacked pools
    ``[L, KV, n_pages, ps, Hd]``, bf16 without scales or int8 with f32
    scales ``[L, KV, n_pages, 1, ps]``; everything contiguous and 16-byte
    aligned.  Returns ``(H, Hd, KV, n_pages, ps)``."""
    H, Hd = q.shape[-2:]
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
    page_dtype = torch.int8 if k_scales is not None else torch.bfloat16
    checks = [("q", q, torch.bfloat16), ("k_pages", k_pages, page_dtype),
              ("v_pages", v_pages, page_dtype)]
    if k_scales is not None:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(t.shape) != (L, KV, n_pages, 1, ps):
                raise ValueError(f"{name} {tuple(t.shape)} is not "
                                 f"{(L, KV, n_pages, 1, ps)}")
            checks.append((name, t, torch.float32))
    for name, t, dtype in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return H, Hd, KV, n_pages, ps


def _check_int32(R: int, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32")
        if t.shape[0] != R:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {R}")


def _pointers(*tensors) -> list:
    """Device pointers for the C entries; an absent operand is NULL."""
    return [None if t is None else t.data_ptr() for t in tensors]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm_count(device: torch.device) -> int:
    """The card's SM count, from its cached properties (no sync)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def engine_cluster_size(n_rows: int, kv_heads: int, max_pages: int,
                        device) -> int | None:
    """The single walk's cluster size an engine fixes once from its static
    shapes (``n_rows`` decode rows, its KV heads and page-table width), so
    that a row's bits do not change with what shares its launch; None off
    the card, where the plain version runs."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return pick_cluster_size(n_rows, kv_heads, max_pages, _sm_count(device))


def _ragged_operands(q, k_pages, v_pages, descriptors, k_scales, v_scales,
                     layer):
    H, Hd, KV, n_pages, ps = _check_pages(q, k_pages, v_pages, k_scales,
                                          v_scales, layer)
    tables, row_starts, q_begins, q_lens = descriptors
    _check_int32(tables.shape[0], page_tables=tables, row_starts=row_starts,
                 q_begins=q_begins, q_lens=q_lens)
    return q.shape[0], H, Hd, KV, n_pages, ps, tables.shape[0], tables.shape[1]


def _check_int8_page_size(ps: int, quantized: bool) -> None:
    """The walks copy int8 pages' scales in 16-byte runs: their page size
    must be a multiple of 4."""
    if quantized and ps % 4:
        raise ValueError(f"int8 pages need a page size that is a multiple of 4, got {ps}")


def _cluster_walk(q, T: int, KV: int, ps: int, mp: int, quantized: bool,
                  cluster: int | None = None) -> int:
    """The single walk's and paged decode's cluster size: ``cluster`` when
    the caller fixed one, else the shape rule for ``T`` queries (raises
    for an int8 page size the kernel cannot take)."""
    _check_int8_page_size(ps, quantized)
    if cluster is not None:
        if cluster not in CLUSTER_SIZES:
            raise ValueError(f"cluster {cluster} not in {CLUSTER_SIZES}")
        return cluster
    return pick_cluster_size(T, KV, mp, _sm_count(q.device))


def _variant(name: str, k_scales) -> str:
    """Launch-counter name: int8 pages count under ``<name>_int8``."""
    return name if k_scales is None else name + "_int8"


def ragged_paged_attention(q, k_pages, v_pages, page_tables, row_starts,
                           q_begins, q_lens, k_scales=None, v_scales=None,
                           *, window: int | None = None,
                           layer: int | None = None,
                           cluster: int | None = None) -> torch.Tensor:
    """The single page walk → ``[T, H·Hd]``: the CUDA kernel for CUDA
    tensors, :func:`reference_ragged_paged_attention` for CPU tensors.
    ``cluster`` fixes the blocks per (token, KV head); None takes
    :func:`pick_cluster_size` of this launch's shapes, under which a
    row's last bits depend on how many tokens share the launch (an
    engine passes :func:`engine_cluster_size`)."""
    descriptors = (page_tables, row_starts, q_begins, q_lens)
    if not dispatch.use_kernel(q, k_pages, v_pages, *descriptors):
        kp, vp, ks, vs = _plain_pages(k_pages, v_pages, k_scales, v_scales, layer)
        return reference_ragged_paged_attention(q, kp, vp, *descriptors, ks, vs,
                                                window=window)
    kp, vp, ks, vs, li = _layer_pages(k_pages, v_pages, k_scales, v_scales, layer)
    T, H, Hd, KV, n_pages, ps, R, mp = _ragged_operands(
        q, kp, vp, descriptors, ks, vs, li)
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("paged_attention.cu", "ragged_paged_attention")
    out = torch.empty((T, H * Hd), dtype=q.dtype, device=q.device)
    if T == 0:
        return out
    cluster = _cluster_walk(q, T, KV, ps, mp, ks is not None, cluster)
    err = fn(*_pointers(q, kp, vp, ks, vs, *descriptors, out),
             T, R, KV, H // KV, Hd, n_pages, ps, mp, li, Hd ** -0.5,
             window or 0, cluster, _stream(q))
    _build.check(err, "ragged_paged_attention")
    dispatch.count_launch(_variant("ragged_paged_attention", ks), f"T{T}")
    return out


def ragged_paged_attention_kvsplit(q, k_pages, v_pages, page_tables,
                                   row_starts, q_begins, q_lens,
                                   k_scales=None, v_scales=None, *,
                                   window: int | None = None,
                                   layer: int | None = None) -> torch.Tensor:
    """The split page walk → ``[T, H·Hd]``: the CUDA kernel for CUDA
    tensors, :func:`reference_ragged_paged_attention_kvsplit` for CPU
    tensors.  One launch in clusters of ``KV_SPLIT_CHUNKS`` blocks per
    (token, KV head), rank ``c`` walking virtual chunk ``c`` of
    ``ceil(mp / KV_SPLIT_CHUNKS)`` pages; no scratch, nothing read back."""
    descriptors = (page_tables, row_starts, q_begins, q_lens)
    if not dispatch.use_kernel(q, k_pages, v_pages, *descriptors):
        kp, vp, ks, vs = _plain_pages(k_pages, v_pages, k_scales, v_scales, layer)
        return reference_ragged_paged_attention_kvsplit(
            q, kp, vp, *descriptors, ks, vs, window=window)
    kp, vp, ks, vs, li = _layer_pages(k_pages, v_pages, k_scales, v_scales, layer)
    T, H, Hd, KV, n_pages, ps, R, mp = _ragged_operands(
        q, kp, vp, descriptors, ks, vs, li)
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("paged_attention.cu", "ragged_paged_attention_kvsplit")
    out = torch.empty((T, H * Hd), dtype=q.dtype, device=q.device)
    if T == 0:
        return out
    _check_int8_page_size(ps, ks is not None)
    err = fn(*_pointers(q, kp, vp, ks, vs, *descriptors, out),
             T, R, KV, H // KV, Hd, n_pages, ps, mp, li, Hd ** -0.5,
             window or 0, -(-mp // KV_SPLIT_CHUNKS), _stream(q))
    _build.check(err, "ragged_paged_attention_kvsplit")
    dispatch.count_launch(_variant("ragged_paged_attention_kvsplit", ks), f"T{T}")
    return out


def paged_decode_attention(q, k_pages, v_pages, page_tables, lengths,
                           k_scales=None, v_scales=None, *,
                           window: int | None = None,
                           layer: int | None = None) -> torch.Tensor:
    """One query token per sequence over its pages → ``[B, H·Hd]``
    (q ``[B, H, Hd]``, tables ``[B, mp]``, ``lengths [B]`` the context
    length including the query token; 0 marks an inactive slot, whose
    output is zeros).  The CUDA kernel for CUDA tensors,
    :func:`reference_paged_attention` for CPU tensors."""
    if not dispatch.use_kernel(q, k_pages, v_pages, page_tables, lengths):
        kp, vp, ks, vs = _plain_pages(k_pages, v_pages, k_scales, v_scales, layer)
        return reference_paged_attention(q, kp, vp, page_tables, lengths, ks, vs,
                                         window=window)
    kp, vp, ks, vs, li = _layer_pages(k_pages, v_pages, k_scales, v_scales, layer)
    H, Hd, KV, n_pages, ps = _check_pages(q, kp, vp, ks, vs, li)
    B, mp = page_tables.shape
    _check_int32(B, page_tables=page_tables, lengths=lengths)
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("paged_attention.cu", "paged_decode_attention")
    out = torch.empty((B, H * Hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    cluster = _cluster_walk(q, B, KV, ps, mp, ks is not None)
    err = fn(*_pointers(q, kp, vp, ks, vs, page_tables, lengths, out),
             B, KV, H // KV, Hd, n_pages, ps, mp, li, Hd ** -0.5, window or 0,
             cluster, _stream(q))
    _build.check(err, "paged_decode_attention")
    dispatch.count_launch(_variant("paged_decode_attention", ks))
    return out


def _window_chunks(starts, counts, C: int, keys: int, window) -> int:
    """Scratch slots per sequence for the query-window kernel's split: the
    most ``WINDOW_CHUNK`` chunks that any live sequence's keys touch, from
    the chunk of its first visible key (``starts − window + 1``, or 0) to
    that of its last (``starts + min(counts, C) − 1``, below ``keys``).
    ``starts``/``counts`` are ints or tensors; CUDA tensors cost one copy
    to the host, except under CUDA-graph capture, where nothing can be
    read and the bound from the shapes alone (``keys``, and ``window +
    C`` under a window) is taken instead.  The kernel's result does not
    depend on the number: only its scratch does."""
    chunk = WINDOW_CHUNK
    bound = -(-keys // chunk)
    if window:
        bound = min(bound, -(-(window + C) // chunk) + 1)
    if bound == 1 or (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        return bound
    s, c = (torch.as_tensor(x).reshape(-1) for x in (starts, counts))
    dev = s.device if s.is_cuda else c.device
    s, c = s.to(dev).long(), c.to(dev).long().clamp(0, C)
    lo = (s - window + 1).clamp(min=0) if window else torch.zeros_like(s)
    hi = (s + c).clamp(max=keys)
    n = torch.where((c > 0) & (hi > lo), (hi - 1) // chunk - lo // chunk + 1, 1)
    return int(n.max())


def _window_kernel(name, q, kp, vp, ks, vs, li, page_tables, starts, counts,
                   window, given=None):
    """Launch the query-window kernel on q ``[B, C, H, Hd]`` → ``[B, C,
    H·Hd]`` (shared by suffix prefill, B = 1, and verify).  Where a live
    window's keys span several ``WINDOW_CHUNK`` chunks, the kernel's
    split partials get f32 scratch here: ``n × B·C·H·(Hd + 2)`` floats
    for ``n`` = :func:`_window_chunks` of ``given``, the caller's starts
    and counts as it passed them (ints stay on the host), at most
    ``ceil(mp·ps / WINDOW_CHUNK)``, and under a window at most
    ``ceil((window + C) / WINDOW_CHUNK) + 1``."""
    H, Hd, KV, n_pages, ps = _check_pages(q, kp, vp, ks, vs, li)
    B, C = q.shape[:2]
    mp = page_tables.shape[1]
    _check_int32(B, page_tables=page_tables, starts=starts, counts=counts)
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("paged_window_attention.cu", "paged_window_attention")
    out = torch.empty((B, C, H * Hd), dtype=q.dtype, device=q.device)
    if B == 0 or C == 0:
        return out
    n_chunks = _window_chunks(*(given or (starts, counts)), C, mp * ps, window)
    acc = m = l = None
    if n_chunks > 1:
        f32 = {"dtype": torch.float32, "device": q.device}
        acc = torch.empty((n_chunks, B, C, H, Hd), **f32)
        m = torch.empty((n_chunks, B, C, H), **f32)
        l = torch.empty((n_chunks, B, C, H), **f32)
    err = fn(*_pointers(q, kp, vp, ks, vs, page_tables, starts, counts, out,
                        acc, m, l),
             B, C, KV, H // KV, Hd, n_pages, ps, mp, li, Hd ** -0.5,
             window or 0, n_chunks, _stream(q))
    _build.check(err, name)
    dispatch.count_launch(_variant(name, ks))
    return out


def paged_prefill_attention(q, k_pages, v_pages, page_row, start, true_len,
                            k_scales=None, v_scales=None, *,
                            window: int | None = None,
                            layer: int | None = None) -> torch.Tensor:
    """Suffix-prefill attention of one sequence → ``[C, H·Hd]``: query
    ``i`` of q ``[C, H, Hd]`` sits at ``start + i`` and attends causally
    over the pages of ``page_row [mp]``; rows at or past ``true_len`` are
    padding and come out as zeros.  ``start`` and ``true_len`` are ints
    or one-element tensors (ints spare the kernel's wrapper a copy to the
    host when it sizes its split scratch).  The query-window CUDA kernel
    (a batch of one) for CUDA tensors,
    :func:`reference_paged_prefill_attention` for CPU tensors."""
    dev = q.device
    starts = torch.as_tensor(start, dtype=torch.int32, device=dev).reshape(1)
    counts = torch.as_tensor(true_len, dtype=torch.int32, device=dev).reshape(1)
    if not dispatch.use_kernel(q, k_pages, v_pages, page_row):
        kp, vp, ks, vs = _plain_pages(k_pages, v_pages, k_scales, v_scales, layer)
        return reference_paged_prefill_attention(q, kp, vp, page_row, starts,
                                                 counts, ks, vs, window=window)
    kp, vp, ks, vs, li = _layer_pages(k_pages, v_pages, k_scales, v_scales, layer)
    return _window_kernel("paged_prefill_attention", q[None], kp, vp, ks, vs,
                          li, page_row[None], starts, counts, window,
                          (start, true_len))[0]


def paged_verify_attention(q, k_pages, v_pages, page_tables, starts, counts,
                           k_scales=None, v_scales=None, *,
                           window: int | None = None,
                           layer: int | None = None) -> torch.Tensor:
    """Per-sequence query windows over paged KV → ``[B, C, H·Hd]``:
    query ``i`` of q ``[B, C, H, Hd]`` sits at ``starts[b] + i`` and
    attends causally over ``page_tables[b]``'s pages; rows at or past
    ``counts[b]`` are padding and come out as zeros (``counts[b] = 0``
    is an inactive slot).  The query-window CUDA kernel for CUDA
    tensors, :func:`reference_paged_verify_attention` for CPU tensors."""
    if not dispatch.use_kernel(q, k_pages, v_pages, page_tables, starts, counts):
        kp, vp, ks, vs = _plain_pages(k_pages, v_pages, k_scales, v_scales, layer)
        return reference_paged_verify_attention(q, kp, vp, page_tables, starts,
                                                counts, ks, vs, window=window)
    kp, vp, ks, vs, li = _layer_pages(k_pages, v_pages, k_scales, v_scales, layer)
    return _window_kernel("paged_verify_attention", q, kp, vp, ks, vs, li,
                          page_tables, starts, counts, window)
