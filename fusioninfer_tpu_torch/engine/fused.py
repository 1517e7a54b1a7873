"""Ragged-batch packing for the one-weight-pass engine step (own copy
of ``fusioninfer_tpu/engine/fused.py``).

Pure host-side assembly (numpy only, no device work, no clocks): given
the decode rows' control state and the step's budgeted prefill-chunk
entries, build the FLAT ragged-concat token layout
:func:`engine.model_runner.fused_step` consumes.  Row layout is
load-bearing:

* rows ``0 .. B-1`` are the decode batch SLOTS (zero-length segments
  for dead slots), so the fused logits' first ``B`` rows line up with
  the engine's slot-indexed sampling state;
* rows ``B ..`` carry this step's prefill chunks, one row per
  mid-prefill sequence, each at its own start position;
* trailing rows up to the power-of-two pad are inert (zero-length
  segments, trash page tables).

Tokens concatenate along ONE flat axis (``q_begins[r]`` is the running
sum of ``q_lens``), so a decode row costs one token of dense work
whatever the chunk length is.  The flat axis pads to a power of two, at
least ``min_tokens``: the JAX package's compile-signature bucket, kept
so that both packages lay out the same tensors.  Padding tokens belong
to no row and follow the live ones, so the port's forward runs over the
live prefix alone (``fused_step(..., n_tokens=packed_tokens)``).  The
TPU kernel's 8-token tile (``RAGGED_BLOCK_Q``) plays no part here: the
port's walks run a thread-block cluster per token.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RaggedBatch:
    """Operand set for one ragged ``fused_step`` dispatch (all numpy,
    ready for ``torch.from_numpy``)."""

    tokens: np.ndarray  # [T] int32 — flat ragged-concat token axis
    row_starts: np.ndarray  # [R] int32 — global position of row's token 0
    q_begins: np.ndarray  # [R] int32 — flat offset of each row's segment
    q_lens: np.ndarray  # [R] int32 — row token count (0 = inert row)
    page_tables: np.ndarray  # [R, mp] int32
    sel: np.ndarray  # [B, W] int32 — decode slots' FLAT window indices
    chunk_sel: np.ndarray  # [NC] int32 — chunk rows' FLAT last-token
    # indices, pow2-padded (lm_head groups must be shape-stable across
    # split and fused dispatches — see model_runner.fused_step)
    adapter_ids: np.ndarray  # [R] int32
    packed_tokens: int  # real (non-padding) tokens in this dispatch


def pow2_rows(n: int) -> int:
    """Smallest power of two ≥ n (compile-signature bounding)."""
    return 1 << max(0, n - 1).bit_length()


def pack_ragged_batch(
    window: np.ndarray,  # [B, W] decode-row token windows (col 0 = input)
    counts_w: np.ndarray,  # [B] real decode window lengths (0 = inactive)
    positions: np.ndarray,  # [B] global position of each decode row's col 0
    decode_tables: np.ndarray,  # [B, mp] decode-row page tables
    decode_adapters: np.ndarray,  # [B] adapter ids
    chunk_entries: list,  # [(tokens list, start, table_row, adapter_id)]
    trash_page: int,
    rows: int | None = None,  # fixed descriptor-row count (compile
    # discipline: the engine pins pow2(2·max_batch) so R never varies)
    chunk_rows: int | None = None,  # fixed chunk_sel width (engine pins
    # pow2(max_batch) so the chunk lm_head group compiles ONCE)
    min_tokens: int = 16,  # flat-axis floor: pow2 bucketing below this
    # would mint a compile signature per tiny T (1, 2, 4...) for dense
    # work that costs nothing anyway
) -> RaggedBatch:
    """Pack decode rows + prefill-chunk rows into one flat ragged batch.

    ``B == 0`` (an empty ``window``) packs chunk rows alone — the
    chunk-advance and batched-suffix paths ride the same layout, so
    every engine forward shares one kernel and one signature family.

    ``sel`` [B, W] covers only the decode slots (their sampled-token
    logits, and the full spec window when speculation is on); columns
    past a row's real count land in a neighbor's segment and are never
    read (the spec tail walks at most count-1 drafts).  ``chunk_sel``
    [pow2(n_chunks)] carries the chunk rows' last real tokens for
    activation, pow2-padded so the chunk lm_head group's shape depends
    only on the chunk COUNT — identical between a split chunk advance
    and the fused step that absorbs it.  Dead and inert entries clamp
    into the flat range; their logits are never read.
    """
    B, W = window.shape
    mp = decode_tables.shape[1] if B else (
        np.asarray(chunk_entries[0][2]).shape[0] if chunk_entries else 0)
    n_chunks = len(chunk_entries)
    R = rows if rows is not None else pow2_rows(max(B + n_chunks, 1))
    if R < B + n_chunks:
        raise ValueError(f"{B} decode + {n_chunks} chunk rows exceed "
                         f"the fixed row count {R}")
    NC = chunk_rows if chunk_rows is not None else (
        pow2_rows(n_chunks) if n_chunks else 0)
    if NC < n_chunks:
        raise ValueError(f"{n_chunks} chunks exceed the fixed chunk_sel "
                         f"width {NC}")

    q_lens = np.zeros((R,), np.int32)
    q_lens[:B] = counts_w
    for j, (toks, _, _, _) in enumerate(chunk_entries):
        q_lens[B + j] = len(toks)
    q_begins = np.zeros((R,), np.int32)
    np.cumsum(q_lens[:-1], out=q_begins[1:])
    total = int(q_lens.sum())
    T = max(pow2_rows(max(total, 1)), min_tokens)

    tokens = np.zeros((T,), np.int32)
    row_starts = np.zeros((R,), np.int32)
    tables = np.full((R, mp), trash_page, np.int32)
    sel = np.zeros((B, W), np.int32)
    chunk_sel = np.zeros((NC,), np.int32)
    ids = np.zeros((R,), np.int32)

    for b in range(B):
        n = int(counts_w[b])
        tokens[q_begins[b]: q_begins[b] + n] = window[b, :n]
        sel[b] = np.minimum(q_begins[b] + np.arange(W), T - 1)
    row_starts[:B] = positions
    if B:
        tables[:B] = decode_tables
        ids[:B] = decode_adapters

    for j, (toks, start, table_row, adapter_id) in enumerate(chunk_entries):
        r = B + j
        tokens[q_begins[r]: q_begins[r] + len(toks)] = toks
        row_starts[r] = start
        tables[r] = table_row
        chunk_sel[j] = q_begins[r] + max(len(toks) - 1, 0)
        ids[r] = adapter_id

    return RaggedBatch(
        tokens=tokens, row_starts=row_starts, q_begins=q_begins,
        q_lens=q_lens, page_tables=tables, sel=sel, chunk_sel=chunk_sel,
        adapter_ids=ids, packed_tokens=total,
    )
