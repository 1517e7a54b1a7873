#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: every CUDA kernel of ``fusioninfer_tpu_torch/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, in parallel);
3. the row-invariant GEMM (``ops.gemm``) at each qwen3-8b projection
   shape and the RMSNorm (``ops.rms_norm``) at its three widths, at row
   counts 1, 2, 8, 40, 64, 65, 520 and 3000: against ``x @ w`` and the
   plain norm, every row's bits the same at every count and alone, kernel
   ms (graph replays) against ``torch.matmul`` / ``F.rms_norm`` and the
   bound, the GEMM also with its weight cold in L2 (replays cycling
   through copies of the weight that together exceed it), with each
   shape's tile, cluster size and splits; the norm fused into its
   neighbours at the same row counts, the residual add + norm
   (``add_rms_norm``) at d_model and the q/k norms + RoPE + K/V page
   write (``qk_norm_rope_kv``) on bf16 and int8 pages: bit for bit the
   unfused chain they replace (the norm kernel, torch's add, ``rotate``,
   ``scatter_kv``), every row the same at every count and alone, within
   the bound of the plain versions, kernel ms against the chain's and the
   bound; then the attention kernels against their plain PyTorch
   versions, on bf16 pages and on int8 pages with scales, at the serve
   path's shapes: the row error
   against a stated bound, kernel / plain / library
   (``scaled_dot_product_attention``, where it computes the same
   function) times by CUDA events, and the least time the card could
   take (bytes or operations).  The three standalone primitives (paged
   decode, suffix prefill, verify) are first driven once each through
   their ``ops`` entry points with the launch counts reset.  The single
   walk and paged decode are also timed at the 2048 serve leg's shape
   (contexts up to 2048, 16-page tables), the split walk at the 4096
   leg's decode-profile shape (contexts 101…1501, 32-page tables).
   Untimed cases cover what the served shapes do not reach, among them
   the single walk's and paged decode's cluster split at each cluster
   size (1, 2, 4, 8), the split walk's fixed chunks (tables of 5 and 13
   pages, windows from mid-chunk, G 1-8, Hd 64, int8, inert rows and
   padding tokens) and its batch independence (each row's output
   bit-identical alone, in T8 and in T72), the
   query-window kernel's key split (verify windows over one, two and
   three 1024-key chunks in one batch, and a windowed suffix prefill on
   two consumer warpgroups across a chunk boundary, held also against
   the plain chunk partials folded by the split combine) and flash at S
   off its 128-row q tile.  At the fused step's shape (the 8 decode rows
   plus a 512-token prefill chunk at 1024) both walks are held against
   their plain versions on both page types and timed beside the
   query-window kernel's C512 time; and each decode row must come out
   bit-identical alone, in the decode-only launch and inside the fused
   launch, the single walk at the cluster size the engine fixes.  At the
   speculative step's shape (the 8 decode rows, each a window of 1 + 4
   tokens ending at ctx 100…4000) both walks are held against their
   plain versions on both page types and timed, the single walk at the
   engine's cluster size and at the one fixed from the step's 40 tokens;
   and each decode row must come out bit-identical whether its
   neighbours carry 0 or 4 drafts.  Then the shapes of the other dense
   families: the GEMM at qwen3-1.7b's weights (D 2048, the tied
   2048 x 151936 head) and mistral-7b's MLP and 32768-column head at row
   counts 1, 8, 32, 40, 160, 520 and 3000 (bits at every count and alone,
   warm and cold against ``torch.matmul``), the norm and ``add_rms_norm``
   at D 2048 and ``qk_norm_rope_kv`` at H16 KV8 with norms and at H32 KV8
   without (bf16 and int8 pages, bit for bit the unfused chain); both
   walks at G 2 over 32 decode rows (contexts 64…1024) and flash at G 2;
   and under mistral-7b's 4096-token window, both walks over 8 decode
   rows at contexts 4500…6000 with and without a 512-token chunk at 5000
   (bf16 and int8 pages, 64-page tables trimmed below each row's window
   onto a trash page of NaN, so a read of a trimmed page would show) and
   flash at S 6144, each timed against SDPA and the bound of the keys
   inside the window;
4. serve ``qwen3-8b`` at full width (36 layers, random bf16 weights from
   a seed) through the port's HTTP server at ``--max-model-len 4096``
   (phases 4-6 as the earlier slices served: ``--no-prefix-caching
   --no-token-budget``):
   four requests, two of them SSE; every request must return its full
   length, the served tokens must be the greedy choice of a plain
   full-sequence forward that runs none of the kernels, and the
   flash-prefill and split-KV decode kernels must have launched; then
   the decode-step profile (wall, CPU and device ms, kernel launches a
   step, the top kernels), which must show one page-walk kernel,
   launched once per layer;
5. the same weights at ``--max-model-len 2048``: decode takes the single
   page walk, whose kernel must have launched; then the decode-step
   profile;
6. the same weights with int8 KV pages (``--kv-cache-dtype int8``), at
   ``--max-model-len 4096`` (the int8 split walk must launch; the plain
   forward reads K/V through ``kv_quantize`` for the decoded rows, as
   the engine's pages hold them; then its decode-step profile, as in
   phase 4) and at 2048 (the int8 single walk);
7. the serve defaults, prefix caching and fused steps, with
   ``--tokens-per-step 512``, on bf16 pages at 4096 (split walk) and 2048
   (single walk) and on int8 pages at 2048: the budget the engine's
   calibration derives on this card is printed, then a miss of a
   1024-token prefix plus a tail, three hits on that prefix (tails 64-200)
   and, while they decode, a long prompt chunked into fused steps; the
   hits must have computed only their suffixes, fused steps must have run
   with one walk launch per layer per forward, and every served token
   must pass the greedy check; then the fused step's profile (one walk
   kernel, one launch per layer a step);
8. speculative decoding (``--speculative-ngram 4``, ``--tokens-per-step
   512``) on bf16 pages at 4096 (split walk) and 2048 (single walk) and
   on int8 pages at 2048: four prompts that quote a passage and ask for
   it again, served greedy and then seeded sampled (temperature 0.8,
   top_k 40); every accepted greedy draft must be the window's argmax,
   every greedy token must pass the greedy check and every ragged
   forward must launch one walk per layer; drafts proposed and accepted,
   tokens per row and step, SSE decode tok/s per stream and a decode
   step's wall, thread-CPU and device ms are printed, then the same for
   an engine without speculation on the same prompts, whose greedy
   streams must equal those with speculation token for token; on the
   first leg, a
   request with ``logprobs: 3`` and a ``logit_bias``, and a seeded top-k
   stream that must be the same when served twice;
9. decode bursts (``--decode-burst 8``, pipelined, CUDA graphs), with
   ``--tokens-per-step 512`` and no prefix cache, on bf16 pages at 4096
   (split walk) and 2048 (single walk) and on int8 pages at 2048: a
   greedy and a seeded (temperature 0.8, top_k 40) request served alone,
   in a full batch of 8 and beside an 1800-token prompt chunked at the
   budget, on a burst engine, a per-token engine without the fused step
   and one with it; each must serve each request the same tokens in
   every case, and all three the same as each other; on the 4096 leg one
   burst's
   graph replay must equal eager ``decode_burst`` bit for bit; the wall,
   thread-CPU and device ms and kernel launches per token of each of 8
   streams decoding in bursts (pipelined, and on the 4096 leg
   unpipelined) and per token, the graphs' capture seconds and pool
   bytes, and on the 4096 leg one forward's device ms (decode at 8 and 2
   live rows, a fused step, a prefill) through the kernels, with the
   unfused norm chain and through ``torch.matmul`` (K C L L C K); then ``engine
   serve`` with the CLI defaults through the server: a cold request's
   TTFT (it carries the captures), four SSE requests' TTFT and decode
   tok/s per stream, the burst counters, and the greedy check;
10. guided decoding through the server at 2048 on bf16 pages, a
    ``--decode-burst 8`` engine: three unguided greedy streams alone,
    then beside json_object and json_schema requests (greedy and
    seeded); every guided request that stops must parse and conform to
    its schema, the closed schema's requests must stop, and the unguided
    streams must equal their alone streams; the guided rows' wall ms a
    token and the guided host work a step are printed.

11. qwen3-1.7b at full width (28 layers, tied head, H16 on KV8: the walks
    at G 2) through ``engine serve``'s ``engine_from_args`` at ``--max-batch-size 32
    --no-token-budget``, bf16 pages at 4096 (split walk) and int8 pages at
    2048 (single walk): 32 greedy requests (prompts of 128…768 token ids,
    128 tokens each) at once with the decode defaults (``--decode-burst
    8``, pipelined), again with ``--decode-burst 1``, then one at a time;
    every stream must be the same all three ways, four must pass the
    greedy check, and the engine's walk must have launched; the wall,
    thread-CPU and device ms a token of each of 32 streams, the launches a
    step and the graphs' capture seconds are printed;
12. mistral-7b at full width (32 layers, no QK-norm, window 4096) at
    ``--max-model-len 8192 --tokens-per-step 512`` on bf16 and int8 pages:
    four prompts of 4500…6000 token ids chunked through the walks and 256
    greedy tokens each on a burst, a per-token and a
    ``--speculative-ngram 4`` engine; all three must serve the same
    tokens, every token must pass a windowed greedy check, every decoding
    sequence must hold at most ``ceil(4096 / 128) + 1 + span`` real pages
    after each step, pages must have been freed by ``trim_window`` (the
    count is printed) and the pool must drain; the decode step's wall,
    CPU and device ms over the four long rows and at phase 4's shape,
    beside qwen3-8b's there;
13. the loader: ``save_hf_checkpoint`` writes mistral-7b's widths at 4
    layers (~2.3 GB of bf16 safetensors) under ``build/``, ``engine serve
    --load-hf DIR`` serves two SSE requests from it under the name
    ``mistral-7b``; the loaded tensors must equal those written and the
    tokens those of an engine built alike from the parameters in memory;
    the directory is removed.

After phase 13 it prints the serve legs' launches by shape: the GEMM by
weight (K x N), the norms by width (the fused q/k kernel by heads and
page type), flash by batch and length, the page walks by tokens a
launch.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core
# rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 outputs against f32-math plain versions on the same bf16 inputs:
# |kernel - plain| <= RTOL·|plain| + row_tol·rms(plain row) elementwise,
# a row being one (token, query head) output vector of head_dim values.
# RTOL covers the final bf16 rounding of both sides (one ulp is at most
# 2^-7 of the value); row_tol, per kernel, covers what the kernel rounds
# on the way.  Skipping one 128-key page of a 4000-key row moves that
# row's outputs by ~0.18·rms, far beyond either row_tol.
RTOL = 1e-2
FLASH_ROW_TOL = 2e-2  # P is rounded to bf16 for the P·V product
PAGED_ROW_TOL = 2e-3  # f32 throughout; only the output is rounded
# the query-window kernel (prefill, verify) rounds P, or P times the V
# scale, to bf16 for its tensor-core P·V product, as flash does
WINDOW_ROW_TOL = 2e-2

SEED = 0
N_REQUESTS_PROMPTS = (64, 300, 800, 1500)  # byte-tokens per prompt
MAX_TOKENS = 32
# the served batch's decode contexts (tokens incl. the new one), ps 128
DECODE_CTX = (100, 600, 1100, 1600, 2100, 2600, 3300, 4000)
# the same at the 2048 serve leg's shape (max-model-len 2048: 16 pages)
DECODE_CTX_2048 = (64, 300, 550, 800, 1050, 1300, 1650, 2048)
# the decode-step profile's contexts (prompts of 100…1500 plus the first
# decoded token), at which the 4096 serve leg runs the split walk
DECODE_CTX_SERVE = (101, 301, 501, 701, 901, 1101, 1301, 1501)
KV_HEADS, GROUP, HEAD_DIM, PAGE = 8, 4, 128, 128
# the fused step's shape: the 8 decode rows plus a 512-token prefill chunk
# starting at position 1024 (tokens per step 512, a chunk of a long prompt)
FUSED_CHUNK = (1024, 512)
# the prefix-cache / chunked-prefill serve legs (phase 7): a shared prefix
# of 1023 byte-tokens plus BOS (8 full pages), tails of 16-200 tokens, one
# long prompt per leg, every request SSE with MAX_TOKENS greedy tokens
PREFIX_TAILS = (16, 64, 128, 200)
TOKENS_PER_STEP = 512
# speculative decoding (phase 8, and the spec shape of phase 3): drafts per
# row, the served tokens of each request
SPEC_K = 4
SPEC_MAX_TOKENS = 64
# the page walks' kernel names in a profile: this tree's one kernel, and
# the split walk's two kernels of earlier trees (for tools/walk_ab.py)
WALK_KERNELS = ("walk_kernel", "split_kernel", "kvsplit_combine_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing -------------------------------------------------------------------


def time_events(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` bracketed by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_graph(fn, reps: int = 20, per_graph: int = 10) -> float:
    """Median device ms of one ``fn()``: ``per_graph`` back-to-back calls
    captured in a CUDA graph, replayed ``reps`` times, so host overhead of
    the Python wrapper is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_events(graph.replay, reps=reps) / per_graph


def time_library(calls, group: int) -> float | None:
    """Device ms of ``scaled_dot_product_attention`` over ``calls``, a list
    of ``(q, k, v, kwargs)`` that together compute the same function (the
    yardstick; the port never calls it): GQA in the call where this torch
    has ``enable_gqa``, else over heads expanded beforehand.  None when no
    SDPA backend takes the inputs."""
    import torch.nn.functional as F

    def gqa():
        for q, k, v, kw in calls:
            F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)

    try:
        try:
            gqa()
            return time_graph(gqa)
        except TypeError:
            expanded = [(q, k.repeat_interleave(group, dim=1),
                         v.repeat_interleave(group, dim=1), kw) for q, k, v, kw in calls]

            def plain_heads():
                for q, k, v, kw in expanded:
                    F.scaled_dot_product_attention(q, k, v, **kw)

            return time_graph(plain_heads)
    except RuntimeError as e:
        log(f"  sdpa yardstick unavailable: {e}")
        return None


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- phase 3: kernels against plain versions -----------------------------------


def check_close(out, ref, what: str, row_tol: float, head_dim: int) -> tuple[float, float]:
    """(max abs error, max row error) of ``out`` against ``ref``, the row
    error being the excess over RTOL·|ref| in units of the row's RMS;
    raises unless every element is finite and the row error is at most
    ``row_tol`` (a row of zeros must match exactly)."""
    import torch

    torch.cuda.synchronize()
    o = out.float().reshape(-1, head_dim)
    r = ref.float().reshape(-1, head_dim)
    diff = (o - r).abs()
    rms = r.square().mean(dim=-1, keepdim=True).sqrt()
    excess = (diff - RTOL * r.abs()).clamp(min=0)
    row_err = torch.where(rms > 0, excess / rms.clamp(min=1e-30),
                          torch.where(excess > 0, float("inf"), 0.0)).max().item()
    if not torch.isfinite(out).all() or row_err > row_tol:
        raise AssertionError(f"{what}: row error {row_err:.3e} beyond {row_tol} "
                             f"(|err| <= {RTOL}·|ref| + {row_tol}·rms(row)); "
                             f"max abs err {diff.max().item():.3e}")
    return diff.max().item(), row_err


def check_flash(gen, B: int, S: int, H: int = 32, window: int | None = None) -> dict:
    """Flash at ``[B, S]`` with ``H`` query heads on 8 KV heads (head_dim
    128), causal, optionally within ``window``: against the plain version,
    kernel / plain / SDPA ms and the bound (the pairs inside the window)."""
    import torch

    from fusioninfer_tpu_torch.ops import flash_attention as fa

    KV, Hd = 8, 128
    dev = "cuda"
    q = torch.randn((B, S, H, Hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, Hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, Hd), generator=gen, device=dev).to(torch.bfloat16)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    ref = fa.reference_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    tag = f"flash B{B} S{S} H{H}" + (f" window {window}" if window else "")
    err, row_err = check_close(out, ref, tag, FLASH_ROW_TOL, Hd)
    del ref
    ms = time_graph(lambda: fa.flash_attention(q, k, v, causal=True, window=window))
    plain_ms = time_events(lambda: fa.reference_attention(q, k, v, causal=True, window=window),
                           reps=20 if window is None else 3, warmup=3 if window is None else 1)
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        kw = {"is_causal": True}
    else:  # query i sees keys (i - window, i]
        i = torch.arange(S, device=dev)
        kw = {"attn_mask": (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)}
    library_ms = time_library([(qT, kT, vT, kw)], H // KV)
    w = S if window is None else min(window, S)
    pairs = B * H * (w * (w + 1) / 2 + (S - w) * w)  # causal (query, key) pairs in the window
    flops = 4 * pairs * Hd
    nbytes = 2 * (2 * B * S * H * Hd + 2 * B * S * KV * Hd)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  {tag}: abs err {err:.3e} row err {row_err:.3e} (bound {FLASH_ROW_TOL}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {library_ms} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": f"B{B} S{S} H{H} KV{KV} Hd{Hd}" + (f" window {window}" if window else ""),
            "max_abs_err": err,
            "max_row_err": row_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# qwen3-8b's projections, (K, N) by weight: wq and wo, wk and wv, gate and
# up share a shape
GEMM_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "gate/up": (4096, 12288),
               "down": (12288, 4096), "lm_head": (4096, 151936)}
# row counts the serve path gives them: a decode row, live decode slots,
# 8 slots, 8 spec windows of 5, one tile, one past it, a fused step, a
# long prefill
GEMM_ROWS = (1, 2, 8, 40, 64, 65, 520, 3000)
# the GEMM accumulates in f32 and rounds once; the norm's statistics are f32
GEMM_ROW_TOL = 2e-3
NORM_ROW_TOL = 2e-3
# the weights a cold timing cycles through, together: four times the L2
COLD_BYTES = 200_000_000
# qwen3-8b's norms, D by kind, with the rows per token: the layer and final
# norms over d_model, the q and k norms over head_dim per head
NORM_SHAPES = {"d_model": (4096, 1), "q_norm": (128, 32), "k_norm": (128, 8)}
# the kernels every projection and norm of a forward launches
PROJECTION_KERNELS = ("gemm", "rms_norm", "add_rms_norm", "qk_norm_rope_kv")
# neither kernel replaces a Pallas kernel: the JAX lines whose XLA ops they
# take over (swiglu's gate product, rms_norm) stand in the "replaces" field
JAX_DOT_LINE = 60
JAX_NORM_LINE = 32


def bit_rows(M: int, gen) -> list[int]:
    """Rows whose M = 1 result anchors the row-invariance check: the first
    eight, the edges of the 64-row tiles the row counts reach, the last,
    and 16 drawn from the seed."""
    import torch

    rows = set(range(8)) | {39, 63, 64, 519, M - 1}
    rows |= set(torch.randint(0, M, (16,), generator=gen, device="cuda").tolist())
    return sorted(r for r in rows if r < M)


def check_invariant(fn, x_all, gen, what: str, rows=GEMM_ROWS) -> None:
    """``fn(x)`` at every row count of ``rows`` must give each row the
    bits the largest count gives it, and the largest count each anchor
    row's bits of a one-row call (:func:`check_rows_invariant`)."""
    check_rows_invariant(lambda lo, hi: fn(x_all[lo:hi]), x_all.shape[0], gen, what, rows)


def check_rows_invariant(run, M: int, gen, what: str, rows=GEMM_ROWS) -> None:
    """``run(lo, hi)`` (rows lo..hi-1 → one output row each) at every row
    count of ``rows`` must give each row the bits the largest count gives
    it, and the largest count each anchor row's bits of a one-row call."""
    import torch

    full = run(0, M)
    for m in rows[:-1]:
        if not torch.equal(run(0, m), full[:m]):
            raise AssertionError(f"{what}: rows at M {m} differ from the same rows at M {M}")
    for r in bit_rows(M, gen):
        if not torch.equal(run(r, r + 1)[0], full[r]):
            raise AssertionError(f"{what}: row {r} at M {M} differs from the same row alone")


def time_cold(fn, weights, reps: int) -> float:
    """Median device ms of one ``fn(w)`` with the weight cold in L2: each
    graph calls ``fn`` once on every copy in ``weights`` (together more
    than the 50 MB L2), so no call finds its weight left by the last."""
    return time_graph(lambda: [fn(w) for w in weights], reps=reps, per_graph=1) / len(weights)


def check_gemm(gen, shapes=GEMM_SHAPES, row_counts=GEMM_ROWS) -> dict:
    """The GEMM kernel (``ops.gemm.matmul``) at each qwen3-8b projection
    shape and every row count of GEMM_ROWS: against the plain ``x @ w``
    (``check_close``, rows of N), row bits invariant across the row
    counts, kernel ms against ``torch.matmul`` and the bound, both timed
    warm (graph replays of one weight) and cold (graph replays over
    copies of the weight that together exceed the L2, as the main path
    meets each layer's weights); plain ms eager."""
    import torch

    from fusioninfer_tpu_torch.ops import gemm

    out = {}
    M_max = max(row_counts)
    for name, (K, N) in shapes.items():
        w = (torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5).to(torch.bfloat16)
        x_all = torch.randn((M_max, K), generator=gen, device="cuda").to(torch.bfloat16)
        check_invariant(lambda x: gemm.matmul(x, w), x_all, gen, f"gemm {name}", row_counts)
        copies = [w] + [w.clone() for _ in range(-(-COLD_BYTES // (2 * K * N)) - 1)]
        splits = gemm.split_k(N, K)
        per_m = {}
        for M in row_counts:
            x = x_all[:M]
            y = gemm.matmul(x, w)
            err, row_err = check_close(y, gemm.reference_matmul(x, w), f"gemm {name} M{M}",
                                       GEMM_ROW_TOL, N)
            reps = 5 if M * N * K > 1e12 else 20
            ms = time_graph(lambda: gemm.matmul(x, w), reps=reps, per_graph=5)
            lib_ms = time_graph(lambda: torch.matmul(x, w), reps=reps, per_graph=5)
            cold_ms = time_cold(lambda wc: gemm.matmul(x, wc), copies, reps)
            cold_lib_ms = time_cold(lambda wc: torch.matmul(x, wc), copies, reps)
            plain_ms = time_events(lambda: gemm.reference_matmul(x, w), reps=reps)
            bound_ms, bound_by = bound(2.0 * M * N * K, 2.0 * (M * K + K * N + M * N))
            rows, cols, pair = gemm.tile_shape(M, N, K)
            per_m[M] = {"max_abs_err": err, "max_row_err": row_err, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms, "cold_ms": cold_ms,
                        "cold_library_ms": cold_lib_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "tile": [rows, cols], "pair": pair,
                        "cluster": splits * pair, "splits": splits}
        out[name] = {"K": K, "N": N, "splits": splits, "cold_copies": len(copies),
                     "rows": per_m}
        log(f"  gemm {name} K{K} N{N} (splits {splits}): rows bit-identical at "
            f"M {', '.join(map(str, row_counts))} and alone; tile (x2: pairs), cluster, "
            f"kernel / torch.matmul ms warm, cold ({len(copies)} copies of the weight), "
            "bound: " + "; ".join(
                f"M{M} {r['tile'][0]}x{r['tile'][1]}{'x2' if r['pair'] == 2 else ''} "
                f"CL{r['cluster']} {r['ms']:.4f} / {r['library_ms']:.4f}, "
                f"{r['cold_ms']:.4f} / {r['cold_library_ms']:.4f}, {r['bound_ms']:.4f}"
                for M, r in per_m.items()))
        del w, x_all, copies
    return out


def check_norm(gen, shapes=NORM_SHAPES, row_counts=GEMM_ROWS) -> dict:
    """The RMSNorm kernel at qwen3-8b's norm widths over the rows of every
    token count of GEMM_ROWS: against the plain version, row bits
    invariant across the counts, kernel ms against
    ``torch.nn.functional.rms_norm`` (where this torch has it) and the
    bound."""
    import torch
    import torch.nn.functional as F

    from fusioninfer_tpu_torch.ops import rms_norm as rn

    out = {}
    eps = 1e-6
    for name, (D, per_tok) in shapes.items():
        w = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(torch.bfloat16)
        x_all = torch.randn((max(row_counts), per_tok, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
        check_invariant(lambda x: rn.rms_norm(x, w, eps), x_all, gen, f"rms_norm {name}",
                        row_counts)
        per_m = {}
        for M in row_counts:
            x = x_all[:M]
            y = rn.rms_norm(x, w, eps)
            err, row_err = check_close(y, rn.reference_rms_norm(x, w, eps),
                                       f"rms_norm {name} M{M}", NORM_ROW_TOL, D)
            ms = time_graph(lambda: rn.rms_norm(x, w, eps))
            plain_ms = time_events(lambda: rn.reference_rms_norm(x, w, eps))
            lib_ms = None
            if hasattr(F, "rms_norm"):
                lib_ms = time_graph(lambda: F.rms_norm(x, (D,), w, eps))
            bound_ms, bound_by = bound(4.0 * x.numel(), 2.0 * (2 * x.numel() + D))
            per_m[M] = {"max_abs_err": err, "max_row_err": row_err, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}
        out[name] = {"D": D, "rows_per_token": per_tok, "rows": per_m}
        log(f"  rms_norm {name} D{D} x{per_tok} a token: rows bit-identical at every count "
            "and alone; kernel / F.rms_norm / bound ms: " + "; ".join(
                f"M{M} {r['ms']:.4f} / {r['library_ms']} / {r['bound_ms']:.4f}"
                for M, r in per_m.items()))
    return out


# the fused q/k kernel rounds q and k to bf16 between the norm and RoPE:
# where the plain norm's f32 statistics differ from the kernel's in a last
# bit, an input moves by one bf16 ulp (2^-8 of values up to ~4 rms), which
# the rotation carries to the output
QK_ROW_TOL = 2e-2
# the fused kernels' shapes at qwen3-8b: the residual stream's width, and
# q / k / v heads a token
ADD_NORM_D = 4096
QK_HEADS = (32, 8, 128)
# the JAX lines whose XLA ops the fused kernels take over: the residual add
# before the MLP norm (layer_forward) and RoPE (qkv_proj)
JAX_ADD_LINE = 331
JAX_ROPE_LINE = 247


def chain_add_rms_norm(x, delta, w, eps):
    """The unfused chain ``add_rms_norm`` replaces: torch's bf16 add, then
    the RMSNorm kernel (the yardstick; the port never calls it)."""
    from fusioninfer_tpu_torch.ops import rms_norm as rn

    s = x + delta
    return s, rn.rms_norm(s, w, eps)


def chain_qk_norm_rope_kv(q, k, v, q_norm, k_norm, rope, eps, *, cache=None, layer=0,
                          write_page=None, write_slot=None, k_out=True):
    """The unfused chain ``qk_norm_rope_kv`` replaces: the RMSNorm kernel on
    q and k, ``rotate``, ``scatter_kv`` (the yardstick)."""
    from fusioninfer_tpu_torch.ops import rms_norm as rn

    if q_norm is not None:
        q, k = rn.rms_norm(q, q_norm, eps), rn.rms_norm(k, k_norm, eps)
    q, k = rn.rotate(q, rope), rn.rotate(k, rope)
    if cache is not None:
        rn.scatter_kv(cache, layer, k, v, write_page, write_slot, head_axis=k.dim() - 2)
    return q, (k if k_out else None)


def check_add_norm(gen, D: int = ADD_NORM_D, row_counts=GEMM_ROWS) -> dict:
    """``add_rms_norm`` at d_model over every row count of GEMM_ROWS: s and
    h bit for bit the unfused chain's (torch's add, the norm kernel), each
    row's bits the same at every count and alone, h within ``check_close``
    of the plain version; kernel ms against the chain's and the bound."""
    import torch

    from fusioninfer_tpu_torch.ops import rms_norm as rn

    eps = 1e-6
    M_max = max(row_counts)
    w = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(torch.bfloat16)
    x_all = torch.randn((M_max, D), generator=gen, device="cuda").to(torch.bfloat16)
    d_all = torch.randn((M_max, D), generator=gen, device="cuda").to(torch.bfloat16)
    check_rows_invariant(lambda lo, hi: torch.cat(
        rn.add_rms_norm(x_all[lo:hi], d_all[lo:hi], w, eps), dim=1), M_max, gen,
        f"add_rms_norm D{D}", row_counts)
    per_m = {}
    for M in row_counts:
        x, d = x_all[:M], d_all[:M]
        s, h = rn.add_rms_norm(x, d, w, eps)
        cs, ch = chain_add_rms_norm(x, d, w, eps)
        if not (torch.equal(s, cs) and torch.equal(h, ch)):
            raise AssertionError(f"add_rms_norm M{M}: not the unfused chain's bits")
        ps_, ph = rn.reference_add_rms_norm(x, d, w, eps)
        if not torch.equal(s, ps_):
            raise AssertionError(f"add_rms_norm M{M}: s is not the plain add's")
        err, row_err = check_close(h, ph, f"add_rms_norm M{M}", NORM_ROW_TOL, D)
        ms = time_graph(lambda: rn.add_rms_norm(x, d, w, eps))
        chain_ms = time_graph(lambda: chain_add_rms_norm(x, d, w, eps))
        plain_ms = time_events(lambda: rn.reference_add_rms_norm(x, d, w, eps))
        bound_ms, bound_by = bound(5.0 * M * D, 2.0 * (4 * M * D + D))
        per_m[M] = {"max_abs_err": err, "max_row_err": row_err, "ms": ms,
                    "chain_ms": chain_ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"  add_rms_norm D{D}: s and h bit for bit the chain's (add + rms_norm kernel) and "
        "every row the same at every count and alone; kernel / chain / bound ms: " + "; ".join(
            f"M{M} {r['ms']:.4f} / {r['chain_ms']:.4f} / {r['bound_ms']:.4f}"
            for M, r in per_m.items()))
    return {"D": D, "rows": per_m}


def check_qk_norm_rope_kv(gen, int8: bool, heads=QK_HEADS, norms: bool = True,
                          row_counts=GEMM_ROWS) -> dict:
    """``qk_norm_rope_kv`` at qwen3-8b's heads over every token count of
    GEMM_ROWS into layer 1 of a pool (bf16, or int8 with scales) that holds
    data, as ``fused_step`` calls it (no k out; every 11th token a padding
    token on the trash page), and with k out as ``prefill`` calls it: q, k
    and every page but the trash page's colliding writes bit for bit the
    unfused chain's (the norm kernel, ``rotate``, ``scatter_kv``), each
    token's q, k and page rows the same at every count and alone, q and k
    within ``check_close`` of the plain version; kernel ms (the fused
    step's call) against the chain's and the bound."""
    import torch

    from fusioninfer_tpu_torch.models.transformer import rope_tables
    from fusioninfer_tpu_torch.ops import rms_norm as rn

    H, KV, Hd = heads
    eps, L, ps, layer = 1e-6, 2, PAGE, 1
    M_max = max(row_counts)
    n_pages = -(-M_max // ps) + 1
    trash = n_pages - 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q_all, k_all, v_all = randn(M_max, H, Hd), randn(M_max, KV, Hd), randn(M_max, KV, Hd)
    qn = (1 + 0.1 * torch.randn((Hd,), generator=gen, device="cuda")).to(torch.bfloat16)
    kn = (1 + 0.1 * torch.randn((Hd,), generator=gen, device="cuda")).to(torch.bfloat16)
    if not norms:  # a model without QK-norm (mistral-7b): RoPE and the page write only
        qn = kn = None
    pos_all = torch.randint(0, 32768, (M_max,), generator=gen, device="cuda")
    cos_all, sin_all = rope_tables(pos_all, Hd, 1e6)  # [M, 1, Hd / 2], a row a token
    perm = torch.randperm(trash, generator=gen, device="cuda")
    tok = torch.arange(M_max, device="cuda")
    page_live = perm[tok // ps]  # a slot of its own for every token
    page_all = torch.where(tok % 11 == 10, trash, page_live)
    slot_all = tok % ps
    shape = (L, KV, n_pages, ps, Hd)
    if int8:
        init = {"k": torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                   dtype=torch.int8),
                "v": torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                   dtype=torch.int8),
                "k_scale": torch.rand((L, KV, n_pages, 1, ps), generator=gen, device="cuda"),
                "v_scale": torch.rand((L, KV, n_pages, 1, ps), generator=gen, device="cuda")}
    else:
        init = {"k": randn(*shape), "v": randn(*shape)}

    def pools():
        return {name: t.clone() for name, t in init.items()}

    def call(fn, lo, hi, cache, page=page_all, k_out=False):
        return fn(q_all[lo:hi], k_all[lo:hi], v_all[lo:hi], qn, kn,
                  (cos_all[lo:hi], sin_all[lo:hi]), eps, cache=cache, layer=layer,
                  write_page=page[lo:hi], write_slot=slot_all[lo:hi], k_out=k_out)

    inv_cache = pools()

    def run(lo, hi):  # every token's q, k and page rows as bytes
        q, k = call(rn.qk_norm_rope_kv, lo, hi, inv_cache, page=page_live, k_out=True)
        pg, sl = page_live[lo:hi], slot_all[lo:hi]
        rows = [q.reshape(hi - lo, -1), k.reshape(hi - lo, -1)]
        for name, t in inv_cache.items():
            t = t[layer, :, :, 0] if "scale" in name else t[layer]  # [KV, n_pages, ps(, Hd)]
            rows.append(t[:, pg, sl].movedim(0, 1).reshape(hi - lo, -1))
        return torch.cat([r.contiguous().view(torch.uint8) for r in rows], dim=1)

    tag = (f"qk_norm_rope_kv {'int8' if int8 else 'bf16'} H{H} KV{KV}"
           + ("" if norms else " without norms"))
    check_rows_invariant(run, M_max, gen, tag, row_counts)
    per_m = {}
    for M in row_counts:
        ours, chain, plain = pools(), pools(), pools()
        for k_out in (False, True):  # as fused_step calls it, then as prefill does
            q, k = call(rn.qk_norm_rope_kv, 0, M, ours, k_out=k_out)
            cq, ck = call(chain_qk_norm_rope_kv, 0, M, chain, k_out=k_out)
            if not torch.equal(q, cq) or (k_out and not torch.equal(k, ck)):
                raise AssertionError(f"{tag} M{M}: q or k not the unfused chain's bits")
            for name in ours:
                if not torch.equal(ours[name][:, :, :trash], chain[name][:, :, :trash]):
                    raise AssertionError(f"{tag} M{M}: {name} pages not the chain's bits")
        pq, pk = call(rn.reference_qk_norm_rope_kv, 0, M, plain, k_out=True)
        err_q, row_q = check_close(q, pq, f"{tag} q M{M}", QK_ROW_TOL, Hd)
        err_k, row_k = check_close(k, pk, f"{tag} k M{M}", QK_ROW_TOL, Hd)
        ms = time_graph(lambda: call(rn.qk_norm_rope_kv, 0, M, ours))
        chain_ms = time_graph(lambda: call(chain_qk_norm_rope_kv, 0, M, chain))
        plain_ms = time_events(lambda: call(rn.reference_qk_norm_rope_kv, 0, M, plain))
        page_bytes = (Hd + 4) if int8 else 2 * Hd  # a (token, head)'s page row
        nbytes = M * (2 * H * Hd * 2 + 2 * KV * Hd * 2 + 2 * KV * page_bytes
                      + 2 * (Hd // 2) * 4 + 16) + 2 * Hd * 2
        if not norms:
            nbytes -= 2 * Hd * 2
        bound_ms, bound_by = bound(M * (H + KV) * Hd * (8.0 if norms else 4.0), nbytes)
        per_m[M] = {"max_abs_err": max(err_q, err_k), "max_row_err": max(row_q, row_k),
                    "ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"  {tag} Hd{Hd}: q, k and pages bit for bit the chain's ("
        + ("rms_norm kernel + " if norms else "") + "rotate + scatter_kv), every token the "
        "same at every count and alone; "
        "kernel / chain / bound ms: " + "; ".join(
            f"M{M} {r['ms']:.4f} / {r['chain_ms']:.4f} / {r['bound_ms']:.4f}"
            for M, r in per_m.items()))
    return {"H": H, "KV": KV, "Hd": Hd, "pages": "int8" if int8 else "bf16", "norms": norms,
            "rows": per_m}


def paged_pool(gen, rows, int8: bool, L: int = 2, mp: int = 32):
    """A stacked ``[L, KV, n_pages, ps, Hd]`` pool (random bf16, or int8
    with f32 scales from ``kv_quantize``) holding the pages of ``rows``
    ``[(start, n)]``, each row on its own randomly placed pages:
    ``(k, v, k_scales, v_scales, page_tables [R, mp])``."""
    import torch

    from fusioninfer_tpu_torch.models.quantization import kv_quantize

    need = [-(-(s + n) // PAGE) for s, n in rows]
    n_pages = sum(need) + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(SEED))
    tables = torch.full((len(rows), mp), n_pages - 1, dtype=torch.int32)
    it = iter(perm.tolist())
    for r, n in enumerate(need):
        for i in range(n):
            tables[r, i] = next(it)
    shape = (L, KV_HEADS, n_pages, PAGE, HEAD_DIM)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    if not int8:
        return kp, vp, None, None, tables.cuda()
    (k8, ks), (v8, vs) = kv_quantize(kp), kv_quantize(vp)
    return (k8, v8, ks[..., None, :].contiguous(), vs[..., None, :].contiguous(),
            tables.cuda())


def ragged_batch(rows, pad: int = 0):
    """``(row_starts, q_begins, q_lens)`` on the card for rows ``[(start,
    n)]`` laid out in order, and the token count with ``pad`` padding
    tokens (in no row) after them."""
    import torch

    q_lens = torch.tensor([n for _, n in rows], dtype=torch.int32)
    q_begins = torch.cumsum(q_lens, 0, dtype=torch.int32) - q_lens
    starts = torch.tensor([s for s, _ in rows], dtype=torch.int32)
    return (*(t.cuda() for t in (starts, q_begins, q_lens)), int(q_lens.sum()) + pad)


def attention_cost(rows, int8: bool, group: int = GROUP,
                   window: int | None = None) -> tuple[float, float]:
    """(FLOP, bytes) of causal paged attention for rows ``[(start, n)]``:
    each live K/V byte read once (int8 pages: Hd codes + one f32 scale
    per token and head), each query read and each output written once;
    with ``window``, only the keys some query of the row sees."""
    H = KV_HEADS * group
    if window is None:
        keys = sum(s + n for s, n in rows)  # live keys per KV head
        pairs = sum(n * s + n * (n + 1) / 2 for s, n in rows)  # (query, key) pairs
    else:  # the query at p sees keys (p - window, p]
        keys = sum(s + n - max(0, s - window + 1) for s, n in rows)
        pairs = sum(min(p + 1, window) for s, n in rows for p in range(s, s + n))
    T = sum(n for _, n in rows)
    per_key = HEAD_DIM + 4 if int8 else 2 * HEAD_DIM
    return 4 * pairs * H * HEAD_DIM, 2 * keys * KV_HEADS * per_key + 2 * T * H * HEAD_DIM * 2


def sdpa_calls(q_flat, kp, vp, tables, rows, window: int | None = None):
    """The library yardstick's calls: one SDPA per row over that row's
    live keys (with ``window``, those some query of the row sees),
    gathered from the bf16 pages of one layer beforehand (the gather is
    not timed); q_flat ``[T, H, Hd]`` holds the rows' tokens in order."""
    import torch

    calls, t0 = [], 0
    for r, (start, n) in enumerate(rows):
        n_keys = start + n
        lo = 0 if window is None else max(0, start - window + 1)
        pages = tables[r, : -(-n_keys // PAGE)].long()
        k_r = kp[:, pages].reshape(KV_HEADS, -1, HEAD_DIM)[None, :, lo:n_keys]
        v_r = vp[:, pages].reshape(KV_HEADS, -1, HEAD_DIM)[None, :, lo:n_keys]
        q_r = q_flat[t0: t0 + n].transpose(0, 1)[None]
        kw = {}
        if n > 1:  # token i of the row sees keys [0, start + i], or its window's
            key = lo + torch.arange(n_keys - lo, device=q_flat.device)[None, :]
            pos = start + torch.arange(n, device=q_flat.device)[:, None]
            kw["attn_mask"] = (key <= pos) & (
                True if window is None else key > pos - window)
        calls.append((q_r, k_r.contiguous(), v_r.contiguous(), kw))
        t0 += n
    return calls


def measure(name: str, shape: str, kern, plain, row_tol: float, rows, int8: bool,
            library, group: int = GROUP, window: int | None = None,
            plain_reps: int = 20) -> dict:
    """Kernel against plain version (``check_close``), then kernel ms (CUDA
    graph), plain ms, library ms (``library()`` gives the SDPA calls, or
    None where no PyTorch call computes the same function) and bound."""
    err, row_err = check_close(kern(), plain(), f"{name} [{shape}]", row_tol, HEAD_DIM)
    ms = time_graph(kern)
    plain_ms = time_events(plain, reps=plain_reps, warmup=min(2, plain_reps))
    calls = library()
    library_ms = time_library(calls, group) if calls is not None else None
    bound_ms, bound_by = bound(*attention_cost(rows, int8, group, window))
    log(f"  {name} [{shape}]: abs err {err:.3e} row err {row_err:.3e} (bound {row_tol}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {library_ms} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": shape, "max_abs_err": err, "max_row_err": row_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_paged(gen, split: bool, int8: bool = False) -> dict:
    """A ragged walk against its plain version on the mixed case (the 8
    decode rows plus a 64-token prefill-chunk row at position 1000), then
    at the decode step's shape (8 decode rows, contexts 100…4000), whose
    numbers it returns; a two-layer pool read at layer 1, max context
    4096."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    layer = 1
    name = ("split-KV" if split else "single walk") + (" int8" if int8 else "")
    walk = pa.ragged_paged_attention_kvsplit if split else pa.ragged_paged_attention
    plain_walk = (pa.reference_ragged_paged_attention_kvsplit if split
                  else pa.reference_ragged_paged_attention)
    result = {}
    for multi_token in (True, False):
        rows = [(c - 1, 1) for c in DECODE_CTX] + ([(1000, 64)] if multi_token else [])
        kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
        *ragged, T = ragged_batch(rows)
        desc = (tables, *ragged)
        q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                        device="cuda").to(torch.bfloat16)
        scales = (ks, vs) if int8 else ()
        layer_scales = (ks[layer], vs[layer]) if int8 else ()

        def kern():
            return walk(q, kp, vp, *desc, *scales, layer=layer)

        def plain():
            return plain_walk(q, kp[layer], vp[layer], *desc, *layer_scales)

        shape = (f"T{q.shape[0]}: 8 decode rows ctx 100..4000"
                 + (" + a 64-token row at 1000" if multi_token else "") + ", ps 128"
                 + (", int8 pages" if int8 else ""))
        res = measure(f"paged {name}", shape, kern, plain, PAGED_ROW_TOL, rows, int8,
                      lambda: None if int8 else sdpa_calls(q, kp[layer], vp[layer],
                                                           tables, rows))
        res["max_abs_err"] = max(res["max_abs_err"], result.get("max_abs_err", 0.0))
        res["max_row_err"] = max(res["max_row_err"], result.get("max_row_err", 0.0))
        result = {**res, "mixed_case": result or None}
    return result


def check_walk_2048(gen, int8: bool) -> dict:
    """The single walk and paged decode at the 2048 serve leg's shape: 8
    decode rows with contexts up to 2048 over 16-page tables (a
    two-layer pool read at layer 1), each against its plain version,
    timed.  Returns ``{"single walk": ..., "paged decode": ...}``."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    layer, mp = 1, 16
    rows = [(c - 1, 1) for c in DECODE_CTX_2048]
    kp, vp, ks, vs, tables = paged_pool(gen, rows, int8, mp=mp)
    q = torch.randn((len(rows), KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    starts = torch.tensor([s for s, _ in rows], dtype=torch.int32, device="cuda")
    ones = torch.ones(len(rows), dtype=torch.int32, device="cuda")
    begins = torch.arange(len(rows), dtype=torch.int32, device="cuda")
    lengths = starts + 1
    sc = (ks, vs) if int8 else ()
    lsc = (ks[layer], vs[layer]) if int8 else ()
    shape = "8 decode rows ctx 64..2048, mp 16, ps 128" + (", int8 pages" if int8 else "")
    sdpa = (lambda: None) if int8 else (lambda: sdpa_calls(q, kp[layer], vp[layer], tables,
                                                           rows))
    return {
        "single walk": measure(
            "paged single walk" + (" int8" if int8 else ""), shape,
            lambda: pa.ragged_paged_attention(q, kp, vp, tables, starts, begins, ones, *sc,
                                              layer=layer),
            lambda: pa.reference_ragged_paged_attention(q, kp[layer], vp[layer], tables,
                                                        starts, begins, ones, *lsc),
            PAGED_ROW_TOL, rows, int8, sdpa),
        "paged decode": measure(
            "paged decode" + (" int8" if int8 else ""), shape,
            lambda: pa.paged_decode_attention(q, kp, vp, tables, lengths, *sc, layer=layer),
            lambda: pa.reference_paged_attention(q, kp[layer], vp[layer], tables, lengths,
                                                 *lsc),
            PAGED_ROW_TOL, rows, int8, sdpa)}


def check_clusters(gen) -> int:
    """Untimed checks of the single walk's and paged decode's cluster
    split, one batch per cluster size: a batch of T one-token rows, the
    largest T up to 40 for which the wrapper's rule
    (``pick_cluster_size``) gives that size on this card; contexts from
    5 keys (fewer pages than ranks: ranks with no keys) to 1500, and an
    inactive slot in decode; ps 16
    for CL 1 and 4, ps 128 for CL 2 and 8; bf16 pages without a window,
    int8 pages under a 300-key window that starts mid-page, past the
    first pages.  Each against its plain version.  Returns the number of
    cases."""
    import torch

    from fusioninfer_tpu_torch.models.quantization import kv_quantize
    from fusioninfer_tpu_torch.ops import paged_attention as pa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctx = (5, 37, 200, 700, 1500, 130, 1000, 64)
    n = 0
    for cl in pa.CLUSTER_SIZES:
        ps = 16 if cl in (1, 4) else 128
        mp = -(-1500 // ps)
        T = max(t for t in range(1, 41) if pa.pick_cluster_size(t, KV_HEADS, mp, sms) == cl)
        starts = torch.tensor([ctx[i % len(ctx)] - 1 for i in range(T)], dtype=torch.int32)
        n_pages = T * mp + 1
        tables = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(cl))
        tables = tables.reshape(T, mp).to(torch.int32).cuda()
        starts = starts.cuda()
        ones = torch.ones(T, dtype=torch.int32, device="cuda")
        begins = torch.arange(T, dtype=torch.int32, device="cuda")
        lengths = (starts + 1) * (begins != T // 2)  # one inactive slot
        q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                        device="cuda").to(torch.bfloat16)
        shape = (2, KV_HEADS, n_pages, ps, HEAD_DIM)
        kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for int8, window in ((False, None), (True, 300)):
            if int8:
                (k, k_s), (v, v_s) = kv_quantize(kp), kv_quantize(vp)
                sc = (k_s[..., None, :].contiguous(), v_s[..., None, :].contiguous())
            else:
                k, v, sc = kp, vp, ()
            lsc = tuple(x[1] for x in sc)
            tag = f"CL {cl} (T{T}, ps {ps}, window {window}{', int8' if int8 else ''})"
            check_close(pa.ragged_paged_attention(q, k, v, tables, starts, begins, ones, *sc,
                                                  window=window, layer=1),
                        pa.reference_ragged_paged_attention(q, k[1], v[1], tables, starts,
                                                            begins, ones, *lsc,
                                                            window=window),
                        f"single walk {tag}", PAGED_ROW_TOL, HEAD_DIM)
            check_close(pa.paged_decode_attention(q, k, v, tables, lengths, *sc,
                                                  window=window, layer=1),
                        pa.reference_paged_attention(q, k[1], v[1], tables, lengths, *lsc,
                                                     window=window),
                        f"paged decode {tag}", PAGED_ROW_TOL, HEAD_DIM)
            n += 2
    return n


def check_split_clusters(gen) -> int:
    """Untimed checks of the split walk's fixed chunks (one cluster of 8
    ranks per token and KV head, rank c on pages [c cp, (c + 1) cp), cp =
    ceil(mp / 8)), each against the plain split walk: mp 5 (ranks 5-7 past
    the table), mp 13 (cp 2: the last rank empty), windows that start
    mid-chunk past the first chunks, ps 16 and 128, G 1, 4 and 8, Hd 64
    and 128, bf16 and int8 pages (int8 under windows too).  Every batch
    holds decode rows, a 3- and a 10-token row, an inert row (q_len 0)
    and two padding tokens.  Returns the number of cases."""
    import torch

    from fusioninfer_tpu_torch.models.quantization import kv_quantize
    from fusioninfer_tpu_torch.ops import paged_attention as pa

    KV, n = 2, 0
    for ps, mp, G, Hd, window, int8 in [(16, 5, 4, 128, None, False),
                                        (16, 13, 1, 64, None, False),
                                        (128, 13, 8, 128, 700, False),
                                        (16, 32, 2, 64, 100, True),
                                        (128, 32, 4, 128, 1300, True),
                                        (16, 13, 8, 64, None, True)]:
        cap = mp * ps
        rows = [(cap - 1, 1), (0, 0), (cap // 3, 3), (5, 10), (cap // 2, 1), (2, 1)]
        *desc, T = ragged_batch(rows, pad=2)
        n_pages = len(rows) * mp + 1
        tables = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(mp))
        tables = tables.reshape(len(rows), mp).to(torch.int32).cuda()
        q = torch.randn((T, KV * G, Hd), generator=gen, device="cuda").to(torch.bfloat16)
        shape = (2, KV, n_pages, ps, Hd)
        kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        sc = ()
        if int8:
            (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
            sc = (ks[..., None, :].contiguous(), vs[..., None, :].contiguous())
        out = pa.ragged_paged_attention_kvsplit(q, kp, vp, tables, *desc, *sc, window=window,
                                                layer=1)
        ref = pa.reference_ragged_paged_attention_kvsplit(q, kp[1], vp[1], tables, *desc,
                                                          *(x[1] for x in sc), window=window)
        check_close(out, ref, f"split walk mp {mp} ps {ps} G{G} Hd{Hd} window {window}"
                    + (" int8" if int8 else ""), PAGED_ROW_TOL, Hd)
        if out[-2:].any():
            raise AssertionError(f"split walk mp {mp}: padding tokens are not zeros")
        n += 1
    return n


def check_split_bits(gen) -> int:
    """The split walk's bits of a row do not depend on the batch: each of
    the 8 decode rows (ctx 100…4000, 32-page tables) run alone (T1), in
    the decode step (T8) and beside a 64-token row at 1000 (T72) gives
    ``torch.equal`` outputs, on bf16 and on int8 pages.  Returns the
    number of rows compared."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    rows = [(c - 1, 1) for c in DECODE_CTX] + [(1000, 64)]
    n = 0
    for int8 in (False, True):
        kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
        sc = (ks, vs) if int8 else ()
        *desc, T = ragged_batch(rows)
        q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                        device="cuda").to(torch.bfloat16)

        def walk(n_rows, first=0):
            t = tables[first:first + n_rows]
            if n_rows == len(rows):
                return pa.ragged_paged_attention_kvsplit(q, kp, vp, t, *desc, *sc, layer=1)
            starts = desc[0][first:first + n_rows]
            ones = torch.ones(n_rows, dtype=torch.int32, device="cuda")
            begins = torch.arange(n_rows, dtype=torch.int32, device="cuda")
            return pa.ragged_paged_attention_kvsplit(q[first:first + n_rows], kp, vp, t,
                                                     starts, begins, ones, *sc, layer=1)

        t72, t8 = walk(len(rows)), walk(len(DECODE_CTX))
        for i in range(len(DECODE_CTX)):
            t1 = walk(1, i)[0]
            if not (torch.equal(t1, t8[i]) and torch.equal(t1, t72[i])):
                raise AssertionError(f"split walk{' int8' if int8 else ''}: row {i} (ctx "
                                     f"{DECODE_CTX[i]}) differs between T1, T8 and T72")
            n += 1
    return n


def check_split_serve(gen, int8: bool) -> dict:
    """The split walk, timed at the 4096 serve leg's decode-profile shape:
    8 decode rows with contexts 101…1501 over 32-page tables (a two-layer
    pool read at layer 1), against the plain split walk."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    rows = [(c - 1, 1) for c in DECODE_CTX_SERVE]
    kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
    *desc, T = ragged_batch(rows)
    q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    sc = (ks, vs) if int8 else ()
    lsc = (ks[1], vs[1]) if int8 else ()
    return measure(
        "paged split-KV" + (" int8" if int8 else ""),
        "8 decode rows ctx 101..1501, mp 32, ps 128" + (", int8 pages" if int8 else ""),
        lambda: pa.ragged_paged_attention_kvsplit(q, kp, vp, tables, *desc, *sc, layer=1),
        lambda: pa.reference_ragged_paged_attention_kvsplit(q, kp[1], vp[1], tables, *desc,
                                                            *lsc),
        PAGED_ROW_TOL, rows, int8,
        (lambda: None) if int8 else (lambda: sdpa_calls(q, kp[1], vp[1], tables, rows)))


def plain_in_pieces(plain_walk, q, kp, vp, tables, rows, scales, piece: int = 64,
                    window: int | None = None):
    """The plain walk over rows ``[(start, n)]`` (tokens in row order),
    computed ``piece`` tokens at a time as rows of their own: a token's
    plain result depends only on its position and its row's pages, and a
    512-token row's gathered f32 context would take ~9 GB at once."""
    import torch

    outs, t0 = [], 0
    for r, (start, n) in enumerate(rows):
        for i in range(0, n, piece):
            m = min(piece, n - i)
            one = torch.ones(1, dtype=torch.int32, device="cuda")
            outs.append(plain_walk(q[t0 + i: t0 + i + m], kp, vp, tables[r: r + 1],
                                   one * (start + i), one * 0, one * m, *scales,
                                   window=window))
        t0 += n
    return torch.cat(outs)


def check_fused_shape(gen, split: bool, int8: bool, cluster: int) -> dict:
    """A ragged walk at the fused step's shape: the 8 decode rows (ctx
    100…4000) plus a 512-token chunk row at 1024 (T520, ps 128, 32-page
    tables, a two-layer pool read at layer 1), against its plain version,
    timed beside the bound and SDPA; the single walk at the engine's fixed
    cluster size ``cluster``."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    rows = [(c - 1, 1) for c in DECODE_CTX] + [FUSED_CHUNK]
    kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
    *ragged, T = ragged_batch(rows)
    desc = (tables, *ragged)
    q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    sc = (ks, vs) if int8 else ()
    lsc = (ks[1], vs[1]) if int8 else ()
    if split:
        def kern():
            return pa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, *sc, layer=1)
        plain_walk = pa.reference_ragged_paged_attention_kvsplit
    else:
        def kern():
            return pa.ragged_paged_attention(q, kp, vp, *desc, *sc, layer=1, cluster=cluster)
        plain_walk = pa.reference_ragged_paged_attention
    name = ("paged split-KV" if split else f"paged single walk CL {cluster}") + (
        " int8" if int8 else "")
    shape = (f"T{T}: 8 decode rows ctx 100..4000 + a 512-token chunk at 1024, ps 128"
             + (", int8 pages" if int8 else ""))
    res = measure(name, shape, kern,
                  lambda: plain_in_pieces(plain_walk, q, kp[1], vp[1], tables, rows, lsc),
                  PAGED_ROW_TOL, rows, int8,
                  (lambda: None) if int8 else (lambda: sdpa_calls(q, kp[1], vp[1], tables,
                                                                  rows)))
    if not split:  # what the shape rule alone (CL 1 at T520) would take
        res["ms_shape_rule"] = time_graph(
            lambda: pa.ragged_paged_attention(q, kp, vp, *desc, *sc, layer=1))
    return res


def check_fused_bits(gen, cluster: int) -> dict:
    """Each of the 8 decode rows comes out ``torch.equal`` alone (T1), in
    the decode-only launch (T8) and inside the fused launch beside the
    512-token chunk (T520), on both walks and both page types, the single
    walk at the engine's fixed cluster size.  Also counts the rows whose
    bits would change between T1 and T520 under the shape rule alone
    (the fault the fixed size repairs).  Returns ``{"rows": n, ...}``."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    rows = [(c - 1, 1) for c in DECODE_CTX] + [FUSED_CHUNK]
    n, moved = 0, {}
    for int8 in (False, True):
        kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
        sc = (ks, vs) if int8 else ()
        *desc, T = ragged_batch(rows)
        q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                        device="cuda").to(torch.bfloat16)
        for split in (False, True):
            def walk(n_rows, first=0, cl=cluster):
                kw = {} if split else {"cluster": cl}
                fn = pa.ragged_paged_attention_kvsplit if split else pa.ragged_paged_attention
                if n_rows == len(rows):
                    return fn(q, kp, vp, tables, *desc, *sc, layer=1, **kw)
                ones = torch.ones(n_rows, dtype=torch.int32, device="cuda")
                begins = torch.arange(n_rows, dtype=torch.int32, device="cuda")
                return fn(q[first:first + n_rows], kp, vp, tables[first:first + n_rows],
                          desc[0][first:first + n_rows], begins, ones, *sc, layer=1, **kw)

            fused, t8 = walk(len(rows)), walk(len(DECODE_CTX))
            tag = ("split walk" if split else f"single walk CL {cluster}") + (
                " int8" if int8 else "")
            for i in range(len(DECODE_CTX)):
                t1 = walk(1, i)[0]
                if not (torch.equal(t1, t8[i]) and torch.equal(t1, fused[i])):
                    raise AssertionError(f"{tag}: decode row {i} (ctx {DECODE_CTX[i]}) "
                                         "differs between T1, T8 and the fused T520")
                n += 1
            if not split:
                shape_rule = pa.ragged_paged_attention(q, kp, vp, tables, *desc, *sc, layer=1)
                alone = [pa.ragged_paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                                   desc[0][i:i + 1], desc[1][:1] * 0,
                                                   desc[2][:1] * 0 + 1, *sc, layer=1)[0]
                         for i in range(len(DECODE_CTX))]
                moved["int8" if int8 else "bf16"] = sum(
                    not torch.equal(a, shape_rule[i]) for i, a in enumerate(alone))
    return {"rows": n, "rows_moved_by_shape_rule": moved}


def spec_rows(drafts) -> list[tuple[int, int]]:
    """The speculative decode step's rows ``[(start, n)]``: decode row i
    carries its input token and ``drafts[i]`` drafts, its window ending at
    the DECODE_CTX[i]-th key (causal within the window)."""
    return [(c - 1 - SPEC_K, 1 + d) for c, d in zip(DECODE_CTX, drafts)]


def check_spec_shape(gen, split: bool, int8: bool, clusters: tuple[int, ...]) -> dict:
    """A ragged walk at the speculative decode step's shape: the 8 decode
    rows, each a window of 1 + SPEC_K tokens ending at ctx 100…4000 (T40,
    ps 128, 32-page tables, layer 1 of a two-layer pool), against its plain
    version, timed beside the bound and SDPA (one call per sequence, a
    causal mask over its window).  The single walk runs at each cluster
    size of ``clusters`` (the first one's numbers are returned, every
    one's time under ``ms_by_cluster``)."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    rows = spec_rows([SPEC_K] * len(DECODE_CTX))
    kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
    *ragged, T = ragged_batch(rows)
    desc = (tables, *ragged)
    q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    sc = (ks, vs) if int8 else ()
    lsc = (ks[1], vs[1]) if int8 else ()
    pages = ", int8 pages" if int8 else ""
    shape = f"T{T}: 8 decode rows x {1 + SPEC_K} tokens ending at ctx 100..4000, ps 128{pages}"
    sdpa = (lambda: None) if int8 else (lambda: sdpa_calls(q, kp[1], vp[1], tables, rows))
    if split:
        return measure("paged split-KV" + (" int8" if int8 else ""), shape,
                       lambda: pa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, *sc,
                                                                 layer=1),
                       lambda: pa.reference_ragged_paged_attention_kvsplit(
                           q, kp[1], vp[1], *desc, *lsc),
                       PAGED_ROW_TOL, rows, int8, sdpa)
    by_cl = {}
    for cl in dict.fromkeys(clusters):
        by_cl[cl] = measure(
            f"paged single walk CL {cl}" + (" int8" if int8 else ""), shape,
            lambda cl=cl: pa.ragged_paged_attention(q, kp, vp, *desc, *sc, layer=1,
                                                    cluster=cl),
            lambda: pa.reference_ragged_paged_attention(q, kp[1], vp[1], *desc, *lsc),
            PAGED_ROW_TOL, rows, int8, sdpa)
    return {**by_cl[clusters[0]], "cluster": clusters[0],
            "ms_by_cluster": {cl: r["ms"] for cl, r in by_cl.items()}}


def check_spec_bits(gen, cluster: int) -> int:
    """Each decode row's outputs are ``torch.equal`` whether its neighbours
    carry 0 or SPEC_K drafts: every row's window alone beside neighbours
    of one token, all windows together (T40) and every row with none
    (T8), on both walks and both page types, the single walk at the
    engine's fixed cluster size.  Returns the rows compared."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    n = 0
    full_rows = spec_rows([SPEC_K] * len(DECODE_CTX))
    for int8 in (False, True):
        kp, vp, ks, vs, tables = paged_pool(gen, full_rows, int8)
        sc = (ks, vs) if int8 else ()
        q_full = torch.randn((sum(c for _, c in full_rows), KV_HEADS * GROUP, HEAD_DIM),
                             generator=gen, device="cuda").to(torch.bfloat16)
        W = 1 + SPEC_K
        for split in (False, True):
            fn = pa.ragged_paged_attention_kvsplit if split else pa.ragged_paged_attention
            kw = {} if split else {"cluster": cluster}

            def walk(drafts):
                """Row i's first 1 + drafts[i] tokens → the row outputs."""
                rows = spec_rows(drafts)
                q = torch.cat([q_full[i * W: i * W + c] for i, (_, c) in enumerate(rows)])
                *desc, _ = ragged_batch(rows)
                out = fn(q, kp, vp, tables, *desc, *sc, layer=1, **kw)
                return list(torch.split(out, [c for _, c in rows]))

            tag = ("split walk" if split else f"single walk CL {cluster}") + (
                " int8" if int8 else "")
            every = walk([SPEC_K] * 8)
            none = walk([0] * 8)
            for i in range(len(DECODE_CTX)):
                alone = walk([SPEC_K if r == i else 0 for r in range(8)])
                same = torch.equal(alone[i], every[i]) and torch.equal(every[i][:1], none[i])
                same = same and all(torch.equal(alone[r], none[r]) for r in range(8) if r != i)
                if not same:
                    raise AssertionError(f"{tag}: decode row {i} (ctx {DECODE_CTX[i]}) "
                                         "changes with its neighbours' drafts")
                n += 1
    return n


def primitive_cases(gen) -> list[dict]:
    """The three standalone primitives at the stated shapes, each on bf16
    and on int8 pages (two-layer pools read at layer 1): paged decode of
    8 sequences with contexts 100…4000; verify windows of 8 queries ending
    at those contexts; a 512-query suffix prefill at position 1024.  Each
    case holds its entry-point call, its plain version, its rows
    ``[(start, n)]`` and its row tolerance."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    H, layer, cases = KV_HEADS * GROUP, 1, []

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for int8 in (False, True):
        sfx = "_int8" if int8 else ""
        pages = " ps 128" + (", int8 pages" if int8 else "")
        # paged decode
        rows = [(c - 1, 1) for c in DECODE_CTX]
        kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
        lengths = torch.tensor(DECODE_CTX, dtype=torch.int32, device="cuda")
        q = rnd(len(rows), H, HEAD_DIM)
        sc = (ks, vs) if int8 else ()
        lsc = (ks[layer], vs[layer]) if int8 else ()
        cases.append({
            "name": "paged_decode_attention" + sfx, "rows": rows, "int8": int8,
            "shape": f"B8 ctx 100..4000,{pages}", "row_tol": PAGED_ROW_TOL,
            "q_flat": q, "pool": (kp[layer], vp[layer], tables),
            "kern": lambda q=q, kp=kp, vp=vp, t=tables, n=lengths, sc=sc:
                pa.paged_decode_attention(q, kp, vp, t, n, *sc, layer=layer),
            "plain": lambda q=q, kp=kp, vp=vp, t=tables, n=lengths, sc=lsc:
                pa.reference_paged_attention(q, kp[layer], vp[layer], t, n, *sc)})
        # verify: windows of 8 queries ending at the decode contexts
        C = 8
        rows = [(c - C, C) for c in DECODE_CTX]
        kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
        starts = torch.tensor([s for s, _ in rows], dtype=torch.int32, device="cuda")
        counts = torch.full((len(rows),), C, dtype=torch.int32, device="cuda")
        q = rnd(len(rows), C, H, HEAD_DIM)
        sc = (ks, vs) if int8 else ()
        lsc = (ks[layer], vs[layer]) if int8 else ()
        cases.append({
            "name": "paged_verify_attention" + sfx, "rows": rows, "int8": int8,
            "shape": f"B8 C8 ending at ctx 100..4000,{pages}", "row_tol": WINDOW_ROW_TOL,
            "q_flat": q.reshape(-1, H, HEAD_DIM), "pool": (kp[layer], vp[layer], tables),
            "kern": lambda q=q, kp=kp, vp=vp, t=tables, s=starts, c=counts, sc=sc:
                pa.paged_verify_attention(q, kp, vp, t, s, c, *sc, layer=layer),
            "plain": lambda q=q, kp=kp, vp=vp, t=tables, s=starts, c=counts, sc=lsc:
                pa.reference_paged_verify_attention(q, kp[layer], vp[layer], t, s, c,
                                                    *sc)})
        # suffix prefill: 512 queries at position 1024
        rows = [(1024, 512)]
        kp, vp, ks, vs, tables = paged_pool(gen, rows, int8)
        q = rnd(512, H, HEAD_DIM)
        # on the card, so that a CUDA graph can capture the call
        start, true_len = (torch.tensor([x], dtype=torch.int32, device="cuda")
                           for x in rows[0])
        sc = (ks, vs) if int8 else ()
        lsc = (ks[layer], vs[layer]) if int8 else ()
        cases.append({
            "name": "paged_prefill_attention" + sfx, "rows": rows, "int8": int8,
            "shape": f"C512 at start 1024,{pages}", "row_tol": WINDOW_ROW_TOL,
            "q_flat": q, "pool": (kp[layer], vp[layer], tables),
            "kern": lambda q=q, kp=kp, vp=vp, t=tables, s=start, n=true_len, sc=sc:
                pa.paged_prefill_attention(q, kp, vp, t[0], s, n, *sc, layer=layer),
            "plain": lambda q=q, kp=kp, vp=vp, t=tables, s=start, n=true_len, sc=lsc:
                pa.reference_paged_prefill_attention(q, kp[layer], vp[layer], t[0], s, n,
                                                     *sc)})
    return cases


def drive_primitives(cases) -> dict[str, int]:
    """Path (b): each primitive's entry point called once per page type,
    with every launch count set to 0 just before; the outputs must be
    finite and of the expected shape.  Returns the counts."""
    import torch

    from fusioninfer_tpu_torch.ops import dispatch

    dispatch.reset_launches()
    outs = [case["kern"]() for case in cases]
    torch.cuda.synchronize()
    launches = dispatch.launches()
    for case, out in zip(cases, outs):
        n_tok = sum(n for _, n in case["rows"])
        if out.numel() != n_tok * KV_HEADS * GROUP * HEAD_DIM or not torch.isfinite(out).all():
            raise AssertionError(f"{case['name']}: output {tuple(out.shape)} "
                                 "not finite or not of the expected size")
        if launches[case["name"]] == 0:
            raise AssertionError(f"{case['name']} did not launch: {launches}")
    return launches


def check_primitive(case) -> dict:
    kp, vp, tables = case["pool"]
    return measure(case["name"], case["shape"], case["kern"], case["plain"],
                   case["row_tol"], case["rows"], case["int8"],
                   lambda: None if case["int8"] else sdpa_calls(
                       case["q_flat"], kp, vp, tables, case["rows"]))


def check_variants(gen) -> int:
    """Untimed kernel-against-plain checks of what the served shapes do not
    reach: sliding windows, sequence lengths off the 64-row tile, head_dim
    64, query groups 1, 2 and 8, page size 16, inactive slots and padding
    rows, on bf16 and int8 pages.  Returns the number of cases."""
    import torch

    from fusioninfer_tpu_torch.models.quantization import kv_quantize
    from fusioninfer_tpu_torch.ops import flash_attention as fa
    from fusioninfer_tpu_torch.ops import paged_attention as pa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    n = 0
    # S off the 128-row q tile: below one tile, across a few, and (S 1000)
    # eight tiles with a ragged last one that the TMA boxes zero-fill
    for B, S, H, KV, Hd, window in [(1, 512, 32, 8, 128, 100), (2, 100, 4, 2, 64, None),
                                    (1, 200, 8, 8, 128, None), (1, 130, 16, 2, 64, 40),
                                    (2, 1000, 32, 8, 128, None)]:
        q, k, v = rnd(B, S, H, Hd), rnd(B, S, KV, Hd), rnd(B, S, KV, Hd)
        check_close(fa.flash_attention(q, k, v, window=window),
                    fa.reference_attention(q, k, v, window=window),
                    f"flash B{B} S{S} H{H} KV{KV} Hd{Hd} window {window}", FLASH_ROW_TOL, Hd)
        n += 1
    rows = [(37, 1), (0, 0), (20, 3), (5, 10), (63, 1), (300, 1)]  # (row_start, q_len)
    ps, mp = 16, 24
    q_lens = torch.tensor([m for _, m in rows], dtype=torch.int32)
    q_begins = torch.cumsum(q_lens, 0, dtype=torch.int32) - q_lens
    starts = torch.tensor([s0 for s0, _ in rows], dtype=torch.int32)
    n_pages = len(rows) * mp + 1
    tables = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(SEED))
    tables = tables[: len(rows) * mp].reshape(len(rows), mp).to(torch.int32).cuda()
    desc = (tables, *(x.cuda() for x in (starts, q_begins, q_lens)))
    T = int(q_lens.sum())
    lengths = torch.tensor([38, 0, 21, 64, 301, 1], dtype=torch.int32, device="cuda")
    # verify windows: a full one, an inactive slot, one with padding rows
    w_starts = torch.tensor([37, 0, 300], dtype=torch.int32, device="cuda")
    w_counts = torch.tensor([24, 0, 7], dtype=torch.int32, device="cuda")
    for G, Hd, window in [(2, 64, None), (2, 64, 24), (1, 128, None), (8, 128, 50)]:
        KV = 2
        q = rnd(T, KV * G, Hd)
        kp, vp = rnd(2, KV, n_pages, ps, Hd), rnd(2, KV, n_pages, ps, Hd)
        for int8 in (False, True):
            if int8:
                (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
                sc = (ks[..., None, :].contiguous(), vs[..., None, :].contiguous())
            else:
                sc = ()
            lsc = tuple(x[1] for x in sc)
            tag = f"G{G} Hd{Hd} window {window}" + (" int8" if int8 else "")
            check_close(pa.ragged_paged_attention(q, kp, vp, *desc, *sc, window=window,
                                                  layer=1),
                        pa.reference_ragged_paged_attention(q, kp[1], vp[1], *desc, *lsc,
                                                            window=window),
                        f"single walk {tag}", PAGED_ROW_TOL, Hd)
            check_close(pa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, *sc,
                                                          window=window, layer=1),
                        pa.reference_ragged_paged_attention_kvsplit(
                            q, kp[1], vp[1], *desc, *lsc, window=window),
                        f"split walk {tag}", PAGED_ROW_TOL, Hd)
            qd = rnd(len(rows), KV * G, Hd)
            check_close(pa.paged_decode_attention(qd, kp, vp, tables, lengths, *sc,
                                                  window=window, layer=1),
                        pa.reference_paged_attention(qd, kp[1], vp[1], tables, lengths,
                                                     *lsc, window=window),
                        f"paged decode {tag}", PAGED_ROW_TOL, Hd)
            qv = rnd(3, 24, KV * G, Hd)
            check_close(pa.paged_verify_attention(qv, kp, vp, tables[:3], w_starts,
                                                  w_counts, *sc, window=window, layer=1),
                        pa.reference_paged_verify_attention(qv, kp[1], vp[1], tables[:3],
                                                            w_starts, w_counts, *lsc,
                                                            window=window),
                        f"verify {tag}", WINDOW_ROW_TOL, Hd)
            qp = rnd(100, KV * G, Hd)
            check_close(pa.paged_prefill_attention(qp, kp, vp, tables[4], 150, 77, *sc,
                                                   window=window, layer=1),
                        pa.reference_paged_prefill_attention(qp, kp[1], vp[1], tables[4],
                                                             150, 77, *lsc, window=window),
                        f"suffix prefill {tag}", WINDOW_ROW_TOL, Hd)
            n += 5
    return n


def check_window_split(gen) -> int:
    """Untimed checks of the query-window kernel's key split, on page size
    128 (TMA tiles, head_dim 128, G 4) and 16 (gathered tiles, head_dim
    64, G 2): verify windows of 8 queries (one consumer warpgroup) whose
    keys span three and two ``WINDOW_CHUNK`` chunks (the second with
    padding rows past its count) beside one that lies in a single chunk
    and is written directly, in one batch, on bf16 pages without a
    sliding window and on int8 pages with one; and a 96-query suffix
    prefill (C·G > 64: two consumer warpgroups) at position 2600 with 6
    padding rows under a 1500-key window, whose tiles span chunks 1 and 2
    (the scratch starting at chunk 1), on bf16 and int8 pages.  Each
    output is held against the plain version and against the plain chunk
    partials folded by the split walk's combine.  Returns the number of
    cases."""
    import torch

    from fusioninfer_tpu_torch.models.quantization import kv_quantize
    from fusioninfer_tpu_torch.ops import paged_attention as pa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    keys, window, n = 3072, 1500, 0
    starts, counts = i32(2990, 500, 1500), i32(8, 8, 5)
    for ps, G, Hd in ((128, 4, 128), (16, 2, 64)):
        B, mp, KV = 3, keys // ps, 2
        n_pages = B * mp + 1
        tables = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(SEED))
        tables = tables[: B * mp].reshape(B, mp).to(torch.int32).cuda()
        qv, qp = rnd(B, 8, KV * G, Hd), rnd(96, KV * G, Hd)
        kp, vp = rnd(2, KV, n_pages, ps, Hd), rnd(2, KV, n_pages, ps, Hd)
        (k8, ks), (v8, vs) = kv_quantize(kp), kv_quantize(vp)
        scales = (ks[..., None, :].contiguous(), vs[..., None, :].contiguous())
        cases = [("verify", False, None), ("verify", True, window),
                 ("suffix prefill", False, window), ("suffix prefill", True, window)]
        for kind, int8, win in cases:
            k, v, sc = (k8, v8, scales) if int8 else (kp, vp, ())
            lsc = tuple(x[1] for x in sc)
            tag = (f"{kind} split ps {ps} G{G} Hd{Hd} window {win}"
                   + (" int8" if int8 else ""))
            if kind == "verify":
                q, t, s0, c0 = qv, tables, starts, counts
                out = pa.paged_verify_attention(q, k, v, t, s0, c0, *sc, window=win,
                                                layer=1)
            else:
                q, t, s0, c0 = qp[None], tables[:1], i32(2600), i32(90)
                out = pa.paged_prefill_attention(qp, k, v, tables[0], 2600, 90, *sc,
                                                 window=win, layer=1)[None]
            ref = pa.reference_paged_verify_attention(q, k[1], v[1], t, s0, c0, *lsc,
                                                      window=win)
            check_close(out, ref, tag, WINDOW_ROW_TOL, Hd)
            acc, m, l = pa.reference_window_partials(q, k[1], v[1], t, s0, c0, *lsc,
                                                     window=win)
            folded = pa.combine_kvsplit_partials(acc, m, l, q.dtype)
            check_close(out, folded.reshape(out.shape), tag + " (plain partials)",
                        WINDOW_ROW_TOL, Hd)
            n += 1
    return n


# -- phases 4-5: serve ----------------------------------------------------------


def _post(port: int, body: dict, stream: bool):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not stream:
            out = json.loads(resp.read())
            t1 = time.perf_counter()
            return {"tokens": out["usage"]["completion_tokens"],
                    "finish": out["choices"][0]["finish_reason"],
                    "e2e_s": t1 - t0, "ttft_s": None, "decode_tok_s": None,
                    "token_ids": None}
        ids, stamps, finish = [], [], None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            choice = json.loads(line[6:])["choices"][0]
            if "token_id" in choice:
                ids.append(choice["token_id"])
                stamps.append(time.perf_counter())
            finish = choice["finish_reason"] or finish
        t1 = time.perf_counter()
        rate = (len(ids) - 1) / (stamps[-1] - stamps[0]) if len(ids) > 1 else None
        return {"tokens": len(ids), "finish": finish, "e2e_s": t1 - t0,
                "ttft_s": stamps[0] - t0 if stamps else None, "decode_tok_s": rate,
                "second_token_s": stamps[1] - stamps[0] if len(stamps) > 1 else None,
                "token_ids": ids}


def post_thread(port: int, label: str, text: str, out: dict,
                errors: list) -> threading.Thread:
    """A started thread that sends one greedy SSE request of MAX_TOKENS
    and stores its result under ``out[label]``."""
    def one():
        try:
            out[label] = {**_post(port, {"prompt": text, "max_tokens": MAX_TOKENS,
                                         "temperature": 0.0, "stream": True},
                                  stream=True), "prompt": text}
        except Exception as e:  # noqa: BLE001 - collected and re-raised by the caller
            errors.append(f"{label}: {e!r}")

    t = threading.Thread(target=one)
    t.start()
    return t


def drive_server(engine, prompts) -> list[dict]:
    """Start the port's server on localhost, send the prompts at once
    (even-indexed ones as SSE), return each request's result."""
    from fusioninfer_tpu_torch.engine.server import EngineServer

    server = EngineServer(engine, host="127.0.0.1", port=0)
    server.start()
    results: list = [None] * len(prompts)
    errors: list = []

    def one(i, text):
        try:
            results[i] = _post(server.port, {
                "prompt": text, "max_tokens": MAX_TOKENS, "temperature": 0.0,
                "stream": i % 2 == 0}, stream=i % 2 == 0)
            results[i]["prompt"] = text
        except Exception as e:  # noqa: BLE001 - collected and re-raised below
            errors.append(f"request {i}: {e!r}")

    try:
        threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a request did not finish within 900 s")
    finally:
        server.stop()
    if errors:
        raise AssertionError("; ".join(errors))
    for i, r in enumerate(results):
        if r["tokens"] != MAX_TOKENS or r["finish"] != "length":
            raise AssertionError(f"request {i}: {r['tokens']} tokens, finish "
                                 f"{r['finish']!r}; expected {MAX_TOKENS}, 'length'")
    return results


def plain_attention(q, k, v, window: int | None, block: int = 1024):
    """``reference_attention``'s math (GQA, f32 scores and softmax, causal,
    within ``window``) over query blocks of ``block`` rows, each against
    the keys it can see, so a sequence of thousands of tokens never holds
    its whole ``[S, S]`` score matrix."""
    import torch

    from fusioninfer_tpu_torch.ops.flash_attention import NEG_INF

    B, S, H, Hd = q.shape
    KV = k.shape[2]
    outs = []
    for a in range(0, S, block):
        b = min(S, a + block)
        lo = 0 if window is None else max(0, a - window + 1)
        qb = q[:, a:b].reshape(B, b - a, KV, H // KV, Hd).float()
        s = torch.einsum("bskgd,btkd->bkgst", qb, k[:, lo:b].float()) / (Hd ** 0.5)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(lo, b, device=q.device)[None, :]
        seen = (kpos <= qpos) & (True if window is None else kpos > qpos - window)
        p = torch.softmax(torch.where(seen, s, torch.full_like(s, NEG_INF)), dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", p, v[:, lo:b].float())
        outs.append(out.reshape(B, b - a, H * Hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def plain_forward(cfg, params, tokens, int8_from: int | None = None, logits_from: int = 0):
    """Full-sequence causal forward → f32 logits of the rows from
    ``logits_from`` on, with the plain versions in place of every kernel
    (``reference_attention`` for flash, or :func:`plain_attention` past
    2048 tokens, ``x @ w`` for the GEMM, the plain RMSNorm) and no pages:
    no hand-written kernel runs in it.  With ``int8_from``, query rows
    from that position on attend over K/V passed through ``kv_quantize``
    and back, as an engine with int8 pages decodes them (its prefill rows
    attend over the exact K/V)."""
    import torch
    import torch.nn.functional as F

    from fusioninfer_tpu_torch.models import transformer as tf
    from fusioninfer_tpu_torch.models.quantization import kv_quantize
    from fusioninfer_tpu_torch.ops.flash_attention import reference_attention
    from fusioninfer_tpu_torch.ops.gemm import reference_matmul as mm
    from fusioninfer_tpu_torch.ops.rms_norm import reference_rms_norm as norm

    def dequant(x):
        x8, scale = kv_quantize(x)
        return x8.float() * scale[..., None]

    B, S = tokens.shape
    H, KV, Hd, eps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rms_eps
    x = tf.embed_lookup(params["embed"], tokens)
    rope = tf.rope_tables(torch.arange(S, device=tokens.device), Hd, cfg.rope_theta)
    for l in range(cfg.n_layers):
        layer = tf.layer_params(params, l)
        h = norm(x, layer["attn_norm"], eps)
        q = mm(h, layer["wq"]).reshape(B, S, H, Hd)
        k = mm(h, layer["wk"]).reshape(B, S, KV, Hd)
        v = mm(h, layer["wv"]).reshape(B, S, KV, Hd)
        if cfg.qk_norm:
            q, k = norm(q, layer["q_norm"], eps), norm(k, layer["k_norm"], eps)
        q, k = tf.rotate(q, rope), tf.rotate(k, rope)

        def attend(k, v):
            if S > 2048:
                return plain_attention(q, k, v, cfg.sliding_window)
            return reference_attention(q, k, v, causal=True, window=cfg.sliding_window)

        attn = attend(k, v) if int8_from != 0 else None
        if int8_from is not None:
            attn8 = attend(dequant(k), dequant(v))
            attn = attn8 if attn is None else torch.cat(
                [attn[:, :int8_from], attn8[:, int8_from:]], dim=1)
        x = x + mm(attn, layer["wo"])
        h = norm(x, layer["mlp_norm"], eps)
        x = x + mm(F.silu(mm(h, layer["w_gate"])) * mm(h, layer["w_up"]), layer["w_down"])
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return mm(norm(x[:, logits_from:], params["final_norm"], eps), head).float()


GREEDY_TOL = 0.25


def check_greedy(engine, results, paged_prompt: bool = False) -> float:
    """The served tokens of each SSE request (flash prefill, paged decode)
    must be the greedy choice of :func:`plain_forward` over the prompt and
    the served tokens (with int8 K/V for the decoded rows when the
    engine's pages are int8, and for the prompt rows too with
    ``paged_prompt``, where the prompt was computed by the page walk over
    the pages: chunks and cache-hit suffixes): the served token's logit
    within ``GREEDY_TOL`` of the row's max (bf16 kernels and the f32-math plain
    attention round differently, and random weights leave near-ties).
    Returns the largest gap seen."""
    from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    return max([check_greedy_ids(engine, tok.encode(r["prompt"]), r["token_ids"],
                                 paged_prompt)
                for r in results if r["token_ids"] is not None], default=0.0)


def check_greedy_ids(engine, prompt: list[int], token_ids: list[int],
                     paged_prompt: bool = False) -> float:
    """``token_ids`` served after ``prompt`` must each be the greedy choice
    of :func:`plain_forward` (see :func:`check_greedy`) within GREEDY_TOL
    → the largest gap."""
    import torch

    seq = prompt + token_ids
    x = torch.tensor([seq[:-1]], device=engine.device)
    with torch.no_grad():
        int8_from = (0 if paged_prompt else len(prompt)) if engine.cache_cfg.quantized \
            else None
        logits = plain_forward(engine.cfg, engine.params, x, int8_from,
                               logits_from=len(prompt) - 1)[0]
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits in the reference forward")
    chosen = torch.tensor(token_ids, device=logits.device)
    gap = (logits.max(dim=-1).values
           - logits.gather(1, chosen[:, None])[:, 0]).max().item()
    if gap > GREEDY_TOL:
        raise AssertionError(f"served token {gap:.3f} below the greedy max (tol {GREEDY_TOL})")
    return gap


def warm_up(engine, prompts) -> None:
    """Run the prompts through the engine once, outside the measured
    window, so TTFT does not carry cuBLAS's and the loader's first-use
    costs."""
    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams
    from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    for i, text in enumerate(prompts):
        engine.add_request(Request(f"warm{i}", tok.encode(text),
                                   SamplingParams(temperature=0.0, max_tokens=2)))
    while engine.has_work():
        engine.step()


def walk_launches(before: dict, n_steps: int) -> dict:
    """Page-walk launches a step since ``before`` (``dispatch.launches()``),
    by counter name: the wrappers' exact counts.  A profile's kernel events
    name the kernels that ran, but CUPTI can drop an event, so the launch
    count comes from here."""
    from fusioninfer_tpu_torch.ops import dispatch

    return {k: (v - before[k]) / n_steps for k, v in dispatch.launches().items()
            if k.startswith("ragged_paged_attention") and v > before[k]}


def check_one_walk_per_layer(prof: dict, n_layers: int, what: str = "decode step") -> None:
    """A step launches one page-walk kernel per layer (the wrappers'
    counts, :func:`walk_launches`) and the profile shows one walk kernel
    and nothing else of the walk (no second, combining kernel)."""
    launched, seen = prof["walk_launches_per_step"], prof["walk_kernels_per_step"]
    if list(launched.values()) != [n_layers] or len(seen) != 1:
        raise AssertionError(f"{what}: page-walk launches {launched}, kernels {seen}; "
                             f"expected one kernel launched {n_layers} times per step")


def profile_decode(engine, n_steps: int = 8, sampling: dict | None = None,
                   device: bool = True) -> dict:
    """Eight requests (prompts of 100…1500 byte-tokens) decoding together
    on ``engine``, greedy or with the ``SamplingParams`` fields of
    ``sampling`` (a seed of its own per request): wall ms per engine step
    without the profiler, and the
    CPU time the calling thread spent in those steps (a wall far above it
    means the thread waited: for the device, or for a core of a shared
    host), then, with ``device``, the same steps under ``torch.profiler``
    for device time per step and the kernels that take it.  Device busy
    share = device ms / wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams
    from fusioninfer_tpu_torch.ops import dispatch

    lens = [100, 300, 500, 700, 900, 1100, 1300, 1500]
    for i, n in enumerate(lens):
        kw = ({"temperature": 0.0} if sampling is None
              else dict(sampling, seed=sampling.get("seed", 0) + i))
        engine.add_request(Request(f"prof{i}", [3 + (7 * j + i) % 250 for j in range(n)],
                                   SamplingParams(max_tokens=(2 + device) * n_steps + 4,
                                                  **kw)))
    engine.step()  # admission, prefill of all eight, first decode step
    engine.step()
    torch.cuda.synchronize()
    if engine.num_running != len(lens):
        raise AssertionError(f"profile batch: {engine.num_running} rows running")
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    cpu_ms = (time.thread_time() - c0) * 1e3 / n_steps
    if not device:
        for i in range(len(lens)):
            engine.cancel(f"prof{i}")
        while engine.has_work():
            engine.step()
        return {"batch": len(lens), "wall_ms_per_step": wall_ms, "cpu_ms_per_step": cpu_ms}
    counts0 = dispatch.launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
    walk_counts = walk_launches(counts0, n_steps)
    while engine.has_work():
        engine.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only: an operator's event carries the time of the
    # kernels it launched, which have their own events
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    walks = [e for e in kernels if any(k in e.key for k in WALK_KERNELS)]
    return {"batch": len(lens), "wall_ms_per_step": wall_ms,
            "cpu_ms_per_step": cpu_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "kernels_per_step": kernel_launches(kernels) / n_steps,
            "walk_ms_per_step": sum(dev_us(e) for e in walks) / 1e3 / n_steps,
            "walk_kernels_per_step": {e.key[:80]: e.count / n_steps for e in walks},
            "walk_launches_per_step": walk_counts,
            "top_kernels_ms_per_step": {e.key[:80]: dev_us(e) / 1e3 / n_steps
                                        for e in top}}


def serve_leg(engine, prompts, must_launch: tuple[str, ...]) -> dict:
    """Warm the engine up, then serve the prompts through the HTTP server
    with every launch count set to 0 just before; the kernels in
    ``must_launch`` must have launched and the SSE tokens must pass
    :func:`check_greedy`."""
    from fusioninfer_tpu_torch.ops import dispatch

    t0 = time.perf_counter()
    warm_up(engine, prompts)
    warm_s = time.perf_counter() - t0
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res = drive_server(engine, prompts)
    wall = time.perf_counter() - t0
    launches = dispatch.launches()
    shapes = dispatch.launches(by_shape=True)
    missing = [k for k in must_launch if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve path did not launch {missing}: {launches}")
    gap = check_greedy(engine, res)
    ttft = [r["ttft_s"] for r in res if r["ttft_s"] is not None]
    rates = [r["decode_tok_s"] for r in res if r["decode_tok_s"]]
    total = sum(r["tokens"] for r in res)
    log(f"  warm-up (first use of every GEMM shape and kernel) {warm_s:.3f} s; "
        f"launches {launches}")
    log(f"  {len(res)} requests x {MAX_TOKENS} tokens in {wall:.3f} s "
        f"({total / wall:.1f} tok/s aggregate); SSE TTFT {[round(t, 4) for t in ttft]} s; "
        f"SSE decode {[round(x, 1) for x in rates]} tok/s per stream; greedy gap {gap:.4f}")
    return {"wall_s": wall, "launches": launches, "greedy_gap": gap, "ttft_s": ttft,
            "launches_by_shape": shapes,
            "decode_tok_s": rates,
            "requests": [{k: v for k, v in r.items() if k not in ("prompt", "token_ids")}
                         for r in res]}


def kernel_launches(events) -> int:
    """Kernel launches among a profile's device events (``key_averages``),
    copies and memsets left out."""
    return sum(e.count for e in events if not e.key.startswith(("Memcpy", "Memset")))


def log_profile(prof: dict, card: str) -> None:
    share = prof["device_busy_share"]
    log(f"  decode step, batch 8 (contexts 100..1500): {prof['wall_ms_per_step']:.3f} ms "
        f"wall, {prof['cpu_ms_per_step']:.3f} ms of the thread's CPU time, "
        f"{prof['device_ms_per_step']:.3f} ms on the device "
        f"(busy share {share if share is None else round(share, 4)}) on {card}, "
        f"{prof['kernels_per_step']:.2f} kernel launches a step; page walk "
        f"{prof['walk_ms_per_step']:.4f} ms/step, launches per step "
        f"{prof['walk_kernels_per_step']}")
    for name, ms in prof["top_kernels_ms_per_step"].items():
        log(f"    {ms:8.4f} ms/step  {name}")


def profile_fused(engine, long_len: int, n_steps: int = 3) -> dict:
    """Mixed steps: four streams decoding while a ``long_len``-token prompt
    prefills in budgeted chunks, every step ONE fused forward (asserted by
    the ledger).  Wall ms per step without the profiler, then device ms per
    step, the walk's ms and launches per step under ``torch.profiler``
    over the same steps of a second long prompt; the walk kernels must
    be one kernel launched once per layer a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams
    from fusioninfer_tpu_torch.ops import dispatch

    def params(n):
        return SamplingParams(temperature=0.0, max_tokens=n)

    for i in range(4):
        engine.add_request(Request(f"fs{i}", [5 + (11 * j + i) % 240 for j in range(100)],
                                   params(8 * n_steps + 16)))
    for _ in range(50):
        if engine.num_running == 4 and not engine.prefilling:
            break
        engine.step()
    out = {}
    for leg in ("wall", "profile"):
        engine.add_request(Request(f"fl-{leg}", [7 + (13 * j + len(leg)) % 230
                                                 for j in range(long_len)], params(2)))
        engine.step()  # admission and its first chunk
        before = engine.sched.fused_steps_total
        packed0 = engine.sched.fused_packed_tokens_sum
        torch.cuda.synchronize()
        if leg == "wall":
            t0 = time.perf_counter()
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
            out["wall_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / n_steps
        else:
            counts0 = dispatch.launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n_steps):
                    engine.step()
                torch.cuda.synchronize()
            out["walk_launches_per_step"] = walk_launches(counts0, n_steps)
        if engine.sched.fused_steps_total - before != n_steps:
            raise AssertionError(f"{n_steps} mixed steps ran "
                                 f"{engine.sched.fused_steps_total - before} fused forwards")
        out[f"packed_tokens_per_step_{leg}"] = (
            engine.sched.fused_packed_tokens_sum - packed0) / n_steps
    while engine.has_work():
        engine.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    walks = [e for e in kernels if any(k in e.key for k in WALK_KERNELS)]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return {**out, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / out["wall_ms_per_step"],
            "walk_ms_per_step": sum(dev_us(e) for e in walks) / 1e3 / n_steps,
            "walk_kernels_per_step": {e.key[:80]: e.count / n_steps for e in walks},
            "top_kernels_ms_per_step": {e.key[:80]: dev_us(e) / 1e3 / n_steps
                                        for e in top}}


def serve_prefix_leg(engine, long_len: int, card: str) -> dict:
    """Phase 7, one leg: the port's serve path with its defaults (prefix
    caching, fused steps) and ``--tokens-per-step 512``.  After a warm-up
    and a print of the budget :meth:`calibrate_token_budget` derives on
    this card (set back to 512 after), through the HTTP server with the
    launch counts set to 0, each request sent once the one before it
    decodes: a 1024-token prefix plus a 16-token tail (a miss, chunked),
    the prefix plus a 64-token tail (a hit, alone), two more hits (tails
    128 and 200) together, and, while the four decode, a ``long_len``-
    token prompt (a miss, chunked into fused steps).  The same sequence
    on another prefix runs first as its warm-up.  Fails unless the
    hits computed only their suffixes, the hit rate is above 0, fused
    steps ran, every ragged forward launched one walk per layer and every
    served token passes :func:`check_greedy`.  Then :func:`profile_fused`."""
    from fusioninfer_tpu_torch.engine.server import EngineServer
    from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer
    from fusioninfer_tpu_torch.ops import dispatch

    def texts(tenant: str):
        """A 1023-character prefix (with BOS 1024 tokens, 8 full pages),
        the prompts sharing it and a long prompt of ``long_len`` tokens."""
        prefix = (f"A long shared system prompt of tenant {tenant}, the same for each "
                  "of its requests. " * 40)[:1023]
        tails = ["".join(chr(97 + (7 * j + n) % 26) for j in range(n))
                 for n in PREFIX_TAILS]
        long_prompt = (f"Quarterly report {tenant} " + "0123456789 " * 600)[:long_len - 1]
        return [prefix + t for t in tails], long_prompt

    warm_up(engine, [("w" * 300), ("Warm-up text, not shared. " * 30)[:700]])
    calibrated = engine.calibrate_token_budget()
    engine.set_token_budget(TOKENS_PER_STEP)
    log(f"  calibrate_token_budget on {card}: {calibrated} tokens/step (set back to "
        f"{TOKENS_PER_STEP} for this leg)")
    server = EngineServer(engine, host="127.0.0.1", port=0)
    results, errors, threads = {}, [], []

    def send(label, prompt, decoding):
        """Send once ``decoding`` streams decode (or after 10 s)."""
        deadline = time.time() + 10
        while engine.num_running < decoding and time.time() < deadline and not errors:
            time.sleep(0.002)
        threads.append(post_thread(server.port, label, prompt, results, errors))
        return engine.num_running

    def sequence(tenant):
        shared, long_prompt = texts(tenant)
        results.clear()
        threads.clear()
        send("miss", shared[0], 0)
        send("hit", shared[1], 1)
        send("hit 2", shared[2], 2)
        send("hit 3", shared[3], 2)
        decoding = send("long miss", long_prompt, 4)
        for t in threads:
            t.join(600)
        if errors or len(results) != len(shared) + 1:
            raise AssertionError(f"prefix leg: {errors or f'{len(results)} results'}")
        return decoding

    server.start()
    try:
        # the same sequence on another tenant's prompts first, so that the
        # measured one finds every GEMM shape and kernel in use already
        sequence("W")
        n_before = {k: getattr(engine.alloc, k) for k in ("hit_tokens_total",
                                                          "query_tokens_total")}
        sched0 = engine.sched.snapshot()
        preempt0 = engine.preemptions_total
        dispatch.reset_launches()
        t0 = time.perf_counter()
        decoding = sequence("M")
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    launches = dispatch.launches()
    shapes = dispatch.launches(by_shape=True)
    order = ["miss", "hit", "hit 2", "hit 3", "long miss"]
    sched1 = engine.sched.snapshot()
    delta = {k: sched1[k] - sched0[k] for k in ("prefill_tokens", "fused_steps",
                                                "weight_passes", "chunks")}
    hit = engine.alloc.hit_tokens_total - n_before["hit_tokens_total"]
    query = engine.alloc.query_tokens_total - n_before["query_tokens_total"]
    walk = sum(v for k, v in launches.items() if k.startswith("ragged_paged_attention"))
    flash_fwd = launches["flash_attention"] / engine.cfg.n_layers
    ragged_fwd = delta["weight_passes"] - flash_fwd
    for r in results.values():
        if r["tokens"] != MAX_TOKENS or r["finish"] != "length":
            raise AssertionError(f"prefix leg: {r['tokens']} tokens, finish {r['finish']!r}")
    if engine.preemptions_total != preempt0:
        raise AssertionError("prefix leg: a request was preempted")
    if hit != (len(PREFIX_TAILS) - 1) * 1024 or engine.prefix_cache_hit_rate() <= 0:
        raise AssertionError(f"prefix leg: {hit} hit tokens, expected "
                             f"{(len(PREFIX_TAILS) - 1) * 1024}")
    if delta["prefill_tokens"] != query - hit:
        raise AssertionError(f"prefix leg: prefilled {delta['prefill_tokens']} tokens, "
                             f"the uncached ones are {query - hit}")
    if delta["fused_steps"] <= 0:
        raise AssertionError("prefix leg: no fused step ran")
    if walk != engine.cfg.n_layers * ragged_fwd:
        raise AssertionError(f"prefix leg: {walk} walk launches for {ragged_fwd} ragged "
                             f"forwards of {engine.cfg.n_layers} layers")
    # every forward's norms and its seven projections a layer went through
    # the kernels: the first norm alone, two add + norm launches and one q/k
    # norm + RoPE + page write launch a layer
    L, forwards = engine.cfg.n_layers, delta["weight_passes"]
    norms = {"rms_norm": 1, "add_rms_norm": 2 * L, "qk_norm_rope_kv": L}
    if (any(launches[k] != n * forwards for k, n in norms.items())
            or launches["gemm"] < 7 * L * forwards):
        raise AssertionError(f"prefix leg: norm launches "
                             f"{ {k: launches[k] for k in norms} } and {launches['gemm']} "
                             f"GEMM launches for {forwards} forwards")
    gap = check_greedy(engine, [results[k] for k in order], paged_prompt=True)
    tok = ByteTokenizer()
    ttft = {k: results[k]["ttft_s"] for k in order}
    lens = {k: len(tok.encode(results[k]["prompt"])) for k in order}
    log(f"  prefix leg in {wall:.3f} s, prompt tokens {lens}; TTFT s "
        f"{ {k: round(v, 4) for k, v in ttft.items()} } (the long prompt sent while "
        f"{decoding} streams decoded); hit rate {hit / query:.4f} in this leg "
        f"({hit} of {query} tokens), {engine.prefix_cache_hit_rate():.4f} over the "
        f"engine's life; prefilled {delta['prefill_tokens']} tokens in "
        f"{delta['chunks']} chunks; {delta['fused_steps']} fused steps; {int(ragged_fwd)} "
        f"ragged forwards, {walk} walk launches; launches {launches}; greedy gap {gap:.4f}")
    prof = profile_fused(engine, 2000)
    check_one_walk_per_layer(prof, engine.cfg.n_layers, "fused step")
    log(f"  fused step (4 decode rows + a chunk, {prof['packed_tokens_per_step_wall']:.0f} "
        f"tokens packed a step): {prof['wall_ms_per_step']:.3f} ms wall, "
        f"{prof['device_ms_per_step']:.3f} ms on the device (busy share "
        f"{prof['device_busy_share']:.4f}); page walk {prof['walk_ms_per_step']:.4f} "
        f"ms/step, launches per step {prof['walk_kernels_per_step']}")
    for name, ms in prof["top_kernels_ms_per_step"].items():
        log(f"    {ms:8.4f} ms/step  {name}")
    return {"wall_s": wall, "launches": launches, "greedy_gap": gap, "ttft_s": ttft,
            "launches_by_shape": shapes,
            "prompt_tokens": lens, "calibrated_budget": calibrated,
            "decoding_when_long_sent": decoding,
            "hit_rate": engine.prefix_cache_hit_rate(), "hit_tokens": hit,
            "query_tokens": query, "sched_delta": delta, "fused_profile": prof,
            "decode_tok_s": {k: results[k]["decode_tok_s"] for k in order}}


# -- phase 8: speculative decoding -----------------------------------------------


SPEC_WORDS = ("the", "engine", "admits", "requests", "into", "a", "running", "batch",
              "pages", "hold", "keys", "and", "values", "of", "each", "sequence", "walk",
              "reads", "them", "back", "while", "decode", "rows", "draft", "tokens")


def extractive_prompts(n: int, passage_len: int, salt: int = 0) -> list[str]:
    """``n`` prompts that quote a passage of ~``passage_len`` bytes and ask
    for it again, ending on its first words: the traffic n-gram drafts
    serve (summaries, RAG answers, code edits quote their prompt)."""
    out = []
    for i in range(n):
        words = [SPEC_WORDS[(7 * j + 3 * i + salt + j * j) % len(SPEC_WORDS)]
                 for j in range(passage_len // 4)]
        passage = " ".join(words)[:passage_len]
        out.append(f"Passage {i}: {passage}\nRepeat the passage word for word.\n"
                   f"{passage[: passage_len // 6]}")
    return out


def first_difference(a: list[int], b: list[int]) -> int | None:
    """The first index at which two token streams differ (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def spy_spec_bursts(engine, record: dict) -> None:
    """Wrap ``engine._spec_bursts`` so that every greedy window is checked
    against its own argmax: the accepted drafts and the token after them
    must be the argmax at their positions, and the first rejected draft
    must differ from it.  Counts land in ``record``; a mismatch is
    recorded (the engine thread must not raise) and raised by the caller."""
    real = engine._spec_bursts

    def spy(live, logits_w, spec_drafts):
        bursts = real(live, logits_w, spec_drafts)
        for slot, (burst, accepted) in bursts.items():
            record["windows"] += 1
            record["accepted"] += accepted
            if live[slot].request.params.temperature > 0.0:
                continue
            drafts = spec_drafts[slot]
            argmax = logits_w[slot].argmax(dim=-1).tolist()
            ok = burst == argmax[: accepted + 1] and drafts[:accepted] == argmax[:accepted]
            ok = ok and (accepted == len(drafts) or drafts[accepted] != argmax[accepted])
            record["greedy_drafts_checked"] += accepted
            if not ok:
                record["mismatches"].append((slot, drafts, burst, accepted))
        return bursts

    engine._spec_bursts = spy


def serve_spec_requests(engine, prompts, sampling: dict, max_tokens: int) -> dict:
    """The prompts sent at once as SSE requests through the port's server
    with ``sampling`` (request fields), the launch counts set to 0 just
    before; every request must return ``max_tokens`` tokens, and every
    ragged forward must have launched one walk per layer."""
    from fusioninfer_tpu_torch.engine.server import EngineServer
    from fusioninfer_tpu_torch.ops import dispatch

    server = EngineServer(engine, host="127.0.0.1", port=0)
    server.start()
    results, errors = [None] * len(prompts), []
    sched0 = engine.sched.snapshot()
    spec0 = (engine.spec_proposed_total, engine.spec_accepted_total)

    def one(i, text):
        try:
            body = {"prompt": text, "max_tokens": max_tokens, "stream": True, **sampling}
            if "seed" in sampling:
                body["seed"] = sampling["seed"] + i
            results[i] = {**_post(server.port, body, stream=True), "prompt": text}
        except Exception as e:  # noqa: BLE001 - collected and re-raised below
            errors.append(f"request {i}: {e!r}")

    dispatch.reset_launches()
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a request did not finish within 600 s")
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError("; ".join(errors))
    for i, r in enumerate(results):
        if r["tokens"] != max_tokens or r["finish"] != "length":
            raise AssertionError(f"request {i}: {r['tokens']} tokens, finish {r['finish']!r}")
    launches = dispatch.launches()
    shapes = dispatch.launches(by_shape=True)
    sched1 = engine.sched.snapshot()
    delta = {k: sched1[k] - sched0[k] for k in ("steps", "weight_passes", "decode_tokens",
                                                "fused_steps")}
    walk = sum(v for k, v in launches.items() if k.startswith("ragged_paged_attention"))
    ragged_fwd = delta["weight_passes"] - launches["flash_attention"] / engine.cfg.n_layers
    if walk != engine.cfg.n_layers * ragged_fwd:
        raise AssertionError(f"{walk} walk launches for {ragged_fwd} ragged forwards of "
                             f"{engine.cfg.n_layers} layers")
    return {"wall_s": wall, "launches": launches, "sched_delta": delta,
            "launches_by_shape": shapes,
            "ragged_forwards": int(ragged_fwd),
            "spec_proposed": engine.spec_proposed_total - spec0[0],
            "spec_accepted": engine.spec_accepted_total - spec0[1],
            "ttft_s": [r["ttft_s"] for r in results],
            "decode_tok_s": [r["decode_tok_s"] for r in results],
            "token_ids": [r["token_ids"] for r in results], "results": results}


def profile_spec(engine, prompts, n_steps: int = 8) -> dict:
    """Eight extractive requests decoding together on ``engine``: after
    their admission, wall ms and the calling thread's CPU ms per engine
    step, and the tokens each row emitted per step (1 without
    speculation); then the same count of steps under ``torch.profiler``
    for device ms per step and the walk's launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams
    from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer
    from fusioninfer_tpu_torch.ops import dispatch

    tok = ByteTokenizer()
    rids = [f"spec-prof{i}" for i in range(len(prompts))]
    for rid, text in zip(rids, prompts):
        engine.add_request(Request(rid, tok.encode(text), SamplingParams(
            temperature=0.0, max_tokens=(1 + SPEC_K) * (2 * n_steps + 4))))
    for _ in range(400):
        if engine.num_running == len(prompts) and not engine.prefilling:
            break
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    if engine.num_running != len(prompts):
        raise AssertionError(f"spec profile: {engine.num_running} rows running")
    spec0 = (engine.spec_proposed_total, engine.spec_accepted_total)
    t0, c0 = time.perf_counter(), time.thread_time()
    emitted = 0
    for _ in range(n_steps):
        emitted += len(engine.step())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    cpu_ms = (time.thread_time() - c0) * 1e3 / n_steps
    counts0 = dispatch.launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
    walk_counts = walk_launches(counts0, n_steps)
    if engine.num_running != len(prompts):
        raise AssertionError("spec profile: a row finished inside the profile")
    for rid in rids:
        engine.cancel(rid)
    while engine.has_work():
        engine.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    walks = [e for e in kernels if any(k in e.key for k in WALK_KERNELS)]
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return {"rows": len(prompts), "wall_ms_per_step": wall_ms, "cpu_ms_per_step": cpu_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "tokens_per_row_step": emitted / n_steps / len(prompts),
            "spec_proposed": engine.spec_proposed_total - spec0[0],
            "spec_accepted": engine.spec_accepted_total - spec0[1],
            "walk_ms_per_step": sum(dev_us(e) for e in walks) / 1e3 / n_steps,
            "walk_kernels_per_step": {e.key[:80]: e.count / n_steps for e in walks},
            "walk_launches_per_step": walk_counts,
            "top_kernels_ms_per_step": {e.key[:80]: dev_us(e) / 1e3 / n_steps
                                        for e in top}}


def check_logprobs(engine) -> dict:
    """Through the server: one greedy request with ``logprobs: 3`` and a
    ``logit_bias`` of +100 on byte 'e' (every token must be it, with a
    logprobs entry of 3 alternatives each); then one seeded top-k request
    (temperature 0.8, top_k 40, the candidate sampler) served twice,
    which must give the same tokens both times."""
    from fusioninfer_tpu_torch.engine.server import EngineServer

    server = EngineServer(engine, host="127.0.0.1", port=0)
    server.start()
    forced = ord("e") + 3  # ByteTokenizer: byte b is id b + 3
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/completions",
            data=json.dumps({"prompt": "Logprobs of a biased stream:", "max_tokens": 8,
                             "temperature": 0.0, "logprobs": 3,
                             "logit_bias": {str(forced): 100}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            out = json.loads(resp.read())
        lp = out["choices"][0]["logprobs"]
        if out["choices"][0]["text"] != "e" * 8 or len(lp["token_logprobs"]) != 8 or any(
                len(t) != 3 for t in lp["top_logprobs"]):
            raise AssertionError(f"logprobs / logit_bias request: {out['choices'][0]}")
        body = {"prompt": "A seeded story about pages and keys:", "max_tokens": MAX_TOKENS,
                "temperature": 0.8, "top_k": 40, "seed": 1234, "stream": True}
        streams = [_post(server.port, body, stream=True)["token_ids"] for _ in range(2)]
    finally:
        server.stop()
    if streams[0] != streams[1] or len(streams[0]) != MAX_TOKENS:
        raise AssertionError(f"a seeded top-k stream served twice differs at "
                             f"{first_difference(streams[0], streams[1])}")
    return {"logprobs_request": lp, "seeded_stream": streams[0]}


def serve_spec_leg(make_engine, tag: str, card: str, extras: bool) -> dict:
    """Phase 8, one leg: an engine with ``--speculative-ngram SPEC_K`` (the
    serve defaults otherwise, ``--tokens-per-step 512``) serves four
    extractive prompts greedy, then seeded sampled (temperature 0.8,
    top_k 40), every window checked by :func:`spy_spec_bursts` and every
    greedy token by :func:`check_greedy`; then :func:`profile_spec`.  An
    engine without speculation serves the same greedy prompts and takes
    the same profile (and, with ``extras``, :func:`check_logprobs`).
    ``make_engine(speculative_k)`` builds the leg's engine."""
    import torch

    prompts = extractive_prompts(4, 600)
    prof_prompts = extractive_prompts(8, 500, salt=5)
    out = {}
    for k in (SPEC_K, None):
        engine = make_engine(k)
        side = "on" if k else "off"
        warm_up(engine, extractive_prompts(2, 300, salt=9))
        record = {"windows": 0, "accepted": 0, "greedy_drafts_checked": 0,
                  "mismatches": []}
        if k:
            spy_spec_bursts(engine, record)
        greedy = serve_spec_requests(engine, prompts, {"temperature": 0.0}, SPEC_MAX_TOKENS)
        gap = check_greedy(engine, greedy["results"], paged_prompt=True)
        leg = {"greedy": greedy, "greedy_gap": gap}
        if k:
            leg["sampled"] = serve_spec_requests(
                engine, prompts, {"temperature": 0.8, "top_k": 40, "seed": 77},
                SPEC_MAX_TOKENS)
            if record["mismatches"]:
                raise AssertionError(f"{tag}: accepted greedy drafts off the window's "
                                     f"argmax: {record['mismatches'][:3]}")
            if greedy["spec_proposed"] <= 0:
                raise AssertionError(f"{tag}: no drafts were proposed")
            leg["windows"] = {k2: v for k2, v in record.items() if k2 != "mismatches"}
        leg["profile"] = profile_spec(engine, prof_prompts)
        if extras and not k:
            leg["extras"] = check_logprobs(engine)
        for part in ("greedy", "sampled"):
            if part in leg:
                leg[part].pop("results")
        out[side] = leg
        p = leg["profile"]
        g = leg["greedy"]
        sampled = leg.get("sampled")
        log(f"  {tag}, speculation {side}: greedy {len(prompts)} x {SPEC_MAX_TOKENS} tokens in "
            f"{g['wall_s']:.3f} s over {g['sched_delta']['steps']} steps, drafts proposed "
            f"{g['spec_proposed']} accepted {g['spec_accepted']}"
            + (f" (sampled: {sampled['spec_proposed']} / {sampled['spec_accepted']})"
               if sampled else "")
            + f"; SSE decode {[round(x, 1) for x in g['decode_tok_s']]} tok/s per stream; "
            f"greedy gap {gap:.4f}; {g['ragged_forwards']} ragged forwards, one walk "
            f"launch per layer each")
        log(f"    step, 8 rows: {p['wall_ms_per_step']:.3f} ms wall, "
            f"{p['cpu_ms_per_step']:.3f} ms thread CPU, {p['device_ms_per_step']:.3f} ms on "
            f"the device (busy {p['device_busy_share']:.4f}) on {card}; "
            f"{p['tokens_per_row_step']:.3f} tokens per row and step (drafts "
            f"{p['spec_proposed']} proposed, {p['spec_accepted']} accepted); walk "
            f"{p['walk_ms_per_step']:.4f} ms/step, launches {p['walk_kernels_per_step']}")
        check_one_walk_per_layer(p, engine.cfg.n_layers, f"{tag} step")
        del engine
        torch.cuda.empty_cache()
    on, off = out["on"]["greedy"]["token_ids"], out["off"]["greedy"]["token_ids"]
    out["first_difference"] = [first_difference(a, b) for a, b in zip(on, off)]
    if any(d is not None for d in out["first_difference"]):
        raise AssertionError(f"{tag}: greedy streams with speculation on and off differ "
                             f"at {out['first_difference']} (per request)")
    log(f"  {tag}: the {len(on)} greedy streams with speculation on equal those with it "
        "off, token for token")
    if extras:
        ex = out["off"]["extras"]
        log(f"  logprobs 3 + logit_bias request: token_logprobs "
            f"{[round(x, 4) for x in ex['logprobs_request']['token_logprobs']]}; top of the "
            f"first token {ex['logprobs_request']['top_logprobs'][0]}; a seeded top-k "
            f"stream served twice identical ({MAX_TOKENS} tokens)")
    return out


# -- phase 9: decode bursts -----------------------------------------------------

BURST = 8
# the A/B of a forward through the GEMM and norm kernels against cuBLAS
# (:func:`gemm_cost`): a fused step's chunk and a flash prefill's prompt
CHUNK_AB = 512
PREFILL_AB = 1024
# the batch-independence check: a greedy and a seeded request, each served
# alone, in a full batch of 8 and beside a long prompt chunked at the
# phase's token budget
A1_TOKENS = 32
A1_LONG = 1800
A1_FILLERS = 6
A1_CASES = ("alone", "batch", "chunk")
A1_TEXTS = ("A greedy stream served alone, in a full batch and beside a chunked prompt:",
            "A seeded stream (temperature 0.8, top_k 40) served the same three ways:")
A1_SEED = 4242


def serve_a1_case(engine, case: str) -> tuple[dict, int]:
    """One case of the batch-independence check on an idle engine:
    ``alone``; ``batch`` (six greedy fillers running first, so the two
    decode in a batch of 8); ``chunk`` (an ``A1_LONG``-token prompt added
    after the two, prefilling in budgeted chunks while they decode).  The
    two requests are admitted one step apart, each prefilled alone, so
    their prompts' K/V and first tokens come the same way in every case
    → ``({request id: tokens}, steps that began with a prompt mid-chunk)``."""
    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams
    from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    reqs = [Request("a1-greedy", tok.encode(A1_TEXTS[0]),
                    SamplingParams(temperature=0.0, max_tokens=A1_TOKENS)),
            Request("a1-seeded", tok.encode(A1_TEXTS[1]),
                    SamplingParams(temperature=0.8, top_k=40, seed=A1_SEED,
                                   max_tokens=A1_TOKENS))]
    others = []
    if case == "batch":
        for i in range(A1_FILLERS):
            r = Request(f"a1-fill{i}", tok.encode(f"Filler {i}: " + "pages and keys " * (8 + 5 * i)),
                        SamplingParams(temperature=0.0, max_tokens=A1_TOKENS + 2 * BURST))
            engine.add_request(r)
            others.append(r.request_id)
        for _ in range(50):
            engine.step()
            if engine.num_running == A1_FILLERS and not (engine.waiting or engine.prefilling):
                break
        else:
            raise AssertionError(f"a1 batch: {engine.num_running} fillers running")
    out = {r.request_id: [] for r in reqs}

    def step():
        for o in engine.step():
            if o.request_id in out:
                out[o.request_id].append(o.token)

    for r in reqs:
        engine.add_request(r)
        step()
    if case == "batch" and engine.num_running != 8:
        raise AssertionError(f"a1 batch: {engine.num_running} rows running, expected 8")
    if case == "chunk":
        engine.add_request(Request("a1-long", [3 + (11 * j) % 250 for j in range(A1_LONG)],
                                   SamplingParams(temperature=0.0, max_tokens=4)))
        others.append("a1-long")
    beside = 0
    for _ in range(400):
        if all(len(v) >= A1_TOKENS for v in out.values()):
            break
        beside += bool(engine.prefilling)
        step()
    if any(len(v) != A1_TOKENS for v in out.values()):
        raise AssertionError(f"a1 {case}: stream lengths {[len(v) for v in out.values()]}")
    for rid in others:
        engine.cancel(rid)
    while engine.has_work():
        engine.step()
    return out, beside


def profile_stepping(engine, n_tokens: int = 32, gemm_ab: bool = False,
                     lens=(100, 300, 500, 700, 900, 1100, 1300, 1500)) -> dict:
    """Greedy requests (by default eight, prompts of 100…1500 tokens) decoding
    together, once the batch runs and its graphs exist: wall ms and the
    stepping thread's CPU ms per token of each stream (one batch step
    per token) over ``n_tokens`` tokens a stream, then over as many more
    under ``torch.profiler`` (device activity only) the device ms per
    token (the kernels' time, graph replays' kernels included) and the
    busy share, device ms / wall ms; with ``gemm_ab``, then
    :func:`gemm_cost` from the same batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams

    rids = [f"burst-prof{i}" for i in range(len(lens))]
    for i, (rid, n) in enumerate(zip(rids, lens)):
        engine.add_request(Request(rid, [3 + (7 * j + i) % 250 for j in range(n)],
                                   SamplingParams(temperature=0.0,
                                                  max_tokens=2 * n_tokens + 4 * BURST + 8)))
    got = dict.fromkeys(rids, 0)
    for _ in range(200):
        if min(got.values()) > BURST + 1 and not (engine.waiting or engine.prefilling):
            break
        for o in engine.step():
            got[o.request_id] += 1
    torch.cuda.synchronize()

    def window():
        emitted = 0
        while emitted < n_tokens * len(lens):
            emitted += len(engine.step())
        torch.cuda.synchronize()
        return emitted / len(lens)

    t0, c0 = time.perf_counter(), time.thread_time()
    per_stream = window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / per_stream
    cpu_ms = (time.thread_time() - c0) * 1e3 / per_stream
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        per_stream2 = window()
    if engine.num_running != len(lens):
        raise AssertionError(f"burst profile: {engine.num_running} rows running")
    gemm_ab = gemm_cost(engine) if gemm_ab else None
    for rid in rids:
        engine.cancel(rid)
    while engine.has_work():
        engine.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / per_stream2
    walks = [e for e in kernels if any(k in e.key for k in WALK_KERNELS)]
    if not walks:
        raise AssertionError("the profile saw no page-walk kernel")
    return {"rows": len(lens), "wall_ms_per_token": wall_ms, "cpu_ms_per_token": cpu_ms,
            "device_ms_per_token": device_ms,
            "kernels_per_token": kernel_launches(kernels) / per_stream2,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "walk_launches_per_token": {e.key[:60]: e.count / per_stream2 for e in walks},
            "gemm_ab": gemm_ab}


def gemm_cost(engine) -> dict:
    """The device ms of one forward (:func:`time_graph`: two forwards a
    graph, the median of five replays, in turns K C L L C K): a decode-only
    forward from the running batch's state at 8 and at 2 live rows, a fused
    step of 4 of those rows beside a ``CHUNK_AB``-token chunk, and a flash
    prefill of one ``PREFILL_AB``-token prompt (the chunk and the prompt
    write the trash page); K through the port's kernels, C with the fused
    norms swapped for the unfused chain they replace (the norm kernel,
    torch's residual adds, ``rotate``, ``scatter_kv``: the forward as it
    ran before the fusion), L with the projections through
    ``torch.matmul`` (cuBLAS) and every norm, fused or not, through its
    plain version, the yardstick (swapped in here for the timing only; the
    port never calls them on the card)."""
    import numpy as np
    import torch

    from fusioninfer_tpu_torch.engine import model_runner as mr
    from fusioninfer_tpu_torch.engine.fused import pack_ragged_batch
    from fusioninfer_tpu_torch.models import transformer as tf
    from fusioninfer_tpu_torch.ops import rms_norm as rn

    live = engine._live()
    cc = engine.cache_cfg
    trash = np.full((cc.max_pages_per_seq,), cc.trash_page, np.int32)

    def forward_ms(slots, chunk=0):
        window, counts, positions, tables = engine._decode_window(
            {s: live[s] for s in slots}, {})
        chunks = [([3 + j % 250 for j in range(chunk)], 0, trash, 0)] if chunk else []
        packed = pack_ragged_batch(window, counts, positions, tables, np.zeros_like(counts),
                                   chunks, cc.trash_page, rows=engine._ragged_rows,
                                   chunk_rows=engine._ragged_chunk_rows if chunk else 0)
        arrays = engine._upload_int32((packed.tokens, packed.row_starts, packed.q_begins,
                                       packed.q_lens, packed.page_tables, packed.sel,
                                       packed.chunk_sel))
        return time_graph(lambda: mr.fused_step(
            engine.cfg, engine.cache_cfg, engine.params, engine.cache, *arrays,
            kv_splits=engine.kv_splits, cluster=engine.walk_cluster,
            n_tokens=packed.packed_tokens), reps=5, per_graph=2)

    def prefill_ms():
        dev = engine.device
        tokens = torch.tensor([[3 + j % 250 for j in range(PREFILL_AB)]], device=dev)
        lens = torch.tensor([PREFILL_AB], device=dev)
        rows = torch.tensor(trash[None].astype(np.int64), device=dev)
        return time_graph(lambda: mr.prefill(engine.cfg, cc, engine.params, engine.cache,
                                             tokens, lens, rows), reps=5, per_graph=2)

    names = ("matmul", "rms_norm", "add_rms_norm", "qk_norm_rope_kv")
    routed = [(mod, name, getattr(mod, name)) for mod in (tf, mr) for name in names
              if hasattr(mod, name)]
    swaps = {"kernels": {},
             "chain": {"add_rms_norm": chain_add_rms_norm,
                       "qk_norm_rope_kv": chain_qk_norm_rope_kv},
             "cublas": {"matmul": torch.matmul, "rms_norm": rn.reference_rms_norm,
                        "add_rms_norm": rn.reference_add_rms_norm,
                        "qk_norm_rope_kv": rn.reference_qk_norm_rope_kv}}

    def route(variant: str):
        for mod, name, fn in routed:
            setattr(mod, name, swaps[variant].get(name, fn))

    slots = sorted(live)
    cases = {"live8": lambda: forward_ms(slots[:8]), "live2": lambda: forward_ms(slots[:2]),
             f"fused4_chunk{CHUNK_AB}": lambda: forward_ms(slots[:4], CHUNK_AB),
             f"prefill{PREFILL_AB}": prefill_ms}
    order = ("kernels", "chain", "cublas", "cublas", "chain", "kernels")
    out = {}
    for name, fn in cases.items():
        runs: dict[str, list[float]] = {}
        for variant in order:
            route(variant)
            try:
                runs.setdefault(variant, []).append(fn())
            finally:
                route("kernels")
        for variant, ms in runs.items():
            out[f"{name}_{variant}"] = sum(ms) / len(ms)
    return out


def check_graph_eager(engine) -> dict:
    """One burst of ``BURST`` steps over eight rows of mixed sampling
    params (greedy, top-k, top-p, min-p, penalties, min_tokens: mode
    "filtered"), from the same pool and count tables: the graph's replay
    must give eager ``decode_burst``'s tokens and counts bit for bit.  The
    eager run's K/V writes are at the positions the replay writes again
    before it reads them; the count tables are restored between the two."""
    import numpy as np
    import torch

    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.model_runner import decode_burst
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams, sample_mode

    kinds = [dict(temperature=0.0), dict(temperature=0.8, top_k=40, seed=1),
             dict(temperature=0.9, top_p=0.9, seed=2), dict(temperature=0.8, min_p=0.05, seed=3),
             dict(temperature=0.0, repetition_penalty=1.3, presence_penalty=0.5),
             dict(temperature=1.0, seed=4, frequency_penalty=0.3),
             dict(temperature=0.0, min_tokens=20, stop_token_ids=(10, 35)),
             dict(temperature=0.7, top_k=100, seed=5)]
    pipelined, engine.pipeline_bursts = engine.pipeline_bursts, False
    rids = [f"graph-eager{i}" for i in range(len(kinds))]
    for i, (rid, kw) in enumerate(zip(rids, kinds)):
        engine.add_request(Request(rid, [3 + (13 * j + i) % 250 for j in range(64 + 60 * i)],
                                   SamplingParams(max_tokens=64, **kw)))
    for _ in range(50):
        if engine.num_running == len(kinds) and not (engine.waiting or engine.prefilling):
            break
        engine.step()
    rows = dict(engine.running)
    if len(rows) != len(kinds) or engine._inflight is not None:
        raise AssertionError("graph-eager check: batch not settled")
    _, span = engine._ensure_decode_capacity(BURST)
    ctl_i, ctl_f, tables = engine._decode_controls(rows)
    mode = sample_mode(st.request.params for st in rows.values())
    tc, oc, sup = engine._token_counts, engine._output_counts, engine._suppress
    saved = tc.clone(), oc.clone()
    dev = engine.device
    eager, _ = decode_burst(engine.cfg, engine.cache_cfg, engine.params, engine.cache,
                            torch.as_tensor(ctl_i, device=dev), torch.as_tensor(ctl_f, device=dev),
                            tc, oc, sup, torch.as_tensor(tables, device=dev), n_steps=BURST,
                            sample_mode=mode, kv_splits=engine.kv_splits,
                            cluster=engine.walk_cluster)
    eager = eager.cpu().numpy()
    counts_eager = tc.clone(), oc.clone()
    tc.copy_(saved[0])
    oc.copy_(saved[1])
    graph = engine.bursts.launch(ctl_i, ctl_f, tables, BURST, mode).tokens()
    same_counts = torch.equal(tc, counts_eager[0]) and torch.equal(oc, counts_eager[1])
    tc.copy_(saved[0])
    oc.copy_(saved[1])
    for rid in rids:
        engine.cancel(rid)
    while engine.has_work():
        engine.step()
    engine.pipeline_bursts = pipelined
    if span != BURST or not np.array_equal(eager, graph) or not same_counts:
        raise AssertionError(f"graph replay differs from eager decode_burst (span {span}, "
                             f"mode {mode}): tokens equal {np.array_equal(eager, graph)}, "
                             f"counts equal {same_counts}")
    return {"mode": mode, "span": span, "rows": len(rows), "tokens": int(eager.size)}


def serve_burst_leg(make_engine, tag: str, card: str, extras: bool) -> dict:
    """Phase 9, one page configuration: the batch-independence check
    (:func:`serve_a1_case`, every case) on a ``--decode-burst 8``
    pipelined engine, a per-token engine without the fused step and a
    per-token engine with it; each must give the same tokens in every
    case, and all three the same as each other (on the card).  Then the
    steady-state profiles of the burst engine pipelined and of the
    per-token engine; with ``extras`` also the graph-against-eager
    check, the burst engine's unpipelined profile and the decode
    forward's device ms through the kernels and through cuBLAS.  ``make_engine(kind)`` builds the leg's
    engines."""
    import torch

    from fusioninfer_tpu_torch.ops import dispatch

    out: dict = {"streams": {}, "launches": {}, "launches_by_shape": {},
                 "beside_chunk_steps": {}}
    for kind in ("burst", "split", "fused"):
        t0 = time.perf_counter()
        engine = make_engine(kind)
        dispatch.reset_launches()
        cases = {case: serve_a1_case(engine, case) for case in A1_CASES}
        out["launches"][kind] = dispatch.launches()
        out["launches_by_shape"][kind] = dispatch.launches(by_shape=True)
        out["streams"][kind] = {case: res[0] for case, res in cases.items()}
        out["beside_chunk_steps"][kind] = cases["chunk"][1]
        if cases["chunk"][1] < 2:
            raise AssertionError(f"{tag} {kind}: the chunked prompt ran beside "
                                 f"{cases['chunk'][1]} decode steps")
        walk = sum(v for k, v in out["launches"][kind].items()
                   if k.startswith("ragged_paged_attention"))
        log(f"  {tag}, {kind}: three cases in {time.perf_counter() - t0:.2f} s; walk launches "
            f"{walk}, flash {out['launches'][kind]['flash_attention']}; sched "
            f"{ {k: engine.sched.snapshot()[k] for k in ('burst_span_steps', 'dispatch_ahead', 'burst_clamped', 'fused_steps')} }")
        if walk == 0:
            raise AssertionError(f"{tag} {kind}: no page walk launched")
        if kind == "burst":
            if ((engine.bursts.graphed and not engine.bursts.captures)
                    or engine.sched.burst_span_steps[BURST] == 0):
                raise AssertionError(f"{tag}: no burst graph ran")
            if extras:
                out["graph_eager"] = check_graph_eager(engine)
            out["profile_pipelined"] = profile_stepping(engine)
            if extras:
                engine.pipeline_bursts = False
                out["profile_unpipelined"] = profile_stepping(engine)
            out["captures"] = [dict(vars(c)) for c in engine.bursts.captures]
        elif kind == "split":
            out["profile_per_token"] = profile_stepping(engine, n_tokens=16, gemm_ab=extras)
        del engine
        torch.cuda.empty_cache()
        log(f"  {tag}, {kind}: engine done in {time.perf_counter() - t0:.1f} s")
    streams = out["streams"]
    for kind in ("burst", "split", "fused"):
        for case in A1_CASES[1:]:
            if streams[kind][case] != streams[kind]["alone"]:
                diff = {rid: first_difference(streams[kind]["alone"][rid], toks)
                        for rid, toks in streams[kind][case].items()}
                raise AssertionError(f"{tag} {kind}: case {case} parts from alone at {diff}")
        if streams[kind]["alone"] != streams["split"]["alone"]:
            diff = {rid: first_difference(streams["split"]["alone"][rid], toks)
                    for rid, toks in streams[kind]["alone"].items()}
            raise AssertionError(f"{tag}: {kind} streams part from per-token streams at "
                                 f"{diff}")
    log(f"  {tag}: greedy and seeded streams the same alone, in a batch of 8 and beside "
        f"a {A1_LONG}-token chunked prompt, on the burst, the per-token and the fused-step "
        f"engines, and the same on all three")
    if extras:
        ge = out["graph_eager"]
        log(f"  {tag}: graph replay = eager decode_burst bit for bit ({ge['rows']} rows, "
            f"span {ge['span']}, mode {ge['mode']})")
    log(f"  {tag}: captures " + ", ".join(
        f"span {c['span']} {c['mode']} {c['seconds']:.2f} s +{c['pool_bytes']} B"
        for c in out["captures"]))
    for name in ("profile_pipelined", "profile_unpipelined", "profile_per_token"):
        if name not in out:
            continue
        p = out[name]
        log(f"  {tag}, {name[8:]}: per token of each of 8 streams {p['wall_ms_per_token']:.3f} "
            f"ms wall, {p['cpu_ms_per_token']:.3f} ms thread CPU, "
            f"{p['device_ms_per_token']:.3f} ms device, busy "
            f"{p['device_busy_share'] if p['device_busy_share'] is None else round(p['device_busy_share'], 4)}, "
            f"{p['kernels_per_token']:.2f} kernel launches on {card}")
    ab = out["profile_per_token"]["gemm_ab"]
    if ab:
        cases = {"8 live rows": "live8", "2 live rows": "live2",
                 f"4 rows beside a {CHUNK_AB}-token chunk": f"fused4_chunk{CHUNK_AB}",
                 f"flash prefill of {PREFILL_AB} tokens": f"prefill{PREFILL_AB}"}
        log(f"  {tag}: one forward's device ms (K C L L C K) on {card}, through the kernels / "
            "with the unfused norm chain / through torch.matmul and the plain norms: " + "; ".join(
                f"{label} {ab[key + '_kernels']:.3f} / {ab[key + '_chain']:.3f} / "
                f"{ab[key + '_cublas']:.3f}" for label, key in cases.items()))
    return out


def serve_burst_defaults(params, card: str) -> dict:
    """``engine serve qwen3-8b`` with the CLI defaults (``--decode-burst
    8`` pipelined, prefix caching, a calibrated token budget,
    ``--max-model-len 4096``) on the phase's weights: one cold request
    first (its TTFT, and the gap to its second token, which waits for the
    graphs' captures), then the phase-4 prompts at once; every greedy
    token must pass :func:`check_greedy`."""
    import torch

    from fusioninfer_tpu_torch import cli
    from fusioninfer_tpu_torch.engine.server import EngineServer, engine_from_args
    from fusioninfer_tpu_torch.ops import dispatch

    args = cli.build_parser().parse_args(["engine", "serve", "qwen3-8b"])
    engine = engine_from_args(args, params=params)
    if engine.burst_steps != BURST or not engine.pipeline_bursts or not engine.prefix_caching:
        raise AssertionError("the CLI defaults did not build a pipelined burst engine")
    server = EngineServer(engine, host="127.0.0.1", port=0)
    server.start()
    prompts = [("The quick brown fox jumps over the lazy dog. " * 40)[:n]
               for n in N_REQUESTS_PROMPTS]
    results, errors = [None] * len(prompts), []
    try:
        dispatch.reset_launches()
        cold = {**_post(server.port, {"prompt": "A cold start: " + prompts[1],
                                      "max_tokens": MAX_TOKENS, "temperature": 0.0,
                                      "stream": True}, stream=True),
                "prompt": "A cold start: " + prompts[1]}
        capture_s = sum(c.seconds for c in engine.bursts.captures)

        def one(i, text):
            try:
                results[i] = {**_post(server.port, {"prompt": text, "max_tokens": MAX_TOKENS,
                                                    "temperature": 0.0, "stream": True},
                                      stream=True), "prompt": text}
            except Exception as e:  # noqa: BLE001 - collected and re-raised below
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a request did not finish within 600 s")
    finally:
        server.stop()
    if errors:
        raise AssertionError("; ".join(errors))
    for r in [cold, *results]:
        if r["tokens"] != MAX_TOKENS or r["finish"] != "length":
            raise AssertionError(f"defaults leg: {r['tokens']} tokens, finish {r['finish']!r}")
    launches = dispatch.launches()
    shapes = dispatch.launches(by_shape=True)
    gap = check_greedy(engine, [cold, *results], paged_prompt=True)
    snap = engine.sched.snapshot()
    out = {"token_budget": engine.token_budget, "launches": launches, "greedy_gap": gap,
           "launches_by_shape": shapes,
           "cold_ttft_s": cold["ttft_s"], "cold_second_token_s": cold["second_token_s"],
           "capture_s": capture_s,
           "captures": [dict(vars(c)) for c in engine.bursts.captures],
           "ttft_s": [r["ttft_s"] for r in results],
           "decode_tok_s": [r["decode_tok_s"] for r in results],
           "dispatch_ahead": snap["dispatch_ahead"], "burst_clamped": snap["burst_clamped"],
           "burst_span_steps": snap["burst_span_steps"]}
    if launches["ragged_paged_attention_kvsplit"] == 0 or snap["burst_span_steps"][str(BURST)] == 0:
        raise AssertionError(f"defaults leg: no burst walk launched: {launches}, {snap}")
    log(f"  CLI defaults (budget {engine.token_budget}): cold request TTFT "
        f"{cold['ttft_s']:.4f} s, its second token {cold['second_token_s']:.4f} s later "
        f"(captures {capture_s:.2f} s: "
        + ", ".join(f"span {c.span} {c.mode} {c.seconds:.2f} s +{c.pool_bytes} B"
                    for c in engine.bursts.captures)
        + f"); then {len(prompts)} SSE requests: TTFT {[round(t, 4) for t in out['ttft_s']]} s, "
        f"decode {[round(x, 1) for x in out['decode_tok_s']]} tok/s per stream; "
        f"dispatch_ahead {snap['dispatch_ahead']}, burst_span_steps "
        f"{snap['burst_span_steps']}, burst_clamped {snap['burst_clamped']}; greedy gap "
        f"{gap:.4f} on {card}")
    del engine
    torch.cuda.empty_cache()
    return out


# -- phase 10: guided decoding ---------------------------------------------------

GUIDED_TOKENS = 48
# json_schema requests: a closed object whose walk the grammar forces to
# a close (every request of it must stop), and one with an unbounded
# integer (may run to its length)
GUIDED_SCHEMAS = {
    "flag": {"type": "object", "properties": {"ok": {"type": "boolean"}},
             "required": ["ok"], "additionalProperties": False},
    "pet": {"type": "object",
            "properties": {"kind": {"enum": ["cat", "dog"]}, "age": {"type": "integer"},
                           "tags": {"type": "array", "items": {"enum": ["a", "b"]},
                                    "maxItems": 2}},
            "required": ["kind", "age"], "additionalProperties": False},
}
GUIDED_PLAIN = ("Unguided stream one decoding in bursts beside guided rows.",
                "Unguided stream two, also bursting, next to json rows.",
                "A third unguided stream, the last of the bursting rows.")


def conforms(name: str, doc) -> bool:
    """``doc`` (parsed JSON) satisfies ``GUIDED_SCHEMAS[name]``, checked by
    hand, independently of the grammar that produced it."""
    if not isinstance(doc, dict):
        return False
    if name == "flag":
        return set(doc) == {"ok"} and isinstance(doc["ok"], bool)
    tags_ok = "tags" not in doc or (isinstance(doc["tags"], list) and len(doc["tags"]) <= 2
                                    and all(t in ("a", "b") for t in doc["tags"]))
    return (set(doc) <= {"kind", "age", "tags"} and doc.get("kind") in ("cat", "dog")
            and type(doc.get("age")) is int and tags_ok)


def serve_guided_leg(engine, card: str) -> dict:
    """Phase 10 on a ``--decode-burst 8`` engine through the server: three
    unguided greedy streams served alone, then again beside json_object
    and json_schema requests, greedy and seeded (the guided rows step once
    a pass while the unguided ones burst).  Every guided request that
    finishes with ``stop`` must parse and conform, every ``flag`` request
    must stop, and each unguided stream must equal its alone stream.  The
    guided rows' wall ms a token (SSE stamps) and the guided host work a
    step (masks, uploads and machine advances) are printed."""
    from fusioninfer_tpu_torch.engine.server import EngineServer
    from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer
    from fusioninfer_tpu_torch.ops import dispatch

    tok = ByteTokenizer()
    server = EngineServer(engine, host="127.0.0.1", port=0)
    if not engine.guided_enabled:
        raise AssertionError("the server installed no guided vocab")
    host = {"s": 0.0, "calls": 0}
    for name in ("_guided_legal", "_guided_advance"):
        fn = getattr(engine, name)

        def timed(*a, _fn=fn):
            t = time.perf_counter()
            try:
                return _fn(*a)
            finally:
                host["s"] += time.perf_counter() - t
                host["calls"] += 1

        setattr(engine, name, timed)
    guided = {}
    for mode, sampling in (("greedy", {"temperature": 0.0}),
                           ("seeded", {"temperature": 0.8, "top_k": 40, "seed": 5})):
        guided[f"object_{mode}"] = {**sampling, "response_format": {"type": "json_object"}}
        for name, schema in GUIDED_SCHEMAS.items():
            guided[f"{name}_{mode}"] = {**sampling, "response_format": {
                "type": "json_schema", "json_schema": {"name": name, "schema": schema}}}
    results, errors = {}, []

    def send(label, body):
        def one():
            try:
                results[label] = _post(server.port, {"max_tokens": GUIDED_TOKENS,
                                                     "stream": True, **body}, stream=True)
            except Exception as e:  # noqa: BLE001 - collected and re-raised below
                errors.append(f"{label}: {e!r}")
        t = threading.Thread(target=one)
        t.start()
        return t

    server.start()
    try:
        for i, text in enumerate(GUIDED_PLAIN):
            send(f"alone{i}", {"prompt": text, "temperature": 0.0}).join(600)
        steps0, host0 = engine.sched.steps_total, dict(host)
        dispatch.reset_launches()
        t0 = time.perf_counter()
        threads = [send(f"beside{i}", {"prompt": text, "temperature": 0.0})
                   for i, text in enumerate(GUIDED_PLAIN)]
        threads += [send(label, {"prompt": f"Answer in JSON ({label}):", **body})
                    for label, body in guided.items()]
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"guided leg: {errors or 'a request did not finish'}")
    launches = dispatch.launches()
    shapes = dispatch.launches(by_shape=True)
    steps = engine.sched.steps_total - steps0
    for i in range(len(GUIDED_PLAIN)):
        a, b = results[f"alone{i}"]["token_ids"], results[f"beside{i}"]["token_ids"]
        if a != b:
            raise AssertionError(f"guided leg: unguided stream {i} beside the guided rows "
                                 f"parts from its alone stream at {first_difference(a, b)}")
    outcomes = {}
    for label in guided:
        r = results[label]
        text = tok.decode(r["token_ids"])
        outcomes[label] = {"finish": r["finish"], "tokens": r["tokens"], "text": text,
                           "ms_per_token": 1e3 / r["decode_tok_s"] if r["decode_tok_s"]
                           else None}
        if r["finish"] == "stop":
            doc = json.loads(text)
            name = label.rsplit("_", 1)[0]
            if not isinstance(doc, dict) or (name in GUIDED_SCHEMAS
                                             and not conforms(name, doc)):
                raise AssertionError(f"guided leg: {label} stopped with {text!r}")
        elif r["finish"] != "length" or r["tokens"] != GUIDED_TOKENS:
            raise AssertionError(f"guided leg: {label} ended {r['finish']!r} after "
                                 f"{r['tokens']} tokens")
    if any(outcomes[f"flag_{m}"]["finish"] != "stop" for m in ("greedy", "seeded")):
        raise AssertionError("guided leg: a closed-schema request did not stop")
    if engine.sched.burst_span_steps[BURST] == 0:
        raise AssertionError("guided leg: the unguided rows never burst")
    host_ms = (host["s"] - host0["s"]) * 1e3 / max(steps, 1)
    ms_tok = [o["ms_per_token"] for o in outcomes.values() if o["ms_per_token"]]
    log(f"  guided leg in {wall:.2f} s, {steps} engine steps: "
        + "; ".join(f"{k} {v['finish']} {v['tokens']} tok {v['text'][:40]!r}"
                    for k, v in outcomes.items()))
    log(f"  guided rows' wall ms a token {[round(x, 2) for x in ms_tok]} on {card}; guided "
        f"host work (masks, uploads, machine advances) {host_ms:.3f} ms a step; the "
        f"{len(GUIDED_PLAIN)} unguided streams beside them equal their alone streams; "
        f"launches {launches}")
    return {"wall_s": wall, "steps": steps, "outcomes": outcomes, "launches": launches,
            "launches_by_shape": shapes,
            "guided_ms_per_token": ms_tok, "guided_host_ms_per_step": host_ms,
            "sched": engine.sched.snapshot()}


# -- phase 3 additions: the shapes of qwen3-1.7b and mistral-7b ----------------

# the projections of qwen3-1.7b and mistral-7b beside qwen3-8b's, (K, N) by
# weight (mistral-7b's wq / wk / wv / wo are qwen3-8b's shapes)
GEMM_SHAPES_NEW = {"1.7b wq/wo": (2048, 2048), "1.7b wk/wv": (2048, 1024),
                   "1.7b gate/up": (2048, 6144), "1.7b down": (6144, 2048),
                   "1.7b tied head": (2048, 151936), "7b gate/up": (4096, 14336),
                   "7b down": (14336, 4096), "7b lm_head": (4096, 32768)}
# row counts: a decode row, 8 and 32 decode slots, 8 spec windows of 5, a
# 160-token chunk, a fused step, a long prefill
GEMM_ROWS_NEW = (1, 8, 32, 40, 160, 520, 3000)
# the walks at G 2 (qwen3-1.7b, H16 on KV8): 32 decode rows, contexts 64…1024
G2_CTX = tuple(64 + (960 * i) // 31 for i in range(32))
# the window of mistral-7b, its 8192-token tables, decode rows past the
# window and a 512-token chunk starting at 5000
WINDOW = 4096
WINDOW_MP = 64
WINDOW_CTX = (4500, 4700, 4900, 5100, 5300, 5500, 5800, 6000)
WINDOW_CHUNK = (5000, 512)


def check_walks_g2(gen, split: bool, int8: bool) -> dict:
    """A ragged walk at G 2 (16 query heads on 8 KV heads) over 32 decode
    rows (contexts 64…1024, ps 128) against its plain version, timed
    beside SDPA and the bound: the split walk on 32-page tables (the 4096
    engine's), the single walk on 16-page tables (the 2048 engine's) at
    the cluster size a 32-row engine fixes."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    layer, G = 1, 2
    mp = 32 if split else 16
    rows = [(c - 1, 1) for c in G2_CTX]
    kp, vp, ks, vs, tables = paged_pool(gen, rows, int8, mp=mp)
    *ragged, T = ragged_batch(rows)
    desc = (tables, *ragged)
    q = torch.randn((T, KV_HEADS * G, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    sc = (ks, vs) if int8 else ()
    lsc = (ks[layer], vs[layer]) if int8 else ()
    cl = pa.engine_cluster_size(len(rows), KV_HEADS, mp, "cuda")
    if split:
        def kern():
            return pa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, *sc, layer=layer)
        plain_walk = pa.reference_ragged_paged_attention_kvsplit
    else:
        def kern():
            return pa.ragged_paged_attention(q, kp, vp, *desc, *sc, layer=layer, cluster=cl)
        plain_walk = pa.reference_ragged_paged_attention
    name = ("paged split-KV" if split else f"paged single walk CL {cl}") + " G2" + (
        " int8" if int8 else "")
    shape = (f"T{T}: 32 decode rows ctx 64..1024, H16 KV8, mp {mp}, ps 128"
             + (", int8 pages" if int8 else ""))
    return measure(name, shape, kern, lambda: plain_walk(q, kp[layer], vp[layer], *desc, *lsc),
                   PAGED_ROW_TOL, rows, int8,
                   (lambda: None) if int8 else (lambda: sdpa_calls(q, kp[layer], vp[layer],
                                                                   tables, rows)),
                   group=G)


def check_walks_window(gen, split: bool, int8: bool, fused: bool) -> dict:
    """A ragged walk under mistral-7b's 4096-token window: 8 decode rows at
    contexts 4500…6000 (and with ``fused`` a 512-token chunk from 5000,
    T520), 64-page tables, against its plain version, timed beside SDPA
    and the bound (keys inside the window only).  The kernel reads
    trimmed tables, as a windowed engine's are: each row's entries below
    the page of its first visible key point to the trash page, whose K/V
    (int8 pages: whose scales) are NaN, so a walk that read one would
    fail ``check_close``; the plain version reads the untrimmed tables."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    layer = 1
    rows = [(c - 1, 1) for c in WINDOW_CTX] + ([WINDOW_CHUNK] if fused else [])
    kp, vp, ks, vs, tables = paged_pool(gen, rows, int8, mp=WINDOW_MP)
    *ragged, T = ragged_batch(rows)
    trash = kp.shape[2] - 1
    trimmed = tables.clone()
    for r, (start, _) in enumerate(rows):
        trimmed[r, : max(0, start - WINDOW + 1) // PAGE] = trash
    nan = float("nan")
    if int8:
        ks_n, vs_n = ks.clone(), vs.clone()
        ks_n[:, :, trash] = nan
        vs_n[:, :, trash] = nan
        pool, sc, lsc = (kp, vp), (ks_n, vs_n), (ks[layer], vs[layer])
    else:
        kp_n, vp_n = kp.clone(), vp.clone()
        kp_n[:, :, trash] = nan
        vp_n[:, :, trash] = nan
        pool, sc, lsc = (kp_n, vp_n), (), ()
    q = torch.randn((T, KV_HEADS * GROUP, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    cl = pa.engine_cluster_size(8, KV_HEADS, WINDOW_MP, "cuda")
    if split:
        def kern():
            return pa.ragged_paged_attention_kvsplit(q, *pool, trimmed, *ragged, *sc,
                                                     window=WINDOW, layer=layer)
        plain_walk = pa.reference_ragged_paged_attention_kvsplit
    else:
        def kern():
            return pa.ragged_paged_attention(q, *pool, trimmed, *ragged, *sc, window=WINDOW,
                                             layer=layer, cluster=cl)
        plain_walk = pa.reference_ragged_paged_attention
    name = ("paged split-KV" if split else f"paged single walk CL {cl}") + (
        f" window {WINDOW}") + (" int8" if int8 else "")
    shape = (f"T{T}: 8 decode rows ctx 4500..6000" + (" + a 512-token chunk at 5000"
                                                      if fused else "")
             + f", mp {WINDOW_MP}, trimmed tables, NaN trash page"
             + (", int8 pages" if int8 else ""))
    return measure(name, shape, kern,
                   lambda: plain_in_pieces(plain_walk, q, kp[layer], vp[layer], tables, rows,
                                           lsc, window=WINDOW),
                   PAGED_ROW_TOL, rows, int8,
                   (lambda: None) if int8 else (lambda: sdpa_calls(q, kp[layer], vp[layer],
                                                                   tables, rows, WINDOW)),
                   window=WINDOW, plain_reps=3)


def check_new_shapes(gen) -> dict:
    """Phase 3's cases at the new models' shapes: the GEMM at qwen3-1.7b's
    and mistral-7b's weights, the norm kernels at D 2048, the q/k kernel
    at H16 KV8 with norms and at H32 KV8 without (bf16 and int8 pages),
    the walks at G 2, flash at G 2 and under the 4096 window, the walks
    under the window over trimmed tables."""
    gemm = check_gemm(gen, GEMM_SHAPES_NEW, GEMM_ROWS_NEW)
    norms = {"rms_norm": check_norm(gen, {"d_model 2048": (2048, 1)}, GEMM_ROWS_NEW),
             "add_rms_norm": check_add_norm(gen, 2048, GEMM_ROWS_NEW)}
    for int8 in (False, True):
        pages = "int8" if int8 else "bf16"
        norms[f"qk_norm_rope_kv_h16_{pages}"] = check_qk_norm_rope_kv(
            gen, int8, (16, 8, 128), True, GEMM_ROWS_NEW)
        norms[f"qk_rope_kv_h32_no_norm_{pages}"] = check_qk_norm_rope_kv(
            gen, int8, (32, 8, 128), False, GEMM_ROWS_NEW)
    walks_g2 = {f"{'split' if split else 'single'}_{'int8' if int8 else 'bf16'}":
                check_walks_g2(gen, split, int8) for int8 in (False, True)
                for split in (False, True)}
    walks_window = {f"{'split' if split else 'single'}_{'int8' if int8 else 'bf16'}_"
                    f"{'fused' if fused else 'decode'}": check_walks_window(gen, split, int8,
                                                                            fused)
                    for int8 in (False, True) for split in (False, True)
                    for fused in (False, True)}
    flash = {"g2": check_flash(gen, 1, 1024, H=16),
             "window": check_flash(gen, 1, 6144, H=32, window=WINDOW)}
    return {"gemm": gemm, "norms": norms, "walks_g2": walks_g2, "walks_window": walks_window,
            "flash": flash}


# -- phases 11-13: the other dense model families --------------------------------

def release_device() -> None:
    """Free the device memory of dropped engines: engines sit in reference
    cycles (servers' threads, patched methods) that only the cycle
    collector frees, and the caching allocator keeps their blocks until
    emptied."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()



# phase 11: qwen3-1.7b at the JAX bench's batch, 32 greedy streams
G2_BATCH = 32
G2_PROMPTS = tuple(128 + (640 * i) // (G2_BATCH - 1) for i in range(G2_BATCH))
G2_TOKENS = 128
G2_CHECKED = (0, 10, 21, 31)  # streams held against the plain forward
# phase 12: mistral-7b past its window
WINDOW_PROMPTS = (4500, 5000, 5500, 6000)
WINDOW_TOKENS = 256
WINDOW_MAX_LEN = 8192
# phase 13: the loader, mistral-7b's widths at 4 layers
LOADER_LAYERS = 4
LOADER_PROMPTS = ("A checkpoint written by the port and served from its files: ",
                  "Loaded tensors must give the tokens of the tensors in memory. " * 6)


def random_prompts(lens, vocab: int, salt: int) -> list[list[int]]:
    """Token ids drawn from the seed, one prompt of each length."""
    import torch

    g = torch.Generator().manual_seed(SEED * 1_000 + salt)
    return [torch.randint(3, vocab, (n,), generator=g).tolist() for n in lens]


def run_streams(engine, prompts, max_tokens: int, alone: bool = False,
                after_step=None, hook_when=None, hook=None) -> dict[int, list[int]]:
    """Serve greedy requests of ``prompts`` on ``engine`` through
    :meth:`NativeEngine.step` until drained → ``{i: tokens}``; ``alone``
    serves them one at a time.  ``after_step(engine)`` runs after every
    step; ``hook(engine)`` (returning the step outputs it caused) runs once,
    the first time ``hook_when(engine)`` holds."""
    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams

    out: dict[int, list[int]] = {i: [] for i in range(len(prompts))}

    def take(outputs):
        for o in outputs:
            if o.finish_reason and o.finish_reason.startswith("error"):
                raise AssertionError(f"{o.request_id}: {o.finish_reason}")
            out[int(o.request_id.rsplit("-", 1)[1])].append(o.token)

    def drain():
        nonlocal hook
        for _ in range(20_000):
            if not engine.has_work():
                return
            take(engine.step())
            if after_step is not None:
                after_step(engine)
            if hook is not None and hook_when(engine):
                take(hook(engine))
                hook = None
        raise AssertionError("the engine did not drain")

    groups = [[i] for i in range(len(prompts))] if alone else [list(range(len(prompts)))]
    for group in groups:
        for i in group:
            engine.add_request(Request(f"s-{i}", list(prompts[i]),
                                       SamplingParams(temperature=0.0, max_tokens=max_tokens)))
        drain()
    for i, toks in out.items():
        if len(toks) != max_tokens:
            raise AssertionError(f"stream {i}: {len(toks)} tokens, expected {max_tokens}")
    return out


def profile_steps(engine, n_steps: int = 8) -> tuple[dict, list]:
    """``n_steps`` engine steps timed (wall ms and the thread's CPU ms a
    step), then ``n_steps`` more under ``torch.profiler`` (device ms and
    kernel launches a step) → ``(figures, the steps' outputs)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    outputs = []
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(n_steps):
        outputs += engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    cpu_ms = (time.thread_time() - c0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            outputs += engine.step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    return ({"wall_ms_per_step": wall_ms, "cpu_ms_per_step": cpu_ms,
             "device_ms_per_step": device_ms,
             "kernels_per_step": kernel_launches(kernels) / n_steps,
             "device_busy_share": device_ms / wall_ms if device_ms else None}, outputs)


def leg_launches(run) -> tuple[object, dict]:
    """``run()`` with every launch count set to 0 just before → (its result,
    ``{"launches", "launches_by_shape"}`` read just after)."""
    from fusioninfer_tpu_torch.ops import dispatch

    dispatch.reset_launches()
    res = run()
    return res, {"launches": dispatch.launches(),
                 "launches_by_shape": dispatch.launches(by_shape=True)}


def serve_g2_leg(params, kv_dtype: str, max_len: int, card: str) -> dict:
    """qwen3-1.7b at full width (28 layers, tied head, H16 on KV8) and
    ``--max-batch-size 32`` through ``engine serve``'s ``engine_from_args``, on
    ``kv_dtype`` pages at ``max_len``: 32 greedy requests (prompts of
    128…768 token ids, G2_TOKENS tokens each) served at once with the CLI's
    decode defaults (bursts of 8, pipelined, prefix caching) and
    ``--no-token-budget`` (every prompt a flash prefill, as alone), again
    with ``--decode-burst 1``, then one at a time on a burst engine without
    prefix caching (so no alone prompt hits the cache): every stream must
    be the same all three ways, G2_CHECKED streams must pass the greedy
    check against :func:`plain_forward`, and the walk the engine fixed
    from ``max_len`` must have launched.  Then the decode profile of the
    32 streams (:func:`profile_stepping`) on the burst and per-token
    engines and the graphs' capture seconds."""
    import torch

    from fusioninfer_tpu_torch import cli
    from fusioninfer_tpu_torch.engine.server import engine_from_args
    from fusioninfer_tpu_torch.models.config import get_preset

    cfg = get_preset("qwen3-1.7b")
    prompts = random_prompts(G2_PROMPTS, cfg.vocab_size, salt=11)
    tag = f"{'int8' if kv_dtype == 'int8' else 'bf16'}_{max_len}"
    base = ["engine", "serve", "qwen3-1.7b", "--max-batch-size", str(G2_BATCH),
            "--max-model-len", str(max_len), "--no-token-budget"] + (
        ["--kv-cache-dtype", "int8"] if kv_dtype == "int8" else [])
    walk = "ragged_paged_attention" + ("_kvsplit" if max_len > 2048 else "") + (
        "_int8" if kv_dtype == "int8" else "")
    out: dict = {"tag": tag, "walk": walk}
    streams = {}
    for kind, extra in (("burst", []), ("step", ["--decode-burst", "1"]),
                        ("alone", ["--no-prefix-caching"])):
        engine = engine_from_args(cli.build_parser().parse_args(base + extra), params=params)
        if (engine.cfg.n_heads // engine.cfg.n_kv_heads != 2 or engine.max_batch_size != G2_BATCH
                or engine.burst_steps != (1 if kind == "step" else BURST)
                or engine.token_budget is not None or (engine.kv_splits == 0) != (max_len <= 2048)):
            raise AssertionError(f"qwen3-1.7b {tag} {kind}: unexpected engine")
        t0 = time.perf_counter()
        streams[kind], leg = leg_launches(
            lambda: run_streams(engine, prompts, G2_TOKENS, alone=kind == "alone"))
        wall = time.perf_counter() - t0
        if leg["launches"][walk] == 0:
            raise AssertionError(f"qwen3-1.7b {tag} {kind}: no {walk} launch at G 2: "
                                 f"{leg['launches']}")
        out[kind] = {**leg, "wall_s": wall,
                     "captures": [dict(vars(c)) for c in
                                  (engine.bursts.captures if engine.bursts else [])]}
        if kind == "burst":
            out["greedy_gap"] = max(check_greedy_ids(engine, prompts[i], streams[kind][i])
                                    for i in G2_CHECKED)
        if kind != "alone":
            out[kind]["profile"] = profile_stepping(engine, n_tokens=16, lens=G2_PROMPTS)
            p = out[kind]["profile"]
            log(f"  qwen3-1.7b {tag}, {kind} engine: {G2_BATCH} x {G2_TOKENS} tokens in "
                f"{wall:.3f} s; decode of {G2_BATCH} streams: {p['wall_ms_per_token']:.3f} ms wall, "
                f"{p['cpu_ms_per_token']:.3f} ms thread CPU, {p['device_ms_per_token']:.3f} ms "
                f"device a token of each stream (busy {p['device_busy_share']:.3f}), "
                f"{p['kernels_per_token']:.1f} kernel launches a step"
                + (f"; captures " + ", ".join(f"span {c.span} {c.mode} {c.seconds:.2f} s"
                                              for c in engine.bursts.captures)
                   if engine.bursts else "") + f" on {card}")
        del engine
        release_device()
    for kind in ("step", "alone"):
        for i in range(G2_BATCH):
            if streams[kind][i] != streams["burst"][i]:
                k = first_difference(streams[kind][i], streams["burst"][i])
                raise AssertionError(f"qwen3-1.7b {tag}: stream {i} {kind} parts from the "
                                     f"batch of {G2_BATCH} in bursts at token {k}")
    log(f"  qwen3-1.7b {tag}: {G2_BATCH} greedy streams ({walk} at G 2) the same in a batch "
        f"of {G2_BATCH} in bursts, per token and alone; streams {list(G2_CHECKED)} pass the greedy "
        f"check (gap {out['greedy_gap']:.4f})")
    return out


def window_trim_check(bound_pages: int, seen: dict):
    """An ``after_step`` that holds every running sequence with at least two
    generated tokens (a newly activated row is trimmed at its next decode
    pass) to ``bound_pages`` non-trash pages, recording the largest count
    in ``seen["max_pages"]``."""
    def check(engine):
        trash = engine.cache_cfg.trash_page
        for st in engine.running.values():
            if st.n_generated < 2:
                continue
            held = sum(p != trash for p in engine.alloc.pages_of(st.request.request_id))
            seen["max_pages"] = max(seen.get("max_pages", 0), held)
            if held > bound_pages:
                raise AssertionError(f"{st.request.request_id} holds {held} pages at length "
                                     f"{len(st.tokens)}, beyond {bound_pages}")
    return check


def serve_window_leg(params, kv_dtype: str, card: str, qwen8_step: dict) -> dict:
    """mistral-7b at full width (32 layers, no QK-norm, window 4096) through
    ``engine serve``'s ``engine_from_args`` at ``--max-model-len 8192
    --tokens-per-step 512`` on ``kv_dtype`` pages: four prompts of
    4500…6000 token ids chunked through the walks and WINDOW_TOKENS greedy
    tokens each, on the CLI's burst engine, a ``--decode-burst 1`` engine
    and a ``--speculative-ngram 4`` engine; all three must serve the same
    tokens, every token must pass the greedy check against a windowed
    :func:`plain_forward`, after every step each decoding sequence must
    hold at most ``ceil(4096 / 128) + 1 + span`` real pages, pages must
    have been trimmed and the pool must drain.  The per-token engine's
    decode step (four rows at ~4600-6200 tokens) is profiled mid-run, and
    :func:`profile_decode` runs on it at phase 4's shape beside qwen3-8b's
    figure there."""
    import torch

    from fusioninfer_tpu_torch import cli
    from fusioninfer_tpu_torch.engine.server import engine_from_args
    from fusioninfer_tpu_torch.models.config import get_preset

    cfg = get_preset("mistral-7b")
    prompts = random_prompts(WINDOW_PROMPTS, cfg.vocab_size, salt=12)
    tag = "int8" if kv_dtype == "int8" else "bf16"
    base = ["engine", "serve", "mistral-7b", "--max-model-len", str(WINDOW_MAX_LEN),
            "--tokens-per-step", str(TOKENS_PER_STEP)] + (
        ["--kv-cache-dtype", "int8"] if kv_dtype == "int8" else [])
    walk = "ragged_paged_attention_kvsplit" + ("_int8" if kv_dtype == "int8" else "")
    out: dict = {"tag": tag, "walk": walk}
    streams = {}
    for kind, extra in (("burst", []), ("step", ["--decode-burst", "1"]),
                        ("spec", ["--speculative-ngram", str(SPEC_K)])):
        engine = engine_from_args(cli.build_parser().parse_args(base + extra), params=params)
        if engine.cfg.sliding_window != WINDOW or engine.kv_splits == 0:
            raise AssertionError(f"mistral-7b {tag} {kind}: unexpected engine")
        span = max(engine.burst_steps, 1 + (engine.spec_k or 0))
        bound_pages = -(-WINDOW // engine.cache_cfg.page_size) + 1 + span
        seen: dict = {}
        prof: dict = {}

        def profile_mid(engine, prof=prof):
            figures, outputs = profile_steps(engine)
            prof.update(figures)
            return outputs

        def decoding(engine):  # every row decodes, none has finished
            return (engine.num_running == len(prompts) and not engine.prefilling
                    and min(st.n_generated for st in engine.running.values()) > 8)

        t0 = time.perf_counter()
        streams[kind], leg = leg_launches(lambda: run_streams(
            engine, prompts, WINDOW_TOKENS, after_step=window_trim_check(bound_pages, seen),
            hook_when=decoding if kind == "step" else None,
            hook=profile_mid if kind == "step" else None))
        wall = time.perf_counter() - t0
        trimmed = engine.window_pages_trimmed_total
        usage = engine.kv_cache_usage()
        if leg["launches"][walk] == 0 or trimmed == 0 or usage != 0.0:
            raise AssertionError(f"mistral-7b {tag} {kind}: {walk} launches "
                                 f"{leg['launches'][walk]}, pages trimmed {trimmed}, pool "
                                 f"usage {usage} after the run")
        out[kind] = {**leg, "wall_s": wall, "pages_trimmed": trimmed,
                     "max_pages_held": seen["max_pages"], "page_bound": bound_pages,
                     "spec_accepted": engine.spec_accepted_total,
                     "spec_proposed": engine.spec_proposed_total}
        log(f"  mistral-7b {tag}, {kind} engine: 4 x {WINDOW_TOKENS} tokens after prompts of "
            f"{', '.join(map(str, WINDOW_PROMPTS))} in {wall:.3f} s; {trimmed} pages freed by "
            f"trim_window, at most {seen['max_pages']} real pages a decoding sequence (bound "
            f"{bound_pages}), pool drained"
            + (f"; drafts accepted {engine.spec_accepted_total}/{engine.spec_proposed_total}"
               if kind == "spec" else ""))
        if kind == "burst":
            t0 = time.perf_counter()
            out["greedy_gap"] = max(check_greedy_ids(engine, prompts[i], streams[kind][i],
                                                     paged_prompt=True)
                                    for i in range(len(prompts)))
            out["greedy_check_s"] = time.perf_counter() - t0
        if kind == "step":
            out["window_profile"] = dict(prof)
        del engine
        release_device()
    # phase 4's decode-step profile (8 rows, contexts 100..1500, as phases 4-6
    # serve: no prefix cache, no token budget) on the same weights
    engine = engine_from_args(cli.build_parser().parse_args(
        base[:5] + ["--no-token-budget", "--no-prefix-caching", "--decode-burst", "1"]
        + base[7:]), params=params)
    out["decode_profile"] = profile_decode(engine)
    del engine
    release_device()
    p, d = out["window_profile"], out["decode_profile"]
    log(f"  mistral-7b {tag} decode step, 4 rows at 4600..6250 tokens (window {WINDOW}): "
        f"{p['wall_ms_per_step']:.3f} ms wall, {p['cpu_ms_per_step']:.3f} ms thread CPU, "
        f"{p['device_ms_per_step']:.3f} ms device, {p['kernels_per_step']:.1f} launches a "
        f"step; at phase 4's shape (8 rows, contexts 100..1500): "
        f"{d['wall_ms_per_step']:.3f} ms wall, {d['device_ms_per_step']:.3f} ms device, "
        f"against qwen3-8b's {qwen8_step['device_ms_per_step']:.3f} ms there at 4096, on "
        f"{card}")
    for kind in ("step", "spec"):
        for i in range(len(prompts)):
            if streams[kind][i] != streams["burst"][i]:
                k = first_difference(streams[kind][i], streams["burst"][i])
                raise AssertionError(f"mistral-7b {tag}: stream {i} on the {kind} engine "
                                     f"parts from the burst engine's at token {k}")
    log(f"  mistral-7b {tag}: burst, per-token and speculative streams the same; every "
        f"token passes the windowed greedy check (gap {out['greedy_gap']:.4f}, "
        f"{out['greedy_check_s']:.1f} s)")
    return out


def serve_loader_leg(params, card: str) -> dict:
    """The port's ``save_hf_checkpoint`` writes mistral-7b's widths at
    LOADER_LAYERS layers (the first layers of ``params``) into a
    temporary directory under ``build/``, removed afterwards; ``engine
    serve --load-hf DIR`` serves two SSE requests from it through the
    HTTP server, under the checkpoint's model name; their tokens must
    equal those of an engine built alike from the parameters in memory,
    and the loaded tensors must equal them bit for bit."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from fusioninfer_tpu_torch import cli
    from fusioninfer_tpu_torch.engine.engine import NativeEngine
    from fusioninfer_tpu_torch.engine.server import EngineServer, engine_from_args
    from fusioninfer_tpu_torch.models.config import get_preset
    from fusioninfer_tpu_torch.models.loader import save_hf_checkpoint
    from fusioninfer_tpu_torch.ops import dispatch

    cfg = dataclasses.replace(get_preset("mistral-7b"), n_layers=LOADER_LAYERS)
    small = {**{k: v for k, v in params.items() if k != "layers"},
             "layers": {k: v[:LOADER_LAYERS] for k, v in params["layers"].items()}}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = tempfile.mkdtemp(prefix="hf-checkpoint-", dir=os.path.join(ROOT, "build"))

    def serve(engine) -> list[dict]:
        server = EngineServer(engine, host="127.0.0.1", port=0)
        server.start()
        try:
            return [{**_post(server.port, {"prompt": text, "max_tokens": MAX_TOKENS,
                                           "temperature": 0.0, "stream": True}, stream=True),
                     "model": server.model_name} for text in LOADER_PROMPTS]
        finally:
            server.stop()

    try:
        t0 = time.perf_counter()
        save_hf_checkpoint(path, cfg, small)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        args = cli.build_parser().parse_args(
            ["engine", "serve", "--load-hf", path, "--max-model-len", str(WINDOW_MAX_LEN),
             "--tokens-per-step", str(TOKENS_PER_STEP)])
        t0 = time.perf_counter()
        dispatch.reset_launches()
        engine = engine_from_args(args)
        load_s = time.perf_counter() - t0
        if engine.cfg != cfg:
            raise AssertionError(f"loaded config {engine.cfg} is not {cfg}")
        for key in ("embed", "final_norm", "lm_head"):
            if not torch.equal(engine.params[key], small[key]):
                raise AssertionError(f"loaded {key} differs from the parameters written")
        for key, w in small["layers"].items():
            if not torch.equal(engine.params["layers"][key], w):
                raise AssertionError(f"loaded layers.{key} differs from the parameters written")
        loaded = serve(engine)
        leg = {"launches": dispatch.launches(),
               "launches_by_shape": dispatch.launches(by_shape=True)}
        settings = dict(max_batch_size=engine.max_batch_size, token_budget=engine.token_budget,
                        decode_burst_steps=engine.burst_steps, device=engine.device)
        cache_cfg = engine.cache_cfg
        del engine
        release_device()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    engine = NativeEngine(cfg, cache_cfg, params=small, **settings)
    memory = serve(engine)
    del engine
    release_device()
    for a, b in zip(loaded, memory):
        if a["model"] != "mistral-7b" or a["tokens"] != MAX_TOKENS:
            raise AssertionError(f"--load-hf served {a['tokens']} tokens as {a['model']!r}")
        if a["token_ids"] != b["token_ids"]:
            raise AssertionError(f"--load-hf tokens part from the in-memory engine's at token "
                                 f"{first_difference(a['token_ids'], b['token_ids'])}")
    log(f"  mistral-7b widths at {LOADER_LAYERS} layers: wrote {nbytes / 1e9:.3f} GB of "
        f"safetensors in {write_s:.2f} s, engine serve --load-hf built in {load_s:.2f} s "
        f"(tensors equal to those written); two SSE requests served as 'mistral-7b', tokens "
        f"equal to the in-memory engine's; TTFT {[round(r['ttft_s'], 4) for r in loaded]} s "
        f"on {card}")
    return {**leg, "bytes": nbytes, "write_s": write_s, "load_s": load_s,
            "ttft_s": [r["ttft_s"] for r in loaded]}


def kernel_row(name: str, source: str, replaces: int, launches: int, res: dict) -> dict:
    return {"name": name, "route": "cuda", "source": f"fusioninfer_tpu_torch/csrc/{source}",
            "replaces": f"fusioninfer_tpu/ops/{replaces}", "launches": launches,
            **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fusioninfer_tpu_torch.engine.engine import NativeEngine
    from fusioninfer_tpu_torch.engine.kv_cache import auto_cache_config
    from fusioninfer_tpu_torch.models.config import get_preset
    from fusioninfer_tpu_torch.ops import _build, dispatch
    from fusioninfer_tpu_torch.ops.paged_attention import engine_cluster_size

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/14] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    _build.build_all()
    log(f"[2/14] build: {len(_build.SIGNATURES)} sources in {_build.build_seconds:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log(f"[3/14] kernels against their plain versions (bf16 and int8 pages, |err| <= "
        f"{RTOL}·|ref| + row_tol·rms(row), row_tol {FLASH_ROW_TOL} flash / {PAGED_ROW_TOL} "
        f"page walks and decode / {WINDOW_ROW_TOL} prefill and verify; times: median "
        f"CUDA-event ms on {card})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log(f"  the row-invariant GEMM and RMSNorm (|err| <= {RTOL}·|ref| + "
        f"{GEMM_ROW_TOL}·rms(row) against x @ w and the plain norm; rows of N or D)")
    norms = check_norm(gen)
    log(f"  RMSNorm fused into its neighbours (bit for bit the unfused chain; |err| <= "
        f"{RTOL}·|ref| + {NORM_ROW_TOL}·rms(row) add + norm, {QK_ROW_TOL} q / k, against "
        "the plain versions)")
    fused_norms = {"add_rms_norm": check_add_norm(gen),
                   **{f"qk_norm_rope_kv_{'int8' if int8 else 'bf16'}":
                      check_qk_norm_rope_kv(gen, int8) for int8 in (False, True)}}
    gemms = check_gemm(gen)
    cases = primitive_cases(gen)
    launches_b = drive_primitives(cases)
    log(f"  primitives through their entry points: launches {launches_b}")
    flash = [check_flash(gen, 1, 2048), check_flash(gen, 4, 512)]
    walks = {(split, int8): check_paged(gen, split, int8)
             for int8 in (False, True) for split in (False, True)}
    prims = {case["name"]: check_primitive(case) for case in cases}
    walks_2048 = {("int8" if int8 else "bf16"): check_walk_2048(gen, int8)
                  for int8 in (False, True)}
    split_serve = {("int8" if int8 else "bf16"): check_split_serve(gen, int8)
                   for int8 in (False, True)}
    log(f"  {check_clusters(gen)} cluster cases (the single walk and paged decode at CL 1, "
        "2, 4 and 8; short rows with ranks that hold no keys, an inactive slot, ps 16 and "
        "128, bf16 and int8 pages under a mid-page window) within the bound")
    log(f"  {check_split_clusters(gen)} split-cluster cases (mp 5 and 13: ranks past the "
        "table; windows from mid-chunk; ps 16 and 128, G 1/2/4/8, Hd 64 and 128, bf16 and "
        "int8, inert rows and padding tokens) within the bound")
    log(f"  {check_split_bits(gen)} rows of the split walk bit-identical alone (T1), in T8 "
        "and in T72, bf16 and int8 pages")
    log(f"  {check_variants(gen)} further cases (windows, ragged S, Hd 64, G 1/2/8, "
        "ps 16, inactive and padding rows, int8) within the bound")
    log(f"  {check_window_split(gen)} key-split cases (verify over 1, 2 and 3 chunks of "
        "1024 keys in one batch, a windowed C96 suffix prefill over chunks 1-2; ps 128 / "
        "Hd 128 and ps 16 / Hd 64, bf16 and int8) within the bound, against the plain "
        "version and the folded plain partials")
    # the single walk's cluster size that a qwen3-8b engine of 8 rows fixes
    # (32-page tables at 4096, 16 at 2048)
    fixed_cl = engine_cluster_size(8, KV_HEADS, 32, "cuda")
    if fixed_cl != engine_cluster_size(8, KV_HEADS, 16, "cuda"):
        raise AssertionError("the 2048 and 4096 engines fix different cluster sizes")
    fused_shape = {(split, int8): check_fused_shape(gen, split, int8, fixed_cl)
                   for int8 in (False, True) for split in (False, True)}
    window_c512 = {pages: prims["paged_prefill_attention" + sfx]["ms"]
                   for pages, sfx in (("bf16", ""), ("int8", "_int8"))}
    for (split, int8), res in fused_shape.items():
        pages = "int8" if int8 else "bf16"
        rule = ("" if split else f" (the shape rule's CL 1: {res['ms_shape_rule']:.4f} ms)")
        log(f"  fused shape, {'split walk' if split else 'single walk'} {pages}: "
            f"{res['ms']:.4f} ms{rule} against the query-window kernel's "
            f"{window_c512[pages]:.4f} ms for the C512 chunk alone and a bound of "
            f"{res['bound_ms']:.4f} ms")
    bits = check_fused_bits(gen, fixed_cl)
    log(f"  {bits['rows']} decode rows bit-identical alone (T1), in T8 and inside the fused "
        f"T520 launch (both walks, bf16 and int8, single walk at the engine's CL {fixed_cl}); "
        f"rows whose bits the shape rule alone would move: "
        f"{bits['rows_moved_by_shape_rule']}")
    # the speculative step's shape: the engine's cluster size (fixed from its
    # 8 slots, speculation on or off) first, then the size fixed from the
    # step's 8 x (1 + SPEC_K) tokens
    spec_cl = fixed_cl
    spec_cls = (spec_cl, engine_cluster_size(8 * (1 + SPEC_K), KV_HEADS, 32, "cuda"))
    spec_shape = {(split, int8): check_spec_shape(gen, split, int8, spec_cls)
                  for int8 in (False, True) for split in (False, True)}
    for (split, int8), res in spec_shape.items():
        pages = "int8" if int8 else "bf16"
        by_cl = ("" if split else " (by cluster size: " + ", ".join(
            f"CL {cl} {ms:.4f} ms" for cl, ms in res["ms_by_cluster"].items()) + ")")
        log(f"  spec shape, {'split walk' if split else 'single walk'} {pages}: "
            f"{res['ms']:.4f} ms{by_cl}, bound {res['bound_ms']:.4f} ms, sdpa "
            f"{res['library_ms']} ms")
    spec_bits = check_spec_bits(gen, spec_cl)
    log(f"  {spec_bits} decode rows bit-identical whether their neighbours carry 0 or "
        f"{SPEC_K} drafts (both walks, bf16 and int8, single walk at CL {spec_cl})")
    del cases
    torch.cuda.empty_cache()
    log("  the shapes of qwen3-1.7b (D 2048, H16 on KV8: G 2, the tied 151936-column head, "
        "32 decode rows) and mistral-7b (no QK-norm, its MLP and head, the 4096 window over "
        "trimmed tables)")
    new_shapes = check_new_shapes(gen)
    torch.cuda.empty_cache()

    log("[4/14] serve qwen3-8b at full width, max-model-len 4096")
    cfg = get_preset("qwen3-8b")
    t0 = time.perf_counter()
    # phases 4-6 serve as the earlier slices did: no prefix cache, no token
    # budget (--no-prefix-caching --no-token-budget); phase 7 the defaults
    legacy = {"enable_prefix_caching": False}
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 4096, 8, "cuda",
                                                 prefix_caching=False),
                          max_batch_size=8, seed=SEED, device="cuda", **legacy)
    torch.cuda.synchronize()
    log(f"  weights + pool ready in {time.perf_counter() - t0:.1f} s "
        f"(kv_splits {engine.kv_splits}, {engine.cache_cfg.n_pages} pages)")
    prompts = [("The quick brown fox jumps over the lazy dog. " * 40)[:n]
               for n in N_REQUESTS_PROMPTS]
    serve4 = serve_leg(engine, prompts, ("flash_attention", "ragged_paged_attention_kvsplit",
                                         *PROJECTION_KERNELS))
    prof4 = profile_decode(engine)
    log_profile(prof4, card)
    check_one_walk_per_layer(prof4, cfg.n_layers)
    params = engine.params
    del engine
    torch.cuda.empty_cache()

    log("[5/14] single page walk: same weights, max-model-len 2048")
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 2048, 8, "cuda",
                                                 prefix_caching=False),
                          max_batch_size=8, params=params, device="cuda", **legacy)
    if engine.kv_splits != 0:
        raise AssertionError(f"expected the single walk at 2048, got kv_splits {engine.kv_splits}")
    prompts5 = prompts[:2] + [prompts[2][:600], prompts[3][:1000]]
    serve5 = serve_leg(engine, prompts5, ("flash_attention", "ragged_paged_attention",
                                          *PROJECTION_KERNELS))
    prof5 = profile_decode(engine)
    log_profile(prof5, card)
    check_one_walk_per_layer(prof5, cfg.n_layers)
    del engine
    torch.cuda.empty_cache()

    log("[6/14] int8 KV pages (--kv-cache-dtype int8): same weights, max-model-len 4096, "
        "then 2048")
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 4096, 8, "cuda", "int8",
                                                 prefix_caching=False),
                          max_batch_size=8, params=params, device="cuda", **legacy)
    if engine.kv_splits == 0 or engine.cache["k"].dtype != torch.int8:
        raise AssertionError("expected int8 pages and the split walk at 4096")
    serve6 = serve_leg(engine, prompts, ("flash_attention",
                                         "ragged_paged_attention_kvsplit_int8",
                                         *PROJECTION_KERNELS))
    prof6 = profile_decode(engine)
    log_profile(prof6, card)
    check_one_walk_per_layer(prof6, cfg.n_layers)
    del engine
    torch.cuda.empty_cache()
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 2048, 8, "cuda", "int8",
                                                 prefix_caching=False),
                          max_batch_size=8, params=params, device="cuda", **legacy)
    serve6s = serve_leg(engine, prompts5, ("flash_attention", "ragged_paged_attention_int8",
                                           *PROJECTION_KERNELS))
    del engine
    torch.cuda.empty_cache()

    log(f"[7/14] prefix caching, chunked prefill and fused steps (the serve defaults, "
        f"--tokens-per-step {TOKENS_PER_STEP}): same weights, bf16 pages at 4096 (split "
        "walk) and 2048 (single walk), int8 pages at 2048")
    serve7 = {}
    for max_len, kv_dtype, long_len in ((4096, "model", 3000), (2048, "model", 1800),
                                        (2048, "int8", 1800)):
        tag = f"{'int8' if kv_dtype == 'int8' else 'bf16'}_{max_len}"
        engine = NativeEngine(cfg, auto_cache_config(cfg, 128, max_len, 8, "cuda", kv_dtype),
                              max_batch_size=8, params=params, device="cuda",
                              token_budget=TOKENS_PER_STEP)
        log(f"  {tag}: {engine.cache_cfg.n_pages} pages, kv_splits {engine.kv_splits}, "
            f"single-walk cluster {engine.walk_cluster}")
        if not engine.prefix_caching or engine.walk_cluster not in (None, fixed_cl):
            raise AssertionError(f"{tag}: prefix caching off or cluster {engine.walk_cluster}")
        serve7[tag] = serve_prefix_leg(engine, long_len, card)
        del engine
        torch.cuda.empty_cache()

    log(f"[8/14] speculative decoding (--speculative-ngram {SPEC_K}), extractive prompts, "
        f"greedy then seeded sampled, against the same engine without speculation: same "
        f"weights, bf16 pages at 4096 (split walk) and 2048 (single walk), int8 pages at "
        f"2048")
    serve8 = {}
    for max_len, kv_dtype in ((4096, "model"), (2048, "model"), (2048, "int8")):
        tag = f"{'int8' if kv_dtype == 'int8' else 'bf16'}_{max_len}"

        def make_engine(k, max_len=max_len, kv_dtype=kv_dtype, tag=tag):
            engine = NativeEngine(cfg, auto_cache_config(cfg, 128, max_len, 8, "cuda",
                                                         kv_dtype),
                                  max_batch_size=8, params=params, device="cuda",
                                  token_budget=TOKENS_PER_STEP, speculative_k=k)
            if engine.walk_cluster not in (None, spec_cl) or engine.spec_k != k:
                raise AssertionError(f"{tag}: cluster {engine.walk_cluster}, spec {k}")
            return engine

        serve8[tag] = serve_spec_leg(make_engine, tag, card, extras=tag == "bf16_4096")

    log(f"[9/14] decode bursts (--decode-burst {BURST}, pipelined, CUDA graphs): a greedy "
        f"and a seeded request alone, in a full batch and beside a {A1_LONG}-token chunked "
        f"prompt on burst, per-token and fused-step engines (no prefix cache, "
        f"--tokens-per-step {TOKENS_PER_STEP}); graph against eager; steady-state "
        f"profiles; then the CLI defaults through the server: same weights, bf16 pages at "
        f"4096 (split walk) and 2048 (single walk), int8 pages at 2048")
    serve9 = {}
    for max_len, kv_dtype in ((4096, "model"), (2048, "model"), (2048, "int8")):
        tag = f"{'int8' if kv_dtype == 'int8' else 'bf16'}_{max_len}"

        def make_burst_engine(kind, max_len=max_len, kv_dtype=kv_dtype, tag=tag):
            engine = NativeEngine(cfg, auto_cache_config(cfg, 128, max_len, 8, "cuda",
                                                         kv_dtype, prefix_caching=False),
                                  max_batch_size=8, params=params, device="cuda",
                                  enable_prefix_caching=False, token_budget=TOKENS_PER_STEP,
                                  fused_step=kind == "fused",
                                  decode_burst_steps=BURST if kind == "burst" else 1)
            if engine.walk_cluster not in (None, fixed_cl):
                raise AssertionError(f"{tag}: cluster {engine.walk_cluster}")
            return engine

        serve9[tag] = serve_burst_leg(make_burst_engine, tag, card,
                                      extras=tag == "bf16_4096")
    serve9["cli_defaults"] = serve_burst_defaults(params, card)

    log(f"[10/14] guided decoding (response_format json_object and json_schema, greedy and "
        f"seeded) beside bursting unguided streams, through the server: same weights, bf16 "
        f"pages at 2048, --decode-burst {BURST}")
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 2048, 8, "cuda",
                                                 prefix_caching=False),
                          max_batch_size=8, params=params, device="cuda",
                          enable_prefix_caching=False, token_budget=TOKENS_PER_STEP,
                          decode_burst_steps=BURST)
    serve10 = serve_guided_leg(engine, card)
    del engine, params
    release_device()
    log(f"  device memory held before phase 11: {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    log(f"[11/14] qwen3-1.7b at full width (28 layers, tied head, G 2), --max-batch-size "
        f"{G2_BATCH}: {G2_BATCH} greedy streams in bursts, per token and alone; bf16 pages at "
        "4096 (split walk), int8 pages at 2048 (single walk)")
    from fusioninfer_tpu_torch.models.transformer import init_params

    cfg17 = get_preset("qwen3-1.7b")
    params17 = init_params(cfg17, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    serve11 = {f"{'int8' if kv == 'int8' else 'bf16'}_{ml}": serve_g2_leg(params17, kv, ml, card)
               for kv, ml in (("model", 4096), ("int8", 2048))}
    del params17
    release_device()

    log(f"[12/14] mistral-7b at full width (32 layers, window {WINDOW}), --max-model-len "
        f"{WINDOW_MAX_LEN} --tokens-per-step {TOKENS_PER_STEP}: four prompts of 4500-6000 "
        f"tokens and {WINDOW_TOKENS} greedy tokens each on burst, per-token and speculative "
        "engines; bf16 and int8 pages")
    cfg7 = get_preset("mistral-7b")
    params7 = init_params(cfg7, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    serve12 = {("int8" if kv == "int8" else "bf16"): serve_window_leg(params7, kv, card, prof4)
               for kv in ("model", "int8")}

    log(f"[13/14] the loader: save_hf_checkpoint of mistral-7b's widths at {LOADER_LAYERS} "
        "layers, engine serve --load-hf")
    serve13 = serve_loader_leg(params7, card)
    del params7
    release_device()

    pa_py = "paged_attention.py"
    legs = [serve4, serve5, serve6, serve6s, *serve7.values(),
            *(leg[side][part] for leg in serve8.values() for side in ("on", "off")
              for part in ("greedy", "sampled") if part in leg[side]),
            *({"launches": leg["launches"][kind],
               "launches_by_shape": leg["launches_by_shape"][kind]}
              for leg in serve9.values() if "streams" in leg for kind in leg["launches"]),
            serve9["cli_defaults"], serve10,
            *(leg[kind] for leg in serve11.values() for kind in ("burst", "step", "alone")),
            *(leg[kind] for leg in serve12.values() for kind in ("burst", "step", "spec")),
            serve13]

    def phase_served(name, phase_legs):  # launches over some legs
        return sum(leg["launches"][name] for leg in phase_legs)

    def served(name):  # launches over every serve leg
        return sum(leg["launches"][name] for leg in legs)

    def served_by_shape(name):  # {shape: launches} over every serve leg
        total: dict[str, int] = {}
        for leg in legs:
            for shape, n in dispatch.by_shape(leg["launches_by_shape"], name).items():
                total[shape] = total.get(shape, 0) + n
        return total

    for name in PROJECTION_KERNELS:
        if served(name) == 0:
            raise AssertionError(f"the serve legs launched no {name} kernel")
    shapes = {name: served_by_shape(name) for name in dispatch.KERNELS}
    for name in PROJECTION_KERNELS:
        if sum(shapes[name].values()) != served(name):
            raise AssertionError(f"{name}: launches by shape {shapes[name]} do not add up to "
                                 f"{served(name)}")
    gemm_names = {f"{K}x{N}": name for name, (K, N) in {**GEMM_SHAPES,
                                                         **GEMM_SHAPES_NEW}.items()}
    log("  launches over phases 4-13 by shape: gemm " + ", ".join(
        f"{gemm_names.get(k, k)} {n}" for k, n in sorted(shapes["gemm"].items()))
        + "; rms_norm " + ", ".join(f"D{k} {n}" for k, n in sorted(shapes["rms_norm"].items()))
        + "; add_rms_norm " + ", ".join(f"D{k} {n}"
                                        for k, n in sorted(shapes["add_rms_norm"].items()))
        + "; qk_norm_rope_kv " + ", ".join(f"{k} {n}" for k, n in
                                           sorted(shapes["qk_norm_rope_kv"].items())))
    # the page walks by tokens a launch: decode rows (T <= 8), windows and
    # short steps (9-64), fused steps and long suffixes (> 64)
    walk_classes = {}
    for name in dispatch.KERNELS:
        if name.startswith("ragged_paged_attention"):
            by_t = {int(k[1:]): n for k, n in shapes[name].items()}
            walk_classes[name] = {
                "T<=8": sum(n for t, n in by_t.items() if t <= 8),
                "T9-64": sum(n for t, n in by_t.items() if 8 < t <= 64),
                "T>64": sum(n for t, n in by_t.items() if t > 64),
                "T40": by_t.get(40, 0), "T513-520": sum(n for t, n in by_t.items()
                                                        if 512 < t <= 520)}
    log(f"  page-walk launches by tokens a launch: {walk_classes}")
    log(f"  flash launches by shape: {shapes['flash_attention']}")

    kernels = [
        kernel_row("flash_attention", "flash_attention.cu", "flash_attention.py:150",
                   served("flash_attention"), flash[0]),
        kernel_row("ragged_paged_attention", "paged_attention.cu", f"{pa_py}:1250",
                   served("ragged_paged_attention"), walks[(False, False)]),
        kernel_row("ragged_paged_attention_kvsplit", "paged_attention.cu", f"{pa_py}:1505",
                   served("ragged_paged_attention_kvsplit"), walks[(True, False)]),
        kernel_row("ragged_paged_attention_int8", "paged_attention.cu", f"{pa_py}:1250",
                   served("ragged_paged_attention_int8"), walks[(False, True)]),
        kernel_row("ragged_paged_attention_kvsplit_int8", "paged_attention.cu",
                   f"{pa_py}:1505", served("ragged_paged_attention_kvsplit_int8"),
                   walks[(True, True)]),
    ]
    for name, source, line in [("paged_decode_attention", "paged_attention.cu", 474),
                               ("paged_prefill_attention", "paged_window_attention.cu", 647),
                               ("paged_verify_attention", "paged_window_attention.cu", 823)]:
        for sfx in ("", "_int8"):
            kernels.append(kernel_row(name + sfx, source, f"{pa_py}:{line}",
                                      launches_b[name + sfx], prims[name + sfx]))
    tf_py = "fusioninfer_tpu/models/transformer.py"
    for name, source, at, res in (
            ("gemm", "gemm.cu", f"{tf_py}:{JAX_DOT_LINE}", gemms["gate/up"]["rows"][8]),
            ("rms_norm", "rms_norm.cu", f"{tf_py}:{JAX_NORM_LINE}",
             norms["d_model"]["rows"][8]),
            ("add_rms_norm", "rms_norm.cu", f"{tf_py}:{JAX_ADD_LINE}",
             fused_norms["add_rms_norm"]["rows"][8]),
            ("qk_norm_rope_kv", "rms_norm.cu", f"{tf_py}:{JAX_ROPE_LINE}",
             fused_norms["qk_norm_rope_kv_bf16"]["rows"][8])):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"fusioninfer_tpu_torch/csrc/{source}", "replaces": at,
                        "launches": served(name),
                        **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}})
    legs11 = {tag: [leg[kind] for kind in ("burst", "step", "alone")]
              for tag, leg in serve11.items()}
    legs12 = {tag: [leg[kind] for kind in ("burst", "step", "spec")]
              for tag, leg in serve12.items()}
    gemm_py = f"{tf_py}:{JAX_DOT_LINE}"
    for name, source, at, launched, res in (
            ("flash_attention (G2)", "flash_attention.cu", f"fusioninfer_tpu/ops/"
             "flash_attention.py:150", phase_served("flash_attention", sum(legs11.values(), [])),
             new_shapes["flash"]["g2"]),
            ("flash_attention (window 4096)", "flash_attention.cu", "fusioninfer_tpu/ops/"
             "flash_attention.py:150", phase_served("flash_attention", [serve13]),
             new_shapes["flash"]["window"]),
            ("ragged_paged_attention_kvsplit (G2)", "paged_attention.cu",
             f"fusioninfer_tpu/ops/{pa_py}:1505",
             phase_served("ragged_paged_attention_kvsplit", legs11["bf16_4096"]),
             new_shapes["walks_g2"]["split_bf16"]),
            ("ragged_paged_attention_int8 (G2)", "paged_attention.cu",
             f"fusioninfer_tpu/ops/{pa_py}:1250",
             phase_served("ragged_paged_attention_int8", legs11["int8_2048"]),
             new_shapes["walks_g2"]["single_int8"]),
            ("ragged_paged_attention_kvsplit (window 4096)", "paged_attention.cu",
             f"fusioninfer_tpu/ops/{pa_py}:1505",
             phase_served("ragged_paged_attention_kvsplit", legs12["bf16"]),
             new_shapes["walks_window"]["split_bf16_decode"]),
            ("ragged_paged_attention_kvsplit_int8 (window 4096)", "paged_attention.cu",
             f"fusioninfer_tpu/ops/{pa_py}:1505",
             phase_served("ragged_paged_attention_kvsplit_int8", legs12["int8"]),
             new_shapes["walks_window"]["split_int8_decode"]),
            ("gemm (tied head 2048x151936)", "gemm.cu", gemm_py,
             sum(leg["launches_by_shape"].get("gemm[2048x151936]", 0)
                 for leg in sum(legs11.values(), [])),
             new_shapes["gemm"]["1.7b tied head"]["rows"][32]),
            ("gemm (mistral-7b gate/up 4096x14336)", "gemm.cu", gemm_py,
             sum(leg["launches_by_shape"].get("gemm[4096x14336]", 0)
                 for leg in sum(legs12.values(), [])),
             new_shapes["gemm"]["7b gate/up"]["rows"][8])):
        if launched == 0:
            raise AssertionError(f"{name}: no launch on phases 11-13")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"fusioninfer_tpu_torch/csrc/{source}", "replaces": at,
                        "launches": launched,
                        **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}})
    for pages, res in split_serve.items():
        leg = serve4 if pages == "bf16" else serve6
        name = "ragged_paged_attention_kvsplit" + ("_int8" if pages == "int8" else "")
        log(f"  split walk at the 4096 leg's decode shape, {pages}: kernel {res['ms']:.4f} ms, "
            f"sdpa {res['library_ms']} ms, bound {res['bound_ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms; {leg['launches'][name]} launches in the 4096 leg")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "device": kind, "torch": torch.__version__,
                   "build_s": _build.build_seconds, "flash": flash,
                   "walks": {f"{'split' if sp else 'single'}{'_int8' if q8 else ''}": r
                             for (sp, q8), r in walks.items()},
                   "primitives": prims, "primitive_launches": launches_b,
                   "walks_2048": walks_2048, "split_serve_shape": split_serve,
                   "serve_4096": {**serve4, "decode_profile": prof4},
                   "serve_2048": {**serve5, "decode_profile": prof5},
                   "serve_int8_4096": {**serve6, "decode_profile": prof6},
                   "serve_int8_2048": serve6s,
                   "fused_shape": {f"{'split' if sp else 'single'}{'_int8' if q8 else ''}": r
                                   for (sp, q8), r in fused_shape.items()},
                   "fused_bits": bits, "fixed_cluster": fixed_cl,
                   "prefix_legs": serve7,
                   "spec_shape": {f"{'split' if sp else 'single'}{'_int8' if q8 else ''}": r
                                  for (sp, q8), r in spec_shape.items()},
                   "spec_bits_rows": spec_bits, "spec_cluster": spec_cl,
                   "spec_legs": serve8, "burst_legs": serve9, "guided_leg": serve10,
                   "gemm": gemms, "rms_norm": norms, "fused_norms": fused_norms,
                   "new_shapes": new_shapes, "qwen3_1_7b": serve11, "mistral_7b": serve12,
                   "loader": serve13,
                   "launches_by_shape": shapes,
                   "walk_launches_by_tokens": walk_classes,
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"[14/14] done in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
