#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: every CUDA kernel of ``fusioninfer_tpu_torch/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, in parallel);
3. kernels against their plain PyTorch versions, on bf16 pages and on
   int8 pages with scales, at the serve path's shapes: the row error
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
   off its 128-row q tile;
4. serve ``qwen3-8b`` at full width (36 layers, random bf16 weights from
   a seed) through the port's HTTP server at ``--max-model-len 4096``:
   four requests, two of them SSE; every request must return its full
   length, the served tokens must be the greedy choice of a plain
   full-sequence forward that runs none of the kernels, and the
   flash-prefill and split-KV decode kernels must have launched; then
   the decode-step profile, which must show one page-walk kernel,
   launched once per layer;
5. the same weights at ``--max-model-len 2048``: decode takes the single
   page walk, whose kernel must have launched; then the decode-step
   profile;
6. the same weights with int8 KV pages (``--kv-cache-dtype int8``), at
   ``--max-model-len 4096`` (the int8 split walk must launch; the plain
   forward reads K/V through ``kv_quantize`` for the decoded rows, as
   the engine's pages hold them; then its decode-step profile, as in
   phase 4) and at 2048 (the int8 single walk).

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


def check_flash(gen, B: int, S: int) -> dict:
    import torch

    from fusioninfer_tpu_torch.ops import flash_attention as fa

    H, KV, Hd = 32, 8, 128
    dev = "cuda"
    q = torch.randn((B, S, H, Hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, Hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, Hd), generator=gen, device=dev).to(torch.bfloat16)
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.reference_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, row_err = check_close(out, ref, f"flash B{B} S{S}", FLASH_ROW_TOL, Hd)
    ms = time_graph(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = time_events(lambda: fa.reference_attention(q, k, v, causal=True))
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_library([(qT, kT, vT, {"is_causal": True})], H // KV)
    pairs = B * H * S * (S + 1) / 2  # causal (query, key) pairs
    flops = 4 * pairs * Hd
    nbytes = 2 * (2 * B * S * H * Hd + 2 * B * S * KV * Hd)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  flash B{B} S{S}: abs err {err:.3e} row err {row_err:.3e} (bound {FLASH_ROW_TOL}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {library_ms} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": f"B{B} S{S} H{H} KV{KV} Hd{Hd}", "max_abs_err": err,
            "max_row_err": row_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


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


def attention_cost(rows, int8: bool) -> tuple[float, float]:
    """(FLOP, bytes) of causal paged attention for rows ``[(start, n)]``:
    each live K/V byte read once (int8 pages: Hd codes + one f32 scale
    per token and head), each query read and each output written once."""
    H = KV_HEADS * GROUP
    keys = sum(s + n for s, n in rows)  # live keys per KV head
    pairs = sum(n * s + n * (n + 1) / 2 for s, n in rows)  # (query, key) pairs
    T = sum(n for _, n in rows)
    per_key = HEAD_DIM + 4 if int8 else 2 * HEAD_DIM
    return 4 * pairs * H * HEAD_DIM, 2 * keys * KV_HEADS * per_key + 2 * T * H * HEAD_DIM * 2


def sdpa_calls(q_flat, kp, vp, tables, rows):
    """The library yardstick's calls: one SDPA per row over that row's
    live keys, gathered from the bf16 pages of one layer beforehand (the
    gather is not timed); q_flat ``[T, H, Hd]`` holds the rows' tokens in
    order."""
    import torch

    calls, t0 = [], 0
    for r, (start, n) in enumerate(rows):
        n_keys = start + n
        pages = tables[r, : -(-n_keys // PAGE)].long()
        k_r = kp[:, pages].reshape(KV_HEADS, -1, HEAD_DIM)[None, :, :n_keys]
        v_r = vp[:, pages].reshape(KV_HEADS, -1, HEAD_DIM)[None, :, :n_keys]
        q_r = q_flat[t0: t0 + n].transpose(0, 1)[None]
        kw = {}
        if n > 1:  # token i of the row sees keys [0, start + i]
            kw["attn_mask"] = (torch.arange(n_keys, device=q_flat.device)[None, :]
                               <= start + torch.arange(n, device=q_flat.device)[:, None])
        calls.append((q_r, k_r.contiguous(), v_r.contiguous(), kw))
        t0 += n
    return calls


def measure(name: str, shape: str, kern, plain, row_tol: float, rows, int8: bool,
            library) -> dict:
    """Kernel against plain version (``check_close``), then kernel ms (CUDA
    graph), plain ms, library ms (``library()`` gives the SDPA calls, or
    None where no PyTorch call computes the same function) and bound."""
    err, row_err = check_close(kern(), plain(), f"{name} [{shape}]", row_tol, HEAD_DIM)
    ms = time_graph(kern)
    plain_ms = time_events(plain, reps=20, warmup=2)
    calls = library()
    library_ms = time_library(calls, GROUP) if calls is not None else None
    bound_ms, bound_by = bound(*attention_cost(rows, int8))
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
                "token_ids": ids}


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


def plain_forward(cfg, params, tokens, int8_from: int | None = None):
    """Full-sequence causal forward → f32 logits, with the plain attention
    (``reference_attention``) in place of the flash kernel and no pages:
    no hand-written kernel runs in it.  With ``int8_from``, query rows from
    that position on attend over K/V passed through ``kv_quantize`` and
    back, as an engine with int8 pages decodes them (its prefill rows
    attend over the exact K/V)."""
    import torch

    from fusioninfer_tpu_torch.models import transformer as tf
    from fusioninfer_tpu_torch.models.quantization import kv_quantize
    from fusioninfer_tpu_torch.ops.flash_attention import reference_attention

    def dequant(x):
        x8, scale = kv_quantize(x)
        return x8.float() * scale[..., None]

    x = tf.embed_lookup(params["embed"], tokens)
    rope = tf.rope_tables(torch.arange(tokens.shape[1], device=tokens.device),
                          cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.n_layers):
        layer = tf.layer_params(params, l)
        q, k, v = tf.qkv_proj(cfg, layer, x, rope)
        attn = reference_attention(q, k, v, causal=True, window=cfg.sliding_window)
        if int8_from is not None:
            attn8 = reference_attention(q, dequant(k), dequant(v), causal=True,
                                        window=cfg.sliding_window)
            attn = torch.cat([attn[:, :int8_from], attn8[:, int8_from:]], dim=1)
        x = x + attn @ layer["wo"]
        x = x + tf.mlp_block(cfg, layer, x)
    return tf.lm_head(cfg, params, tf.rms_norm(x, params["final_norm"], cfg.rms_eps))


def check_greedy(engine, results) -> float:
    """The served tokens of each SSE request (flash prefill, paged decode)
    must be the greedy choice of :func:`plain_forward` over the prompt and
    the served tokens (with int8 K/V for the decoded rows when the
    engine's pages are int8): the served token's logit within ``tol`` of
    the row's max (bf16 kernels and the f32-math plain attention round
    differently, and random weights leave near-ties).  Returns the largest
    gap seen."""
    import torch

    from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer

    tol = 0.25
    worst = 0.0
    tok = ByteTokenizer()
    for r in results:
        if r["token_ids"] is None:
            continue
        prompt = tok.encode(r["prompt"])
        seq = prompt + r["token_ids"]
        x = torch.tensor([seq[:-1]], device=engine.device)
        with torch.no_grad():
            logits = plain_forward(engine.cfg, engine.params, x,
                                   len(prompt) if engine.cache_cfg.quantized else None)
            logits = logits[0, len(prompt) - 1:]
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits in the reference forward")
        chosen = torch.tensor(r["token_ids"], device=logits.device)
        gap = (logits.max(dim=-1).values
               - logits.gather(1, chosen[:, None])[:, 0]).max().item()
        worst = max(worst, gap)
        if gap > tol:
            raise AssertionError(f"served token {gap:.3f} below the greedy max (tol {tol})")
    return worst


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


def profile_decode(engine, n_steps: int = 8) -> dict:
    """Eight requests (prompts of 100…1500 byte-tokens) decoding together
    on ``engine``: wall ms per engine step without the profiler, then the
    same steps under ``torch.profiler`` for device time per step and the
    kernels that take it.  Device busy share = device ms / wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fusioninfer_tpu_torch.engine.engine import Request
    from fusioninfer_tpu_torch.engine.sampler import SamplingParams

    lens = [100, 300, 500, 700, 900, 1100, 1300, 1500]
    for i, n in enumerate(lens):
        engine.add_request(Request(f"prof{i}", [3 + (7 * j + i) % 250 for j in range(n)],
                                   SamplingParams(temperature=0.0,
                                                  max_tokens=3 * n_steps + 4)))
    engine.step()  # admission, prefill of all eight, first decode step
    engine.step()
    torch.cuda.synchronize()
    if engine.num_running != len(lens):
        raise AssertionError(f"profile batch: {engine.num_running} rows running")
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
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
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "walk_ms_per_step": sum(dev_us(e) for e in walks) / 1e3 / n_steps,
            "walk_kernels_per_step": {e.key[:80]: e.count / n_steps for e in walks},
            "top_kernels_ms_per_step": {e.key[:80]: dev_us(e) / 1e3 / n_steps
                                        for e in top}}


def check_one_walk_per_layer(prof: dict, n_layers: int) -> None:
    """A decode step of the split walk launches one page-walk kernel per
    layer and nothing else of the walk (no second, combining kernel)."""
    launched = prof["walk_kernels_per_step"]
    if list(launched.values()) != [n_layers]:
        raise AssertionError(f"decode step: page-walk kernels {launched}, expected one "
                             f"kernel launched {n_layers} times per step")


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
            "decode_tok_s": rates,
            "requests": [{k: v for k, v in r.items() if k not in ("prompt", "token_ids")}
                         for r in res]}


def log_profile(prof: dict, card: str) -> None:
    share = prof["device_busy_share"]
    log(f"  decode step, batch 8 (contexts 100..1500): {prof['wall_ms_per_step']:.3f} ms "
        f"wall, {prof['device_ms_per_step']:.3f} ms on the device "
        f"(busy share {share if share is None else round(share, 4)}) on {card}; page walk "
        f"{prof['walk_ms_per_step']:.4f} ms/step, launches per step "
        f"{prof['walk_kernels_per_step']}")
    for name, ms in prof["top_kernels_ms_per_step"].items():
        log(f"    {ms:8.4f} ms/step  {name}")


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
    from fusioninfer_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/7] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    _build.build_all()
    log(f"[2/7] build: {len(_build.SIGNATURES)} sources in {_build.build_seconds:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log(f"[3/7] kernels against their plain versions (bf16 and int8 pages, |err| <= "
        f"{RTOL}·|ref| + row_tol·rms(row), row_tol {FLASH_ROW_TOL} flash / {PAGED_ROW_TOL} "
        f"page walks and decode / {WINDOW_ROW_TOL} prefill and verify; times: median "
        f"CUDA-event ms on {card})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
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
    del cases
    torch.cuda.empty_cache()

    log("[4/7] serve qwen3-8b at full width, max-model-len 4096")
    cfg = get_preset("qwen3-8b")
    t0 = time.perf_counter()
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 4096, 8, "cuda"),
                          max_batch_size=8, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"  weights + pool ready in {time.perf_counter() - t0:.1f} s "
        f"(kv_splits {engine.kv_splits}, {engine.cache_cfg.n_pages} pages)")
    prompts = [("The quick brown fox jumps over the lazy dog. " * 40)[:n]
               for n in N_REQUESTS_PROMPTS]
    serve4 = serve_leg(engine, prompts, ("flash_attention", "ragged_paged_attention_kvsplit"))
    prof4 = profile_decode(engine)
    log_profile(prof4, card)
    check_one_walk_per_layer(prof4, cfg.n_layers)
    params = engine.params
    del engine
    torch.cuda.empty_cache()

    log("[5/7] single page walk: same weights, max-model-len 2048")
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 2048, 8, "cuda"),
                          max_batch_size=8, params=params, device="cuda")
    if engine.kv_splits != 0:
        raise AssertionError(f"expected the single walk at 2048, got kv_splits {engine.kv_splits}")
    prompts5 = prompts[:2] + [prompts[2][:600], prompts[3][:1000]]
    serve5 = serve_leg(engine, prompts5, ("flash_attention", "ragged_paged_attention"))
    prof5 = profile_decode(engine)
    log_profile(prof5, card)
    del engine
    torch.cuda.empty_cache()

    log("[6/7] int8 KV pages (--kv-cache-dtype int8): same weights, max-model-len 4096, "
        "then 2048")
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 4096, 8, "cuda", "int8"),
                          max_batch_size=8, params=params, device="cuda")
    if engine.kv_splits == 0 or engine.cache["k"].dtype != torch.int8:
        raise AssertionError("expected int8 pages and the split walk at 4096")
    serve6 = serve_leg(engine, prompts, ("flash_attention",
                                         "ragged_paged_attention_kvsplit_int8"))
    prof6 = profile_decode(engine)
    log_profile(prof6, card)
    check_one_walk_per_layer(prof6, cfg.n_layers)
    del engine
    torch.cuda.empty_cache()
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 2048, 8, "cuda", "int8"),
                          max_batch_size=8, params=params, device="cuda")
    serve6s = serve_leg(engine, prompts5, ("flash_attention", "ragged_paged_attention_int8"))

    pa_py = "paged_attention.py"
    kernels = [
        kernel_row("flash_attention", "flash_attention.cu", "flash_attention.py:150",
                   serve4["launches"]["flash_attention"], flash[0]),
        kernel_row("ragged_paged_attention", "paged_attention.cu", f"{pa_py}:1250",
                   serve5["launches"]["ragged_paged_attention"], walks[(False, False)]),
        kernel_row("ragged_paged_attention_kvsplit", "paged_attention.cu", f"{pa_py}:1505",
                   serve4["launches"]["ragged_paged_attention_kvsplit"],
                   walks[(True, False)]),
        kernel_row("ragged_paged_attention_int8", "paged_attention.cu", f"{pa_py}:1250",
                   serve6s["launches"]["ragged_paged_attention_int8"], walks[(False, True)]),
        kernel_row("ragged_paged_attention_kvsplit_int8", "paged_attention.cu",
                   f"{pa_py}:1505",
                   serve6["launches"]["ragged_paged_attention_kvsplit_int8"],
                   walks[(True, True)]),
    ]
    for name, source, line in [("paged_decode_attention", "paged_attention.cu", 474),
                               ("paged_prefill_attention", "paged_window_attention.cu", 647),
                               ("paged_verify_attention", "paged_window_attention.cu", 823)]:
        for sfx in ("", "_int8"):
            kernels.append(kernel_row(name + sfx, source, f"{pa_py}:{line}",
                                      launches_b[name + sfx], prims[name + sfx]))
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
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"[7/7] done in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
