#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: every CUDA kernel of ``fusioninfer_tpu_torch/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, in parallel);
3. kernels against their plain PyTorch versions, in bf16 at the serve
   path's shapes: max abs error against a stated bound, kernel / plain /
   library (``scaled_dot_product_attention``) times by CUDA events, and
   the least time the card could take (bytes or operations);
4. serve ``qwen3-8b`` at full width (36 layers, random bf16 weights from
   a seed) through the port's HTTP server at ``--max-model-len 4096``:
   four requests, two of them SSE; every request must return its full
   length, the served tokens must be the greedy choice of a plain
   full-sequence forward that runs none of the kernels, and the
   flash-prefill and split-KV decode kernels must have launched;
5. the same weights at ``--max-model-len 2048``: decode takes the single
   page walk, whose kernel must have launched.

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

SEED = 0
N_REQUESTS_PROMPTS = (64, 300, 800, 1500)  # byte-tokens per prompt
MAX_TOKENS = 32


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


def paged_case(gen, multi_token: bool):
    """8 decode rows with contexts spread over 100…4000 tokens (the decode
    step of the served batch), with ``multi_token`` plus one 64-token row
    (a prefill chunk at position 1000); ps 128, a two-layer pool read at
    layer 1, max_pages_per_seq 32 (max context 4096)."""
    import torch

    KV, G, Hd, ps, mp, L = 8, 4, 128, 128, 32, 2
    ctx = [100, 600, 1100, 1600, 2100, 2600, 3300, 4000]  # tokens incl. the new one
    rows = [(c - 1, 1) for c in ctx] + ([(1000, 64)] if multi_token else [])
    need = [-(-(s + n) // ps) for s, n in rows]
    n_pages = sum(need) + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(SEED))
    tables = torch.full((len(rows), mp), n_pages - 1, dtype=torch.int32)
    it = iter(perm.tolist())
    for r, n in enumerate(need):
        for i in range(n):
            tables[r, i] = next(it)
    q_lens = torch.tensor([n for _, n in rows], dtype=torch.int32)
    q_begins = torch.cumsum(q_lens, 0, dtype=torch.int32) - q_lens
    starts = torch.tensor([s for s, _ in rows], dtype=torch.int32)
    T = int(q_lens.sum())
    dev = "cuda"
    q = torch.randn((T, KV * G, Hd), generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn((L, KV, n_pages, ps, Hd), generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn((L, KV, n_pages, ps, Hd), generator=gen, device=dev).to(torch.bfloat16)
    desc = tuple(t.to(dev) for t in (tables, starts, q_begins, q_lens))
    keys = sum((s + n) for s, n in rows)  # live keys per KV head
    pairs = sum(n * s + n * (n + 1) / 2 for s, n in rows)  # (query token, key) pairs
    flops = 4 * pairs * KV * G * Hd
    nbytes = 2 * (2 * keys * KV * Hd + 2 * T * KV * G * Hd)
    return q, kp, vp, desc, rows, flops, nbytes


def check_paged(gen, split: bool) -> dict:
    """Kernel against plain version on the mixed case (decode rows plus a
    multi-token row), then times at the decode step's shape."""
    import torch

    from fusioninfer_tpu_torch.ops import paged_attention as pa

    layer = 1
    name = "split-KV" if split else "single walk"
    result = {}
    for multi_token in (True, False):
        q, kp, vp, desc, rows, flops, nbytes = paged_case(gen, multi_token)
        if split:
            def kern():
                return pa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, layer=layer)

            def plain():
                return pa.reference_ragged_paged_attention_kvsplit(
                    q, kp[layer], vp[layer], *desc)
        else:
            def kern():
                return pa.ragged_paged_attention(q, kp, vp, *desc, layer=layer)

            def plain():
                return pa.reference_ragged_paged_attention(q, kp[layer], vp[layer], *desc)
        T, H, Hd = q.shape
        err, row_err = check_close(kern(), plain(), f"paged {name} multi_token={multi_token}",
                                   PAGED_ROW_TOL, Hd)
        ms = time_graph(kern)
        plain_ms = time_events(plain, reps=20, warmup=2)
        # library yardstick: one SDPA call per row over that row's live
        # keys, gathered from the pages beforehand (the gather is not timed)
        KV = kp.shape[1]
        tables, starts, _, _ = desc
        ps = kp.shape[3]
        calls, t0 = [], 0
        for r, (start, n) in enumerate(rows):
            n_keys = start + n
            pages = tables[r, : -(-n_keys // ps)].long()
            k_r = kp[layer][:, pages].reshape(KV, -1, Hd)[None, :, :n_keys]
            v_r = vp[layer][:, pages].reshape(KV, -1, Hd)[None, :, :n_keys]
            q_r = q[t0: t0 + n].transpose(0, 1)[None]
            kw = {}
            if n > 1:  # token i of the row sees keys [0, start + i]
                kw["attn_mask"] = (torch.arange(n_keys, device=q.device)[None, :]
                                   <= start + torch.arange(n, device=q.device)[:, None])
            calls.append((q_r, k_r.contiguous(), v_r.contiguous(), kw))
            t0 += n
        library_ms = time_library(calls, H // KV)
        bound_ms, bound_by = bound(flops, nbytes)
        shape = (f"T{T}: 8 decode rows ctx 100..4000"
                 + (" + a 64-token row at 1000" if multi_token else "") + ", ps 128")
        log(f"  paged {name} [{shape}]: abs err {err:.3e} row err {row_err:.3e} "
            f"(bound {PAGED_ROW_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"sdpa {library_ms} ms bound {bound_ms:.4f} ms ({bound_by})")
        result = {"shape": shape, "max_abs_err": max(err, result.get("max_abs_err", 0.0)),
                  "max_row_err": max(row_err, result.get("max_row_err", 0.0)),
                  "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "mixed_case": result or None}
    return result


def check_variants(gen) -> int:
    """Untimed kernel-against-plain checks of what the served shapes do not
    reach: sliding windows, sequence lengths off the 64-row tile, head_dim
    64 and query groups 1, 2 and 8.  Returns the number of cases."""
    import torch

    from fusioninfer_tpu_torch.ops import flash_attention as fa
    from fusioninfer_tpu_torch.ops import paged_attention as pa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    n = 0
    for B, S, H, KV, Hd, window in [(1, 512, 32, 8, 128, 100), (2, 100, 4, 2, 64, None),
                                    (1, 200, 8, 8, 128, None), (1, 130, 16, 2, 64, 40)]:
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
    tables = tables[: len(rows) * mp].reshape(len(rows), mp).to(torch.int32)
    desc = tuple(x.cuda() for x in (tables, starts, q_begins, q_lens))
    T = int(q_lens.sum())
    for G, Hd, window in [(2, 64, None), (2, 64, 24), (1, 128, None), (8, 128, 50)]:
        KV = 2
        q = rnd(T, KV * G, Hd)
        kp, vp = rnd(2, KV, n_pages, ps, Hd), rnd(2, KV, n_pages, ps, Hd)
        check_close(pa.ragged_paged_attention(q, kp, vp, *desc, window=window, layer=0),
                    pa.reference_ragged_paged_attention(q, kp[0], vp[0], *desc, window=window),
                    f"single walk G{G} Hd{Hd} window {window}", PAGED_ROW_TOL, Hd)
        check_close(pa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, window=window, layer=1),
                    pa.reference_ragged_paged_attention_kvsplit(q, kp[1], vp[1], *desc,
                                                                window=window),
                    f"split walk G{G} Hd{Hd} window {window}", PAGED_ROW_TOL, Hd)
        n += 2
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


def plain_forward(cfg, params, tokens):
    """Full-sequence causal forward → f32 logits, with the plain attention
    (``reference_attention``) in place of the flash kernel and no pages:
    no hand-written kernel runs in it."""
    import torch

    from fusioninfer_tpu_torch.models import transformer as tf
    from fusioninfer_tpu_torch.ops.flash_attention import reference_attention

    x = tf.embed_lookup(params["embed"], tokens)
    rope = tf.rope_tables(torch.arange(tokens.shape[1], device=tokens.device),
                          cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.n_layers):
        layer = tf.layer_params(params, l)
        q, k, v = tf.qkv_proj(cfg, layer, x, rope)
        x = x + reference_attention(q, k, v, causal=True,
                                    window=cfg.sliding_window) @ layer["wo"]
        x = x + tf.mlp_block(cfg, layer, x)
    return tf.lm_head(cfg, params, tf.rms_norm(x, params["final_norm"], cfg.rms_eps))


def check_greedy(engine, results) -> float:
    """The served tokens of each SSE request (flash prefill, paged decode)
    must be the greedy choice of :func:`plain_forward` over the prompt and
    the served tokens: the served token's logit within ``tol`` of the
    row's max (bf16 kernels and the f32-math plain attention round
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
            logits = plain_forward(engine.cfg, engine.params, x)[0, len(prompt) - 1:]
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
    return {"batch": len(lens), "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "top_kernels_ms_per_step": {e.key[:80]: dev_us(e) / 1e3 / n_steps
                                        for e in top}}


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

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/6] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    _build.build_all()
    log(f"[2/6] build: {len(_build.SIGNATURES)} sources in {_build.build_seconds:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log(f"[3/6] kernels against their plain versions (bf16, |err| <= {RTOL}·|ref| + "
        f"row_tol·rms(row), row_tol {FLASH_ROW_TOL} flash / {PAGED_ROW_TOL} paged; "
        f"times: median CUDA-event ms on {card})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = [check_flash(gen, 1, 2048), check_flash(gen, 4, 512)]
    single = check_paged(gen, split=False)
    split = check_paged(gen, split=True)
    log(f"  {check_variants(gen)} further cases (windows, ragged S, Hd 64, G 1/2/8) "
        "within the bound")

    log("[4/6] serve qwen3-8b at full width, max-model-len 4096")
    cfg = get_preset("qwen3-8b")
    t0 = time.perf_counter()
    cache_cfg = auto_cache_config(cfg, 128, 4096, 8, "cuda")
    engine = NativeEngine(cfg, cache_cfg, max_batch_size=8, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"  weights + pool ready in {time.perf_counter() - t0:.1f} s "
        f"(kv_splits {engine.kv_splits}, {cache_cfg.n_pages} pages)")
    prompts = [("The quick brown fox jumps over the lazy dog. " * 40)[:n]
               for n in N_REQUESTS_PROMPTS]
    t0 = time.perf_counter()
    warm_up(engine, prompts)
    log(f"  warm-up (first use of every GEMM shape and kernel): "
        f"{time.perf_counter() - t0:.3f} s")
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res4 = drive_server(engine, prompts)
    wall4 = time.perf_counter() - t0
    launches4 = dispatch.launches()
    log(f"  launches {launches4}")
    if launches4["flash_attention"] == 0 or launches4["ragged_paged_attention_kvsplit"] == 0:
        raise AssertionError(f"serve path did not launch flash + split-KV: {launches4}")
    gap = check_greedy(engine, res4)
    ttft = [r["ttft_s"] for r in res4 if r["ttft_s"] is not None]
    rates = [r["decode_tok_s"] for r in res4 if r["decode_tok_s"]]
    total = sum(r["tokens"] for r in res4)
    log(f"  {len(res4)} requests x {MAX_TOKENS} tokens in {wall4:.3f} s "
        f"({total / wall4:.1f} tok/s aggregate); SSE TTFT {[round(t, 4) for t in ttft]} s; "
        f"SSE decode {[round(x, 1) for x in rates]} tok/s per stream; "
        f"greedy gap {gap:.4f} on {card}")

    prof = profile_decode(engine)
    share = prof["device_busy_share"]
    log(f"  decode step, batch 8 (contexts 100..1500): {prof['wall_ms_per_step']:.3f} ms "
        f"wall, {prof['device_ms_per_step']:.3f} ms on the device "
        f"(busy share {share if share is None else round(share, 4)}) on {card}")
    for name, ms in prof["top_kernels_ms_per_step"].items():
        log(f"    {ms:8.4f} ms/step  {name}")

    log("[5/6] single page walk: same weights, max-model-len 2048")
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    cache2 = auto_cache_config(cfg, 128, 2048, 8, "cuda")
    engine2 = NativeEngine(cfg, cache2, max_batch_size=8, params=params, device="cuda")
    if engine2.kv_splits != 0:
        raise AssertionError(f"expected the single walk at 2048, got kv_splits {engine2.kv_splits}")
    prompts5 = prompts[:2] + [prompts[2][:600], prompts[3][:1000]]
    warm_up(engine2, prompts5)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res5 = drive_server(engine2, prompts5)
    wall5 = time.perf_counter() - t0
    launches5 = dispatch.launches()
    log(f"  launches {launches5}; {len(res5)} requests in {wall5:.3f} s")
    if launches5["ragged_paged_attention"] == 0 or launches5["flash_attention"] == 0:
        raise AssertionError(f"2048 path did not launch flash + single walk: {launches5}")
    gap5 = check_greedy(engine2, res5)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "fusioninfer_tpu_torch/csrc/flash_attention.cu",
         "replaces": "fusioninfer_tpu/ops/flash_attention.py:150",
         "launches": launches4["flash_attention"],
         **{k: flash[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}},
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": "fusioninfer_tpu_torch/csrc/paged_attention.cu",
         "replaces": "fusioninfer_tpu/ops/paged_attention.py:1250",
         "launches": launches5["ragged_paged_attention"],
         **{k: single[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}},
        {"name": "ragged_paged_attention_kvsplit", "route": "cuda",
         "source": "fusioninfer_tpu_torch/csrc/paged_attention.cu",
         "replaces": "fusioninfer_tpu/ops/paged_attention.py:1505",
         "launches": launches4["ragged_paged_attention_kvsplit"],
         **{k: split[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}},
    ]
    os.makedirs(OUT_DIR, exist_ok=True)
    strip = [{k: v for k, v in r.items() if k not in ("prompt", "token_ids")}
             for r in res4 + res5]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "device": kind, "torch": torch.__version__,
                   "build_s": _build.build_seconds, "flash": flash,
                   "single_walk": single, "kvsplit": split,
                   "serve_4096": {"wall_s": wall4, "launches": launches4,
                                  "requests": strip[:len(res4)], "greedy_gap": gap,
                                  "decode_profile": prof},
                   "serve_2048": {"wall_s": wall5, "launches": launches5,
                                  "requests": strip[len(res4):], "greedy_gap": gap5},
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"[6/6] done in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
