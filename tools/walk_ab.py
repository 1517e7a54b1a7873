"""The page walks (single, split) and paged decode of two checkouts of
the port, timed on one card in turns (A, B, B, A).

    python3 tools/walk_ab.py [--toggle ATTR] [--out FILE] PATH_A PATH_B

Each turn runs in a process of its own (both checkouts hold a package of
one name), builds that checkout's kernels into its own ``build/kernels``,
holds its walks against their plain versions and prints one line
``RESULT {json}``: ms (CUDA-graph replays, ``chip_smoke.time_graph``) at 8
one-token rows, on bf16 and on int8 pages, of the single walk and paged
decode at contexts 100…4000 (32-page tables) and 101…1501 (16-page
tables, the 2048 leg's decode profile), and of the split walk at
contexts 100…4000 and 101…1501, both over 32-page tables (the 4096
leg's); then qwen3-8b engines at max-model-len 2048 (the single walk)
and 4096 (the split walk, on bf16 and on int8 KV pages), random weights
from seed 0, each through ``chip_smoke.profile_decode``, greedy and
then seeded top-k 40: wall and thread CPU ms per decode step over 24
steps (a list, one entry per run), then device ms and kernel launches
per step, the walk's ms and the top kernels over 8 steps under the
profiler.  With ``--toggle ATTR``, on a
checkout whose engine has the boolean attribute ``ATTR``, each
decoding's wall and CPU ms are taken with it set True, False, False and
True, and its device ms once each way.  ``--out FILE`` appends each
turn's line to FILE as well.  Both sides build their engines without
prefix caching (on a demand-sized pool), where the checkout has the
option, so that they profile one configuration.  The helpers come from this checkout's
``chip_smoke.py``.  Needs one CUDA card; the first line printed is the
card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

# the sampled decode profile: seeded top-k, a candidate row of either path
SAMPLED = {"temperature": 0.8, "top_k": 40, "seed": 1234}
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTX_LONG = (100, 600, 1100, 1600, 2100, 2600, 3300, 4000)
CTX_SERVE = (101, 301, 501, 701, 901, 1101, 1301, 1501)
# (label, contexts, table pages, walks timed there)
SHAPES = (("ctx 100..4000", CTX_LONG, 32, ("walk", "decode", "split")),
          ("ctx 101..1501", CTX_SERVE, 16, ("walk", "decode")),
          ("ctx 101..1501 mp 32", CTX_SERVE, 32, ("split",)))


def _accepted(fn, **kw) -> dict:
    """The keyword arguments of ``kw`` that ``fn`` takes (an older
    checkout may lack them)."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in params}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def one_turn(tree: str, toggle: str | None = None) -> dict:
    """The measurements of one checkout, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import fusioninfer_tpu_torch
    from fusioninfer_tpu_torch.engine.engine import NativeEngine
    from fusioninfer_tpu_torch.engine.kv_cache import auto_cache_config
    from fusioninfer_tpu_torch.models.config import get_preset
    from fusioninfer_tpu_torch.ops import _build
    from fusioninfer_tpu_torch.ops import paged_attention as pa

    if not fusioninfer_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {fusioninfer_tpu_torch.__file__}, not {tree}")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    res = {}
    for label, ctx, mp, timed in SHAPES:
        for int8 in (False, True):
            rows = [(c - 1, 1) for c in ctx]
            kp, vp, ks, vs, tables = cs.paged_pool(gen, rows, int8, mp=mp)
            q = torch.randn((len(rows), cs.KV_HEADS * cs.GROUP, cs.HEAD_DIM), generator=gen,
                            device="cuda").to(torch.bfloat16)
            starts = torch.tensor([s for s, _ in rows], dtype=torch.int32, device="cuda")
            ones = torch.ones(len(rows), dtype=torch.int32, device="cuda")
            begins = torch.arange(len(rows), dtype=torch.int32, device="cuda")
            sc = (ks, vs) if int8 else ()
            lsc = (ks[1], vs[1]) if int8 else ()
            tag = f"{label} {'int8' if int8 else 'bf16'}"

            desc = (tables, starts, begins, ones)
            walks = {
                "walk": (lambda: pa.ragged_paged_attention(q, kp, vp, *desc, *sc, layer=1),
                         lambda: pa.reference_ragged_paged_attention(q, kp[1], vp[1], *desc,
                                                                     *lsc)),
                "decode": (lambda: pa.paged_decode_attention(q, kp, vp, tables, starts + 1,
                                                             *sc, layer=1),
                           lambda: pa.reference_paged_attention(q, kp[1], vp[1], tables,
                                                                starts + 1, *lsc)),
                "split": (lambda: pa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, *sc,
                                                                    layer=1),
                          lambda: pa.reference_ragged_paged_attention_kvsplit(
                              q, kp[1], vp[1], *desc, *lsc))}
            for name in timed:
                kern, plain = walks[name]
                cs.check_close(kern(), plain(), f"{name} {tag}", cs.PAGED_ROW_TOL, cs.HEAD_DIM)
                res[f"{name} {tag}"] = cs.time_graph(kern)
    cfg = get_preset("qwen3-8b")
    params = None
    for max_len, splits, kv_dtype in ((2048, False, "model"), (4096, True, "model"),
                                      (4096, True, "int8")):
        cache_cfg = auto_cache_config(cfg, 128, max_len, 8, "cuda", kv_dtype,
                                      **_accepted(auto_cache_config, prefix_caching=False))
        engine = NativeEngine(cfg, cache_cfg, max_batch_size=8, seed=cs.SEED, params=params,
                              device="cuda",
                              **_accepted(NativeEngine, enable_prefix_caching=False))
        if (engine.kv_splits != 0) != splits:
            raise RuntimeError(f"max-model-len {max_len}: kv_splits {engine.kv_splits}")
        leg = f"{max_len}" + (" int8" if kv_dtype == "int8" else "")
        # with the toggle in the checkout: wall and CPU ms with it on, off,
        # off, on, then device ms once each way
        runs = (((True, False), (False, False), (False, False), (True, False),
                 (True, True), (False, True)) if toggle and hasattr(engine, toggle)
                else ((None, False), (None, True)))
        for decoding, sampling in (("greedy", None), ("top-k 40", SAMPLED)):
            for on, device in runs:
                if on is not None:
                    setattr(engine, toggle, on)
                prof = cs.profile_decode(engine, n_steps=8 if device else 24,
                                         sampling=sampling, device=device)
                key = f"{leg} {decoding}" + ("" if on is None else f" {toggle}={on}")
                if not device:
                    for name in ("wall", "cpu"):
                        res.setdefault(f"{key} step {name} ms", []).append(
                            prof[f"{name}_ms_per_step"])
                    continue
                res[f"{key} step device ms"] = prof["device_ms_per_step"]
                res[f"{key} kernel launches per step"] = prof.get("kernels_per_step")
                res[f"{key} walk ms per step"] = prof["walk_ms_per_step"]
                res[f"{key} walk kernels per step"] = prof["walk_kernels_per_step"]
                res[f"{key} top kernels ms per step"] = prof["top_kernels_ms_per_step"]
        params = engine.params
        del engine
        torch.cuda.empty_cache()
    return res


def main(argv: list[str]) -> int:
    args = argv[1:]
    if args[:1] == ["--turn"] and len(args) in (2, 3):
        print("RESULT", json.dumps(one_turn(*args[1:])), flush=True)
        return 0
    opts = {}
    while len(args) > 2 and args[0] in ("--toggle", "--out"):
        opts[args[0]], args = args[1], args[2:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(_chip_smoke().card_line(), flush=True)
    trees = {"A": args[0], "B": args[1]}
    toggle = [opts["--toggle"]] if "--toggle" in opts else []
    for name in ("A", "B", "B", "A"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                               trees[name]] + toggle,
                              capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(f"{name} ({trees[name]}): exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  flush=True)
            return 1
        line = f"{name} {time.perf_counter() - t0:.0f} s {lines[0]}"
        print(line, flush=True)
        if "--out" in opts:
            with open(opts["--out"], "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
