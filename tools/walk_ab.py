"""The single page walk and paged decode of two checkouts of the port,
timed on one card in turns (A, B, B, A).

    python3 tools/walk_ab.py PATH_A PATH_B

Each turn runs in a process of its own (both checkouts hold a package of
one name), builds that checkout's kernels into its own ``build/kernels``,
holds its walk against the plain version and prints one line ``RESULT
{json}``: walk and decode ms (CUDA-graph replays, ``chip_smoke.time_graph``)
at 8 one-token rows with contexts 100…4000 (32-page tables) and
101…1501 (16-page tables, the decode profile's contexts), on bf16 and on
int8 pages; then a qwen3-8b engine at max-model-len 2048 (the single
walk), random weights from seed 0, through ``chip_smoke.profile_decode``:
wall and device ms per decode step and the walk's device ms per step.
The helpers come from this checkout's ``chip_smoke.py``.  Needs one CUDA
card; the first line printed is the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("ctx 100..4000", (100, 600, 1100, 1600, 2100, 2600, 3300, 4000), 32),
          ("ctx 101..1501", (101, 301, 501, 701, 901, 1101, 1301, 1501), 16))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def one_turn(tree: str) -> dict:
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
    for label, ctx, mp in SHAPES:
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

            def walk():
                return pa.ragged_paged_attention(q, kp, vp, tables, starts, begins, ones,
                                                 *sc, layer=1)

            def decode():
                return pa.paged_decode_attention(q, kp, vp, tables, starts + 1, *sc, layer=1)

            cs.check_close(walk(), pa.reference_ragged_paged_attention(
                q, kp[1], vp[1], tables, starts, begins, ones, *lsc), tag, cs.PAGED_ROW_TOL,
                cs.HEAD_DIM)
            res[f"walk {tag}"] = cs.time_graph(walk)
            res[f"decode {tag}"] = cs.time_graph(decode)
    cfg = get_preset("qwen3-8b")
    engine = NativeEngine(cfg, auto_cache_config(cfg, 128, 2048, 8, "cuda"),
                          max_batch_size=8, seed=cs.SEED, device="cuda")
    if engine.kv_splits != 0:
        raise RuntimeError("expected the single walk at max-model-len 2048")
    prof = cs.profile_decode(engine)
    res["step wall ms"] = prof["wall_ms_per_step"]
    res["step device ms"] = prof["device_ms_per_step"]
    res["walk ms per step"] = sum(ms for name, ms in prof["top_kernels_ms_per_step"].items()
                                  if "walk_kernel" in name or "ragged_kernel" in name)
    return res


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--turn":
        print("RESULT", json.dumps(one_turn(argv[2])), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    print(_chip_smoke().card_line(), flush=True)
    trees = {"A": argv[1], "B": argv[2]}
    for name in ("A", "B", "B", "A"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", trees[name]],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(f"{name} ({trees[name]}): exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  flush=True)
            return 1
        print(f"{name} {time.perf_counter() - t0:.0f} s {lines[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
