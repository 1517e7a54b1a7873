"""The row-invariant GEMM's tiles, pairings and K splits, timed on one card.

    python3 tools/gemm_sweep.py [--out FILE]

For each qwen3-8b projection shape (``chip_smoke.GEMM_SHAPES``) this
launches ``csrc/gemm.cu`` through its C entry at every K split the
kernel folds (1, 2, 4, 8; a range at least four 64-deep blocks) and every
tile and pairing it takes at the row count: 64 x 64 and 64 x 128 at
decode rows (M 1, 8, 64; the weight cold in L2, ``chip_smoke.time_cold``),
128 x 64 alone, 128 x 128 and 128 x 256 alone and paired, at M 520, 1024
and 3000 (warm,
``chip_smoke.time_graph``), beside ``torch.matmul``.  The tile and the
pairing move no bits; the split does, so only ``ops/gemm.py::split_k``'s
choice serves, and ``chip_smoke.py`` phase 3 holds its bits.  This is
what ``split_k``, ``tile_shape`` and ``STAGE_TIME`` were chosen from.  It
prints the card's name and power limit, then one line per (shape, M) with
ms by ``S<splits> <rows>x<cols>p<pair>``; ``--out FILE`` writes them as
JSON lines too.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_ROWS = (1, 8, 64)
PREFILL_ROWS = (520, 1024, 3000)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def configs(m: int, k: int) -> list[tuple[int, int, int, int]]:
    """(splits, rows, cols, pair) the kernel takes for ``m`` rows of a
    ``[k, n]`` weight."""
    kb = -(-k // 64)
    out = []
    for s in (1, 2, 4, 8):
        per = -(-kb // s)
        if s > 1 and (per < 4 or (s - 1) * per >= kb):
            continue
        if m <= 64:
            out += [(s, 64, cols, 1) for cols in (64, 128)]
        else:
            out += [(s, 128, cols, pair) for cols in (64, 128, 256) for pair in (1, 2)
                    if s * pair <= 8 and (pair == 1 or (m > 128 and cols > 64))
                    and cols % (4 * s) == 0]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write each line as JSON to this file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemm_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    cs = _chip_smoke()
    from fusioninfer_tpu_torch.ops import _build, gemm

    print(cs.card_line(), flush=True)
    entry = _build.entry("gemm.cu", "gemm_bf16")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    sink = open(args.out, "a") if args.out else None
    try:
        for name, (K, N) in cs.GEMM_SHAPES.items():
            w = (torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5).to(torch.bfloat16)
            x_all = torch.randn((max(PREFILL_ROWS), K), generator=gen,
                                device="cuda").to(torch.bfloat16)
            copies = [w] + [w.clone() for _ in range(-(-cs.COLD_BYTES // (2 * K * N)) - 1)]
            for M in DECODE_ROWS + PREFILL_ROWS:
                x = x_all[:M]
                y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                cold = M in DECODE_ROWS
                reps = 5 if M * N * K > 1e12 else 15

                def timed(fn):
                    fn(w)
                    torch.cuda.synchronize()
                    if cold:
                        return cs.time_cold(fn, copies, reps)
                    return cs.time_graph(lambda: fn(w), reps=reps, per_graph=5)

                ms = {}
                for s, rows, cols, pair in configs(M, K):
                    def run(wc, s=s, rows=rows, cols=cols, pair=pair):
                        _build.check(entry(x.data_ptr(), wc.data_ptr(), y.data_ptr(), M, N, K,
                                           s, rows, cols, pair,
                                           torch.cuda.current_stream().cuda_stream), "gemm_bf16")
                    ms[f"S{s} {rows}x{cols}p{pair}"] = timed(run)
                line = {"shape": name, "K": K, "N": N, "M": M, "cold": cold,
                        "split_k": gemm.split_k(N, K), "rule": list(gemm.tile_shape(M, N, K)),
                        "torch_matmul_ms": timed(lambda wc: torch.matmul(x, wc)), "ms": ms}
                print(f"{name} M{M} {'cold' if cold else 'warm'}: torch.matmul "
                      f"{line['torch_matmul_ms']:.4f}; split_k {line['split_k']} rule "
                      f"{line['rule']}; " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
                      flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
            del w, x_all, copies
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
