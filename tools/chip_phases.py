#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` alone on one NVIDIA GPU.

    python3 tools/chip_phases.py [3] [11] [12] [13]

Builds the kernels, then runs, in order, what is named (all four without
arguments): ``3``, phase 3's shapes of qwen3-1.7b and mistral-7b
(``chip_smoke.check_new_shapes``); ``11``, qwen3-1.7b at batch 32 on bf16
pages at 4096 and int8 pages at 2048 (``serve_g2_leg``); ``12``,
mistral-7b past its window on bf16 and int8 pages (``serve_window_leg``,
without phase 4's qwen3-8b figure beside it); ``13``, the loader
(``serve_loader_leg``).  Each check raises as it does in ``chip_smoke.py``;
the results go to ``chiprun_out/chip_phases.json``.  About 3.5 minutes for
all four on an H100, the build included.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fusioninfer_tpu_torch.models.config import get_preset
    from fusioninfer_tpu_torch.models.transformer import init_params
    from fusioninfer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    print(f"build {_build.build_seconds:.1f} s", flush=True)
    which = sys.argv[1:] or ["3", "11", "12", "13"]
    out = {"card": card}

    def weights(name):
        return init_params(get_preset(name), torch.Generator(device="cuda").manual_seed(cs.SEED),
                           "cuda")

    if "3" in which:
        out["new_shapes"] = cs.check_new_shapes(torch.Generator(device="cuda").manual_seed(cs.SEED))
        print(f"phase 3's new shapes done at {time.perf_counter() - t0:.1f} s", flush=True)
    if "11" in which:
        params = weights("qwen3-1.7b")
        out["11"] = {f"{kv}_{ml}": cs.serve_g2_leg(params, kv, ml, card)
                     for kv, ml in (("model", 4096), ("int8", 2048))}
        del params
        cs.release_device()
        print(f"phase 11 done at {time.perf_counter() - t0:.1f} s", flush=True)
    if "12" in which or "13" in which:
        params = weights("mistral-7b")
        if "12" in which:
            out["12"] = {kv: cs.serve_window_leg(params, kv, card,
                                                 {"device_ms_per_step": float("nan")})
                         for kv in ("model", "int8")}
            print(f"phase 12 done at {time.perf_counter() - t0:.1f} s", flush=True)
        if "13" in which:
            out["13"] = cs.serve_loader_leg(params, card)
            print(f"phase 13 done at {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_phases.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
