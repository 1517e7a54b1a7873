"""Command line of the PyTorch/CUDA port.

    python -m fusioninfer_tpu_torch.cli engine serve [PRESET | --load-hf DIR] \\
        [--device cuda] [--max-model-len 4096] [--kv-cache-dtype int8] \\
        [--no-prefix-caching] [--prefill-chunk-size N] \\
        [--tokens-per-step N | --no-token-budget] [--no-fused-step] \\
        [--speculative-ngram K] [--decode-burst 8] [--no-decode-pipeline] \\
        [--port 8000] [--seed 0]

``engine serve`` runs on the card unless ``--device cpu`` is given; with
no CUDA device it raises instead of falling back to the CPU.  It serves a
preset with random weights from ``--seed``, or with ``--load-hf DIR`` a
HuggingFace safetensors checkpoint under the name its config gives.
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    from fusioninfer_tpu_torch.models.config import list_presets

    p = argparse.ArgumentParser(prog="fusioninfer-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    engine = sub.add_parser("engine", help="inference engine on PyTorch/CUDA")
    esub = engine.add_subparsers(dest="subcommand", required=True)
    serve = esub.add_parser("serve", help="serve an OpenAI-compatible API")
    serve.add_argument("model", nargs="?", default="qwen3-tiny",
                       help=f"model preset ({', '.join(list_presets())}), "
                            "served with random weights from --seed")
    serve.add_argument("--load-hf", default="", metavar="DIR",
                       help="serve the HuggingFace safetensors checkpoint "
                            "(*.safetensors + config.json) under DIR, "
                            "named by its config; not with a preset")
    serve.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the plain "
                            "PyTorch path)")
    serve.add_argument("--max-batch-size", type=int, default=8)
    serve.add_argument("--max-model-len", type=int, default=4096)
    serve.add_argument("--page-size", type=int, default=128)
    serve.add_argument("--kv-cache-dtype", choices=("auto", "int8"),
                       default="auto",
                       help="int8: quantized KV pages with per-token f32 "
                            "scales (Hd + 4 bytes per token and head "
                            "instead of 2·Hd); auto keeps the model dtype")
    serve.add_argument("--no-prefix-caching", action="store_true",
                       help="disable automatic prefix caching (KV page reuse)")
    serve.add_argument("--prefill-chunk-size", type=int, default=0,
                       help="chunked prefill: prompts longer than this many "
                            "tokens prefill in bounded chunks interleaved "
                            "with decode steps (0 = no threshold of its "
                            "own); when set it also seeds the per-step "
                            "token budget")
    serve.add_argument("--tokens-per-step", type=int, default=0,
                       help="token-budgeted scheduling: each engine step "
                            "processes at most this many tokens, the "
                            "running batch's decode tokens first, the "
                            "remainder as adaptively-sized prefill chunks; "
                            "0 = derive it from a forward timed on the "
                            "device at startup")
    serve.add_argument("--no-token-budget", action="store_true",
                       help="skip the startup-derived token budget "
                            "(monolithic prefill); an explicit "
                            "--prefill-chunk-size still seeds a budget")
    serve.add_argument("--fused-step", action=argparse.BooleanOptionalAction,
                       default=True,
                       help="run each step's decode rows and budgeted "
                            "prefill-chunk rows in ONE forward, so the "
                            "weights stream from memory once per step "
                            "(--no-fused-step: a chunk forward, then a "
                            "decode forward).  Burst engines "
                            "(--decode-burst > 1) keep the split path "
                            "either way")
    serve.add_argument("--speculative-ngram", type=int, default=0, metavar="K",
                       help="n-gram prompt-lookup speculative decoding: "
                            "propose up to K draft tokens per sequence from "
                            "its own context and score them in the decode "
                            "step's forward (0 = off); greedy outputs "
                            "are token-identical with it on or off, on "
                            "CUDA as on the CPU")
    serve.add_argument("--decode-burst", type=int, default=8, metavar="N",
                       help="decode bursts: up to N decode + sample steps "
                            "in one dispatch (a CUDA graph on the card), "
                            "each sampled token fed back on the device, "
                            "one host round trip per N tokens (0 or 1 = "
                            "per-token stepping); a request that needs "
                            "host work each token (logprobs, logit_bias) "
                            "steps once per pass while the rest of the "
                            "batch bursts")
    serve.add_argument("--no-decode-pipeline", action="store_true",
                       help="do not dispatch the next burst before "
                            "reading the current one's tokens")
    serve.add_argument("--seed", type=int, default=0,
                       help="seed of the random weights")
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8000)
    serve.set_defaults(func=_cmd_engine_serve)
    return p


def _cmd_engine_serve(args: argparse.Namespace) -> int:
    from fusioninfer_tpu_torch.engine.server import serve_from_args

    return serve_from_args(args)


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
