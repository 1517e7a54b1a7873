"""Command line of the PyTorch/CUDA port.

    python -m fusioninfer_tpu_torch.cli engine serve qwen3-8b \\
        [--device cuda] [--max-model-len 4096] [--kv-cache-dtype int8] \\
        [--port 8000] [--seed 0]

``engine serve`` runs on the card unless ``--device cpu`` is given; with
no CUDA device it raises instead of falling back to the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fusioninfer-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    engine = sub.add_parser("engine", help="inference engine on PyTorch/CUDA")
    esub = engine.add_subparsers(dest="subcommand", required=True)
    serve = esub.add_parser("serve", help="serve an OpenAI-compatible API")
    serve.add_argument("model", nargs="?", default="qwen3-tiny",
                       help="model preset (qwen3-tiny, qwen3-8b)")
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
