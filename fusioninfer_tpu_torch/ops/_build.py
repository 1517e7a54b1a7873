"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
under ``build/kernels/`` at the repository root.  Every source gets its
own ``nvcc`` process, all started together, so the build takes as long
as the slowest file.  A library's name carries a hash of its source and
of every local header it ``#include``s (recursively), so an edited kernel
or header is rebuilt and an unchanged one is reused.

Nothing here runs at import: the first wrapper that launches a kernel
calls :func:`library`, which builds every kernel once per process.
There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry point -> argtypes; every entry returns a cudaError_t as int
SIGNATURES = {
    "flash_attention.cu": {
        # q, k, v, out, B, S, H, KV, Hd, scale, causal, window, stream
        "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _P],
    },
    "paged_attention.cu": {
        # q, k_pages, v_pages, k_scales, v_scales (NULL for bf16 pages),
        # tables, row_starts, q_begins, q_lens, out, T, R, KV, G, Hd,
        # n_pages, ps, mp, layer, scale, window, cluster, stream
        "ragged_paged_attention": [_P] * 10 + [_I] * 9 + [_F, _I, _I, _P],
        # the same, with chunk_pages (ceil(mp / 8)) in place of cluster
        "ragged_paged_attention_kvsplit": [_P] * 10 + [_I] * 9 + [_F, _I, _I, _P],
        # q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out,
        # B, KV, G, Hd, n_pages, ps, mp, layer, scale, window, cluster,
        # stream
        "paged_decode_attention": [_P] * 8 + [_I] * 8 + [_F, _I, _I, _P],
    },
    "paged_window_attention.cu": {
        # q, k_pages, v_pages, k_scales, v_scales, tables, starts, counts,
        # out, acc, m, l (split partials; NULL when n_chunks is 1), B, C,
        # KV, G, Hd, n_pages, ps, mp, layer, scale, window, n_chunks (the
        # partials' chunk slots per sequence), stream
        "paged_window_attention": [_P] * 12 + [_I] * 9 + [_F, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_includes(src: Path) -> list[Path]:
    """``src`` and every header it ``#include "..."``s, recursively, each
    once, in the order first met; an include resolves against the
    directory of the file that names it, and one that does not resolve
    raises ``FileNotFoundError``."""
    seen: list[Path] = []
    todo = [src.resolve()]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for name in _LOCAL_INCLUDE.findall(f.read_text()):
            inc = (f.parent / name).resolve()
            if not inc.is_file():
                raise FileNotFoundError(f"{f.name} includes {name!r}, not found")
            todo.append(inc)
    return seen


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in local_includes(src):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no current library (all in parallel),
    load every library, bind its entry points.  Idempotent per process."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in SIGNATURES:
            src = CSRC / name
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, out))
        failed = []
        for name, proc, tmp, out in jobs:
            try:
                log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                failed.append(f"{name}: nvcc timed out")
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name, entries in SIGNATURES.items():
            lib = ctypes.CDLL(str(_lib_path(CSRC / name)))
            for fn, argtypes in entries.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        build_seconds = time.perf_counter() - t0
        return _libs


def entry(source: str, fn: str):
    return getattr(build_all()[source], fn)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
