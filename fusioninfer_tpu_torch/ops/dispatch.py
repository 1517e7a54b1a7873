"""Kernel-or-plain routing and the kernels' launch counters.

The rule is the tensor's device and nothing else: a CUDA tensor goes to
the hand-written kernel, a CPU tensor to the plain PyTorch version.  No
environment variable or config can route a CUDA tensor to the plain
version, and a failed build or launch raises instead of falling back.
"""

from __future__ import annotations

import torch

# one counter per kernel and page type: the paged wrappers count int8
# pages under ``<name>_int8``
KERNELS = ("flash_attention",
           "ragged_paged_attention", "ragged_paged_attention_int8",
           "ragged_paged_attention_kvsplit", "ragged_paged_attention_kvsplit_int8",
           "paged_decode_attention", "paged_decode_attention_int8",
           "paged_prefill_attention", "paged_prefill_attention_int8",
           "paged_verify_attention", "paged_verify_attention_int8",
           "gemm", "rms_norm", "add_rms_norm", "qk_norm_rope_kv")

# kernel name -> launches since the last reset; a wrapper adds one where
# it launches its kernel and nowhere else, and one under
# ``<name>[<shape>]`` for the shape it launched at (the GEMM's ``KxN``,
# the norms' ``D``, the fused q/k kernel's ``HxKVxHd`` and page type,
# flash's ``B S``, the walks' tokens ``T``).  A CUDA
# graph's capture launches nothing and its replay runs no wrapper: the
# graph runner (engine/graphs.py) takes back what the wrappers counted
# during the capture and adds it again at each replay, which launches
# those kernels
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or
    on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all cuda or all cpu")


def count_launch(name: str, shape: str | None = None) -> None:
    LAUNCHES[name] += 1
    if shape is not None:
        key = f"{name}[{shape}]"
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def count_launches(counts: dict[str, int]) -> None:
    """Add a replayed graph's launches, ``{counter: launches}``."""
    for name, n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def restore_launches(counts: dict[str, int]) -> None:
    """Set every count back to ``counts`` (what ``launches(by_shape=True)``
    gave before a capture)."""
    LAUNCHES.clear()
    LAUNCHES.update(counts)


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES.update(dict.fromkeys(KERNELS, 0))


def launches(by_shape: bool = False) -> dict[str, int]:
    """Launches by kernel; with ``by_shape``, also by ``<name>[<shape>]``."""
    if by_shape:
        return dict(LAUNCHES)
    return {name: LAUNCHES[name] for name in KERNELS}


def by_shape(counts: dict[str, int], name: str) -> dict[str, int]:
    """``{shape: launches}`` of kernel ``name`` in ``counts`` (a
    ``launches(by_shape=True)``)."""
    head = name + "["
    return {k[len(head):-1]: n for k, n in counts.items() if k.startswith(head)}
