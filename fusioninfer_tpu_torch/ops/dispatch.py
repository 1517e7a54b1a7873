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
           "paged_verify_attention", "paged_verify_attention_int8")

# kernel name -> launches since the last reset; a wrapper adds one where
# it launches its kernel and nowhere else
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


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)
