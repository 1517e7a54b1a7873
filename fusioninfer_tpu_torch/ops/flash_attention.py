"""Causal flash attention for prefill: CUDA kernel wrapper + plain version.

Replaces ``fusioninfer_tpu/ops/flash_attention.py::flash_attention`` (the
Pallas TPU kernel).  Same contract: q ``[B, S, H, Hd]``, k/v
``[B, S, KV, Hd]`` with GQA group ``H // KV``, causal by global position,
optional sliding window, f32 softmax statistics → ``[B, S, H·Hd]``.

Kernel (``csrc/flash_attention.cu``, on the shared Hopper machinery of
``csrc/hopper_attention.cuh``): a persistent grid of one block per SM
walks work items of one 128-row q tile of one q head and batch row,
heaviest first, with the G heads of a KV head side by side so their K/V
reads hit L2.  A producer warpgroup (registers lowered by ``setmaxnreg``)
issues every load as a TMA copy from 3-D tensor maps over q/k/v,
zero-filled past S, and streams 128-key K/V tiles through a three-stage
mbarrier ring; two consumer warpgroups of 64 rows each take turns on the
tensor cores, running QKᵀ and PV as ``wgmma`` (P from registers) with
the online softmax in f32 registers, and mask only the tiles that cross
the diagonal, the window's edge or S.  GQA reads KV head ``h // G`` in
place (no head broadcast in memory).

Bound on an H100: prefill at the served shapes is bound by operations
(≈4·S²·H·Hd/2 FLOP against ≈ (2·H + 2·KV)·S·Hd·2 bytes), so the design
keeps both products on the tensor cores through ``wgmma``, the only path
to their full rate, and the [S, S] scores out of device memory.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.ops import dispatch
from fusioninfer_tpu_torch.ops.masks import attend

NEG_INF = -1e30  # mask value of the plain version (scores are f32)
_HEAD_DIMS = (64, 128)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's GQA semantics (f32 math)."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, Hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / (Hd ** 0.5)
    if causal or window is not None:
        pos = torch.arange(S, device=q.device)
        mask = attend(pos[:, None], pos[None, :], window, causal=causal)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H * Hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Blockwise exact attention → ``[B, S, H·Hd]``: the CUDA kernel for
    CUDA tensors, :func:`reference_attention` for CPU tensors."""
    if not dispatch.use_kernel(q, k, v):
        return reference_attention(q, k, v, causal=causal, window=window)
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, Hd) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {KV}")
    if Hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {Hd} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not causal and window is None:
        raise ValueError("non-causal attention requires a window")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("flash_attention.cu", "flash_attention_bf16")
    out = torch.empty((B, S, H * Hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, H, KV, Hd, Hd ** -0.5, int(causal), window or 0, stream)
    _build.check(err, "flash_attention_bf16")
    dispatch.count_launch("flash_attention", f"B{B} S{S}")
    return out
