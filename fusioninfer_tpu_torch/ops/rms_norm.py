"""RMSNorm: CUDA kernel wrapper + plain version.

``rms_norm(x, weight, eps)`` normalises the last axis of ``x`` by its
root mean square (statistics in f32) and scales by ``weight``.  It
replaces no TPU kernel (the JAX package leaves its norms to XLA); it
exists so that a row's bits on the card do not depend on how many rows
share the call.

Kernel (``csrc/rms_norm.cu``): a fixed reduction tree per row that depends
on D alone (G threads a row, each adding its 16-byte chunks in order, a
butterfly of warp shuffles, warp sums added in order); bf16 in and out.
Bound by bytes.

The rule is the device: a CUDA tensor goes to the kernel (bf16 only), a
CPU tensor to :func:`reference_rms_norm`.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.ops import dispatch


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def reference_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version (the JAX ``rms_norm``'s arithmetic)."""
    orig = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(orig)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis → ``x``'s shape and type: the CUDA kernel
    for CUDA tensors, :func:`reference_rms_norm` for CPU tensors."""
    if not dispatch.use_kernel(x, weight):
        return reference_rms_norm(x, weight, eps)
    D = x.shape[-1]
    if weight.shape != (D,):
        raise ValueError(f"weight {tuple(weight.shape)} does not match D {D}")
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"rms_norm takes bfloat16, got x {x.dtype} and weight {weight.dtype}")
    if D % 8:
        raise ValueError(f"D {D} must be a multiple of 8")
    x2 = x.reshape(-1, D)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if not weight.is_contiguous():
        weight = weight.contiguous()
    for name, t in (("x", x2), ("weight", weight)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("rms_norm.cu", "rms_norm_bf16")
    stream = _stream(x)
    err = fn(x2.data_ptr(), weight.data_ptr(), y.data_ptr(), x2.shape[0], D, float(eps),
             stream)
    _build.check(err, "rms_norm_bf16")
    dispatch.count_launch("rms_norm", str(D))
    return y.reshape(x.shape)
