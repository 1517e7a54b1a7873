"""int8 KV-cache quantization (own copy of ``kv_quantize`` from the JAX
package's ``models/quantization.py``).

Per-(token, head) symmetric int8: ``scale = max(|x|) / 127`` over the
head dim, floored at 1e-8, and ``clip(round(x / scale), -127, 127)``.
``torch.round`` rounds half to even like ``jnp.round``, and the division
stays in f32, so on the CPU the codes and scales are bit-identical to
the JAX package's.

The paged kernels rely on ``q · (s · k8) == s · (q · k8)``: the K scale
multiplies the scores after the dot and the V scale the probabilities
before P·V, so a page is never dequantized into memory.
"""

from __future__ import annotations

import torch


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., Hd]`` → (int8 ``[..., Hd]``, f32 scale ``[...]``)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale
