"""The one definition of attention visibility (own copy of the JAX
package's ``ops/masks.py``).

``attend(q_pos, k_pos, window)``: key ``k_pos`` is visible to query
``q_pos`` iff it is causal (``k <= q``) and, under a sliding window,
within the trailing band (``q - k < window``: the query sees the previous
``window`` positions, itself included).  The CUDA kernels apply the same
rule by global position.
"""

from __future__ import annotations

import torch


def attend(q_pos: torch.Tensor, k_pos: torch.Tensor,
           window: int | None = None, causal: bool = True) -> torch.Tensor:
    """Bool visibility mask, broadcast over ``q_pos``/``k_pos``."""
    if causal:
        keep = q_pos >= k_pos
        if window is not None:
            keep = keep & (q_pos - k_pos < window)
        return keep
    if window is not None:
        return q_pos - k_pos < window
    raise ValueError("attend() with causal=False requires a window")
