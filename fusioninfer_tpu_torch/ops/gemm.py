"""The projections' matrix product: CUDA kernel wrapper + plain version.

``matmul(x, w)`` computes ``x @ w`` for activations ``x [..., K]`` and a
weight ``w [K, N]`` in the JAX package's ``[in, out]`` layout.  It
replaces no TPU kernel (the JAX package leaves its projections to XLA);
it exists so that a row's output bits on the card depend on that row and
the weight alone, never on how many rows share the call.

Kernel (``csrc/gemm.cu``): K split into :func:`split_k` ranges chosen
from (N, K) alone; each range accumulated in f32 by a warpgroup's
``wgmma`` chain in k order from zero, rows padded to 64; the ranges of a
tile are the K ranks of one thread-block cluster, whose partials are
folded in range order through distributed shared memory (nothing goes
to device memory, no counter or atomic decides the order).  A TMA +
mbarrier ring feeds a persistent grid that walks the output tiles; two
128-row tiles with the same columns may pair in the cluster and load
their weight tile once (TMA multicast).  :func:`tile_shape` picks the
tile and the pairing for the row count: they move which ``wgmma`` width
computes a column and which block loads what, never an element's adds.
bf16 in and out.  At decode row counts it streams the weight once and is
bound by bytes; at prefill row counts by the L2 -> shared memory traffic
and then the tensor cores.

The rule is the device: a CUDA tensor goes to the kernel (bf16 only; it
raises on anything else), a CPU tensor to ``x @ w``.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.ops import dispatch

# K per ring stage (csrc/gemm.cu's BK); the narrowest tile's columns
TILE_K, TILE_N = 64, 64
# the tiles the kernel has, (rows, columns)
TILES = ((64, 64), (64, 128), (128, 64), (128, 128), (128, 256))
# the most rows that run in 64-row tiles (one warpgroup, two blocks an SM)
SMALL_M = 64
# clusters' ranks the split aims at with TILE_N-wide tiles: about one an
# SM of an H100.  A constant, not the card's count, so a weight's split
# (and its bits) are the same on any card
TARGET_BLOCKS = 128
# for the tile choice only (it moves no bits), an H100's figures: its SMs,
# and the SMs that clusters of 4 or 8 blocks fill; the time of a 64-deep
# stage of a 128-row tile by (columns, pair) and of a fold of the K ranges,
# relative (about microseconds).  With these tile_shape picks the fastest
# tile of tools/gemm_sweep.py's run at every prefill shape (H100 at 700 W)
SMS, SMS_IN_QUADS = 132, 120
STAGE_TIME = {(64, 1): 0.56, (128, 1): 0.67, (256, 1): 1.02, (128, 2): 0.68, (256, 2): 0.93}
FOLD_TIME = 3.0
# at decode rows, the weight bytes a 128-column block may stream for that
# width to beat 64 (tools/gemm_sweep.py: wk/wv's 512-deep ranges, yes;
# wq/wo's 2048, no)
SHORT_RANGE_BYTES = 128 * 1024
# the fewest K blocks a split range may hold, and the most ranges: the
# portable cluster size (csrc/gemm.cu's MAX_SPLITS)
MIN_SPLIT_BLOCKS = 4
MAX_SPLITS = 8


def split_k(n: int, k: int) -> int:
    """Ranges of whole ``TILE_K`` blocks that K is split into for a weight
    ``[k, n]``: the least power of two that brings ``ceil(n / TILE_N)``
    column tiles to ``TARGET_BLOCKS``, each range at least
    ``MIN_SPLIT_BLOCKS`` blocks deep, at most ``MAX_SPLITS`` ranges, and
    no empty range.  A function of (n, k) alone, never of the row count,
    so a row's reduction order is the same at every M."""
    tiles = -(-n // TILE_N)
    kb = -(-k // TILE_K)
    s = 1
    while s < MAX_SPLITS and tiles * s < TARGET_BLOCKS and kb // (2 * s) >= MIN_SPLIT_BLOCKS:
        s *= 2
    while s > 1 and (s - 1) * -(-kb // s) >= kb:
        s //= 2
    return s


def tile_shape(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(rows, columns, pair) of the kernel's tile for an ``[m, k] @ [k,
    n]`` product.  Up to ``SMALL_M`` rows: 64-row tiles, no pairs, 128
    columns where the split's clusters of 128-column tiles fill the card
    or a block of them streams at most ``SHORT_RANGE_BYTES`` of weight
    (few stages in a row: wider tiles then win), else 64.  Above: 128-row
    tiles, whose width and pairing (2: two row tiles load their weight
    tile once, in clusters of splits × 2 blocks) give the least time in a
    model of the persistent grid: rounds of the clusters that fit, each a
    K range's stages at ``STAGE_TIME`` plus a fold with a split; within 3 %
    the model keeps the earlier candidate (no pairs, wider tiles first).
    The tile moves no bits, so this may look at ``m``."""
    s = split_k(n, k)
    stages = -(-(-(-k // TILE_K)) // s)
    if m <= SMALL_M:
        wide = -(-n // 128) * s >= SMS or stages * TILE_K * 128 * 2 <= SHORT_RANGE_BYTES
        return 64, (128 if wide else 64), 1
    m_tiles = -(-m // 128)
    best = None
    for (cols, pair), stage in sorted(STAGE_TIME.items(), key=lambda c: (c[0][1], -c[0][0])):
        if pair == 2 and (m_tiles < 2 or 2 * s > MAX_SPLITS):
            continue
        blocks = s * pair
        clusters = (SMS if blocks <= 2 else SMS_IN_QUADS) // blocks
        rounds = -(-(-(-m_tiles // pair) * -(-n // cols)) // clusters)
        cost = rounds * (stages * stage + (FOLD_TIME if s > 1 else 0.0))
        if best is None or cost < 0.97 * best[0]:
            best = (cost, cols, pair)
    return 128, best[1], best[2]


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def reference_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x @ w``."""
    return x @ w


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` → ``[..., N]``: the CUDA kernel for CUDA
    tensors, :func:`reference_matmul` for CPU tensors."""
    if not dispatch.use_kernel(x, w):
        return reference_matmul(x, w)
    K = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"weight {tuple(w.shape)} does not take x {tuple(x.shape)}")
    N = w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemm takes bfloat16, got x {x.dtype} and w {w.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"K {K} and N {N} must be multiples of 8")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if not w.is_contiguous():
        raise ValueError("the weight must be contiguous ([in, out] row-major)")
    for name, t in (("x", x2), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    splits = split_k(N, K)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"{splits} K ranges do not fit a cluster of at most {MAX_SPLITS}")
    rows, cols, pair = tile_shape(M, N, K)
    if cols % (4 * splits) or splits * pair > MAX_SPLITS:
        raise ValueError(f"{splits} K ranges do not fit a cluster of the {rows} x {cols} tile")
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("gemm.cu", "gemm_bf16")
    stream = _stream(x)
    err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, splits, rows, cols, pair,
             stream)
    _build.check(err, "gemm_bf16")
    dispatch.count_launch("gemm", f"{K}x{N}")
    return y.reshape(*lead, N)
