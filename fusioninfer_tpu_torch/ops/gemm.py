"""The projections' matrix product: CUDA kernel wrapper + plain version.

``matmul(x, w)`` computes ``x @ w`` for activations ``x [..., K]`` and a
weight ``w [K, N]`` in the JAX package's ``[in, out]`` layout.  It
replaces no TPU kernel (the JAX package leaves its projections to XLA);
it exists so that a row's output bits on the card depend on that row and
the weight alone, never on how many rows share the call.

Kernel (``csrc/gemm.cu``): every 64 rows × 128 columns accumulated by one
warpgroup's ``wgmma`` chain in f32 over K in order, rows padded to 64,
tiles of 64 rows up to 64 rows (two blocks an SM) and of 128 above (two
warpgroups sharing each weight tile, one block an SM), a TMA + mbarrier
ring of (x, w) tiles; K split into
:func:`split_k` ranges chosen from (N, K) alone, their f32 partials added
in range order: by the last block of each tile where each range is a
block of its own, or in registers by the one block that runs all of a
tile's ranges (:func:`block_per_range` picks, by waves on the card), the
same adds either way.
bf16 in and out.  At decode row counts it streams the weight once and is
bound by bytes; the split fills the card where N / 128 gives few tiles.

The rule is the device: a CUDA tensor goes to the kernel (bf16 only; it
raises on anything else), a CPU tensor to ``x @ w``.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.ops import dispatch

# the kernel's tile: columns and K per stage (csrc/gemm.cu); its rows are
# tile_rows(m)
TILE_N, TILE_K = 128, 64
# blocks the split aims at: one an SM of an H100.  A constant, not the
# card's count, so a weight's split (and its bits) are the same on any card
TARGET_BLOCKS = 132
# the fold model of block_per_range: an SM's tensor rate (about half an
# H100 SM's peak, as measured for this kernel), the memory rate, and a
# wave's fixed cost (ring fill, epilogue, fold: ~5 us measured at decode)
PER_SM_FLOPS = 989e12 / 132 / 2
HBM_BYTES_S = 3.35e12
WAVE_S = 5e-6
# the fewest K blocks a split range may hold, and the most ranges
# (csrc/gemm.cu's MAX_SPLITS)
MIN_SPLIT_BLOCKS = 4
MAX_SPLITS = 16
# the per-tile counters of split launches (zeroed once; each launch leaves
# them zero): device -> int32 tensor
_COUNTS: dict[torch.device, torch.Tensor] = {}
_MAX_COUNTS = 1 << 16


def split_k(n: int, k: int) -> int:
    """Ranges of whole ``TILE_K`` blocks that K is split into for a weight
    ``[k, n]``: enough to bring ``ceil(n / 128)`` column tiles near
    ``TARGET_BLOCKS`` blocks, each range at least ``MIN_SPLIT_BLOCKS``
    blocks deep, at most ``MAX_SPLITS`` ranges, and no empty range.  A
    function of (n, k) alone, never of the row count, so a row's
    reduction order is the same at every M."""
    tiles = -(-n // TILE_N)
    kb = -(-k // TILE_K)
    s = max(1, min(kb // MIN_SPLIT_BLOCKS, TARGET_BLOCKS // tiles, MAX_SPLITS))
    per = -(-kb // s)
    return -(-kb // per)


def tile_rows(m: int) -> tuple[int, int]:
    """(rows a tile, blocks an SM) of the kernel for ``m`` rows: 64-row
    tiles two an SM up to 64 rows, 128-row tiles one an SM above."""
    return (64, 2) if m <= 64 else (128, 1)


def block_per_range(m: int, n: int, k: int) -> bool:
    """Run each K range of an ``[m, k] @ [k, n]`` product as a block of its
    own (partials folded in memory) rather than all of a tile's ranges in
    one block (folded in registers)?  Whichever a rough model of the card
    finds faster: waves of blocks at ``PER_SM_FLOPS`` an SM, ``WAVE_S``
    each, plus the partials' write and read at ``HBM_BYTES_S``.  The two
    give the same bits, so this choice may look at ``m``."""
    s = split_k(n, k)
    if s == 1:
        return False
    rows, per_sm = tile_rows(m)
    tiles, slots = -(-m // rows) * -(-n // TILE_N), TARGET_BLOCKS * per_sm
    unit = 2 * rows * TILE_N * -(-k // (s * TILE_K)) * TILE_K * per_sm / PER_SM_FLOPS
    apart = -(-tiles * s // slots) * (unit + WAVE_S) + 8 * s * m * n / HBM_BYTES_S
    together = -(-tiles // slots) * (s * unit + WAVE_S)
    return apart < together


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def reference_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x @ w``."""
    return x @ w


def _counts(device: torch.device, need: int) -> torch.Tensor:
    buf = _COUNTS.get(device)
    if buf is None:
        buf = _COUNTS[device] = torch.zeros(_MAX_COUNTS, dtype=torch.int32, device=device)
    if need > buf.numel():
        raise ValueError(f"a split launch of {need} tiles exceeds the {buf.numel()} counters")
    return buf


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
    ws = counts = None
    if block_per_range(M, N, K):
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
        counts = _counts(x.device, -(-M // tile_rows(M)[0]) * -(-N // TILE_N))
    from fusioninfer_tpu_torch.ops import _build

    fn = _build.entry("gemm.cu", "gemm_bf16")
    stream = _stream(x)
    err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
             0 if ws is None else ws.data_ptr(),
             0 if counts is None else counts.data_ptr(), M, N, K, splits, stream)
    _build.check(err, "gemm_bf16")
    dispatch.count_launch("gemm")
    return y.reshape(*lead, N)
