"""The hand-written kernels (attention, the projections' GEMM, RMSNorm)
and their plain PyTorch versions."""
