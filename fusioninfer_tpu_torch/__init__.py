"""PyTorch/CUDA port of the fusioninfer-tpu serving engine for NVIDIA Hopper.

The JAX package ``fusioninfer_tpu`` is the reference this package is held
against; nothing here imports it (or JAX).  Plain tensor code is PyTorch;
every Pallas TPU kernel on the ported path is a CUDA kernel written by hand
for ``sm_90a`` under ``csrc/``, built at first use (``ops/_build.py``).
"""
