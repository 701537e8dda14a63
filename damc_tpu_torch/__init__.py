"""PyTorch port of damc_tpu for NVIDIA Hopper GPUs.

The JAX package `damc_tpu` stays the reference; this package imports
nothing of it. Its hand-written CUDA kernels live in `csrc/` and are built
by `ops/cuda/build.py` at first use; its host C++ libraries (batch engine,
JPEG decoder, LMDB reader) live in `csrc/host/` and are built by
`data/_native_build.py` at first use.
"""
