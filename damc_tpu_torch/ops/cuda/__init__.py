"""Hand-written CUDA kernels: build, wrappers and plain versions."""
