"""Diffusion math, counter noise, Langevin samplers and the CUDA kernels."""
