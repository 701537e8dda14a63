"""K0, the counter noise: the port's plain version (`damc_tpu_torch/ops/noise.py`)
against numpy uint32 arithmetic bit for bit, and against the noise the JAX
Pallas kernel draws (plain interpreter); stream mode's row seeds."""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.ops.pallas.fused_langevin import fused_prior_langevin
from damc_tpu_torch.ops.noise import (
    counter_bits, counter_normal, mix32, stream_row_seeds, uniform_from_bits,
)


def _mix_np(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _bits_np(seeds, counter, cols):
    with np.errstate(over="ignore"):
        base = _mix_np(seeds ^ (np.uint32(counter) * np.uint32(0x9E3779B9)))
        col = np.arange(cols, dtype=np.uint32) * np.uint32(0x85EBCA77)
        return _mix_np(base[:, None] ^ col[None, :])


def test_mix32_bit_exact_against_numpy_uint32():
    x = np.random.default_rng(0).integers(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    with np.errstate(over="ignore"):
        want = _mix_np(x)
    got = mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), want) and got.max() < 2**32


@pytest.mark.parametrize("counter", [0, 1, 7, 119, 2**31 + 5])
def test_counter_bits_bit_exact_against_numpy_uint32(counter):
    seeds = np.random.default_rng(counter % 1000).integers(0, 2**31 - 1, 64).astype(np.int32)
    seeds[0] = -1  # negative int32 seeds are their uint32 bits
    want = _bits_np(seeds.view(np.uint32), counter, 130)
    got = counter_bits(torch.from_numpy(seeds), counter, 130).numpy().astype(np.uint32)
    assert np.array_equal(got, want)


def test_uniform_from_bits_matches_float32_formula():
    bits = np.random.default_rng(1).integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    bits[:2] = [0, 2**32 - 1]
    want = (bits >> 8).astype(np.int32).astype(np.float32) * np.float32(1 / 2**24) + np.float32(0.5 / 2**24)
    got = uniform_from_bits(torch.from_numpy(bits.astype(np.int64))).numpy()
    assert np.array_equal(got, want)
    # 2^-25 below 1 rounds to 1.0 in float32, in the JAX kernel as here.
    assert got.min() > 0 and got.max() <= 1


def test_counter_normal_equals_the_jax_kernels_noise():
    """With zero weights, z=0, one step of size 1 the JAX chain returns
    exactly its step-0 noise. Bits are equal; log/sqrt/cos may differ by an
    ulp, hence atol 1e-5 on standard normals."""
    nz, ndf, b = 128, 16, 10
    seeds = np.random.default_rng(2).integers(0, 2**31 - 1, b).astype(np.int32)
    zeros = lambda *s: jnp.zeros(s, jnp.float32)
    want = np.asarray(
        fused_prior_langevin(
            zeros(b, nz), zeros(nz, ndf), zeros(ndf), zeros(ndf, ndf), zeros(ndf), zeros(ndf),
            steps=1, step_size=1.0, with_noise=True, interpret="plain",
            row_seeds=jnp.asarray(seeds),
        )
    )
    got = counter_normal(torch.from_numpy(seeds), 0, nz).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_counter_normal_moments():
    """Standard normal moments over 2^17 draws (5-sigma bounds)."""
    seeds = torch.arange(1024, dtype=torch.int32)
    x = counter_normal(seeds, 3, 128).double()
    n = x.numel()
    assert abs(x.mean().item()) < 5 / math.sqrt(n)
    assert abs(x.var().item() - 1.0) < 5 * math.sqrt(2 / n)
    assert not torch.equal(counter_normal(seeds, 3, 128), counter_normal(seeds, 4, 128))


def _stream_np(seed, b):
    with np.errstate(over="ignore"):
        rows = np.arange(b, dtype=np.uint32) * np.uint32(0x27D4EB2F)
        return _mix_np(np.uint32(seed & 0xFFFFFFFF) ^ rows)


@pytest.mark.parametrize("seed", [0, 12345, -7, 2**31 - 1])
def test_stream_row_seeds_bit_exact_and_independent_of_batch(seed):
    """Stream mode's row seeds against numpy uint32 arithmetic, and row i's
    seed (so its noise) the same whatever the batch size."""
    big = stream_row_seeds(seed, 4096)
    assert np.array_equal(big.numpy().astype(np.uint32), _stream_np(seed, 4096))
    for b in (1, 7, 256):
        assert torch.equal(stream_row_seeds(seed, b), big[:b])
        assert torch.equal(counter_normal(stream_row_seeds(seed, b), 3, 16), counter_normal(big, 3, 16)[:b])
    assert len(set(big.tolist())) == 4096  # distinct rows, distinct streams


def test_stream_noise_moments_and_seed_dependence():
    """Standard normal moments over 2^17 stream-mode draws (5-sigma bounds);
    another seed gives other noise."""
    x = counter_normal(stream_row_seeds(99, 1024), 0, 128).double()
    n = x.numel()
    assert abs(x.mean().item()) < 5 / math.sqrt(n)
    assert abs(x.var().item() - 1.0) < 5 * math.sqrt(2 / n)
    assert not torch.equal(stream_row_seeds(99, 8), stream_row_seeds(100, 8))
