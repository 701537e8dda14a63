"""Counter-based Gaussian noise (K0): the plain version of `csrc/counter_noise.cuh`.

Counterpart of the counter helpers in
`damc_tpu/ops/pallas/fused_langevin.py:127-159` (`_mix32`, `_counter_bits`,
`_counter_normal`). Element (i, j) at step s is

    r cos(2 pi u2),  r = sqrt(-2 ln u1),
    u_k = (bits_k >> 8) 2^-24 + 2^-25,
    bits_k = fmix32(fmix32(seed_i ^ c_k * 0x9E3779B9) ^ j * 0x85EBCA77),

with c_1 = 2s and c_2 = 2s + 1 and all hashing in uint32 arithmetic: a row's
noise is a pure function of its seed, whatever batch it sits in. The bits
equal the JAX kernel's bit for bit; only log, sqrt and cos may differ by an
ulp.

torch has no `>>` for uint32 on the CPU, so the hash runs on int64 tensors
that hold uint32 values. A product of two uint32 values can pass 2^63, so
`_mul32` multiplies by the constant's two 16-bit halves and masks, which
stays exact in int64.
"""

from __future__ import annotations

import math

import torch

GOLD = 0x9E3779B9  # 2^32 / phi: Weyl increment of the draw counter
COLC = 0x85EBCA77  # odd column multiplier
_M32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c."""
    lo = x * (c & 0xFFFF)  # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16  # < 2^32
    return (lo + hi) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def as_u32(seeds) -> torch.Tensor:
    """int32 (or any integer) seeds -> int64 holding their uint32 bits."""
    return torch.as_tensor(seeds).to(torch.int64) & _M32


def counter_bits(seeds: torch.Tensor, counter: int, cols: int) -> torch.Tensor:
    """(rows, cols) uint32 bits (as int64) for per-row seeds (rows,)."""
    seeds = as_u32(seeds)
    cnt = _mul32(torch.tensor(counter, dtype=torch.int64) & _M32, GOLD)
    base = mix32(seeds ^ cnt.to(seeds.device))  # (rows,)
    col = _mul32(torch.arange(cols, dtype=torch.int64, device=seeds.device), COLC)
    return mix32(base[:, None] ^ col[None, :])


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> (0, 1): the top 24 bits, offset by half an ulp."""
    top24 = (bits >> 8).to(torch.float32)
    return top24 * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def counter_normal(seeds: torch.Tensor, step: int, cols: int) -> torch.Tensor:
    """(rows, cols) float32 standard normals of chain step `step`."""
    u1 = uniform_from_bits(counter_bits(seeds, 2 * step, cols))
    u2 = uniform_from_bits(counter_bits(seeds, 2 * step + 1, cols))
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2)
