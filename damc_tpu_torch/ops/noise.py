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

Stream mode (one scalar seed for a whole batch, the training path) draws
from the same counter stream: row i's seed is `stream_row_seeds(seed, B)[i]`
= fmix32(seed ^ i * ROWC). The TPU kernels seed their on-core PRNG once per
grid block instead (`pltpu.prng_seed(seed + program_id)`,
`damc_tpu/ops/pallas/fused_langevin.py:178-180`), whose bits no GPU can
give; here a row's noise depends on (seed, row) and not on the block
layout, so it does not change when the batch grows. A sharded launch
(`fused_prior_langevin_sharded`, `fused_reverse_sweep_sharded`) passes its
first global row as `row_base`, so the rows of every rank draw what one
unsharded launch draws for them: the port's counterpart of the TPU's
"every block on every shard draws a distinct stream"
(`damc_tpu/ops/pallas/fused_langevin.py:403`, seed + axis_index *
local_blocks), which gives the same distribution but other draws. Both are standard
normals; the JAX package documents the same kind of difference between
its fused and scan sweeps (`damc_tpu/models/amortizer.py:211-214`).

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
ROWC = 0x27D4EB2F  # odd row multiplier of stream mode (neither GOLD nor COLC)
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


def counter_bits(seeds: torch.Tensor, counter, cols: int) -> torch.Tensor:
    """(rows, cols) uint32 bits (as int64) for per-row seeds (rows,). The
    counter is an int, or an int64 tensor that broadcasts against the seeds
    (one counter a row)."""
    seeds = as_u32(seeds)
    cnt = _mul32(torch.as_tensor(counter, dtype=torch.int64) & _M32, GOLD)
    base = mix32(seeds ^ cnt.to(seeds.device))  # (rows,)
    col = _mul32(torch.arange(cols, dtype=torch.int64, device=seeds.device), COLC)
    return mix32(base[:, None] ^ col[None, :])


def int32_seed(seed) -> int:
    """An integer seed (Python int or one-element tensor) as the int32 with
    the same low 32 bits, the value a kernel's C `int` argument carries."""
    s = int(seed) & _M32
    return s - (1 << 32) if s >= (1 << 31) else s


def stream_row_seeds(seed: int, b: int, device=None, row_base: int = 0) -> torch.Tensor:
    """(b,) uint32 row seeds (as int64) of stream mode for the int32 `seed`:
    row i gets fmix32(seed ^ (row_base + i) * ROWC), as `stream_row_seed`
    in `csrc/counter_noise.cuh`. Row i's seed does not depend on b, and
    the b rows from `row_base` on are rows row_base .. row_base + b - 1 of
    any longer batch: a rank's slice of a sharded batch draws what the
    unsharded launch draws for those rows."""
    rows = torch.arange(row_base, row_base + b, dtype=torch.int64, device=device)
    return mix32((int(seed) & _M32) ^ _mul32(rows, ROWC))


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
