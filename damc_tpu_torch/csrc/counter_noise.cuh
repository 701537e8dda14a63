// Counter-based Gaussian noise (K0), shared by the Langevin and sweep kernels.
//
// Replaces the counter helpers of damc_tpu/ops/pallas/fused_langevin.py
// (_mix32, _counter_bits, _counter_normal, :127-159). Element (row, col) at
// chain step s is r * cos(2 pi u2) with r = sqrt(-2 ln u1), where
//   u_k  = (bits_k >> 8) * 2^-24 + 2^-25,
//   bits = fmix32(fmix32(seed ^ c * 0x9E3779B9) ^ col * 0x85EBCA77),
// c = 2s for u1 and 2s + 1 for u2, all in uint32 arithmetic. The bits equal
// the JAX kernel's and damc_tpu_torch/ops/noise.py's bit for bit; logf,
// sqrtf and cosf (full precision, no fast-math) may differ by an ulp.
//
// Stream mode (one scalar seed for a whole launch) draws from the same
// counter stream, with row i's seed fmix32(seed ^ i * 0x27D4EB2F)
// (`stream_row_seed`, equal to ops/noise.py::stream_row_seeds); i is the
// global row, row_base + the row of the launch, so a rank's launch on its
// rows of a sharded batch draws what one unsharded launch draws. The TPU
// kernels instead seed the on-core PRNG once per grid block
// (pltpu.prng_seed(seed + program_id)), whose bits no GPU can give: here a
// row's noise depends on (seed, row) and not on how rows are cut into
// blocks. The distribution is the same; the draws are not.
#pragma once

#include <stdint.h>

namespace damc {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t seed, uint32_t counter, uint32_t col) {
  const uint32_t base = mix32(seed ^ (counter * 0x9E3779B9u));
  return mix32(base ^ (col * 0x85EBCA77u));
}

// Odd Weyl multiplier of the row index in stream mode, distinct from the
// draw-counter (0x9E3779B9) and column (0x85EBCA77) multipliers.
constexpr uint32_t kStreamRowMul = 0x27D4EB2Fu;

__device__ __forceinline__ uint32_t stream_row_seed(uint32_t seed, uint32_t row) {
  return mix32(seed ^ (row * kStreamRowMul));
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  // top24 * 2^-24 is exact, so contracting the add into an FMA changes nothing.
  return __fadd_rn(__fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f), 0.5f / 16777216.0f);
}

__device__ __forceinline__ float counter_normal(uint32_t seed, int step, int col) {
  const float u1 = uniform_from_bits(counter_bits(seed, 2u * (uint32_t)step, (uint32_t)col));
  const float u2 = uniform_from_bits(counter_bits(seed, 2u * (uint32_t)step + 1u, (uint32_t)col));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831854820251465f, u2)));
}

}  // namespace damc

// The C entry points of every kernel library share this error reporter.
#define DAMC_ERROR_STRING_EXPORT                                   \
  extern "C" const char* damc_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
