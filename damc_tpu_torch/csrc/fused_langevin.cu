// K1: the whole K-step prior-Langevin chain in one launch.
//
// Replaces the TPU kernel damc_tpu/ops/pallas/fused_langevin.py::_kernel
// (pallas_call in fused_prior_langevin, :311), counter-noise mode. Each step
//   z <- z - 0.5 eps^2 (dE/dz + z) + eps * N,
// for the energy MLP E(z) = k3 . lrelu(lrelu(z K1 + b1) K2 + b2) (slope
// 0.2), with the gradient derived by hand (no autodiff residuals):
//   h1p = z K1 + b1, h2p = lrelu(h1p) K2 + b2, d2 = lrelu'(h2p) * k3,
//   d1 = lrelu'(h1p) * (d2 K2^T), dE/dz = d1 K1^T.
//
// Bound on an H100: operations. Per chain and step the four products are
// 2 nz ndf + 2 ndf^2 multiply-adds (131,200 at nz=128, ndf=200), while the
// bytes the chain must move are z in and out plus the 262 KB of weights,
// once. At B=16, 60 steps that is 0.25 GFLOP against 0.3 MB: the fp32
// CUDA-core rate bounds it.
//
// Design: the TPU kernel kept every weight on chip for the whole chain. The
// fp32 weights (262 KB) exceed a block's 227 KB of shared memory, so K2
// (ndf x ndf, 160 KB) lives in shared memory for the whole chain and K1
// (nz x ndf) is read through L1/L2 each step (it stays L2-resident). One
// block owns kRows chains for all steps and keeps their z, h1p, h1, d2, d1
// and gradient in shared memory; blocks never talk to each other. Forward
// products give each thread one output column and a sequential sum over
// the input (coalesced weight rows, activations broadcast from shared
// memory); the two transposed products give each warp one output and its
// lanes the input, summed with a fixed shuffle tree. Every chain runs the
// same instruction sequence whatever its position, so a chain's result
// does not depend on the other chains in the launch. fp32 FMA on the CUDA
// cores throughout; speed (tensor cores, more chains per weight read) is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

namespace {

constexpr int kRows = 4;  // chains per block
constexpr int kThreads = 256;
constexpr float kSlope = 0.2f;

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : kSlope * x; }
__device__ __forceinline__ float dlrelu(float x) { return x >= 0.f ? 1.f : kSlope; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // complete in lane 0
}

__global__ void __launch_bounds__(kThreads) prior_langevin_kernel(
    const float* __restrict__ z_in, const float* __restrict__ k1, const float* __restrict__ b1,
    const float* __restrict__ k2, const float* __restrict__ b2, const float* __restrict__ k3,
    const int* __restrict__ seeds, float* __restrict__ z_out, int B, int nz, int ndf, int steps,
    float step_size, float coeff) {
  extern __shared__ float smem[];
  float* k2s = smem;              // ndf * ndf
  float* zs = k2s + ndf * ndf;    // kRows * nz
  float* gs = zs + kRows * nz;    // kRows * nz: dU/dz
  float* h1p = gs + kRows * nz;   // kRows * ndf
  float* h1 = h1p + kRows * ndf;  // kRows * ndf
  float* d2 = h1 + kRows * ndf;   // kRows * ndf
  float* d1 = d2 + kRows * ndf;   // kRows * ndf

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  for (int i = tid; i < ndf * ndf; i += blockDim.x) k2s[i] = k2[i];
  for (int e = tid; e < kRows * nz; e += blockDim.x) {
    const int r = e / nz;
    zs[e] = r < nrows ? z_in[(size_t)row0 * nz + e] : 0.f;  // ragged tile: zero rows
  }

  for (int s = 0; s < steps; ++s) {
    __syncthreads();
    // h1p = z K1 + b1
    for (int j = tid; j < ndf; j += blockDim.x) {
      float acc[kRows] = {};
      for (int k = 0; k < nz; ++k) {
        const float w = __ldg(&k1[k * ndf + j]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(zs[r * nz + k], w, acc[r]);
      }
      const float b = b1[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = acc[r] + b;
        h1p[r * ndf + j] = v;
        h1[r * ndf + j] = lrelu(v);
      }
    }
    __syncthreads();
    // h2p = h1 K2 + b2; d2 = lrelu'(h2p) * k3
    for (int j = tid; j < ndf; j += blockDim.x) {
      float acc[kRows] = {};
      for (int k = 0; k < ndf; ++k) {
        const float w = k2s[k * ndf + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h1[r * ndf + k], w, acc[r]);
      }
      const float b = b2[j], head = k3[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) d2[r * ndf + j] = dlrelu(acc[r] + b) * head;
    }
    __syncthreads();
    // d1 = lrelu'(h1p) * (d2 K2^T)
    for (int i = warp; i < ndf; i += nwarps) {
      float acc[kRows] = {};
      for (int j = lane; j < ndf; j += 32) {
        const float w = k2s[i * ndf + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(d2[r * ndf + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = warp_sum(acc[r]);
        if (lane == 0) d1[r * ndf + i] = dlrelu(h1p[r * ndf + i]) * v;
      }
    }
    __syncthreads();
    // dU/dz = d1 K1^T + z
    for (int i = warp; i < nz; i += nwarps) {
      float acc[kRows] = {};
      for (int j = lane; j < ndf; j += 32) {
        const float w = __ldg(&k1[i * ndf + j]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(d1[r * ndf + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = warp_sum(acc[r]);
        if (lane == 0) gs[r * nz + i] = v + zs[r * nz + i];
      }
    }
    __syncthreads();
    // z <- z - coeff * grad (+ eps * N)
    for (int e = tid; e < kRows * nz; e += blockDim.x) {
      const int r = e / nz, c = e - r * nz;
      float z = zs[e] - coeff * gs[e];
      if (seeds != nullptr && r < nrows)
        z += step_size * damc::counter_normal((uint32_t)seeds[row0 + r], s, c);
      zs[e] = z;
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * nz; e += blockDim.x) z_out[(size_t)row0 * nz + e] = zs[e];
}

}  // namespace

DAMC_ERROR_STRING_EXPORT

extern "C" int damc_fused_langevin_rows() { return kRows; }

extern "C" int damc_fused_langevin_smem_bytes(int nz, int ndf) {
  return (int)sizeof(float) * (ndf * ndf + kRows * (2 * nz + 4 * ndf));
}

// seeds: per-chain int32 counter seeds, or NULL for a noiseless chain.
extern "C" int damc_fused_langevin(const float* z, const float* k1, const float* b1, const float* k2,
                                   const float* b2, const float* k3, const int* seeds, float* out,
                                   int B, int nz, int ndf, int steps, float step_size, float coeff,
                                   void* stream) {
  const int smem = damc_fused_langevin_smem_bytes(nz, ndf);
  cudaError_t err = cudaFuncSetAttribute(prior_langevin_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kRows - 1) / kRows;
  prior_langevin_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      z, k1, b1, k2, b2, k3, seeds, out, B, nz, ndf, steps, step_size, coeff);
  return (int)cudaGetLastError();
}
