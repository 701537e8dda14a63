// K2: the whole n-step DAMC reverse-diffusion sweep in one launch.
//
// Replaces the TPU kernel damc_tpu/ops/pallas/fused_qsweep.py::_kernel
// (pallas_call in fused_reverse_sweep, :344), counter-noise mode. Each step
// evaluates the 7-layer FiLM U-Net denoiser of models/denoiser.py from the
// hoisted tables, then takes one ancestral step:
//   emb  = [sin 2pi t, cos 2pi t, z], t = zB - rint(zB)   (exact reduction)
//   per layer: c = silu(pre_t[step] + pre_x), gate = sigmoid(c G + g),
//              out = (h L + l) * gate + c H + h S + s
//   3 in layers (skip pushed before the LeakyReLU 0.01), 1 mid, 3 out layers
//   on [h, skip] concatenations (activation after the concat); residual z +.
//   x_hat = c1 z - c2 eps; z <- m_z z + m_x x_hat + std N; the last step
//   returns x_hat.
//
// Bound on an H100: operations. At the CIFAR-10 widths a step costs
// 1.48 M multiply-adds per row against 5.9 MB of weights read once per
// call; at B=16 and 100 steps that is 4.7 GFLOP against about 6.5 MB, so
// the fp32 CUDA-core rate bounds it.
//
// Design: the TPU kernel kept all 5.9 MB of weights in VMEM. A Hopper block
// has 227 KB of shared memory, so here each block owns kRows rows for every
// step and keeps only their activations in shared memory (z, the layer
// input up to 2 x wide, the context c, the output and the three skips:
// 57 KB at kRows=8); the weights are read from L2 (5.9 MB stays resident
// in the 50 MB L2) once per block and step and reused for all kRows rows.
// Each thread owns one output column of a layer and sums its four products
// sequentially over the input, weights coalesced across the warp and
// activations broadcast as float4 from shared memory. Every row runs the
// same instruction sequence whatever its position, so a row's result does
// not depend on the other rows. fp32 FMA on the CUDA cores: TF32 would break
// the 2e-4 parity with the fp32 reference. At B=16 only two blocks run;
// spreading a layer's columns over a cluster is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

namespace {

constexpr int kRows = 8;  // rows per block
constexpr int kThreads = 256;
constexpr int kLayers = 7;
constexpr float kSlope = 0.01f;
constexpr float kTwoPi = 6.2831854820251465f;  // float32(2 pi)

struct SweepArgs {
  const float* lin_k[kLayers];  // (din, dout)
  const float* lin_b[kLayers];
  const float* skip_k[kLayers];  // (din, dout)
  const float* skip_b[kLayers];
  const float* gate_k[kLayers];  // (dout, dout)
  const float* gate_b[kLayers];
  const float* hyper_k[kLayers];  // (dout, dout)
  int din[kLayers];
  int dout[kLayers];
  int ctx_off[kLayers];  // column offset of the layer in pre_x / pre_t
  int ctx_total;
  int in_max;
  int d_max;
};

__device__ __forceinline__ float act(float x) { return x >= 0.f ? x : kSlope * x; }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// acc[r] += sum_k x[r][k] * W[k][j] for k < n (n % 4 == 0), sequential in k.
__device__ __forceinline__ void dot_col(const float* __restrict__ w, int ld, int j,
                                        const float* x, int xs, int n, float* acc) {
  for (int k = 0; k < n; k += 4) {
    const float w0 = __ldg(w + (size_t)(k + 0) * ld + j);
    const float w1 = __ldg(w + (size_t)(k + 1) * ld + j);
    const float w2 = __ldg(w + (size_t)(k + 2) * ld + j);
    const float w3 = __ldg(w + (size_t)(k + 3) * ld + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(x + r * xs + k);
      acc[r] = fmaf(v.x, w0, acc[r]);
      acc[r] = fmaf(v.y, w1, acc[r]);
      acc[r] = fmaf(v.z, w2, acc[r]);
      acc[r] = fmaf(v.w, w3, acc[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) reverse_sweep_kernel(
    const float* __restrict__ z_in, const float* __restrict__ fourier,
    const float* __restrict__ pre_x, const float* __restrict__ pre_t,
    const float* __restrict__ coeffs, const int* __restrict__ seeds, float* __restrict__ z_out,
    const SweepArgs a, int B, int nz, int nfour, int steps, int residual) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);  // kRows x nz
  float* in = zs + kRows * nz;                  // kRows x in_max: layer input
  float* cb = in + kRows * a.in_max;            // kRows x d_max: context c
  float* ob = cb + kRows * a.d_max;             // kRows x d_max: layer output
  float* skip[3];                               // kRows x dout[l], l < 3
  skip[0] = ob + kRows * a.d_max;
  skip[1] = skip[0] + kRows * a.dout[0];
  skip[2] = skip[1] + kRows * a.dout[1];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  for (int e = tid; e < kRows * nz; e += kThreads) {
    const int r = e / nz;
    zs[e] = r < nrows ? z_in[(size_t)row0 * nz + e] : 0.f;  // ragged tile: zero rows
  }

  for (int step = 0; step < steps; ++step) {
    for (int l = 0; l < kLayers; ++l) {
      __syncthreads();
      // Phase A: this layer's input and context.
      if (l == 0) {
        for (int e = tid; e < kRows * nfour; e += kThreads) {
          const int r = e / nfour, f = e - r * nfour;
          float t = 0.f;
          for (int k = 0; k < nz; ++k) t = fmaf(zs[r * nz + k], __ldg(fourier + k * nfour + f), t);
          t = t - rintf(t);  // sin(2 pi t) has period 1 in t: reduce exactly
          const float proj = kTwoPi * t;
          in[r * a.in_max + f] = sinf(proj);
          in[r * a.in_max + nfour + f] = cosf(proj);
        }
        for (int e = tid; e < kRows * nz; e += kThreads) {
          const int r = e / nz, k = e - r * nz;
          in[r * a.in_max + 2 * nfour + k] = zs[e];
        }
      } else {
        // U-Net glue after layer p = l - 1: in layers feed their own
        // (activated) output on; out layers take [output, popped skip].
        const int p = l - 1;
        const int dp = a.dout[p];
        const float* src = p < 3 ? skip[p] : ob;
        const int src_ld = p < 3 ? dp : a.d_max;
        for (int e = tid; e < kRows * dp; e += kThreads) {
          const int r = e / dp, j = e - r * dp;
          in[r * a.in_max + j] = act(src[r * src_ld + j]);
        }
        if (p >= 3) {
          const int q = 5 - p;  // mid -> skip 2, out0 -> skip 1, out1 -> skip 0
          const int dq = a.dout[q];
          for (int e = tid; e < kRows * dq; e += kThreads) {
            const int r = e / dq, j = e - r * dq;
            in[r * a.in_max + dp + j] = act(skip[q][r * dq + j]);
          }
        }
      }
      const int dout = a.dout[l];
      const float* pt = pre_t + (size_t)step * a.ctx_total + a.ctx_off[l];
      for (int e = tid; e < kRows * dout; e += kThreads) {
        const int r = e / dout, j = e - r * dout;
        float pre = __ldg(pt + j);
        if (r < nrows) pre += __ldg(pre_x + (size_t)(row0 + r) * a.ctx_total + a.ctx_off[l] + j);
        cb[r * a.d_max + j] = pre * sigmoid(pre);  // silu
      }
      __syncthreads();
      // Phase B: out = (h L + l) * sigmoid(c G + g) + c H + h S + s.
      float* dst = l < 3 ? skip[l] : ob;
      const int dst_ld = l < 3 ? dout : a.d_max;
      for (int j = tid; j < dout; j += kThreads) {
        float ag[kRows] = {}, ah[kRows] = {}, al[kRows] = {}, as[kRows] = {};
        dot_col(a.gate_k[l], dout, j, cb, a.d_max, dout, ag);
        dot_col(a.hyper_k[l], dout, j, cb, a.d_max, dout, ah);
        dot_col(a.lin_k[l], dout, j, in, a.in_max, a.din[l], al);
        dot_col(a.skip_k[l], dout, j, in, a.in_max, a.din[l], as);
        const float gb = __ldg(a.gate_b[l] + j), lb = __ldg(a.lin_b[l] + j);
        const float sb = __ldg(a.skip_b[l] + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float gate = sigmoid(ag[r] + gb);
          dst[r * dst_ld + j] = (al[r] + lb) * gate + ah[r] + as[r] + sb;
        }
      }
    }
    __syncthreads();
    // Ancestral step; ob holds the last layer's output (eps before the residual).
    const float* cf = coeffs + step * 6;
    const float c1 = __ldg(cf + 0), c2 = __ldg(cf + 1), m_z = __ldg(cf + 2);
    const float m_x = __ldg(cf + 3), std_ = __ldg(cf + 4);
    const bool is_last = __ldg(cf + 5) > 0.5f;
    for (int e = tid; e < kRows * nz; e += kThreads) {
      const int r = e / nz, c = e - r * nz;
      const float z = zs[e];
      const float eps = residual ? z + ob[r * a.d_max + c] : ob[r * a.d_max + c];
      const float x_pred = c1 * z - c2 * eps;
      float z_next = m_z * z + m_x * x_pred;
      if (!is_last && seeds != nullptr && r < nrows)
        z_next += std_ * damc::counter_normal((uint32_t)seeds[row0 + r], step, c);
      zs[e] = is_last ? x_pred : z_next;
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * nz; e += kThreads) z_out[(size_t)row0 * nz + e] = zs[e];
}

}  // namespace

DAMC_ERROR_STRING_EXPORT

extern "C" int damc_fused_qsweep_rows() { return kRows; }

extern "C" int damc_fused_qsweep_layers() { return kLayers; }

// dims = [din[0..6], dout[0..6]]; layer_ptrs = per layer, in order:
// lin_k, lin_b, skip_k, skip_b, gate_k, gate_b, hyper_k. pre_x (B, sum dout)
// and pre_t (steps, sum dout) hold the layers' columns side by side.
// seeds: per-row int32 counter seeds, or NULL for a noiseless sweep.
extern "C" int damc_fused_qsweep(const float* z, const float* fourier, const void* const* layer_ptrs,
                                 const int* dims, const float* pre_x, const float* pre_t,
                                 const float* coeffs, const int* seeds, float* out, int B, int nz,
                                 int nfour, int steps, int residual, int smem_bytes, void* stream) {
  SweepArgs a;
  int off = 0;
  a.in_max = 0;
  a.d_max = 0;
  for (int l = 0; l < kLayers; ++l) {
    const void* const* p = layer_ptrs + 7 * l;
    a.lin_k[l] = static_cast<const float*>(p[0]);
    a.lin_b[l] = static_cast<const float*>(p[1]);
    a.skip_k[l] = static_cast<const float*>(p[2]);
    a.skip_b[l] = static_cast<const float*>(p[3]);
    a.gate_k[l] = static_cast<const float*>(p[4]);
    a.gate_b[l] = static_cast<const float*>(p[5]);
    a.hyper_k[l] = static_cast<const float*>(p[6]);
    a.din[l] = dims[l];
    a.dout[l] = dims[kLayers + l];
    a.ctx_off[l] = off;
    off += a.dout[l];
    a.in_max = a.din[l] > a.in_max ? a.din[l] : a.in_max;
    a.d_max = a.dout[l] > a.d_max ? a.dout[l] : a.d_max;
  }
  a.ctx_total = off;
  cudaError_t err = cudaFuncSetAttribute(reverse_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kRows - 1) / kRows;
  reverse_sweep_kernel<<<blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      z, fourier, pre_x, pre_t, coeffs, seeds, out, a, B, nz, nfour, steps, residual);
  return (int)cudaGetLastError();
}
