// K1: the whole K-step prior-Langevin chain in one launch.
//
// Replaces the TPU kernel damc_tpu/ops/pallas/fused_langevin.py::_kernel
// (pallas_call in fused_prior_langevin, :311), in its three noise modes:
// counter (per-row int32 seeds, serving), stream (one int32 seed for the
// launch, training; row seeds from counter_noise.cuh::stream_row_seed) and
// noiseless. Each step
//   z <- z - 0.5 eps^2 (dE/dz + z) + eps * N,
// for the energy MLP E(z) = k3 . lrelu(lrelu(z K1 + b1) K2 + b2) (slope
// 0.2), with the gradient derived by hand (no autodiff residuals):
//   h1p = z K1 + b1, h2p = lrelu(h1p) K2 + b2, d2 = lrelu'(h2p) * k3,
//   d1 = lrelu'(h1p) * (d2 K2^T), dE/dz = d1 K1^T.
//
// Bound on an H100: operations. Per chain and step the four products are
// 2 nz ndf + 2 ndf^2 multiply-adds (131,200 at nz=128, ndf=200), while the
// bytes the chain must move are z in and out plus the 262 KB of weights,
// once. At B=16, 60 steps that is 0.25 GFLOP against 0.3 MB, and at the
// training shape (B=256) 4.0 GFLOP against 0.5 MB: the fp32 CUDA-core rate
// bounds it (0.0038 and 0.060 ms).
//
// What held the first kernel back (2.9 ms at every batch on an H100 80GB
// HBM3 at 700 W, about 48 us a step for 4 chains a block): the fp32
// weights (262 KB) exceed a block's 227 KB of shared memory, so it kept the
// EBM's K2 there and read K1
// (100 KB) through L2 twice a step, in loops whose every iteration waited on
// an L2 round trip; the two transposed products gave each warp one output
// at a time and reduced it through shuffle trees; and at 4 chains a block
// only ceil(B / 4) SMs worked.
//
// Design: a thread-block cluster of kCluster = 4 blocks owns kRows = 8
// chains for all steps and holds both weight matrices in shared memory,
// split by the hidden column: block `rank` keeps K1[:, J] and K2[:, J] for
// its J = ndf / 4 columns (67 KB at the CIFAR-10 widths, zero-padded to a
// multiple of 4, at a row stride of 4 x odd floats so that both a walk down
// a column and 128-bit reads along the rows of a warp's lanes hit distinct
// banks). The forward products give its own columns of h1p and h2p, each a
// sum over the input in order. The transposed products use the same column
// slices: the block sums d2 K2^T and d1 K1^T over its own J only, for every
// output, and the cluster adds the 4 partial sums in rank order. Three
// cluster barriers a step: after lrelu(h1p) (every block then gathers all
// of h1 through distributed shared memory), after the d1 partials, and
// after the gradient partials; the z update and its noise run in every
// block on the same values, so each block holds the whole z. Activations
// are read as float4 along the input, 2 chains a thread. Every output
// element is summed in an order fixed by (nz, ndf, kCluster), never by B or
// by the chain's place in the cluster, so a chain's result is the same bit
// for bit in any batch. No atomics, no global memory inside the step. fp32
// FMA on the CUDA cores throughout.
//
// What set the first kernel's 48 us a step, from chip_smoke.py's kernel
// phase on successive versions (H100 80GB HBM3, 700 W, B=16): keeping both
// matrices on chip over a cluster, with no L2 access and no shuffle tree in
// the step, took 2.86 ms to 1.01 ms; issuing a dot's loads eight at a time
// to 0.96 ms; float4 activation and weight-row reads to 0.77 ms. The rest
// is the three barriers and gathers a step and the dependent chains of the
// sums (PERF.md, section 6).
//
// The bf16-dot variant (kBf16Dots; the TPU kernel's dots_dtype="bfloat16",
// damc_tpu/ops/pallas/fused_langevin.py:184-212): the four products take
// bfloat16 operands and accumulate in fp32. Each weight is rounded to bf16
// once, as it is loaded to shared memory; each activation operand (z, the
// gathered lrelu(h1p), d2, d1) is rounded as it enters a product: z as it
// is read, the other three where they are stored, since nothing else reads
// them. Rounding is round-to-nearest-even (__float2bfloat16_rn), as JAX's
// astype; the rounded values are kept as floats, so a product of two is
// exact in fp32 and the FMAs, the layout and the summation order are the
// fp32 variant's. The biases, lrelu and its derivative, k3, the + z term,
// the chain state and the noise stay fp32. The fp32 variant (kBf16Dots
// false) compiles to the same code as before the variant existed. Its bound
// on an H100 is the same operations at the bf16 tensor-core rate (989
// TFLOP/s): 0.0041 ms at B=256, nz=128, 60 steps. This first version runs
// them on the CUDA cores as the fp32 variant does, so it takes about that
// variant's time; tensor-core products (mma.sync) are later work.
//
// Every width of the 2-hidden EBM, as the TPU kernel takes (it pads only
// the batch). The wrapper (ops/cuda/fused_langevin.py::launch_widths) pads
// nz to a multiple of 4 and ndf to one of kCluster with zero weights and
// zero z columns, and slices the padding off the result: a zero weight
// adds an exact zero to every sum, at its end, so the real columns are
// what the unpadded widths would give, and a column's noise depends on its
// index alone. Where a block's slices do not fit its shared memory (ndf =
// 512 at nz = 128: 386 KB), the kSmemWeights = false variant reads them
// from global memory, where L2 keeps them (1.3 MB at that width), ndf
// padded to a multiple of 4 kCluster; its summation order is the same
// walk, fixed by the padded widths.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;     // chains per cluster
constexpr int kCluster = 4;  // blocks per cluster, each holding ndf / kCluster hidden columns
constexpr int kThreads = 256;
constexpr int kRt = 2;  // chains per thread in the products
constexpr int kGroups = kRows / kRt;
constexpr float kSlope = 0.2f;

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : kSlope * x; }
__device__ __forceinline__ float dlrelu(float x) { return x >= 0.f ? 1.f : kSlope; }

// A product operand: x rounded to the nearest bfloat16 in the bf16-dot
// variant, x itself in the fp32 one.
template <bool kBf16Dots>
__device__ __forceinline__ float operand(float x) {
  return kBf16Dots ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// J = ndf / kCluster hidden columns a block holds, padded with zeros to
// j4 (a multiple of 4, for float4 reads); its weight slices have row stride
// slice_ld: a multiple of 4 whose quarter is odd, so that 128-bit reads of
// consecutive rows by the lanes of a warp hit distinct banks.
__host__ __device__ inline int pad4(int J) { return (J + 3) / 4 * 4; }
__host__ __device__ inline int slice_ld(int J) {
  const int j4 = pad4(J);
  return (j4 / 4) % 2 ? j4 : j4 + 4;
}

// acc[r] = sum_k x[r][k] w[k * ld], k < n (n % 4 == 0), in order of k: a
// walk down a weight column, kRt chains at x (row stride x_ld); with
// kRoundX each x, with kRoundW each w, is rounded to bf16 as it is read.
template <bool kRoundX, bool kRoundW>
__device__ __forceinline__ void dot_col(const float* w, int ld, const float* x, int x_ld, int n,
                                        float* acc) {
#pragma unroll 4
  for (int k = 0; k < n; k += 4) {
    const float w0 = operand<kRoundW>(w[(k + 0) * ld]), w1 = operand<kRoundW>(w[(k + 1) * ld]);
    const float w2 = operand<kRoundW>(w[(k + 2) * ld]), w3 = operand<kRoundW>(w[(k + 3) * ld]);
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(x + r * x_ld + k);
      acc[r] = fmaf(operand<kRoundX>(v.x), w0, acc[r]);
      acc[r] = fmaf(operand<kRoundX>(v.y), w1, acc[r]);
      acc[r] = fmaf(operand<kRoundX>(v.z), w2, acc[r]);
      acc[r] = fmaf(operand<kRoundX>(v.w), w3, acc[r]);
    }
  }
}

// acc[r] = sum_k x[r][k] w[k], k < n (n % 4 == 0), in order of k: a walk
// along a weight row; with kRoundW each w is rounded to bf16 as it is read.
template <bool kRoundW>
__device__ __forceinline__ void dot_row(const float* w, const float* x, int x_ld, int n,
                                        float* acc) {
#pragma unroll 4
  for (int k = 0; k < n; k += 4) {
    float4 wk = *reinterpret_cast<const float4*>(w + k);
    wk = make_float4(operand<kRoundW>(wk.x), operand<kRoundW>(wk.y), operand<kRoundW>(wk.z),
                     operand<kRoundW>(wk.w));
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(x + r * x_ld + k);
      acc[r] = fmaf(v.x, wk.x, acc[r]);
      acc[r] = fmaf(v.y, wk.y, acc[r]);
      acc[r] = fmaf(v.z, wk.z, acc[r]);
      acc[r] = fmaf(v.w, wk.w, acc[r]);
    }
  }
}

// kSmemWeights: the block holds its slices of K1 and K2 in shared memory
// (as set out above); else it reads them where they lie in global memory
// (through L1 and L2), its J columns at row stride ndf, and shared memory
// holds the activations alone. That variant serves the widths whose slices
// do not fit (ndf = 512 at nz = 128 needs 386 KB a block); it needs J % 4
// == 0, so that the slices need no zero padding and their rows stay
// 16-byte aligned, and the bf16-dot variant rounds each weight as it is read.
template <bool kBf16Dots, bool kSmemWeights>
__global__ void __launch_bounds__(kThreads, 2) prior_langevin_kernel(
    const float* __restrict__ z_in, const float* __restrict__ k1, const float* __restrict__ b1,
    const float* __restrict__ k2, const float* __restrict__ b2, const float* __restrict__ k3,
    const int* __restrict__ seeds, int seed, int stream_noise, int row_base,
    float* __restrict__ z_out, int B, int nz, int ndf, int steps, float step_size, float coeff) {
  constexpr bool kRoundW = kBf16Dots && !kSmemWeights;  // shared-memory slices are rounded as loaded
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int J = ndf / kCluster, j4 = pad4(J), j0 = rank * J;
  const int ld = kSmemWeights ? slice_ld(J) : ndf;
  extern __shared__ float4 smem4[];
  __shared__ uint32_t row_seed[kRows];
  float* k1s = reinterpret_cast<float*>(smem4);  // nz x ld: K1[:, j0:j0+J], zero past J
  float* k2s = k1s + nz * ld;                    // ndf x ld: K2[:, j0:j0+J], zero past J
  const float* k1w = kSmemWeights ? k1s : k1 + j0;  // the block's slices, where it reads them
  const float* k2w = kSmemWeights ? k2s : k2 + j0;
  float* zs = kSmemWeights ? k2s + ndf * ld : k1s;  // kRows x nz: the whole z, in every block
  float* h1 = zs + kRows * nz;    // kRows x ndf: lrelu(h1p), gathered from the cluster
  float* xd1 = h1 + kRows * ndf;  // kRows x ndf: d2 K2^T summed over own columns
  float* xg = xd1 + kRows * ndf;  // kRows x nz: d1 K1^T summed over own columns
  float* d2 = xg + kRows * nz;    // kRows x j4, own columns, zero past J
  float* d1 = d2 + kRows * j4;    // kRows x j4, own columns, zero past J
  float* h1p = d1 + kRows * j4;   // kRows x J, own columns
  float* xh1 = h1p + kRows * J;   // kRows x J: own lrelu(h1p), read by the cluster

  const int tid = threadIdx.x;
  const int row0 = (int)(blockIdx.x / kCluster) * kRows;
  const int nrows = min(kRows, B - row0);

  const bool noisy = seeds != nullptr || stream_noise;
  if (tid < nrows)
    row_seed[tid] = seeds != nullptr
                        ? (uint32_t)seeds[row0 + tid]
                        : damc::stream_row_seed((uint32_t)seed, (uint32_t)(row_base + row0 + tid));
  if (kSmemWeights) {
    for (int e = tid; e < nz * ld; e += kThreads) {
      const int k = e / ld, j = e - k * ld;
      k1s[e] = j < J ? operand<kBf16Dots>(k1[(size_t)k * ndf + j0 + j]) : 0.f;
    }
    for (int e = tid; e < ndf * ld; e += kThreads) {
      const int i = e / ld, j = e - i * ld;
      k2s[e] = j < J ? operand<kBf16Dots>(k2[(size_t)i * ndf + j0 + j]) : 0.f;
    }
  }
  for (int e = tid; e < 2 * kRows * j4; e += kThreads) d2[e] = 0.f;  // d2 and d1
  for (int e = tid; e < kRows * nz; e += kThreads) {
    const int r = e / nz;
    zs[e] = r < nrows ? z_in[(size_t)row0 * nz + e] : 0.f;  // ragged tile: zero rows
  }

  for (int s = 0; s < steps; ++s) {
    __syncthreads();
    // h1p = z K1 + b1, own columns.
    for (int t = tid; t < J * kGroups; t += kThreads) {
      const int j = t % J, r0 = (t / J) * kRt;
      float acc[kRt] = {};
      dot_col<kBf16Dots, kRoundW>(k1w + j, ld, zs + r0 * nz, nz, nz, acc);
      const float b = __ldg(b1 + j0 + j);
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        const float v = acc[r] + b;
        h1p[(r0 + r) * J + j] = v;
        xh1[(r0 + r) * J + j] = operand<kBf16Dots>(lrelu(v));
      }
    }
    cluster.sync();
    // All of lrelu(h1p), from the cluster.
#pragma unroll 4
    for (int e = tid; e < kRows * ndf; e += kThreads) {
      const int r = e / ndf, i = e - r * ndf, c = i / J;
      h1[e] = cluster.map_shared_rank(xh1, c)[r * J + (i - c * J)];
    }
    __syncthreads();
    // d2 = lrelu'(h1 K2 + b2) * k3, own columns.
    for (int t = tid; t < J * kGroups; t += kThreads) {
      const int j = t % J, r0 = (t / J) * kRt;
      float acc[kRt] = {};
      dot_col<false, kRoundW>(k2w + j, ld, h1 + r0 * ndf, ndf, ndf, acc);  // h1 was rounded where stored
      const float b = __ldg(b2 + j0 + j), head = __ldg(k3 + j0 + j);
#pragma unroll
      for (int r = 0; r < kRt; ++r)
        d2[(r0 + r) * j4 + j] = operand<kBf16Dots>(dlrelu(acc[r] + b) * head);
    }
    __syncthreads();
    // d2 K2^T over own columns, every output.
    for (int t = tid; t < ndf * kGroups; t += kThreads) {
      const int i = t % ndf, r0 = (t / ndf) * kRt;
      float acc[kRt] = {};
      dot_row<kRoundW>(k2w + (size_t)i * ld, d2 + r0 * j4, j4, j4, acc);
#pragma unroll
      for (int r = 0; r < kRt; ++r) xd1[(r0 + r) * ndf + i] = acc[r];
    }
    cluster.sync();
    // d1 = lrelu'(h1p) * (d2 K2^T), own columns: the cluster's partials in rank order.
    for (int e = tid; e < kRows * J; e += kThreads) {
      const int r = e / J, j = e - r * J;
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < kCluster; ++c) v += cluster.map_shared_rank(xd1, c)[r * ndf + j0 + j];
      d1[r * j4 + j] = operand<kBf16Dots>(dlrelu(h1p[e]) * v);
    }
    __syncthreads();
    // d1 K1^T over own columns, every output.
    for (int t = tid; t < nz * kGroups; t += kThreads) {
      const int m = t % nz, r0 = (t / nz) * kRt;
      float acc[kRt] = {};
      dot_row<kRoundW>(k1w + (size_t)m * ld, d1 + r0 * j4, j4, j4, acc);
#pragma unroll
      for (int r = 0; r < kRt; ++r) xg[(r0 + r) * nz + m] = acc[r];
    }
    cluster.sync();
    // z <- z - coeff * (d1 K1^T + z) (+ eps * N), every column, in every block.
    for (int e = tid; e < kRows * nz; e += kThreads) {
      const int r = e / nz, m = e - r * nz;
      float g = 0.f;
#pragma unroll
      for (int c = 0; c < kCluster; ++c) g += cluster.map_shared_rank(xg, c)[e];
      float z = zs[e] - coeff * (g + zs[e]);
      if (noisy && r < nrows) z += step_size * damc::counter_normal(row_seed[r], s, m);
      zs[e] = z;
    }
  }
  cluster.sync();  // no block leaves while another may still read its partials
  if (rank == 0)
    for (int e = tid; e < nrows * nz; e += kThreads) z_out[(size_t)row0 * nz + e] = zs[e];
}

int smem_bytes(int nz, int ndf, bool smem_weights) {
  const int J = ndf / kCluster;
  return (int)sizeof(float) * ((smem_weights ? (nz + ndf) * slice_ld(J) : 0) +
                               kRows * (2 * nz + 2 * ndf + 2 * pad4(J) + 2 * J));
}

cudaLaunchConfig_t launch_config(int clusters, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kBf16Dots, bool kSmemWeights>
int launch(const float* z, const float* k1, const float* b1, const float* k2, const float* b2,
           const float* k3, const int* seeds, int seed, int stream_noise, int row_base, float* out,
           int B, int nz, int ndf, int steps, float step_size, float coeff, cudaStream_t stream) {
  const auto kernel = prior_langevin_kernel<kBf16Dots, kSmemWeights>;
  const int smem = smem_bytes(nz, ndf, kSmemWeights);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config((B + kRows - 1) / kRows, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base,
                           out, B, nz, ndf, steps, step_size, coeff);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

DAMC_ERROR_STRING_EXPORT

// [chains per cluster, blocks per cluster, threads per block]: the
// wrapper's planner checks its constants against these.
extern "C" void damc_fused_langevin_geometry(int* out) {
  out[0] = kRows;
  out[1] = kCluster;
  out[2] = kThreads;
}

extern "C" int damc_fused_langevin_smem_bytes(int nz, int ndf, int smem_weights) {
  return smem_bytes(nz, ndf, smem_weights != 0);
}

// Noise: seeds = per-chain int32 counter seeds (counter mode); else
// stream_noise != 0 draws stream mode from the scalar `seed`, chain r of
// the launch with the seed of global row row_base + r (a rank's rows of a
// sharded batch start at row_base, so they draw what an unsharded launch
// draws for them); else the chain is noiseless. bf16_dots != 0 selects the
// bf16-dot variant, smem_weights != 0 the variant that holds the weight
// slices in shared memory. nz must be a multiple of 4 and ndf of kCluster;
// without smem_weights ndf must be a multiple of 4 kCluster and k1 and k2
// 16-byte aligned.
extern "C" int damc_fused_langevin(const float* z, const float* k1, const float* b1, const float* k2,
                                   const float* b2, const float* k3, const int* seeds, int seed,
                                   int stream_noise, int row_base, int bf16_dots, int smem_weights,
                                   float* out, int B, int nz, int ndf, int steps, float step_size,
                                   float coeff, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(k1) % 16 == 0 && reinterpret_cast<uintptr_t>(k2) % 16 == 0;
  if (nz % 4 || ndf % kCluster || (!smem_weights && (ndf % (4 * kCluster) || !aligned)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = smem_weights ? (bf16_dots ? launch<true, true> : launch<false, true>)
                                : (bf16_dots ? launch<true, false> : launch<false, false>);
  return run(z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base, out, B, nz, ndf, steps,
             step_size, coeff, s);
}
