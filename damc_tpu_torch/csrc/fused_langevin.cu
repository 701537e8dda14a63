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
// Design: a thread-block cluster of kCluster = 4 blocks (8 for wide EBMs,
// below) owns kRows = 8 chains for all steps and holds both weight matrices
// in shared memory, split by the hidden column: block `rank` keeps K1[:, J]
// and K2[:, J] for its J = ndf / kCluster columns (67 KB at the CIFAR-10
// widths, zero-padded to a multiple of 4, at a row stride of 4 x odd floats so that both a walk down
// a column and 128-bit reads along the rows of a warp's lanes hit distinct
// banks). The forward products give its own columns of h1p and h2p, each a
// sum over the input in order. The transposed products use the same column
// slices: the block sums d2 K2^T and d1 K1^T over its own J only, for every
// output, and the cluster adds the kCluster partial sums in rank order. Three
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
// The bf16-dot variant (the TPU kernel's dots_dtype="bfloat16",
// damc_tpu/ops/pallas/fused_langevin.py:184-212): the four products take
// bfloat16 operands and accumulate in fp32. Each weight is rounded to bf16
// once, as it is loaded; each activation operand (z, lrelu(h1p), d2, d1) is
// rounded where it is stored, since only a product reads it. Rounding is
// round-to-nearest-even (__float2bfloat16_rn), as JAX's astype. The biases,
// lrelu and its derivative, k3, the + z term, the chain state and the
// noise stay fp32. Its bound on an H100 is the same operations at the bf16
// tensor-core rate (989 TFLOP/s): 0.0041 ms at B=256, nz=128, 60 steps.
// Where its weights fit on chip it is the tensor-core kernel at the end of
// this file (prior_langevin_mma_kernel, whose note gives its design); past
// that it is the L2 variant below (kBf16Dots with kSmemWeights false),
// which runs the fp32 walk on operands rounded as they are read.
//
// Every width of the 2-hidden EBM, as the TPU kernel takes (it pads only
// the batch). For this kernel the wrapper (ops/cuda/fused_langevin.py::
// launch_widths, pad_widths) pads nz to a multiple of 4 and ndf to one of
// the cluster with zero weights and zero z columns, and slices the padding
// off the result (the tensor-core kernel pads its own shared copies): a
// zero weight adds an exact zero to every sum, at its end, so the real
// columns are what the unpadded widths would give, and a column's noise
// depends on its index alone.
//
// The fp32 variant's cluster size kCluster is a template parameter, 4 or 8 (kClusters;
// 8 is the portable maximum). A block holds ndf / kCluster hidden columns,
// so a larger cluster holds a wider EBM on chip: a block's share of the
// weights is (nz + ndf) x slice_ld(ndf / kCluster) floats, beside 8 chains'
// activations. At nz = 128 that is 395,264 B a block at ndf = 512 over 4
// blocks, past the 232,448 B a Hopper block may use, and 223,232 B over 8
// (ndf = 200 over 4: 95,744 B). The wrapper takes the smallest cluster
// whose share fits, with ndf padded to a multiple of it, so 4 serves ndf
// up to 368 and 8 up to 536 at nz = 128; the cluster is a function of the
// widths alone, so a chain's sums stay fixed by (nz, ndf) in any batch and
// at any slot. The kCluster = 4 instantiation is the kernel as it was
// before the parameter existed. At kCluster = 8 and 223 KB one block fits
// an SM, and a cluster takes 8 SMs of one GPC: at B = 256 the 32 clusters
// run in waves of the clusters the card holds at once.
//
// Past the largest cluster's share (ndf above 536 at nz = 128), the
// kSmemWeights = false variant, at kCluster = 4, reads the slices from
// global memory, where L2 keeps them (4.7 MB at ndf = 1,024), ndf padded
// to a multiple of 16; its summation order is the same walk, fixed by the
// padded widths. Every product then waits on L2 (PERF.md, section 6).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;  // chains per cluster
constexpr int kThreads = 256;
// Blocks per cluster of the variants that hold the weight slices in shared
// memory, smallest first (each block holds ndf / kCluster hidden columns),
// and of the variant that reads them from global memory.
constexpr int kClusters[] = {4, 8};
constexpr int kNumClusters = sizeof(kClusters) / sizeof(kClusters[0]);
constexpr int kL2Cluster = 4;
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

// kCluster: blocks per cluster, one of kClusters (or kL2Cluster without
// kSmemWeights). kSmemWeights: the block holds its slices of K1 and K2 in
// shared memory (as set out above); else it reads them where they lie in
// global memory (through L1 and L2), its J columns at row stride ndf, and
// shared memory holds the activations alone. That variant serves the widths
// whose slices fit no cluster (ndf = 1,024 at nz = 128 needs 698,368 B a
// block over 8); it needs J % 4 == 0, so that the slices need no zero padding and their rows stay
// 16-byte aligned, and the bf16-dot variant rounds each weight as it is read.
// kBf16Dots with kSmemWeights is not instantiated: the bf16-dot widths whose
// weights fit on chip go to prior_langevin_mma_kernel.
template <int kCluster, bool kBf16Dots, bool kSmemWeights>
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

int smem_bytes(int nz, int ndf, bool smem_weights, int cluster) {
  const int J = ndf / cluster;
  return (int)sizeof(float) * ((smem_weights ? (nz + ndf) * slice_ld(J) : 0) +
                               kRows * (2 * nz + 2 * ndf + 2 * pad4(J) + 2 * J));
}

cudaLaunchConfig_t launch_config(int clusters, int cluster, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kCluster, bool kBf16Dots, bool kSmemWeights>
int launch(const float* z, const float* k1, const float* b1, const float* k2, const float* b2,
           const float* k3, const int* seeds, int seed, int stream_noise, int row_base, float* out,
           int B, int nz, int ndf, int steps, float step_size, float coeff, cudaStream_t stream) {
  const auto kernel = prior_langevin_kernel<kCluster, kBf16Dots, kSmemWeights>;
  const int smem = smem_bytes(nz, ndf, kSmemWeights, kCluster);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config((B + kRows - 1) / kRows, kCluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base,
                           out, B, nz, ndf, steps, step_size, coeff);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tensor-core kernel: K1 with bf16 dots, its weights in shared memory.
//
// Replaces the same TPU kernel (damc_tpu/ops/pallas/fused_langevin.py::
// _kernel, pallas_call :311) with dots_dtype="bfloat16" (:184-212), and
// computes what it computes: the four products on bf16 operands with fp32
// sums, the rounding as set out above.
//
// Bound on an H100: operations, at the bf16 tensor-core rate (989 TFLOP/s):
// 2 nz ndf + 2 ndf^2 multiply-adds a chain and step, 0.0041 ms at B=256,
// nz=128, ndf=200, 60 steps; the bytes (z in and out, the weights once) are
// under 0.4 MB. What holds the kernel far above that is shared memory: with
// 8 chains a block each weight read from it serves 8 multiply-adds, so a
// step reads the whole bf16 weights (279 KB at nz=128, ndf=208) and the
// warps' activation fragments (96 KB) at 128 B a clock, about 2,900 clocks,
// beside the step's normals and five barriers (PERF.md, section 6).
//
// Design. The products run as mma.sync.m16n8k16 (bf16 in, fp32 out) with
// the kRows = 8 chains of a block as the N = 8 dimension and a weight
// matrix as the A operand, 16 output rows a tile:
//   h1p^T = K1^T z^T (k over nz), h2p^T = K2^T h1^T (k over ndf),
//   (d2 K2^T)^T = K2 d2^T and (d1 K1^T)^T = K1 d1^T (k over the hidden
//   columns).
// So one bf16 copy of K1 and K2 in shared memory serves a product and its
// transpose: ldmatrix reads a weight matrix as A, ldmatrix.trans as A^T. A
// block's weights are rounded to bf16 as they are loaded, at row stride
// J + 8 halves (J a multiple of 16), so that the 8 rows ldmatrix reads at
// once fall in distinct banks; the activation operands are stored as bf16
// rows of one chain at stride width + 8, so that a warp's 32-bit reads of
// the B fragment fall in distinct banks. Half-width weights fit one block
// at the presets' widths (nz=128, ndf=200 padded to 208: 145,152 B of
// weights, 165,888 B with the activations), so there a cluster of 1 runs the
// chain with __syncthreads() alone: four barriers a step, no remote read.
// A block has kMmaThreads = 512 threads, 16 warps. The products over the
// own columns (h1p, h2p and, in one block, d2 K2^T) are held by the first 8
// warps, two 16-column tiles each, so that each activation fragment read
// serves two tiles (J <= 256); meanwhile the other 8 warps draw the step's
// normals, a long chain of arithmetic a value. The products over every
// output row (d1 K1^T, and d2 K2^T over a cluster) take one tile a warp.
// Wider EBMs split the hidden columns over a cluster of 4 or 8
// (kMmaClusters) as the fp32 kernel does: own columns for the forward
// products, each block's partial sums of the transposed products over its
// own columns, added across the cluster in rank order; lrelu(h1p) is
// pushed to every block's copy of h1 through distributed shared memory.
// The wrapper takes the smallest cluster whose block fits 232,448 B
// (ops/cuda/fused_langevin.py::launch_widths): 1 up to ndf=256, 4 up to
// 512 and 8 up to 640 at nz=128; past that the L2 variant above.
//
// Summation order. Each output tile belongs to one warp (own tile t to
// warp t % 8, a tile of every row to warp t % 16), which walks k in order,
// 16 at a time: one mma.sync from zero a slice, the slices' sums added in
// fp32 in order of k (tile_products says why); the cluster's partials are
// added in rank order. No split of k between warps, no atomics: every
// output element's sum is fixed by the padded widths and the cluster,
// which the widths fix, so a chain's result is the same bit for bit in any
// batch and at any slot. A warp keeps its tiles' h1p in registers from the
// first product to d1.
//
// Widths. The kernel takes z and the weights at their own widths and pads
// them in shared memory: nz to a multiple of 16 (mma_pad_nz) and ndf to
// one of 16 x the cluster (mma_pad_ndf), with zero weights, biases, head
// and z columns, so the wrapper pads nothing. A zero weight adds an exact
// zero, a padded hidden unit feeds nothing and a padded z column stays 0
// (it draws no noise), so the real columns are the unpadded chain's.

using bf16 = __nv_bfloat16;

// Blocks per cluster of the tensor-core kernel, smallest first.
constexpr int kMmaClusters[] = {1, 4, 8};
constexpr int kNumMmaClusters = sizeof(kMmaClusters) / sizeof(kMmaClusters[0]);
constexpr int kMmaThreads = 512;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kOwnWarps = kMmaWarps / 2;  // the warps that hold the own-column tiles, two each
constexpr int kTile = 16;  // output rows of an mma tile, and its k

__host__ __device__ inline int mma_pad_nz(int nz) { return (nz + kTile - 1) / kTile * kTile; }
__host__ __device__ inline int mma_pad_ndf(int ndf, int cluster) {
  return (ndf + kTile * cluster - 1) / (kTile * cluster) * (kTile * cluster);
}

// A block's shared memory, at the padded widths: the bf16 weight slices
// (nz + ndf) x (J + 8); per chain the bf16 operands z (nz + 8), h1
// (ndf + 8), d2 and d1 (J + 8 each), in fp32 z and the step's normals (nz
// each) and, over a cluster of more than 1, the partial sums of d1 K1^T
// (nz) and d2 K2^T (ndf).
int mma_smem_bytes(int nz, int ndf, int cluster) {
  const int nzp = mma_pad_nz(nz), ndfp = mma_pad_ndf(ndf, cluster), J = ndfp / cluster;
  const int halves = (nzp + ndfp) * (J + 8) + kRows * ((nzp + 8) + (ndfp + 8) + 2 * (J + 8));
  const int floats = kRows * (2 * nzp + (cluster > 1 ? nzp + ndfp : 0));
  return (int)sizeof(bf16) * halves + (int)sizeof(float) * floats;
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The A fragment of a 16 x 16 tile: four 8 x 8 matrices, lane l giving the
// shared address of row l % 8 of matrix l / 8; kTrans reads each
// transposed.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t address) {
  if (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(address));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(address));
}

// d += A B: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), d 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
struct Stage {
  static constexpr int value = N;
};

// acc[i] = A_{t[i]} x^T for kT output tiles t[i] of one warp: rows
// 16t .. 16t + 15 of A, the weights w read as they lie (A[m][k] = w[m ld +
// k]) or, with kTrans, as their transpose (A[m][k] = w[k ld + m]), times the
// 8 chains' bf16 operands (x[r x_ld + k]), k < nk; the B fragment of a
// slice is read once for the kT tiles. Each 16-deep slice of k is one
// mma.sync from a zero accumulator, and the slices' sums are added to acc
// in fp32 (round to nearest) in order of k: the tensor core's own
// accumulation rounds otherwise, and over a whole row its sums part from
// fp32 ones by enough to flip an operand's bf16 rounding. The next slice's
// fragments are loaded while the current one multiplies (two register
// stages), and a slice's sums are added after the next slice's mma.sync is
// issued, so that no instruction waits on the one before it. The loop is
// not unrolled: 16 warps run the kernel's products at different places,
// and its code has to stay in the instruction cache. Fragment element q of
// lane l is row 16t + l / 4 + 8 (q / 2), chain 2 (l % 4) + q % 2.
template <bool kTrans, int kT>
__device__ __forceinline__ void tile_products(float (&acc)[2][4], const bf16* w, int ld, const int (&t)[2],
                                              const bf16* x, int x_ld, int nk) {
  const int lane = threadIdx.x % 32, row = lane % 8, quad = lane / 8;
  uint32_t a[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int offset = kTrans ? (row + (quad / 2) * 8) * ld + (quad % 2) * 8 + t[i] * kTile
                              : (row + (quad % 2) * 8 + t[i] * kTile) * ld + (quad / 2) * 8;
    a[i] = shared_address(w) + (uint32_t)sizeof(bf16) * offset;
  }
  const uint32_t slice_bytes = sizeof(bf16) * (kTrans ? kTile * ld : kTile);
  const bf16* xl = x + (lane / 4) * x_ld + (lane % 4) * 2;
  const int slices = nk / kTile;
  uint32_t fa[2][kT][4], fb[2][2];
  float d0[kT][4], d1[kT][4];
  auto load = [&](auto stage, int slice) {
    constexpr int s = decltype(stage)::value;
    fb[s][0] = *reinterpret_cast<const uint32_t*>(xl + slice * kTile);
    fb[s][1] = *reinterpret_cast<const uint32_t*>(xl + slice * kTile + 8);
#pragma unroll
    for (int i = 0; i < kT; ++i) ldmatrix_x4<kTrans>(fa[s][i], a[i] + slice * slice_bytes);
  };
  auto mul = [&](auto stage, float (&d)[kT][4]) {
    constexpr int s = decltype(stage)::value;
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
      mma_bf16(d[i], fa[s][i], fb[s][0], fb[s][1]);
    }
  };
  auto add = [&](const float (&d)[kT][4]) {
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] += d[i][q];
  };
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) d1[i][q] = 0.f;
  load(Stage<0>(), 0);
  int slice = 0;
#pragma unroll 1
  for (; slice + 2 <= slices; slice += 2) {
    load(Stage<1>(), slice + 1);
    mul(Stage<0>(), d0);
    add(d1);  // slice - 1 (zeros at the first)
    load(Stage<0>(), min(slice + 2, slices - 1));
    mul(Stage<1>(), d1);
    add(d0);
  }
  add(d1);
  if (slice < slices) {
    mul(Stage<0>(), d0);
    add(d0);
  }
}

// acc[0] = the product of tile first + warp, if it is below ntiles (else
// zeros): one tile a warp, for products over every output row.
template <bool kTrans>
__device__ __forceinline__ void warp_product(float (&acc)[2][4], const bf16* w, int ld, int first, int ntiles,
                                             const bf16* x, int x_ld, int nk) {
  const int t[2] = {first + (int)threadIdx.x / 32, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[0][q] = 0.f;
  if (t[0] < ntiles) tile_products<kTrans, 1>(acc, w, ld, t, x, x_ld, nk);
}

// acc[i] = the product of own tile warp + kOwnWarps i (i < 2), below
// own_tiles (else zeros): the first kOwnWarps warps hold the own-column
// tiles, two each, so that each B fragment serves two tiles.
template <bool kTrans>
__device__ __forceinline__ void own_products(float (&acc)[2][4], const bf16* w, int ld, int own_tiles,
                                             const bf16* x, int x_ld, int nk) {
  const int warp = threadIdx.x / 32, t[2] = {warp, warp + kOwnWarps};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  if (warp >= kOwnWarps) return;
  if (t[1] < own_tiles)
    tile_products<kTrans, 2>(acc, w, ld, t, x, x_ld, nk);
  else if (t[0] < own_tiles)
    tile_products<kTrans, 1>(acc, w, ld, t, x, x_ld, nk);
}

// s (rows x ld, bf16) = w[0:rows, j0:j0 + J] (w is rows_real x ndf fp32)
// rounded to bf16, zero past rows_real and ndf; 4 columns a load (float4
// where `vec`), 8 loads in flight a thread.
__device__ __forceinline__ void load_slice(bf16* s, const float* __restrict__ w, int rows, int rows_real,
                                           int ndf, int j0, int J, int ld, bool vec) {
  const int groups = J / 4, n = rows * groups;
  constexpr int kDepth = 8;
  for (int e0 = threadIdx.x; e0 < n; e0 += kMmaThreads * kDepth) {
    float4 v[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int e = e0 + u * kMmaThreads, k = e / groups, c = j0 + (e - k * groups) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < n && k < rows_real) {
        const float* p = w + (size_t)k * ndf + c;
        if (vec && c + 3 < ndf) {
          v[u] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v[u].x = c < ndf ? __ldg(p) : 0.f;
          v[u].y = c + 1 < ndf ? __ldg(p + 1) : 0.f;
          v[u].z = c + 2 < ndf ? __ldg(p + 2) : 0.f;
          v[u].w = c + 3 < ndf ? __ldg(p + 3) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int e = e0 + u * kMmaThreads, k = e / groups, g = e - k * groups;
      if (e < n) {
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(s + k * ld + g * 4);
        q[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
        q[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
      }
    }
  }
}

// __syncthreads() in a cluster of 1, else the cluster's barrier (whose
// arrive releases and whose wait acquires the blocks' shared memory).
template <int kCluster>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (kCluster == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// kCluster: blocks per cluster, one of kMmaClusters. nz and ndf are the
// EBM's own widths; the block works at mma_pad_nz(nz) and
// mma_pad_ndf(ndf, kCluster), J = the latter / kCluster own columns.
template <int kCluster>
__global__ void __launch_bounds__(kMmaThreads, 1) prior_langevin_mma_kernel(
    const float* __restrict__ z_in, const float* __restrict__ k1, const float* __restrict__ b1,
    const float* __restrict__ k2, const float* __restrict__ b2, const float* __restrict__ k3,
    const int* __restrict__ seeds, int seed, int stream_noise, int row_base,
    float* __restrict__ z_out, int B, int nz, int ndf, int steps, float step_size, float coeff) {
  const int nzp = mma_pad_nz(nz), ndfp = mma_pad_ndf(ndf, kCluster), J = ndfp / kCluster;
  int rank = 0;
  if constexpr (kCluster > 1) rank = (int)cg::this_cluster().block_rank();
  const int j0 = rank * J;
  const int ldw = J + 8, ldz = nzp + 8, ldh = ndfp + 8, ldd = J + 8;
  extern __shared__ float4 smem4[];
  __shared__ uint32_t row_seed[kRows];
  bf16* k1s = reinterpret_cast<bf16*>(smem4);  // nzp x ldw: K1[:, j0:j0+J]
  bf16* k2s = k1s + nzp * ldw;                  // ndfp x ldw: K2[:, j0:j0+J]
  bf16* zb = k2s + ndfp * ldw;                  // kRows x ldz: z, the operand of h1p
  bf16* h1b = zb + kRows * ldz;                 // kRows x ldh: lrelu(h1p), every column
  bf16* d2b = h1b + kRows * ldh;                // kRows x ldd: d2, own columns
  bf16* d1b = d2b + kRows * ldd;                // kRows x ldd: d1, own columns
  float* zs = reinterpret_cast<float*>(d1b + kRows * ldd);  // kRows x nzp: the chains
  float* noise = zs + kRows * nzp;  // kRows x nzp: the step's normals
  float* xg = noise + kRows * nzp;  // kRows x nzp: d1 K1^T over own columns (kCluster > 1)
  float* xd1 = xg + kRows * nzp;    // kRows x ndfp: d2 K2^T over own columns (kCluster > 1)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = (int)(blockIdx.x / kCluster) * kRows;
  const int nrows = min(kRows, B - row0);
  const int own_tiles = J / kTile, ndf_tiles = ndfp / kTile, nz_tiles = nzp / kTile;
  // Own tile i (< 2) of warp w < kOwnWarps is w + kOwnWarps i; its
  // fragment element q is own column (of h1p, d2, d1) own[i][q / 2] of
  // chain chain[q % 2].
  int own[2][2];
  bool owns[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = warp + kOwnWarps * i;
    owns[i] = warp < kOwnWarps && t < own_tiles;
    own[i][0] = t * kTile + lane / 4;
    own[i][1] = own[i][0] + 8;
  }
  const int chain[2] = {(lane % 4) * 2, (lane % 4) * 2 + 1};

  const bool noisy = seeds != nullptr || stream_noise;
  if (tid < kRows)
    row_seed[tid] = tid >= nrows      ? 0u  // a ragged tile's zero rows draw no noise
                    : seeds != nullptr ? (uint32_t)seeds[row0 + tid]
                                       : damc::stream_row_seed((uint32_t)seed, (uint32_t)(row_base + row0 + tid));
  const bool vec = ndf % 4 == 0 && reinterpret_cast<uintptr_t>(k1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k2) % 16 == 0;
  load_slice(k1s, k1, nzp, nz, ndf, j0, J, ldw, vec);
  load_slice(k2s, k2, ndfp, ndf, ndf, j0, J, ldw, vec);
  for (int e = tid; e < kRows * (ldz + ldh + 2 * ldd); e += kMmaThreads) zb[e] = __float2bfloat16_rn(0.f);
  float bias1[2][2], bias2[2][2], head[2][2];  // of the own columns
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + own[i][h];
      const bool real = owns[i] && j < ndf;
      bias1[i][h] = real ? __ldg(b1 + j) : 0.f;
      bias2[i][h] = real ? __ldg(b2 + j) : 0.f;
      head[i][h] = real ? __ldg(k3 + j) : 0.f;
    }
  __syncthreads();
  for (int e = tid; e < kRows * nzp; e += kMmaThreads) {
    const int r = e / nzp, m = e - r * nzp;
    const float z = r < nrows && m < nz ? z_in[(size_t)(row0 + r) * nz + m] : 0.f;  // ragged tile: zero rows
    zs[e] = z;
    zb[r * ldz + m] = __float2bfloat16_rn(z);
  }
  // Every block of the cluster has its buffers set before any is written remotely.
  cluster_barrier<kCluster>();

  // The step's normals: the warps that hold no own tile draw them during
  // the first three products (whose time goes to reading the weights from
  // shared memory, while the arithmetic units are free), element
  // kOwnWarps * 32 k + their thread for k = part mod 3: parts 0, 1, 2 in
  // the second, first and third product, the longest first.
  auto draw = [&](int s, int part) {
    if (!noisy || warp < kOwnWarps) return;
    constexpr int kStride = (kMmaWarps - kOwnWarps) * 32;
#pragma unroll 1
    for (int e = tid - kOwnWarps * 32 + part * kStride; e < kRows * nzp; e += 3 * kStride) {
      const int r = e / nzp;
      noise[e] = damc::counter_normal(row_seed[r], s, e - r * nzp);
    }
  };
  float h1p[2][4];  // the own columns of h1p, from the first product to d1
  float acc[2][4];
  for (int s = 0; s < steps; ++s) {
    // h1p^T = K1[:, own]^T z^T + b1; lrelu(h1p) to every block's h1.
    draw(s, 1);
    own_products<true>(acc, k1s, ldw, own_tiles, zb, ldz, nzp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (owns[i])
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h1p[i][q] = acc[i][q] + bias1[i][q / 2];
          const bf16 v = __float2bfloat16_rn(lrelu(h1p[i][q]));
          const int at = chain[q % 2] * ldh + j0 + own[i][q / 2];
          if constexpr (kCluster == 1) {
            h1b[at] = v;
          } else {
#pragma unroll
            for (int c = 0; c < kCluster; ++c) cg::this_cluster().map_shared_rank(h1b, c)[at] = v;
          }
        }
    cluster_barrier<kCluster>();
    // d2 = lrelu'(h1 K2[:, own] + b2) * k3, own columns.
    draw(s, 0);
    own_products<true>(acc, k2s, ldw, own_tiles, h1b, ldh, ndfp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (owns[i])
#pragma unroll
        for (int q = 0; q < 4; ++q)
          d2b[chain[q % 2] * ldd + own[i][q / 2]] =
              __float2bfloat16_rn(dlrelu(acc[i][q] + bias2[i][q / 2]) * head[i][q / 2]);
    __syncthreads();
    // d2 K2^T over own columns; d1 = lrelu'(h1p) * (its cluster sum), own columns.
    draw(s, 2);
    if constexpr (kCluster == 1) {
      own_products<false>(acc, k2s, ldw, own_tiles, d2b, ldd, J);
    } else {
#pragma unroll 1
      for (int first = 0; first < ndf_tiles; first += kMmaWarps) {
        warp_product<false>(acc, k2s, ldw, first, ndf_tiles, d2b, ldd, J);
        if (first + warp < ndf_tiles)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xd1[chain[q % 2] * ndfp + (first + warp) * kTile + lane / 4 + 8 * (q / 2)] = acc[0][q];
      }
      cluster_barrier<kCluster>();
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (owns[i])
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = 0.f;
#pragma unroll
            for (int c = 0; c < kCluster; ++c)
              v += cg::this_cluster().map_shared_rank(xd1, c)[chain[q % 2] * ndfp + j0 + own[i][q / 2]];
            acc[i][q] = v;
          }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (owns[i])
#pragma unroll
        for (int q = 0; q < 4; ++q)
          d1b[chain[q % 2] * ldd + own[i][q / 2]] = __float2bfloat16_rn(dlrelu(h1p[i][q]) * acc[i][q]);
    __syncthreads();
    // d1 K1^T over own columns, and z <- z - coeff * (d1 K1^T + z) (+ eps * N):
    // in one block by the warp that holds the element, over a cluster after
    // adding the cluster's partials in rank order.
    auto update = [&](int r, int m, float g) {
      const int e = r * nzp + m;
      float z = zs[e] - coeff * (g + zs[e]);
      if (noisy && r < nrows && m < nz) z += step_size * noise[e];
      zs[e] = z;
      zb[r * ldz + m] = __float2bfloat16_rn(z);
    };
#pragma unroll 1
    for (int first = 0; first < nz_tiles; first += kMmaWarps) {
      warp_product<false>(acc, k1s, ldw, first, nz_tiles, d1b, ldd, J);
      if (first + warp < nz_tiles)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = chain[q % 2], m = (first + warp) * kTile + lane / 4 + 8 * (q / 2);
          if constexpr (kCluster == 1)
            update(r, m, acc[0][q]);
          else
            xg[r * nzp + m] = acc[0][q];
        }
    }
    if constexpr (kCluster > 1) {
      cluster_barrier<kCluster>();
#pragma unroll 1
      for (int e = tid; e < kRows * nzp; e += kMmaThreads) {
        float g = 0.f;
#pragma unroll
        for (int c = 0; c < kCluster; ++c) g += cg::this_cluster().map_shared_rank(xg, c)[e];
        update(e / nzp, e % nzp, g);
      }
    }
    __syncthreads();
  }
  if constexpr (kCluster > 1) cluster_barrier<kCluster>();  // no block leaves while another may read its partials
  if (rank == 0)
    for (int e = tid; e < nrows * nz; e += kMmaThreads) {
      const int r = e / nz, m = e - r * nz;
      z_out[(size_t)(row0 + r) * nz + m] = zs[r * nzp + m];
    }
}

template <int kCluster>
int launch_mma(const float* z, const float* k1, const float* b1, const float* k2, const float* b2,
               const float* k3, const int* seeds, int seed, int stream_noise, int row_base, float* out,
               int B, int nz, int ndf, int steps, float step_size, float coeff, cudaStream_t stream) {
  const auto kernel = prior_langevin_mma_kernel<kCluster>;
  const int smem = mma_smem_bytes(nz, ndf, kCluster);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config((B + kRows - 1) / kRows, kCluster, smem, stream, &attr);
  cfg.blockDim = dim3(kMmaThreads);
  if (kCluster == 1) cfg.numAttrs = 0;  // no cluster: one block a chain tile
  err = cudaLaunchKernelEx(&cfg, kernel, z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base,
                           out, B, nz, ndf, steps, step_size, coeff);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

DAMC_ERROR_STRING_EXPORT

// [chains per cluster, threads per block, blocks per cluster of the
// variant that reads the weights from global memory, the number of on-chip
// cluster sizes of the fp32 variant, then those sizes, smallest first, the
// number of cluster sizes of the tensor-core variant, then those, its tile
// and its threads per block] (out holds at least 7 + kNumClusters +
// kNumMmaClusters ints): the wrapper checks its constants against these.
extern "C" void damc_fused_langevin_geometry(int* out) {
  out[0] = kRows;
  out[1] = kThreads;
  out[2] = kL2Cluster;
  out[3] = kNumClusters;
  for (int i = 0; i < kNumClusters; ++i) out[4 + i] = kClusters[i];
  int* mma = out + 4 + kNumClusters;
  mma[0] = kNumMmaClusters;
  for (int i = 0; i < kNumMmaClusters; ++i) mma[1 + i] = kMmaClusters[i];
  mma[1 + kNumMmaClusters] = kTile;
  mma[2 + kNumMmaClusters] = kMmaThreads;
}

// A block's shared memory: the tensor-core variant's (bf16_dots with
// smem_weights) at widths it pads itself, else the fp32 kernel's.
extern "C" int damc_fused_langevin_smem_bytes(int nz, int ndf, int smem_weights, int cluster, int bf16_dots) {
  if (bf16_dots && smem_weights) return mma_smem_bytes(nz, ndf, cluster);
  return smem_bytes(nz, ndf, smem_weights != 0, cluster);
}

// Noise: seeds = per-chain int32 counter seeds (counter mode); else
// stream_noise != 0 draws stream mode from the scalar `seed`, chain r of
// the launch with the seed of global row row_base + r (a rank's rows of a
// sharded batch start at row_base, so they draw what an unsharded launch
// draws for them); else the chain is noiseless. bf16_dots != 0 selects the
// bf16-dot variant, smem_weights != 0 the variant that holds the weight
// slices in shared memory, over `cluster` blocks a cluster. Both together
// launch the tensor-core kernel, over one of kMmaClusters, at the EBM's
// own widths (it pads them). Otherwise the cluster is one of kClusters,
// or kL2Cluster without smem_weights; nz must be a multiple of 4 and ndf
// of the cluster; without smem_weights ndf must be a multiple of 4
// kL2Cluster and k1 and k2 16-byte aligned.
extern "C" int damc_fused_langevin(const float* z, const float* k1, const float* b1, const float* k2,
                                   const float* b2, const float* k3, const int* seeds, int seed,
                                   int stream_noise, int row_base, int bf16_dots, int smem_weights,
                                   int cluster, float* out, int B, int nz, int ndf, int steps,
                                   float step_size, float coeff, void* stream) {
  static_assert(kNumClusters == 2 && kClusters[0] == 4 && kClusters[1] == 8,
                "the switch below launches each size of kClusters and no other");
  static_assert(kNumMmaClusters == 3 && kMmaClusters[0] == 1 && kMmaClusters[1] == 4 && kMmaClusters[2] == 8,
                "the switch below launches each size of kMmaClusters and no other");
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_dots && smem_weights) {
    decltype(&launch_mma<1>) run = nullptr;
    switch (cluster) {
      case 1: run = launch_mma<1>; break;
      case 4: run = launch_mma<4>; break;
      case 8: run = launch_mma<8>; break;
      default: break;
    }
    if (!run || nz < 1 || ndf < 1 || mma_pad_ndf(ndf, cluster) / cluster > kMmaWarps * kTile)
      return (int)cudaErrorInvalidValue;
    return run(z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base, out, B, nz, ndf, steps,
               step_size, coeff, s);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(k1) % 16 == 0 && reinterpret_cast<uintptr_t>(k2) % 16 == 0;
  decltype(&launch<4, false, true>) run = nullptr;
  if (!smem_weights) {
    if (cluster == kL2Cluster) run = bf16_dots ? launch<kL2Cluster, true, false> : launch<kL2Cluster, false, false>;
  } else {
    switch (cluster) {
      case 4: run = launch<4, false, true>; break;
      case 8: run = launch<8, false, true>; break;
      default: break;
    }
  }
  if (!run || nz % 4 || ndf % cluster || (!smem_weights && (ndf % (4 * cluster) || !aligned)))
    return (int)cudaErrorInvalidValue;
  return run(z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base, out, B, nz, ndf, steps,
             step_size, coeff, s);
}
