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
// Where its weights fit on chip it is the tensor-core kernel
// (prior_langevin_mma_kernel, whose note gives its design); past that it is
// the streamed kernel at the end of this file (prior_langevin_l2_kernel),
// whose weights are rounded as they are staged into shared memory.
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
// Past the largest cluster's share (ndf above 536 at nz = 128) the
// streamed kernel at the end of this file (prior_langevin_l2_kernel) takes
// the chain, in both dot precisions; its note gives its design.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;  // chains per cluster
constexpr int kThreads = 256;
// Blocks per cluster of the fp32 kernel, smallest first (each block holds
// ndf / kCluster hidden columns of the weights in shared memory).
constexpr int kClusters[] = {4, 8};
constexpr int kNumClusters = sizeof(kClusters) / sizeof(kClusters[0]);
constexpr int kRt = 2;  // chains per thread in the products
constexpr int kGroups = kRows / kRt;
constexpr float kSlope = 0.2f;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one Hopper block may use

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
// walk down a weight column, kRt chains at x (row stride x_ld).
__device__ __forceinline__ void dot_col(const float* w, int ld, const float* x, int x_ld, int n, float* acc) {
#pragma unroll 4
  for (int k = 0; k < n; k += 4) {
    const float w0 = w[(k + 0) * ld], w1 = w[(k + 1) * ld], w2 = w[(k + 2) * ld], w3 = w[(k + 3) * ld];
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(x + r * x_ld + k);
      acc[r] = fmaf(v.x, w0, acc[r]);
      acc[r] = fmaf(v.y, w1, acc[r]);
      acc[r] = fmaf(v.z, w2, acc[r]);
      acc[r] = fmaf(v.w, w3, acc[r]);
    }
  }
}

// acc[r] = sum_k x[r][k] w[k], k < n (n % 4 == 0), in order of k: a walk
// along a weight row.
__device__ __forceinline__ void dot_row(const float* w, const float* x, int x_ld, int n, float* acc) {
#pragma unroll 4
  for (int k = 0; k < n; k += 4) {
    const float4 wk = *reinterpret_cast<const float4*>(w + k);
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

// kCluster: blocks per cluster, one of kClusters. Each block holds its
// slices of K1 and K2 in shared memory, as set out above.
template <int kCluster>
__global__ void __launch_bounds__(kThreads, 2) prior_langevin_kernel(
    const float* __restrict__ z_in, const float* __restrict__ k1, const float* __restrict__ b1,
    const float* __restrict__ k2, const float* __restrict__ b2, const float* __restrict__ k3,
    const int* __restrict__ seeds, int seed, int stream_noise, int row_base,
    float* __restrict__ z_out, int B, int nz, int ndf, int steps, float step_size, float coeff) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int J = ndf / kCluster, j4 = pad4(J), j0 = rank * J;
  const int ld = slice_ld(J);
  extern __shared__ float4 smem4[];
  __shared__ uint32_t row_seed[kRows];
  float* k1s = reinterpret_cast<float*>(smem4);  // nz x ld: K1[:, j0:j0+J], zero past J
  float* k2s = k1s + nz * ld;                    // ndf x ld: K2[:, j0:j0+J], zero past J
  float* zs = k2s + ndf * ld;     // kRows x nz: the whole z, in every block
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
  for (int e = tid; e < nz * ld; e += kThreads) {
    const int k = e / ld, j = e - k * ld;
    k1s[e] = j < J ? k1[(size_t)k * ndf + j0 + j] : 0.f;
  }
  for (int e = tid; e < ndf * ld; e += kThreads) {
    const int i = e / ld, j = e - i * ld;
    k2s[e] = j < J ? k2[(size_t)i * ndf + j0 + j] : 0.f;
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
      dot_col(k1s + j, ld, zs + r0 * nz, nz, nz, acc);
      const float b = __ldg(b1 + j0 + j);
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        const float v = acc[r] + b;
        h1p[(r0 + r) * J + j] = v;
        xh1[(r0 + r) * J + j] = lrelu(v);
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
      dot_col(k2s + j, ld, h1 + r0 * ndf, ndf, ndf, acc);
      const float b = __ldg(b2 + j0 + j), head = __ldg(k3 + j0 + j);
#pragma unroll
      for (int r = 0; r < kRt; ++r) d2[(r0 + r) * j4 + j] = dlrelu(acc[r] + b) * head;
    }
    __syncthreads();
    // d2 K2^T over own columns, every output.
    for (int t = tid; t < ndf * kGroups; t += kThreads) {
      const int i = t % ndf, r0 = (t / ndf) * kRt;
      float acc[kRt] = {};
      dot_row(k2s + (size_t)i * ld, d2 + r0 * j4, j4, j4, acc);
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
      d1[r * j4 + j] = dlrelu(h1p[e]) * v;
    }
    __syncthreads();
    // d1 K1^T over own columns, every output.
    for (int t = tid; t < nz * kGroups; t += kThreads) {
      const int m = t % nz, r0 = (t / nz) * kRt;
      float acc[kRt] = {};
      dot_row(k1s + (size_t)m * ld, d1 + r0 * j4, j4, j4, acc);
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

int smem_bytes(int nz, int ndf, int cluster) {
  const int J = ndf / cluster;
  return (int)sizeof(float) * ((nz + ndf) * slice_ld(J) + kRows * (2 * nz + 2 * ndf + 2 * pad4(J) + 2 * J));
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

template <int kCluster>
int launch(const float* z, const float* k1, const float* b1, const float* k2, const float* b2,
           const float* k3, const int* seeds, int seed, int stream_noise, int row_base, float* out,
           int B, int nz, int ndf, int steps, float step_size, float coeff, cudaStream_t stream) {
  const auto kernel = prior_langevin_kernel<kCluster>;
  const int smem = smem_bytes(nz, ndf, kCluster);
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
// 512 and 8 up to 640 at nz=128; past that the streamed kernel below.
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

// The streamed kernel (K1_l2): K1 for EBMs whose weights fit no cluster's
// shared memory, in both dot precisions.
//
// Replaces the same TPU kernel (damc_tpu/ops/pallas/fused_langevin.py::
// _kernel, pallas_call :311) at the widths where neither the fp32 kernel
// (fp32 dots, ndf above 536 at nz=128) nor the tensor-core kernel (bf16
// dots, ndf above 640) holds a block's share of the weights on chip, and
// computes what it computes, in its three noise modes.
//
// Bound on an H100: operations, as above. At nz=128, ndf=1,024 a chain's
// step is 2.36 M multiply-adds, so 60 steps at B=500 are 141.6 GFLOP, 2.11
// ms at the fp32 rate (B=256: 1.08 ms; B=16: 0.068 ms), while the bytes
// (the 4.7 MB of fp32 weights once, z in and out) take 0.0014 ms.
//
// What held the kernel it replaces back (41.5 ms on the ndf=1,024 FID batch,
// B=500, 60 steps, and 26.4 ms at B=256; H100 80GB HBM3, 700 W): a cluster
// of 4 blocks owned 8 chains and each block walked its ndf/4 columns of K1
// and K2 in global memory twice a step, so every cluster pulled the whole
// fp32 EBM through L2 twice a step (9.4 MB at ndf=1,024) for 8 chains:
// 35.7 GB at B=500, about 0.86 TB/s, each unrolled step of the walk waiting
// on an L2 round trip, and each weight it loaded served 2 chains.
//
// Design. A cluster of kL2Cluster = 8 blocks owns M chains (16, 32 or 48,
// taken by the wrapper from the batch and the clusters the card holds at
// once: the fewest waves, then the fewest chains; 8 where 32 chains fit no
// block) and splits the hidden columns: block `rank` owns J = ndf / 8 of
// them. Once a launch, pack_l2_kernel lays the weights out in the order the
// blocks stream them, each tile as it lies in shared memory (10 MB at
// ndf=1,024, the wrapper's scratch). Each step every block streams, in a
// fixed order, the weight tiles of its four products into a ring of
// kL2Stages shared-memory slots, one bulk (TMA) copy a tile issued by one
// thread on the slot's mbarrier, kL2Stages - 1 tiles ahead of the products
// and across the step's barriers. The products read weights and
// activations from shared memory only, so each weight brought from L2
// serves M chains: at B=500 the cluster count drops from 63 to 11, and the
// traffic from 35.7 GB to about 6 GB.
//   h1p = z K1[:, own] + b1 and h2p = h1 K2[:, own] + b2 (own columns, sum
//     over nz and over ndf): tiles K1[k-tile, own], K2[k-tile, own];
//   xd1 = d2 K2[own, :]^T (own columns, sum over ndf): tiles K2[own, k-tile],
//     rows of K2, so no partial sums cross the cluster;
//   d1 K1^T over own columns (every output, partial): tiles K1[:, own k-tile],
//     the cluster's 8 partials added in rank order.
// Activations of the whole width are never held: a block keeps its own
// columns of lrelu(h1p) and d2, and the products over ndf copy each k-tile
// of them from the block that owns it (distributed shared memory) into a
// local tile, one tile ahead, in step with the weight tiles. z and the
// partials of d1 K1^T (M x nz) are whole in every block; the z update and
// its noise run in every block on the same values, as in the fp32 kernel.
// Three cluster barriers a step (after lrelu(h1p), after d2, after the
// partials) and one block barrier a tile.
//
// Products. A warp computes a 16-chain x 32-column tile (8 x 32 at M = 8),
// each thread 4 x 4 (2 x 4) outputs in registers: the forward products read
// a k of 4 chains and of 4 columns as two 128-bit words (8 distinct words of
// the weight row a warp: one shared-memory wavefront each), the transposed
// ones 4 k at once along rows at strides of 4 x odd floats, conflict-free.
// Output columns are cut into chunks of `cols` (128; 32 at the widths where
// nothing else fits), a chunk's tiles rows x k-tile deep (kt: 32, 16 or 8,
// the largest that fits), so that the ring does not grow with the widths.
//
// What holds it (H100 80GB HBM3, 700 W; tools/k1_l2_phases, PERF.md, PR
// 19): two thirds to three quarters of a step are the products, which
// issue two 128-bit shared-memory reads for every 16 multiply-adds; the
// rest the tile hand-over, the z update, the activation copies and the
// barriers. Per-thread 16-byte copies of the tiles (cp.async) and a bulk
// copy a row both cost more than one bulk copy a tile; larger thread tiles
// over a split of k spilled registers, were slower and summed in another
// order.
//
// Summation order. Every output element is one thread's sum over all of k,
// in order, by fmaf from zero (the partials of d1 K1^T: over the block's own
// columns, then the cluster's 8 in rank order), so it is fixed by the
// padded widths and the cluster: not by B, M, the tile sizes or a chain's
// slot, and a chain's result is the same bit for bit in any batch and at a
// rank's row_base. fp32 FMA on the CUDA cores (TF32 off).
//
// Widths. The wrapper pads nz to a multiple of kt and ndf to one of 8 kt
// (ops/cuda/fused_langevin.py::l2_tiling, pad_widths; nz=128, ndf=1,024 as
// they are) with zero weights, as for the fp32 kernel.
//
// bf16 dots: the same kernel with each weight rounded to bf16 as it is
// packed (pack_l2_kernel), so the tiles land rounded, z rounded as the
// first product reads it, and lrelu(h1p), d2 and d1 rounded where they are
// stored; the products of two bf16 values are exact in fp32, so the values
// are the plain bf16 version's up to the order of the sums. Tensor cores
// for the streamed walk are later work.

constexpr int kL2Cluster = 8;  // blocks per cluster of the streamed kernel
constexpr int kL2Stages = 4;   // slots of the weight ring
constexpr int kL2Chains[] = {16, 32, 48};  // chains per cluster, taken by the batch
constexpr int kNumL2Chains = sizeof(kL2Chains) / sizeof(kL2Chains[0]);
constexpr int kL2Base = 32;    // the chains a tiling must fit (then 16 and 48 where they fit)
constexpr int kL2Narrow = 8;   // chains per cluster where 32 fit no block
constexpr int kL2Cols[] = {128, 32};      // output columns of a tile
constexpr int kL2Ktiles[] = {32, 16, 8};  // depth of a tile

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// A block's shared memory at padded widths (nz % kt == 0, ndf % (8 kt) ==
// 0; J = ndf / 8) with `chains` chains: in floats z and the partials of
// d1 K1^T (nz x chains each), the own columns of lrelu(h1p) (later d1) and
// of d2 (chains x (J + 4) each), the weight ring (kL2Stages x cols x (kt +
// 4)) and two activation tiles (chains x (kt + 4) each); then the signs of
// h1p, chains x J bytes.
int l2_smem_bytes(int nz, int ndf, int chains, int cols, int kt) {
  const int J = ndf / kL2Cluster;
  const int floats = 2 * nz * chains + 2 * chains * (J + 4) + kL2Stages * cols * (kt + 4) + 2 * chains * (kt + 4);
  return (int)sizeof(float) * floats + chains * J;
}

struct L2Tiling {
  int nz, ndf, cols, kt, base;  // padded widths, tile columns and depth, the chains it was fitted to
};

// The tiling of widths (nz, ndf): the first of (32 chains, 128 columns),
// (8, 128), (8, 32), each at the deepest k-tile of kL2Ktiles, whose block
// fits, with nz padded to a multiple of the k-tile and ndf to one of 8 x it.
// A function of the widths alone; the same for widths it padded.
bool l2_tiling(int nz, int ndf, L2Tiling* t) {
  const int fits[3][2] = {{kL2Base, kL2Cols[0]}, {kL2Narrow, kL2Cols[0]}, {kL2Narrow, kL2Cols[1]}};
  for (const auto& f : fits)
    for (int kt : kL2Ktiles) {
      const int nzp = round_up(nz, kt), ndfp = round_up(ndf, kL2Cluster * kt);
      if (l2_smem_bytes(nzp, ndfp, f[0], f[1], kt) <= kSmemLimit) {
        *t = {nzp, ndfp, f[1], kt, f[0]};
        return true;
      }
    }
  return false;
}

// Whether the kernel runs `chains` chains a cluster on the tiling: its
// fitted chains, or, over a tiling fitted to 32, one of kL2Chains that fits.
bool l2_takes(const L2Tiling& t, int chains) {
  if (chains == t.base) return true;
  if (t.base != kL2Base) return false;
  bool known = false;
  for (int c : kL2Chains) known |= c == chains;
  return known && l2_smem_bytes(t.nz, t.ndf, chains, t.cols, t.kt) <= kSmemLimit;
}

// A warp's tile: 4 lanes of chains x 8 lanes of columns, kTc chains x 4
// columns a thread; kHalves warp tiles cover the M chains, 4 the 128
// columns of a tile.
template <int kM>
struct L2Shape {
  static constexpr int kTc = kM >= 16 ? 4 : 2;
  static constexpr int kWc = 4 * kTc;
  static constexpr int kHalves = kM / kWc;
  static constexpr int kThreads = 32 * 4 * kHalves;
  static_assert(kM % kWc == 0, "chains a cluster: a multiple of a warp tile's");
};

// A bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completed on the mbarrier `bar`;
// the mbarrier's phase, armed for the bytes of a tile; waiting on it.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(bytes), "r"(shared_address(bar))
               : "memory");
}
__device__ __forceinline__ void expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_address(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void wait_parity(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(shared_address(bar)),
      "r"(parity)
      : "memory");
}

// acc[c][j] += sum_k a[k lda + c] w[k ldw + j] over k < kt, in order of k:
// kTc chains side by side in a (z or lrelu(h1p) as [k][chain]), 4 columns
// side by side in a weight tile's row; with kRound each a is rounded to
// bf16 as it is read.
template <int kTc, bool kRound>
__device__ __forceinline__ void col_product(float (&acc)[kTc][4], const float* a, int lda, const float* w,
                                            int ldw, int kt) {
#pragma unroll 4
  for (int k = 0; k < kt; ++k) {
    float av[kTc];
    if constexpr (kTc == 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + k * lda);
      av[0] = v.x, av[1] = v.y, av[2] = v.z, av[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(a + k * lda);
      av[0] = v.x, av[1] = v.y;
    }
    const float4 wv = *reinterpret_cast<const float4*>(w + k * ldw);
#pragma unroll
    for (int c = 0; c < kTc; ++c) {
      const float x = operand<kRound>(av[c]);
      acc[c][0] = fmaf(x, wv.x, acc[c][0]);
      acc[c][1] = fmaf(x, wv.y, acc[c][1]);
      acc[c][2] = fmaf(x, wv.z, acc[c][2]);
      acc[c][3] = fmaf(x, wv.w, acc[c][3]);
    }
  }
}

// acc[c][j] += sum_k a[4c lda + k] w[8j ldw + k] over k < kt (kt % 4 ==
// 0), in order of k: rows 4c of a (d2 or d1 as [chain][k]) and rows 8j of a
// weight tile ([output][k]), read 4 k at a time.
template <int kTc>
__device__ __forceinline__ void row_product(float (&acc)[kTc][4], const float* a, int lda, const float* w,
                                            int ldw, int kt) {
#pragma unroll 2
  for (int k = 0; k < kt; k += 4) {
    float4 av[kTc], wv[4];
#pragma unroll
    for (int c = 0; c < kTc; ++c) av[c] = *reinterpret_cast<const float4*>(a + 4 * c * lda + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = *reinterpret_cast<const float4*>(w + 8 * j * ldw + k);
#pragma unroll
    for (int c = 0; c < kTc; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[c][j] = fmaf(av[c].x, wv[j].x, acc[c][j]);
        acc[c][j] = fmaf(av[c].y, wv[j].y, acc[c][j]);
        acc[c][j] = fmaf(av[c].z, wv[j].z, acc[c][j]);
        acc[c][j] = fmaf(av[c].w, wv[j].w, acc[c][j]);
      }
  }
}

// The weight stream of one block: in each step, for each product p (0:
// h1p, 1: h2p, 2: d2 K2^T, 3: d1 K1^T), each chunk ch of its output
// columns and each k-tile t, a tile of rows x ld floats as it lies in a ring
// slot: forward products kt rows of K1 or K2 [k-tile, own columns of the
// chunk] at stride cols (zero past the own columns), transposed ones
// rows(p, ch) rows of K2 [own rows, k-tile] or K1 [rows of nz, own k-tile]
// at stride kt + 4. pack_l2_kernel writes every block's stream of a step
// once a launch, in this order, so that one bulk copy brings a tile.
struct L2Layout {
  int nz, ndf, J, cols, kt;
  __host__ __device__ int outputs(int p) const { return p == 3 ? nz : J; }
  __host__ __device__ int chunks(int p) const { return (outputs(p) + cols - 1) / cols; }
  __host__ __device__ int ktiles(int p) const { return (p == 0 ? nz : p == 3 ? J : ndf) / kt; }
  __host__ __device__ int tiles(int p) const { return chunks(p) * ktiles(p); }
  __host__ __device__ int rows(int p, int ch) const {
    const int left = outputs(p) - ch * cols;
    return p < 2 ? kt : left < cols ? left : cols;
  }
  __host__ __device__ int ld(int p) const { return p < 2 ? cols : kt + 4; }
  // Floats of product p's tiles in a step: over the chunks, the forward
  // products' rows are kt and the transposed ones' add up to outputs(p).
  __host__ __device__ long long floats(int p) const {
    return p < 2 ? (long long)chunks(p) * ktiles(p) * kt * cols : (long long)outputs(p) * ktiles(p) * (kt + 4);
  }
  __host__ __device__ long long rank_floats() const { return floats(0) + floats(1) + floats(2) + floats(3); }
  __host__ __device__ long long offset(int p, int ch, int t) const {
    long long base = 0;
    for (int q = 0; q < p; ++q) base += floats(q);
    return base + (p < 2 ? ((long long)ch * ktiles(p) + t) * kt * cols
                         : ((long long)ch * cols * ktiles(p) + (long long)t * rows(p, ch)) * (kt + 4));
  }
};

// One block a tile of one rank's step (blockIdx.x the tile in stream
// order, blockIdx.y the rank): its weights, rounded to bf16 in the bf16-dot
// variant, zero past the tile's columns.
template <bool kBf16>
__global__ void pack_l2_kernel(const float* __restrict__ k1, const float* __restrict__ k2, L2Layout L,
                               float* __restrict__ packed) {
  int p = 0, l = (int)blockIdx.x;
  while (l >= L.tiles(p)) l -= L.tiles(p), ++p;
  const int ch = l / L.ktiles(p), t = l - ch * L.ktiles(p), rank = (int)blockIdx.y, j0 = rank * L.J;
  const int c0 = ch * L.cols, k0 = t * L.kt, rows = L.rows(p, ch), ld = L.ld(p);
  const int width = p < 2 ? min(L.cols, L.J - c0) : L.kt;
  const float* src = p == 0   ? k1 + (size_t)k0 * L.ndf + j0 + c0
                     : p == 1 ? k2 + (size_t)k0 * L.ndf + j0 + c0
                     : p == 2 ? k2 + (size_t)(j0 + c0) * L.ndf + k0
                              : k1 + (size_t)c0 * L.ndf + j0 + k0;
  float* dst = packed + rank * L.rank_floats() + L.offset(p, ch, t);
  for (int e = threadIdx.x; e < rows * ld; e += blockDim.x) {
    const int r = e / ld, col = e - r * ld;
    dst[e] = col < width ? operand<kBf16>(src[(size_t)r * L.ndf + col]) : 0.f;
  }
}

// kM: chains per cluster (one of kL2Chains, or kL2Narrow); nz, ndf padded
// as l2_tiling says, cols and kt its tile. One cluster of kL2Cluster
// blocks a chain tile of kM rows.
template <int kM, bool kBf16>
__global__ void __launch_bounds__(L2Shape<kM>::kThreads, 1) prior_langevin_l2_kernel(
    const float* __restrict__ z_in, const float* __restrict__ packed, const float* __restrict__ b1,
    const float* __restrict__ b2, const float* __restrict__ k3, const int* __restrict__ seeds, int seed,
    int stream_noise, int row_base, float* __restrict__ z_out, int B, int nz, int ndf, int steps, float step_size,
    float coeff, int cols, int kt) {
  using Shape = L2Shape<kM>;
  constexpr int kTc = Shape::kTc, kWc = Shape::kWc, kThr = Shape::kThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int J = ndf / kL2Cluster, j0 = rank * J, ldx = J + 4, ldk = kt + 4;
  extern __shared__ float4 smem4[];
  __shared__ uint32_t row_seed[kM];
  __shared__ uint64_t full[kL2Stages];  // a ring slot's tile has landed
  float* zt = reinterpret_cast<float*>(smem4);  // nz x kM: z as [m][chain]
  float* part = zt + nz * kM;                    // nz x kM: d1 K1^T over own columns, [m][chain]
  float* xs = part + nz * kM;    // lrelu(h1p) own as [j][chain] (stride kM), then d1 as [chain][j] (stride ldx)
  float* ys = xs + kM * ldx;     // d2 own as [chain][j], stride ldx
  float* ring = ys + kM * ldx;   // kL2Stages slots of cols x ldk floats: the weight tiles
  float* stg = ring + kL2Stages * cols * ldk;  // 2 slots of kM x ldk: activation tiles from the cluster
  uint8_t* pos = reinterpret_cast<uint8_t*>(stg + 2 * kM * ldk);  // J x kM: h1p >= 0

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = (int)(blockIdx.x / kL2Cluster) * kM, nrows = min(kM, B - row0);
  // This warp's tile: chains half * kWc + ..., columns grp * 32 + ... of a chunk.
  const int half = warp % Shape::kHalves, grp = warp / Shape::kHalves, lc = lane / 8, lo = lane % 8;
  const int col_chain = half * kWc + lc * kTc, row_chain = half * kWc + lc;  // first chain, forward / transposed
  const int col_out = grp * 32 + lo * 4, row_out = grp * 32 + lo;            // first output column, the same

  const bool noisy = seeds != nullptr || stream_noise;
  if (tid < kM)
    row_seed[tid] = tid >= nrows      ? 0u
                    : seeds != nullptr ? (uint32_t)seeds[row0 + tid]
                                       : damc::stream_row_seed((uint32_t)seed, (uint32_t)(row_base + row0 + tid));
  for (int e = tid; e < nz * kM; e += kThr) {
    const int m = e / kM, r = e - m * kM;
    zt[e] = r < nrows ? z_in[(size_t)(row0 + r) * nz + m] : 0.f;  // ragged tile: zero rows
  }
  if (tid == 0) {
    for (int s = 0; s < kL2Stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(full + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The weight stream: tiles in order of step, product, output chunk,
  // k-tile; thread 0 arms a slot's mbarrier and brings its tile with one
  // bulk copy, while the other threads go on.
  const L2Layout L{nz, ndf, J, cols, kt};
  const float* stream = packed + rank * L.rank_floats();
  const int ktiles[4] = {nz / kt, ndf / kt, ndf / kt, J / kt};
  const int chunks[4] = {L.chunks(0), L.chunks(1), L.chunks(2), L.chunks(3)};
  int is = 0, ip = 0, ich = 0, ikt = 0, issued = 0, used = 0;
  auto issue = [&]() {
    if (tid == 0 && is < steps) {
      const int slot = issued % kL2Stages, bytes = L.rows(ip, ich) * L.ld(ip) * (int)sizeof(float);
      expect_bytes(full + slot, bytes);
      bulk_copy(ring + slot * cols * ldk, stream + L.offset(ip, ich, ikt), bytes, full + slot);
      if (++ikt == ktiles[ip]) {
        ikt = 0;
        if (++ich == chunks[ip]) {
          ich = 0;
          if (++ip == 4) ip = 0, ++is;
        }
      }
    }
    ++issued;
  };
  // The next tile of the stream, once it has landed; when every thread has
  // it (and is done with the one before), the tile kL2Stages - 1 ahead is
  // issued into the slot the previous one freed.
  auto acquire = [&]() -> const float* {
    const int slot = used % kL2Stages;
    wait_parity(full + slot, (used / kL2Stages) & 1);
    const float* w = ring + slot * cols * ldk;
    __syncthreads();
    issue();
    ++used;
    return w;
  };
  // The activations of k-tile t of product p from the block that owns
  // columns t kt: lrelu(h1p) as [k][chain] (p = 1) or d2 as [chain][k] at
  // stride ldk (p = 2); one 16-byte piece a thread (kt kM / 4 <= kThr).
  auto fetch = [&](int p, int t, float4& v) -> bool {
    const int k0 = t * kt, c = k0 / J, off = k0 - c * J;
    if (p == 1) {
      if (tid >= kt * kM / 4) return false;
      v = reinterpret_cast<const float4*>(cluster.map_shared_rank(xs, c) + off * kM)[tid];
    } else {
      const int q = kt / 4;
      if (tid >= kM * q) return false;
      const int r = tid / q, c4 = tid - r * q;
      v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(ys, c) + r * ldx + off + 4 * c4);
    }
    return true;
  };
  auto put = [&](int p, float* slot, const float4& v) {
    if (p == 1) {
      reinterpret_cast<float4*>(slot)[tid] = v;
    } else {
      const int q = kt / 4, r = tid / q, c4 = tid - r * q;
      *reinterpret_cast<float4*>(slot + r * ldk + 4 * c4) = v;
    }
  };

  float acc[kTc][4];
  auto zero = [&]() {
#pragma unroll
    for (int c = 0; c < kTc; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
  };
  // A product over ndf whose activations come from the cluster (p = 1, 2):
  // each k-tile's activations are fetched during the tile before (the first
  // before the loop), so a chunk's tiles alternate between the two slots.
  auto cluster_product = [&](auto stage, auto epilogue) {
    constexpr int p = decltype(stage)::value;
    const int nt = ndf / kt, nch = chunks[p];
    float4 v;
    if (fetch(p, 0, v)) put(p, stg, v);
    for (int ch = 0, f = 0; ch < nch; ++ch) {
      zero();
      const int cw = min(cols, J - ch * cols);
      const bool active = grp * 32 < cw;
      for (int t = 0; t < nt; ++t, ++f) {
        const float* w = acquire();
        const bool next = (t + 1 < nt || ch + 1 < nch) && fetch(p, (t + 1) % nt, v);
        const float* a = stg + (f % 2) * kM * ldk;
        if (active) {
          if constexpr (p == 1)
            col_product<kTc, false>(acc, a + col_chain, kM, w + col_out, cols, kt);
          else
            row_product<kTc>(acc, a + row_chain * ldk, ldk, w + row_out * ldk, ldk, kt);
        }
        if (next) put(p, stg + ((f + 1) % 2) * kM * ldk, v);
      }
      if (active) epilogue(ch * cols, cw);
    }
  };

  for (int i = 0; i < kL2Stages - 1; ++i) issue();
  for (int s = 0; s < steps; ++s) {
    // h1p = z K1 + b1, own columns: lrelu(h1p) and its sign.
    for (int ch = 0; ch < chunks[0]; ++ch) {
      zero();
      const int c0 = ch * cols, cw = min(cols, J - c0);
      const bool active = grp * 32 < cw;
      for (int t = 0; t < ktiles[0]; ++t) {
        const float* w = acquire();
        if (active) col_product<kTc, kBf16>(acc, zt + t * kt * kM + col_chain, kM, w + col_out, cols, kt);
      }
      if (active)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = col_out + j, col = c0 + n;
          if (n >= cw) continue;
          const float b = __ldg(b1 + j0 + col);
#pragma unroll
          for (int c = 0; c < kTc; ++c) {
            const float hp = acc[c][j] + b;
            pos[col * kM + col_chain + c] = hp >= 0.f;
            xs[col * kM + col_chain + c] = operand<kBf16>(lrelu(hp));
          }
        }
    }
    cluster.sync();
    // d2 = lrelu'(h1 K2 + b2) * k3, own columns.
    cluster_product(Stage<1>(), [&](int c0, int cw) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = col_out + j, col = c0 + n;
        if (n >= cw) continue;
        const float b = __ldg(b2 + j0 + col), head = __ldg(k3 + j0 + col);
#pragma unroll
        for (int c = 0; c < kTc; ++c) ys[(col_chain + c) * ldx + col] = operand<kBf16>(dlrelu(acc[c][j] + b) * head);
      }
    });
    cluster.sync();
    // d1 = lrelu'(h1p) * (d2 K2^T), own columns, over the rows of K2.
    cluster_product(Stage<2>(), [&](int c0, int cw) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = row_out + 8 * j, col = c0 + n;
        if (n >= cw) continue;
#pragma unroll
        for (int c = 0; c < kTc; ++c) {
          const int r = row_chain + 4 * c;
          xs[r * ldx + col] = operand<kBf16>((pos[col * kM + r] ? 1.f : kSlope) * acc[c][j]);
        }
      }
    });
    // d1 K1^T over own columns, every output: the block's partials.
    for (int ch = 0; ch < chunks[3]; ++ch) {
      zero();
      const int c0 = ch * cols, cw = min(cols, nz - c0);
      const bool active = grp * 32 < cw;
      for (int t = 0; t < ktiles[3]; ++t) {
        const float* w = acquire();
        if (active) row_product<kTc>(acc, xs + row_chain * ldx + t * kt, ldx, w + row_out * ldk, ldk, kt);
      }
      if (active)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = row_out + 8 * j;
          if (n >= cw) continue;
#pragma unroll
          for (int c = 0; c < kTc; ++c) part[(c0 + n) * kM + row_chain + 4 * c] = acc[c][j];
        }
    }
    cluster.sync();
    // z <- z - coeff * (d1 K1^T + z) (+ eps * N): the cluster's partials in rank order, in every block.
    for (int e = tid; e < nz * kM; e += kThr) {
      const int m = e / kM, r = e - m * kM;
      float g = 0.f;
#pragma unroll
      for (int c = 0; c < kL2Cluster; ++c) g += cluster.map_shared_rank(part, c)[e];
      float z = zt[e] - coeff * (g + zt[e]);
      if (noisy && r < nrows) z += step_size * damc::counter_normal(row_seed[r], s, m);
      zt[e] = z;
    }
  }
  cluster.sync();  // no block leaves while another may still read its partials
  if (rank == 0)
    for (int e = tid; e < nrows * nz; e += kThr) {
      const int r = e / nz, m = e - r * nz;
      z_out[(size_t)(row0 + r) * nz + m] = zt[m * kM + r];
    }
}

template <int kM, bool kBf16>
cudaError_t prepare_l2(const L2Tiling& t, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B,
                       cudaStream_t stream) {
  const auto kernel = prior_langevin_l2_kernel<kM, kBf16>;
  const int smem = l2_smem_bytes(t.nz, t.ndf, kM, t.cols, t.kt);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  *cfg = launch_config((B + kM - 1) / kM, kL2Cluster, smem, stream, attr);
  cfg->blockDim = dim3(L2Shape<kM>::kThreads);
  return err;
}

L2Layout l2_layout(const L2Tiling& t) { return {t.nz, t.ndf, t.ndf / kL2Cluster, t.cols, t.kt}; }

// Packs the weights into `packed` (8 x rank_floats() floats), then runs the chain.
template <int kM, bool kBf16>
int launch_l2(const float* z, const float* k1, const float* b1, const float* k2, const float* b2, const float* k3,
              const int* seeds, int seed, int stream_noise, int row_base, float* packed, float* out, int B,
              const L2Tiling& t, int steps, float step_size, float coeff, cudaStream_t stream) {
  const L2Layout L = l2_layout(t);
  const int tiles = L.tiles(0) + L.tiles(1) + L.tiles(2) + L.tiles(3);
  pack_l2_kernel<kBf16><<<dim3(tiles, kL2Cluster), 256, 0, stream>>>(k1, k2, L, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = prepare_l2<kM, kBf16>(t, &cfg, &attr, B, stream);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = prior_langevin_l2_kernel<kM, kBf16>;
  err = cudaLaunchKernelEx(&cfg, kernel, z, (const float*)packed, b1, b2, k3, seeds, seed, stream_noise, row_base,
                           out, B, t.nz, t.ndf, steps, step_size, coeff, t.cols, t.kt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int kM, bool kBf16>
int max_clusters_l2(const L2Tiling& t, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = prepare_l2<kM, kBf16>(t, &cfg, &attr, kM, nullptr);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = prior_langevin_l2_kernel<kM, kBf16>;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// The instantiations, by chains a cluster and dot precision.
using L2Launch = decltype(&launch_l2<8, false>);
using L2MaxClusters = decltype(&max_clusters_l2<8, false>);
static_assert(kNumL2Chains == 3 && kL2Chains[0] == 16 && kL2Chains[1] == 32 && kL2Chains[2] == 48 && kL2Narrow == 8,
              "the switches below take each of kL2Chains and kL2Narrow and no other");

L2Launch l2_launcher(int chains, bool bf16) {
  switch (chains) {
    case 8: return bf16 ? launch_l2<8, true> : launch_l2<8, false>;
    case 16: return bf16 ? launch_l2<16, true> : launch_l2<16, false>;
    case 32: return bf16 ? launch_l2<32, true> : launch_l2<32, false>;
    case 48: return bf16 ? launch_l2<48, true> : launch_l2<48, false>;
    default: return nullptr;
  }
}

L2MaxClusters l2_max_clusters(int chains, bool bf16) {
  switch (chains) {
    case 8: return bf16 ? max_clusters_l2<8, true> : max_clusters_l2<8, false>;
    case 16: return bf16 ? max_clusters_l2<16, true> : max_clusters_l2<16, false>;
    case 32: return bf16 ? max_clusters_l2<32, true> : max_clusters_l2<32, false>;
    case 48: return bf16 ? max_clusters_l2<48, true> : max_clusters_l2<48, false>;
    default: return nullptr;
  }
}


}  // namespace

DAMC_ERROR_STRING_EXPORT

// [chains per cluster, threads per block, the number of cluster sizes of
// the fp32 kernel, then those sizes, smallest first; the number of cluster
// sizes of the tensor-core kernel, then those, its tile and its threads per
// block; the streamed kernel's blocks per cluster, ring slots, the number of
// its chains a cluster, then those, its narrow chains, its 2 tile widths and
// its 3 tile depths] (out holds at least 32 ints): the wrapper checks its
// constants against these.
extern "C" void damc_fused_langevin_geometry(int* out) {
  int n = 0;
  out[n++] = kRows;
  out[n++] = kThreads;
  out[n++] = kNumClusters;
  for (int c : kClusters) out[n++] = c;
  out[n++] = kNumMmaClusters;
  for (int c : kMmaClusters) out[n++] = c;
  out[n++] = kTile;
  out[n++] = kMmaThreads;
  out[n++] = kL2Cluster;
  out[n++] = kL2Stages;
  out[n++] = kNumL2Chains;
  for (int c : kL2Chains) out[n++] = c;
  out[n++] = kL2Narrow;
  for (int c : kL2Cols) out[n++] = c;
  for (int k : kL2Ktiles) out[n++] = k;
}

// A block's shared memory: the tensor-core kernel's (bf16_dots with
// smem_weights) at widths it pads itself, else the fp32 kernel's over
// `cluster` blocks.
extern "C" int damc_fused_langevin_smem_bytes(int nz, int ndf, int cluster, int bf16_dots) {
  return bf16_dots ? mma_smem_bytes(nz, ndf, cluster) : smem_bytes(nz, ndf, cluster);
}

// The streamed kernel's block with `chains` chains and tiles of cols x kt,
// at padded widths.
extern "C" int damc_fused_langevin_l2_smem_bytes(int nz, int ndf, int chains, int cols, int kt) {
  return l2_smem_bytes(nz, ndf, chains, cols, kt);
}

// Floats of the streamed kernel's packed weights at the tiling of widths
// (nz, ndf), the scratch its launch needs; -1 where no tiling fits.
extern "C" long long damc_fused_langevin_l2_packed_floats(int nz, int ndf) {
  L2Tiling t;
  return l2_tiling(nz, ndf, &t) ? kL2Cluster * l2_layout(t).rank_floats() : -1;
}

// out = [padded nz, padded ndf, tile columns, tile depth, fitted chains] of
// the streamed kernel's tiling of widths (nz, ndf); returns 0 where no
// tiling fits a block.
extern "C" int damc_fused_langevin_l2_tiling(int nz, int ndf, int* out) {
  L2Tiling t;
  if (!l2_tiling(nz, ndf, &t)) return 0;
  out[0] = t.nz, out[1] = t.ndf, out[2] = t.cols, out[3] = t.kt, out[4] = t.base;
  return 1;
}

// How many clusters of the streamed kernel with `chains` chains the card
// runs at once, at the tiling of widths (nz, ndf).
extern "C" int damc_fused_langevin_l2_max_clusters(int nz, int ndf, int chains, int bf16_dots, int* out) {
  L2Tiling t;
  const L2MaxClusters run = l2_max_clusters(chains, bf16_dots != 0);
  if (!run || !l2_tiling(nz, ndf, &t) || !l2_takes(t, chains)) return (int)cudaErrorInvalidValue;
  return run(t, out);
}

// Noise: seeds = per-chain int32 counter seeds (counter mode); else
// stream_noise != 0 draws stream mode from the scalar `seed`, chain r of
// the launch with the seed of global row row_base + r (a rank's rows of a
// sharded batch start at row_base, so they draw what an unsharded launch
// draws for them); else the chain is noiseless. smem_weights != 0 selects
// a kernel that holds the weight slices in shared memory over `cluster`
// blocks: with bf16_dots the tensor-core kernel, over one of kMmaClusters,
// at the EBM's own widths (it pads them); else the fp32 kernel over one of
// kClusters, nz a multiple of 4 and ndf of the cluster. smem_weights == 0
// selects the streamed kernel in the precision bf16_dots says, over
// kL2Cluster blocks with `chains` chains a cluster (one its tiling takes;
// the other kernels take kRows and ignore it), at widths its tiling padded
// (l2_tiling gives them back unchanged), with `packed` its scratch:
// damc_fused_langevin_l2_packed_floats floats, 16-byte aligned (the others
// take null).
extern "C" int damc_fused_langevin(const float* z, const float* k1, const float* b1, const float* k2,
                                   const float* b2, const float* k3, const int* seeds, int seed,
                                   int stream_noise, int row_base, int bf16_dots, int smem_weights,
                                   int cluster, int chains, float* packed, float* out, int B, int nz, int ndf,
                                   int steps, float step_size, float coeff, void* stream) {
  static_assert(kNumClusters == 2 && kClusters[0] == 4 && kClusters[1] == 8,
                "the switch below launches each size of kClusters and no other");
  static_assert(kNumMmaClusters == 3 && kMmaClusters[0] == 1 && kMmaClusters[1] == 4 && kMmaClusters[2] == 8,
                "the switch below launches each size of kMmaClusters and no other");
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!smem_weights) {
    L2Tiling t;
    const L2Launch run = l2_launcher(chains, bf16_dots != 0);
    if (!run || cluster != kL2Cluster || !packed || reinterpret_cast<uintptr_t>(packed) % 16 ||
        !l2_tiling(nz, ndf, &t) || t.nz != nz || t.ndf != ndf || !l2_takes(t, chains))
      return (int)cudaErrorInvalidValue;
    return run(z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base, packed, out, B, t, steps, step_size, coeff,
               s);
  }
  if (bf16_dots) {
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
  decltype(&launch<4>) run = nullptr;
  switch (cluster) {
    case 4: run = launch<4>; break;
    case 8: run = launch<8>; break;
    default: break;
  }
  if (!run || nz % 4 || ndf % cluster) return (int)cudaErrorInvalidValue;
  return run(z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base, out, B, nz, ndf, steps,
             step_size, coeff, s);
}
