// K2: the whole n-step DAMC reverse-diffusion sweep in one launch.
//
// Replaces the TPU kernel damc_tpu/ops/pallas/fused_qsweep.py::_kernel
// (pallas_call in fused_reverse_sweep, :344), in its three noise modes:
// counter (per-row int32 seeds, serving), stream (one int32 seed for the
// launch, training; row seeds from counter_noise.cuh::stream_row_seed) and
// noiseless. Each step
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
// call; at B=16 and 100 steps that is 4.7 GFLOP against about 6.5 MB (at
// the training shape B=128, 38 GFLOP against 8 MB), so the fp32 CUDA-core
// rate bounds it (0.071 and 0.57 ms).
//
// What held the first kernel back: one block owned 8 rows for all 100
// steps and walked every layer of every step alone, so the time was one
// block's latency (27.5 ms at B=16, 28.1 ms at B=128 on an H100 80GB HBM3
// at 700 W), on 2 and 16 of the 132 SMs, each block re-reading all 5.9 MB
// of weights from L2 every step.
//
// Design. A thread-block cluster of kCluster = 8 blocks owns a tile of
// rows (4, 8, 12 or 16: the wrapper takes the smallest tile whose clusters
// all fit on the card at once, so B=16 runs 4 clusters on 32 SMs and
// B=128 11 clusters on 88) for all steps. Rows go across clusters, a
// layer's output columns across the blocks of a cluster: block `rank`
// computes the columns [rank * tile, (rank + 1) * tile) of every layer
// (tile = col_tile(dout), 16 or 32), so it needs 1/8 of the weights and
// uses each for all the tile's rows.
//  - Weights: the wrapper packs each layer's (lin, skip) and (gate, hyper)
//    pairs so that a block's rows of its columns are contiguous; a producer
//    warp streams them, 64 input rows a stage, into a ring of shared-memory
//    slots by bulk (TMA) copies completed on mbarriers, up to 10 stages
//    ahead of the 16 compute warps, which release each slot on an "empty"
//    mbarrier. The ring depth is what shared memory leaves beside the
//    tile's buffers (11 slots at 4 rows, 4 at 16): at 4-row tiles going
//    from 4 slots to 8 cut the sweep by a fifth.
//  - Exchange: each block keeps its output tile of every layer, and its
//    tile of every layer's context c = silu(pre_t[step] + pre_x), in its
//    own shared memory; after one cluster barrier a layer every block
//    gathers the layer's input (and, in the out layers, the popped skip)
//    and context through distributed shared memory. The context loads are
//    issued a layer ahead and the silu taken after that layer's products.
//    The Fourier features are split over the cluster the same way (one
//    more barrier a step); the ancestral step and its noise run in every
//    block on the same values, so each block holds the whole z.
//  - Arithmetic: compute warp w sums rows [(w % 8) * 8, (w % 8) * 8 + 8) of
//    every 64-row stage, in order, for one half of the tile's rows; a lane
//    owns one column and all of that half's rows (tile 32) or half of them
//    (tile 16), for all four products; the 8 partial sums of each output are
//    added in warp order. Every output element is thus summed in one order
//    fixed by the widths, never by B, the row tile or the cluster layout: a
//    row's result is the same bit for bit in any batch. No atomics.
//  - Precision: fp32 FMA on the CUDA cores, except t = z B, which is summed
//    in fp64 (8,192 multiply-adds a row and step): |t| reaches tens, and
//    the fp32 rounding of t - rint(t) is amplified by the chaotic sweep
//    into the largest error of the whole step. With it, 6 steps land about
//    20 times closer to the fp64 reference than the fp32 plain version.
//  - Widths: products read float4s of a layer's input, and gathers copy
//    float4s; a width that is not a multiple of 4 (the toy's nz = 2: its
//    last layer's output and context are 2 wide) takes its last rows and
//    columns one float at a time, in the same order, and the buffers' row
//    strides are rounded up to 4. The z, Fourier and ancestral-step loops
//    are scalar for every width.
//  - Not taken: precomputing the FiLM half (gate and hyper, 42% of the
//    multiply-adds) for every (step, row) off the serial path would cost
//    2 x 1,408 floats each (144 MB at B=128) and a second kernel.
// Where the time goes and what was measured: PERF.md (sections 5 and 6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows[4] = {4, 8, 12, 16};  // the row tiles (rows per cluster) a launch may take
constexpr int kCluster = 8;   // blocks per cluster, each owning 1/kCluster of a layer's columns
constexpr int kWorkers = 512;  // threads of the compute warps
constexpr int kProducer = kWorkers / 32;  // the warp that streams the weights
constexpr int kThreads = kWorkers + 32;
constexpr int kSplit = 8;     // chunks of every stage's rows, one per warp of each half
constexpr int kHalves = kWorkers / 32 / kSplit;  // warps on each chunk, each on half the rows
constexpr int kMaxTile = 32;  // most columns a block owns in one layer
constexpr int kStageRows = 64;  // input rows of a weight stage
constexpr int kChunkRows = kStageRows / kSplit;  // rows of a stage one warp sums
constexpr int kStageFloats = kStageRows * 2 * kMaxTile;
// Stages in the ring, all but one in flight: as many as shared memory
// allows beside the row tile's buffers.
__host__ __device__ constexpr int ring_stages(int rows) {
  return rows <= 4 ? 11 : rows <= 8 ? 8 : rows <= 12 ? 6 : 4;
}
constexpr int kLayers = 7;
constexpr float kSlope = 0.01f;
constexpr float kTwoPi = 6.2831854820251465f;  // float32(2 pi)

// Columns a block owns in a layer of width dout: ceil(dout / kCluster)
// rounded up to a multiple of 16 (the thread layouts of csl_layer).
__host__ __device__ inline int col_tile(int dout) {
  const int t = (dout + kCluster - 1) / kCluster;
  return (t + 15) / 16 * 16;
}
// Fourier features a block computes: ceil(nfour / kCluster).
__host__ __device__ inline int emb_tile(int nfour) { return (nfour + kCluster - 1) / kCluster; }
__host__ __device__ inline int stages_of(int n) { return (n + kStageRows - 1) / kStageRows; }

struct SweepArgs {
  // Each layer's (lin, skip) pair over din rows and (gate, hyper) pair over
  // dout rows, packed as [rank][row][matrix][col_tile(dout)] with zeros past
  // dout: the rows of a block's column tile of both matrices of a pair are
  // contiguous, so a stage is one bulk copy.
  const float* packed;
  int off[kLayers][2];  // first float of each packed pair
  const float* lin_b[kLayers];
  const float* skip_b[kLayers];
  const float* gate_b[kLayers];
  int din[kLayers];
  int dout[kLayers];
  int ctx_off[kLayers];  // column offset of the layer in pre_x / pre_t
  int ctx_total;
  int in_max;
  int d_max;
  int stages;  // weight stages of one step
};

__device__ __forceinline__ float act(float x) { return x >= 0.f ? x : kSlope * x; }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

// Bulk (TMA) copies from global to shared memory, completed on an mbarrier.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// Stage i of the launch into its slot: one bulk copy of the table's bytes.
template <int kStages>
__device__ __forceinline__ void issue_stage(const SweepArgs& a, const int2* table, int i,
                                            float* ring, uint64_t* full) {
  const int2 st = table[i % a.stages];
  const int s = i % kStages;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(full + s)),
               "r"(st.y)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(ring + s * kStageFloats)),
      "l"(a.packed + st.x), "r"(st.y), "r"(smem_u32(full + s))
      : "memory");
}

// acc_a[r] += x[r][k] A[k] and acc_b[r] += x[r][k] B[k] for the four k of
// one float4 of each row of x, in order of k.
template <int kRt>
__device__ __forceinline__ void fma4(const float* x, int x_ld, const float* wa, const float* wb,
                                     float* acc_a, float* acc_b) {
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(x + r * x_ld);
    acc_a[r] = fmaf(v.x, wa[0], acc_a[r]);
    acc_a[r] = fmaf(v.y, wa[1], acc_a[r]);
    acc_a[r] = fmaf(v.z, wa[2], acc_a[r]);
    acc_a[r] = fmaf(v.w, wa[3], acc_a[r]);
    acc_b[r] = fmaf(v.x, wb[0], acc_b[r]);
    acc_b[r] = fmaf(v.y, wb[1], acc_b[r]);
    acc_b[r] = fmaf(v.z, wb[2], acc_b[r]);
    acc_b[r] = fmaf(v.w, wb[3], acc_b[r]);
  }
}

// The same for the last m < 4 rows of an input whose width is not a
// multiple of 4 (the toy's context of width nz = 2), one k at a time and in
// order of k, so each sum takes the additions fma4 would give it; w holds
// the rows as the ring does, A at w[k * 2 kTile] and B kTile further.
template <int kRt, int kTile>
__device__ __forceinline__ void fma_tail(const float* x, int x_ld, const float* w, int m,
                                         float* acc_a, float* acc_b) {
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    if (u < m) {
      const float wa = w[u * 2 * kTile], wb = w[u * 2 * kTile + kTile];
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        const float v = x[r * x_ld + u];
        acc_a[r] = fmaf(v, wa, acc_a[r]);
        acc_b[r] = fmaf(v, wb, acc_b[r]);
      }
    }
  }
}

// This block's kTile output columns [col0, col0 + kTile) of layer l for
// all kRows rows: out = (h L + l) * sigmoid(c G + g) + c H + h S + s, into
// out (kRows x kTile). The weights arrive stage by stage in the ring (g
// counts the stages of the launch so far): the producer warp starts stage
// g + kStages - 1 once the compute warps have released its slot (stage
// g - 1), and each compute warp waits for stage g, sums its rows of it and
// releases it. Warp w sums rows [c * kChunkRows, (c + 1) * kChunkRows) of
// every stage, c = w % kSplit, for the rows of half w / kSplit; its lanes
// are kTile columns by 32 / kTile row groups. The chunks' partial sums meet
// in `part` and are added in chunk order. Columns past dout (a ragged last
// tile) come out as the bias of column dout - 1 and nobody reads them.
template <int kRows, int kTile, int kStages = ring_stages(kRows)>
__device__ __forceinline__ void csl_layer(const SweepArgs& a, int l, int rank, const float* x,
                                          int x_ld, const float* cb, int c_ld, float* ring,
                                          uint64_t* full, uint64_t* empty, const int2* table,
                                          int& g, int total, float* part, float* out) {
  constexpr int kGroups = 32 / kTile;             // row groups in a warp
  constexpr int kRt = kRows / kHalves / kGroups;  // rows per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = warp % kSplit, half = warp / kSplit;
  const int col = lane % kTile, row0 = (half * kGroups + lane / kTile) * kRt;
  const int dout = a.dout[l];
  // The biases of this thread's output column in the final sum.
  const int jj = min(rank * kTile + tid % kTile, dout - 1);
  const float gb = __ldg(a.gate_b[l] + jj), lb = __ldg(a.lin_b[l] + jj);
  const float sb = __ldg(a.skip_b[l] + jj);
  float al[kRt] = {}, as[kRt] = {}, ag[kRt] = {}, ah[kRt] = {};
  for (int p = 0; p < 2; ++p) {
    const int n = p == 0 ? a.din[l] : dout;
    const float* xr = p == 0 ? x + row0 * x_ld : cb + row0 * c_ld;
    const int ld = p == 0 ? x_ld : c_ld;
    for (int k0 = 0; k0 < n; k0 += kStageRows, ++g) {
      if (warp == kProducer) {
        const int i = g + kStages - 1;  // the stage to start, into the slot of stage g - 1
        if (lane == 0 && i < total) {
          if (i >= kStages) mbar_wait(empty + i % kStages, (i / kStages - 1) & 1);
          issue_stage<kStages>(a, table, i, ring, full);
        }
        continue;
      }
      if (lane == 0) mbar_wait(full + g % kStages, (g / kStages) & 1);
      __syncwarp();
      const float* slot = ring + (g % kStages) * kStageFloats + col;
#pragma unroll
      for (int h = 0; h < kChunkRows; h += 4) {
        const int i = chunk * kChunkRows + h;  // [row][matrix][kTile] in the slot
        const int m = n - (k0 + i);             // rows of these four that exist
        if (m >= 4) {
          float wa[4], wb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            wa[u] = slot[(i + u) * 2 * kTile];
            wb[u] = slot[(i + u) * 2 * kTile + kTile];
          }
          if (p == 0)
            fma4<kRt>(xr + k0 + i, ld, wa, wb, al, as);
          else
            fma4<kRt>(xr + k0 + i, ld, wa, wb, ag, ah);
        } else if (m > 0) {
          if (p == 0)
            fma_tail<kRt, kTile>(xr + k0 + i, ld, slot + i * 2 * kTile, m, al, as);
          else
            fma_tail<kRt, kTile>(xr + k0 + i, ld, slot + i * 2 * kTile, m, ag, ah);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + g % kStages);
    }
  }
  if (warp != kProducer) {
    float* pp = part + (chunk * 4 * kRows + row0) * kTile + col;  // [chunk][product][row][col]
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      pp[(0 * kRows + r) * kTile] = al[r];
      pp[(1 * kRows + r) * kTile] = as[r];
      pp[(2 * kRows + r) * kTile] = ag[r];
      pp[(3 * kRows + r) * kTile] = ah[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < kRows * kTile; e += kThreads) {
    const int r = e / kTile, c = e - r * kTile;
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kSplit; ++w) v += part[((w * 4 + q) * kRows + r) * kTile + c];
      s[q] = v;
    }
    out[e] = (s[0] + lb) * sigmoid(s[2] + gb) + s[3] + s[1] + sb;
  }
}

// dst[r][c] (row stride dst_ld) = act or identity of a layer-wide vector
// of width d whose columns the cluster's blocks hold in tiles (kRows x
// col_tile(d)). The compute warps take the rows in turn, their lanes the
// float4 columns; every remote read is issued before the first store. A
// width or a destination that is not a multiple of 4 floats (the toy's last
// layer, nz = 2) is copied one float at a time.
template <int kRows, bool kAct>
__device__ __forceinline__ void gather(const cg::cluster_group& cluster, const float* tiles, int d,
                                       float* dst, int dst_ld) {
  constexpr int kPerRow = kWorkers / 32 / kRows;  // warps on a row (at least one)
  constexpr int kMax = (kMaxTile * kCluster / 4 + 32 * kPerRow - 1) / (32 * kPerRow);  // float4s a lane
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w >= kRows * kPerRow) return;
  const int r = w % kRows, first = (w / kRows) * 32 + lane;
  const int n4 = d / 4, t = col_tile(d), shift = t == 16 ? 4 : 5;
  if ((d & 3) || (dst_ld & 3) || (reinterpret_cast<uintptr_t>(dst) & 15)) {
    for (int c = first; c < d; c += 32 * kPerRow) {
      const int owner = c >> shift;
      const float v = cluster.map_shared_rank(tiles, owner)[r * t + (c - (owner << shift))];
      dst[r * dst_ld + c] = kAct ? act(v) : v;
    }
    return;
  }
  float4 v[kMax];
#pragma unroll
  for (int u = 0; u < kMax; ++u) {
    const int c4 = first + 32 * kPerRow * u, c = c4 * 4, owner = c >> shift;
    if (c4 < n4)
      v[u] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(tiles, owner) + r * t +
                                              (c - (owner << shift)));
  }
#pragma unroll
  for (int u = 0; u < kMax; ++u) {
    const int c4 = first + 32 * kPerRow * u;
    if (c4 < n4)
      *reinterpret_cast<float4*>(dst + r * dst_ld + c4 * 4) =
          kAct ? make_float4(act(v[u].x), act(v[u].y), act(v[u].z), act(v[u].w)) : v[u];
  }
}

// This block's Fourier features [f0, f0 + ef) of every row, from the whole
// z: sin and cos of 2 pi (t - rint(t)), t = z B summed in fp64 so that the
// reduction keeps its digits (|t| reaches tens; in fp32 the reduction's
// rounding is the largest error of the whole step). Four neighbouring lanes
// share a feature, each summing one quarter of z in order; the quarters
// are added as (q0 + q1) + (q2 + q3).
template <int kRows>
__device__ __forceinline__ void fourier_tile(const float* zs, const float* __restrict__ fourier,
                                             int nz, int nfour, int rank, float* etile) {
  const int ef = emb_tile(nfour), f0 = rank * ef, nf = max(0, min(ef, nfour - f0));
  const int quarter = (nz + 3) / 4, tasks = 4 * kRows * nf;
  for (int base = threadIdx.x & ~31; base < tasks; base += kThreads) {  // whole warps
    const int e4 = base + (threadIdx.x & 31), e = e4 >> 2, q = e4 & 3;
    double t = 0.0;
    if (e4 < tasks) {
      const int r = e / nf, f = e - r * nf, k1 = min((q + 1) * quarter, nz);
#pragma unroll 4
      for (int k = q * quarter; k < k1; ++k)
        t = fma((double)zs[r * nz + k], (double)__ldg(fourier + k * nfour + f0 + f), t);
    }
    t += __shfl_down_sync(0xffffffffu, t, 1);  // q0 + q1, q2 + q3
    t += __shfl_down_sync(0xffffffffu, t, 2);  // (q0 + q1) + (q2 + q3)
    if (e4 < tasks && q == 0) {
      const int r = e / nf, f = e - r * nf;
      const float proj = kTwoPi * (float)(t - rint(t));  // sin(2 pi t) has period 1 in t
      etile[r * 2 * ef + f] = sinf(proj);
      etile[r * 2 * ef + ef + f] = cosf(proj);
    }
  }
}

template <int kRows, int kStages = ring_stages(kRows)>
__global__ void __launch_bounds__(kThreads, 1) reverse_sweep_kernel(
    const float* __restrict__ z_in, const float* __restrict__ fourier,
    const float* __restrict__ pre_x, const float* __restrict__ pre_t,
    const float* __restrict__ coeffs, const int* __restrict__ seeds, int seed, int stream_noise,
    int row_base, float* __restrict__ z_out, const __grid_constant__ SweepArgs a, int B, int nz,
    int nfour, int steps, int residual) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[kStages];   // a weight stage has landed
  __shared__ uint64_t empty[kStages];  // the compute warps are done with a stage
  __shared__ uint32_t row_seed[kRows];
  const int ef = emb_tile(nfour);
  float* ring = reinterpret_cast<float*>(smem4);     // kStages x kStageFloats: the weight stream
  float* part = ring + kStages * kStageFloats;       // kSplit x 4 x kRows x kMaxTile
  float* zs = part + kSplit * 4 * kRows * kMaxTile;  // kRows x nz: the whole z, in every block
  float* in = zs + kRows * nz;                       // kRows x in_max: layer input
  float* cb = in + kRows * a.in_max;                 // kRows x d_max: layer context
  float* otile = cb + kRows * a.d_max;  // kLayers x kRows x kMaxTile: this block's outputs
  float* ctile = otile + kLayers * kRows * kMaxTile;  // the same, of the contexts
  float* etile = ctile + kLayers * kRows * kMaxTile;  // kRows x 2 ef: Fourier sin, cos
  int2* table = reinterpret_cast<int2*>(etile + kRows * 2 * ef);  // a.stages: the weight stream

  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / kCluster) * kRows;
  const int nrows = min(kRows, B - row0);
  const int total = steps * a.stages;  // weight stages of the launch

  if (tid == 0) {
    int i = 0;
    for (int l = 0; l < kLayers; ++l)
      for (int p = 0; p < 2; ++p) {
        const int n = p == 0 ? a.din[l] : a.dout[l], t = col_tile(a.dout[l]);
        for (int k0 = 0; k0 < n; k0 += kStageRows)
          table[i++] = make_int2(a.off[l][p] + (rank * n + k0) * 2 * t,
                                 min(kStageRows, n - k0) * 2 * t * (int)sizeof(float));
      }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWorkers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages - 1 && i < total; ++i) issue_stage<kStages>(a, table, i, ring, full);
  }
  const bool noisy = seeds != nullptr || stream_noise;
  if (tid < nrows)
    row_seed[tid] = seeds != nullptr
                        ? (uint32_t)seeds[row0 + tid]
                        : damc::stream_row_seed((uint32_t)seed, (uint32_t)(row_base + row0 + tid));
  for (int e = tid; e < kRows * nz; e += kThreads) {
    const int r = e / nz;
    zs[e] = r < nrows ? z_in[(size_t)row0 * nz + e] : 0.f;  // ragged tile: zero rows
  }
  __syncthreads();

  // This block's context tile of layer l at a step: its columns of
  // c = silu(pre_t[step] + pre_x). Each thread owns one element; the loads
  // are issued a layer ahead and the silu taken after that layer's products.
  const float* px_rows = pre_x + (size_t)row0 * a.ctx_total;
  auto ctx_load = [&](int step, int l, float& vt, float& vx) {
    const int t = col_tile(a.dout[l]);
    if (tid < kRows * t) {
      const int r = tid / t, j = min(rank * t + tid % t, a.dout[l] - 1) + a.ctx_off[l];
      vt = __ldg(pre_t + (size_t)step * a.ctx_total + j);
      vx = r < nrows ? __ldg(px_rows + (size_t)r * a.ctx_total + j) : 0.f;
    }
  };
  auto ctx_store = [&](int l, float vt, float vx) {
    if (tid < kRows * col_tile(a.dout[l])) ctile[l * kRows * kMaxTile + tid] = silu(vt + vx);
  };
  float vt = 0.f, vx = 0.f;
  if (steps > 0) {
    ctx_load(0, 0, vt, vx);
    ctx_store(0, vt, vx);
    fourier_tile<kRows>(zs, fourier, nz, nfour, rank, etile);
  }
  cluster.sync();  // the cluster runs; step 0's embedding and first context are out

  int g = 0;  // weight stages consumed
  for (int step = 0; step < steps; ++step) {
    for (int l = 0; l < kLayers; ++l) {
      // This layer's input and context, from the cluster: the Fourier
      // embedding and z, or the previous layer's output, activated, and for
      // the out layers the popped skip beside it (activation after the
      // concat).
      const int dout = a.dout[l];
      if (l == 0) {
        for (int e = tid; e < kRows * nfour; e += kThreads) {
          const int r = e / nfour, f = e - r * nfour, owner = f / ef;
          const float* src = cluster.map_shared_rank(etile, owner) + r * 2 * ef + (f - owner * ef);
          in[r * a.in_max + f] = src[0];
          in[r * a.in_max + nfour + f] = src[ef];
        }
        for (int e = tid; e < kRows * nz; e += kThreads) {
          const int r = e / nz, k = e - r * nz;
          in[r * a.in_max + 2 * nfour + k] = zs[e];
        }
      } else {
        const int p = l - 1;
        gather<kRows, true>(cluster, otile + p * kRows * kMaxTile, a.dout[p], in, a.in_max);
        if (p >= 3) {  // mid pops skip 2, out0 skip 1, out1 skip 0
          const int q = 5 - p;
          gather<kRows, true>(cluster, otile + q * kRows * kMaxTile, a.dout[q], in + a.dout[p], a.in_max);
        }
      }
      gather<kRows, false>(cluster, ctile + l * kRows * kMaxTile, dout, cb, a.d_max);
      __syncthreads();
      // The next layer's context loads, in flight during this layer's products.
      const bool more = l + 1 < kLayers || step + 1 < steps;
      const int nstep = l + 1 < kLayers ? step : step + 1, nl = l + 1 < kLayers ? l + 1 : 0;
      if (more) ctx_load(nstep, nl, vt, vx);
      float* out = otile + l * kRows * kMaxTile;
      if (col_tile(dout) == 16)
        csl_layer<kRows, 16>(a, l, rank, in, a.in_max, cb, a.d_max, ring, full, empty, table, g, total,
                      part, out);
      else
        csl_layer<kRows, 32>(a, l, rank, in, a.in_max, cb, a.d_max, ring, full, empty, table, g, total,
                      part, out);
      if (more) ctx_store(nl, vt, vx);
      cluster.sync();  // every output and context tile of layer l is out
    }
    // Ancestral step; the cluster's last tiles hold the last layer's output
    // (eps before the residual).
    const float* last = otile + (kLayers - 1) * kRows * kMaxTile;
    const int t6 = col_tile(a.dout[kLayers - 1]);
    const float* cf = coeffs + step * 6;
    const float c1 = __ldg(cf + 0), c2 = __ldg(cf + 1), m_z = __ldg(cf + 2);
    const float m_x = __ldg(cf + 3), std_ = __ldg(cf + 4);
    const bool is_last = __ldg(cf + 5) > 0.5f;
    for (int e = tid; e < kRows * nz; e += kThreads) {
      const int r = e / nz, c = e - r * nz;
      const int owner = c / t6;
      const float o = cluster.map_shared_rank(last, owner)[r * t6 + (c - owner * t6)];
      const float z = zs[e];
      const float eps = residual ? z + o : o;
      const float x_pred = c1 * z - c2 * eps;
      float z_next = m_z * z + m_x * x_pred;
      if (!is_last && noisy && r < nrows)
        z_next += std_ * damc::counter_normal(row_seed[r], step, c);
      zs[e] = is_last ? x_pred : z_next;
    }
    if (step + 1 < steps) {
      __syncthreads();
      fourier_tile<kRows>(zs, fourier, nz, nfour, rank, etile);
      cluster.sync();  // the next step's embedding is out
    }
  }
  cluster.sync();  // no block leaves while another may still read its tiles
  if (rank == 0)
    for (int e = tid; e < nrows * nz; e += kThreads) z_out[(size_t)row0 * nz + e] = zs[e];
}

// Offsets of the packed pairs: layer by layer, (lin, skip) then (gate,
// hyper); a pair of n rows takes n * kCluster * 2 * col_tile(dout) floats.
int packed_offsets(const int* dims, int off[kLayers][2]) {
  int o = 0;
  for (int l = 0; l < kLayers; ++l) {
    const int din = dims[l], dout = dims[kLayers + l], w = kCluster * 2 * col_tile(dout);
    off[l][0] = o;
    o += din * w;
    off[l][1] = o;
    o += dout * w;
  }
  return o;
}

int stages_per_step(const int* dims) {
  int s = 0;
  for (int l = 0; l < kLayers; ++l) s += stages_of(dims[l]) + stages_of(dims[kLayers + l]);
  return s;
}

// Row strides of the layer input and context buffers: the widest input
// and output, rounded up to a multiple of 4 so that every row starts on a
// float4.
void row_widths(const int* dims, int* in_max, int* d_max) {
  int a = 0, b = 0;
  for (int l = 0; l < kLayers; ++l) {
    a = dims[l] > a ? dims[l] : a;
    b = dims[kLayers + l] > b ? dims[kLayers + l] : b;
  }
  *in_max = (a + 3) / 4 * 4;
  *d_max = (b + 3) / 4 * 4;
}

SweepArgs make_args(const float* packed, const void* const* layer_ptrs, const int* dims) {
  SweepArgs a;
  a.packed = packed;
  packed_offsets(dims, a.off);
  a.stages = stages_per_step(dims);
  int off = 0;
  for (int l = 0; l < kLayers; ++l) {
    const void* const* p = layer_ptrs + 7 * l;  // lin_k, lin_b, skip_k, skip_b, gate_k, gate_b, hyper_k
    a.lin_b[l] = static_cast<const float*>(p[1]);
    a.skip_b[l] = static_cast<const float*>(p[3]);
    a.gate_b[l] = static_cast<const float*>(p[5]);
    a.din[l] = dims[l];
    a.dout[l] = dims[kLayers + l];
    a.ctx_off[l] = off;
    off += a.dout[l];
  }
  a.ctx_total = off;
  row_widths(dims, &a.in_max, &a.d_max);
  return a;
}

int smem_bytes(const int* dims, int nz, int rows) {
  int in_max, d_max;
  row_widths(dims, &in_max, &d_max);
  const int nfour = (dims[0] - nz) / 2;
  const int per_row = nz + in_max + d_max + 2 * kLayers * kMaxTile + 2 * emb_tile(nfour);
  const int floats = ring_stages(rows) * kStageFloats + kSplit * 4 * rows * kMaxTile + rows * per_row;
  return (int)sizeof(float) * floats + (int)sizeof(int2) * stages_per_step(dims);
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

}  // namespace

DAMC_ERROR_STRING_EXPORT

namespace {

using SweepKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                             const int*, int, int, int, float*, const SweepArgs, int, int, int, int,
                             int);

// The kernel of a row tile (4, 8, 12 or 16 rows a cluster), or null.
SweepKernel kernel_for(int rows) {
  switch (rows) {
    case 4: return reverse_sweep_kernel<4>;
    case 8: return reverse_sweep_kernel<8>;
    case 12: return reverse_sweep_kernel<12>;
    case 16: return reverse_sweep_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

// [blocks per cluster, threads per block, chunks of a stage, most columns
// a block owns, rows of a stage, the three row tiles]: the wrapper's
// planner checks its constants against these.
extern "C" void damc_fused_qsweep_geometry(int* out) {
  out[0] = kCluster;
  out[1] = kThreads;
  out[2] = kSplit;
  out[3] = kMaxTile;
  out[4] = kStageRows;
  for (int i = 0; i < 4; ++i) out[5 + i] = kTileRows[i];
}

extern "C" int damc_fused_qsweep_col_tile(int dout) { return col_tile(dout); }

// dims = [din[0..6], dout[0..6]].
extern "C" int damc_fused_qsweep_smem_bytes(const int* dims, int nz, int rows) {
  return smem_bytes(dims, nz, rows);
}

extern "C" int damc_fused_qsweep_packed_floats(const int* dims) {
  int off[kLayers][2];
  return packed_offsets(dims, off);
}

// How many clusters of the kernel with this row tile the card runs at once.
extern "C" int damc_fused_qsweep_max_active_clusters(const int* dims, int nz, int rows, int* out) {
  const SweepKernel kernel = kernel_for(rows);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(dims, nz, rows);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// packed = the layers' matrices as the wrapper's pack_weights lays them
// out; dims = [din[0..6], dout[0..6]]; layer_ptrs = per layer, in order:
// lin_k, lin_b, skip_k, skip_b, gate_k, gate_b, hyper_k (the kernel reads
// the biases). pre_x (B, sum dout) and pre_t (steps, sum dout) hold the
// layers' columns side by side. rows = the row tile (4, 8, 12 or 16). Noise:
// seeds = per-row int32 counter seeds (counter mode); else stream_noise !=
// 0 draws stream mode from the scalar `seed`, row r of the launch with the
// seed of global row row_base + r (a rank's rows of a sharded batch);
// else the sweep is noiseless.
extern "C" int damc_fused_qsweep(const float* z, const float* fourier, const float* packed,
                                 const void* const* layer_ptrs, const int* dims, const float* pre_x,
                                 const float* pre_t, const float* coeffs, const int* seeds, int seed,
                                 int stream_noise, int row_base, float* out, int B, int nz,
                                 int nfour, int steps, int residual, int rows, void* stream) {
  const SweepKernel kernel = kernel_for(rows);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const SweepArgs a = make_args(packed, layer_ptrs, dims);
  const int smem = smem_bytes(dims, nz, rows);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config((B + rows - 1) / rows, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, z, fourier, pre_x, pre_t, coeffs, seeds, seed,
                           stream_noise, row_base, out, a, B, nz, nfour, steps, residual);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
