// gn_act_onepass: GroupNorm + activation with each sample on chip, one
// thread-block cluster per sample.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_kernel
// (reached through _pallas_forward / fused_group_norm_gelu): per-sample
// GroupNorm over a [T, C] block, then affine, then gelu / tanh / none.
//
// Bound on an H100: bytes. The work is ~10 operations per element against
// 2 x elem_size bytes moved, far below the ~295 operations per byte where the
// tensor cores (or even the f32 units) would limit it. The least time is
// (read x once + write out once) / 3.35 TB/s: ~1 us at [16, 200, 512] bf16.
// At such sizes what a launch costs is latency: how many SMs pull the bytes
// and how long the chain of dependent steps is, not the bytes themselves.
//
// Design. The earlier design gave each sample one block of 1024 threads (16
// blocks on 132 SMs at B = 16, each walking 200 rows per column in series).
// Here each sample is a cluster of K blocks (K = `cluster`, 8 at the decode:
// 128 blocks at B = 16), launched with cudaLaunchKernelEx and a cluster
// dimension. The caller gives the row split: rank r stages rows
// [rank_begin[r], rank_begin[r + 1]) of its sample (the Python wrapper's
// cluster_rows: ceil(T / K) contiguous rows a rank, ranks past the end hold
// none) into shared memory with one coalesced read, sums each column over
// its rows, and reduces the columns of each group to an (s, q) partial in a
// fixed order. After a cluster barrier every rank reads all K ranks' partials
// through distributed shared memory in rank order, so every rank finalizes
// the same bits; a second barrier keeps each rank's shared memory alive until
// all have read it. Each rank then normalizes, applies the affine and the
// activation to its rows from shared memory and writes them once. No atomics,
// no second launch: two runs give the same bits. A block's shared memory is
// the column sums, the group partials and statistics (the statistics reuse
// the column sums' space) and its rows: never more than the whole sample
// with the same head, which is what the engage rule (onepass_fits) counts.
//
// What bounds it now (H100 SXM, 700 W): 7-16 us of device time a launch at
// the decode's sizes, set by the latency of the staging read, the column sums
// and the cluster barriers, not by the ~1-2 us of bytes; called back to back
// the launch is paced by the host (its wrapper and cudaLaunchKernelEx).
#include <cooperative_groups.h>

#include <algorithm>

#include "gn_common.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;  // the portable cluster size

// Column sums and squares (later the group statistics), then this rank's
// group partials (read by the other ranks); the staged rows start 16-byte
// aligned.
__host__ __device__ inline size_t stage_offset(int cols, int groups) {
  const size_t head = (2 * (size_t)cols + 2 * (size_t)groups) * sizeof(float);
  return (head + 15) & ~(size_t)15;
}

// The first row of each rank's part of a sample, and the end: rank r stages
// rows [begin[r], begin[r + 1]).
struct RankSplit {
  int begin[kMaxCluster + 1];
};

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
gn_act_onepass_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int rows, int cols, int groups, float eps, RankSplit split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* col_sum = reinterpret_cast<float*>(smem);
  float* col_sq = col_sum + cols;
  float* part = col_sq + cols;     // [2, groups]: this rank's (s, q) per group
  // the group statistics, written once every rank is past its column sums
  float* g_mean = col_sum;
  float* g_inv = col_sum + groups;
  T* xs = reinterpret_cast<T*>(smem + stage_offset(cols, groups));

  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int sample = blockIdx.x / k;
  const int r0 = split.begin[rank], r1 = split.begin[rank + 1];
  const int cg = cols / groups;
  const size_t n = (size_t)(r1 - r0) * cols;
  const T* xb = x + ((size_t)sample * rows + r0) * cols;
  T* ob = out + ((size_t)sample * rows + r0) * cols;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = cols % kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  // 1. Stage this rank's rows: the only read of x from HBM.
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(xb);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (size_t i = threadIdx.x; i < n / kVec; i += blockDim.x) dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) xs[i] = xb[i];
  }
  __syncthreads();

  // 2. Per-column sum and sum of squares over this rank's rows, in f32.
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int t = 0; t < r1 - r0; ++t) {
      const float v = gn::to_f32(xs[(size_t)t * cols + c]);
      s += v;
      q += v * v;
    }
    col_sum[c] = s;
    col_sq[c] = q;
  }
  __syncthreads();

  // 3. This rank's per-group partials, one warp per group.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int g = warp; g < groups; g += nwarps) {
    float s = 0.0f, q = 0.0f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      s += col_sum[c];
      q += col_sq[c];
    }
    s = gn::warp_sum(s);
    q = gn::warp_sum(q);
    if (lane == 0) {
      part[g] = s;
      part[groups + g] = q;
    }
  }
  cluster.sync();  // every rank's partials are written, its column sums read

  // 4. The sample's statistics from all ranks' partials, in rank order
  // (distributed shared memory), the same bits on every rank.
  const float denom = (float)rows * (float)cg;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int r = 0; r < k; ++r) {
      const float* remote = cluster.map_shared_rank(part, r);
      s += remote[g];
      q += remote[groups + g];
    }
    gn::finalize(s, q, denom, eps, &g_mean[g], &g_inv[g]);
  }
  cluster.sync();  // no rank leaves while another reads its partials; g_* published

  // 5. Normalise, affine, activate: the only write of out to HBM.
  if (vec) {
    for (size_t i = threadIdx.x; i < n / kVec; i += blockDim.x) {
      const int c0 = (int)((i * kVec) % cols);
      const uint4 raw = reinterpret_cast<const uint4*>(xs)[i];
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = c0 + e, g = c / cg;
        const float xn = (gn::to_f32(v[e]) - g_mean[g]) * g_inv[g];
        o[e] = gn::from_f32<T>(gn::activate<ACT>(xn * scale[c] + bias[c]));
      }
      reinterpret_cast<uint4*>(ob)[i] = res;
    }
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = (int)(i % cols), g = c / cg;
      const float xn = (gn::to_f32(xs[i]) - g_mean[g]) * g_inv[g];
      ob[i] = gn::from_f32<T>(gn::activate<ACT>(xn * scale[c] + bias[c]));
    }
  }
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  void* out;
  int batch, rows, cols, groups;
  float eps;
  int cluster;
  RankSplit split;
  cudaStream_t stream;

  template <typename T, int ACT>
  int operator()() const {
    int most = 0;
    for (int r = 0; r < cluster; ++r) most = std::max(most, split.begin[r + 1] - split.begin[r]);
    const size_t smem = stage_offset(cols, groups) + (size_t)most * cols * sizeof(T);
    auto kernel = gn_act_onepass_kernel<T, ACT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), scale, bias,
                             static_cast<T*>(out), rows, cols, groups, eps, split);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

}  // namespace

// `cluster` blocks per sample (1 .. 8); `rank_begin` (host memory, cluster + 1
// ints from 0 to rows, not decreasing) gives each rank's rows. A block takes
// its sample from its cluster's index and its rows from its rank. Returns a
// cudaError_t code: 0 when the kernel was launched.
extern "C" int gn_act_onepass(const void* x, const void* scale, const void* bias,
                              void* out, int batch, int rows, int cols, int groups,
                              float eps, int dtype, int act, const int* rank_begin,
                              int cluster, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      cluster < 1 || cluster > kMaxCluster || rank_begin == nullptr ||
      rank_begin[0] != 0 || rank_begin[cluster] != rows)
    return (int)cudaErrorInvalidValue;
  RankSplit split{};
  for (int r = 0; r <= cluster; ++r) {
    if (r > 0 && rank_begin[r] < rank_begin[r - 1]) return (int)cudaErrorInvalidValue;
    split.begin[r] = rank_begin[r];
  }
  Launch launch{x,     static_cast<const float*>(scale), static_cast<const float*>(bias),
                out,   batch, rows, cols, groups, eps, cluster, split,
                static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
