// gn_bwd_onepass: backward of GroupNorm + activation with each sample on
// chip, one thread-block cluster per sample.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_bwd_kernel
// (reached through _pallas_backward, the custom_vjp of
// fused_group_norm_gelu). Given x and the gradient g of out = act(xn * scale
// + bias), it recomputes the statistics and xn, then
//   da   = g * act'(y)
//   dxn  = da * scale
//   dx   = (dxn - mean_g(dxn) - xn * mean_g(dxn * xn)) * inv_g
// and writes per-sample column sums of da * xn (dscale) and da (dbias), which
// the wrapper adds over the batch.
//
// Bound on an H100: bytes. About 40 operations per element against
// 3 x elem_size bytes moved (read x and g once, write dx once), far below the
// ~295 operations per byte where arithmetic would limit it; least time is
// those bytes over 3.35 TB/s (~3 us at [16, 200, 512] bf16). At such sizes a
// launch costs latency: how many SMs pull the bytes and how long the chain of
// dependent steps is.
//
// Design. The earlier design gave each sample one block of 1024 threads (16
// blocks on 132 SMs at B = 16, each walking all T rows per column). Here each
// sample is a cluster of K blocks (K = kCluster, 8: 128 blocks at B = 16),
// launched with cudaLaunchKernelEx and a cluster dimension, as gn_act_onepass
// is. The caller gives the row split: rank r stages rows [rank_begin[r],
// rank_begin[r + 1]) of its sample's x and g (the Python wrapper's
// cluster_rows: ceil(T / K) contiguous rows a rank) into shared memory with
// one coalesced read each (cp.async: every load of the block in flight at
// once), then
//   1. sums each column of x and x^2 over its rows (split over row slots
//      where C leaves threads idle, the slots added in order), and each
//      group's columns into an (s, q) partial, which it writes into its own
//      slot of every rank's shared memory (distributed shared memory);
//      cluster barrier;
//   2. adds the K slots it holds in rank order, so every rank finalizes the
//      same mean and inv_std bits;
//   3. sums each column of da and da * xn over its rows in the same way;
//      times scale those are the column sums of dxn and dxn * xn, which it
//      adds over each group's columns; it writes those group partials into
//      its slot of every rank, and each column's da and da * xn sums into
//      its slot of the rank that owns the column (ceil(C / K) columns a
//      rank); cluster barrier;
//   4. adds the slots it holds in rank order: the group means of dxn and
//      dxn * xn (the same bits on every rank) and the dscale / dbias
//      partials of its own columns;
//   5. writes dx for its rows from shared memory: the only write to HBM.
// Every read of another rank's data is local, after the barrier that
// follows its writes, so no rank waits for the others before it leaves; a
// split barrier at the start (arrive at once, wait before the first remote
// write) makes sure every rank of the cluster is running. No atomics, no
// second launch: two runs give the same bits. A block's shared memory is
// four column vectors, the K ranks' group partials (two sets) and column
// slices, two group vectors and two floats a thread for the row slots, then
// its rows of x and of g; the engage rule (onepass_bwd_fits) counts exactly
// that for ceil(T / K) rows and K = 8.
#include <cooperative_groups.h>

#include <algorithm>

#include "gn_common.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// Blocks a sample: the portable cluster size (ONEPASS_CLUSTER in
// groupnorm_gelu.py, which builds the rank split for it).
constexpr int kCluster = 8;

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) & ~(size_t)15; }

// Four column vectors; the K ranks' group partials of x and of dxn [2, K,
// 2, groups]; the K ranks' sums of da and da * xn over this rank's columns
// [2, K, ceil(cols / K)]; two group vectors; the row slots' sums (two per
// thread); then the staged rows of x, then those of g, each 16-byte aligned.
__host__ __device__ inline size_t stage_offset(int cols, int groups, int k) {
  const size_t per = (cols + k - 1) / k;
  return round16((4 * (size_t)cols + 4 * (size_t)k * groups + 2 * (size_t)k * per +
                  2 * (size_t)groups + 2 * (size_t)kThreads) *
                 sizeof(float));
}

struct RankSplit {
  int begin[kCluster + 1];
};

// Copies n elements from global to shared memory. With `vec` (both 16-byte
// aligned, n a multiple of a 16-byte vector) every thread issues its copies
// as cp.async, which do not wait for the data, so all of a block's loads are
// in flight at once; the caller waits with gn::cp_async_wait_all() and a
// barrier.
template <typename T>
__device__ void stage(const T* __restrict__ src, T* dst, size_t n, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    for (size_t i = threadIdx.x; i < n / kVec; i += blockDim.x)
      gn::cp_async16(dst + i * kVec, src + i * kVec);
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Per-group sums of two column vectors (each column times mul[c] where mul
// is given), one warp per group, lanes over the group's columns in order,
// then the warp's fixed shuffle tree; written into slot `rank` ([2, groups])
// of `slots` ([k, 2, groups]) in every rank of the cluster.
__device__ void push_group_sums(const cgrp::cluster_group& cluster, const float* a,
                                const float* b, const float* __restrict__ mul, float* slots,
                                int groups, int cg, int rank, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int grp = warp; grp < groups; grp += blockDim.x >> 5) {
    float s = 0.0f, q = 0.0f;
    for (int c = grp * cg + lane; c < (grp + 1) * cg; c += 32) {
      const float m = mul ? mul[c] : 1.0f;
      s += a[c] * m;
      q += b[c] * m;
    }
    s = gn::warp_sum(s);
    q = gn::warp_sum(q);
    if (lane < k) {  // lane r writes to rank r
      float* remote = cluster.map_shared_rank(slots, lane) + (size_t)rank * 2 * groups;
      remote[grp] = s;
      remote[groups + grp] = q;
    }
  }
}

// The sums in rank order of entry i of each rank's slot ([k, stride]).
__device__ __forceinline__ float2 slot_sums(const float* slots, int i, int j, int stride,
                                            int k) {
  float a = 0.0f, b = 0.0f;
  for (int r = 0; r < k; ++r) {
    a += slots[(size_t)r * stride + i];
    b += slots[(size_t)r * stride + j];
  }
  return make_float2(a, b);
}

// Sums over this rank's nr rows of two per-element terms, term(i, c) ->
// float2 for the element at i in column c, for every column. Where the
// columns leave threads idle (C < kThreads) the rows are split over row
// slots whose sums meet in `red` and are added in slot order.
template <typename Term>
__device__ void column_sums(int nr, int cols, float* red, float* out_a, float* out_b,
                            Term term) {
  const int slots = max(1, kThreads / cols);
  if (slots == 1) {
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float a = 0.0f, b = 0.0f;
      for (int t = 0; t < nr; ++t) {
        const float2 v = term((size_t)t * cols + c, c);
        a += v.x;
        b += v.y;
      }
      out_a[c] = a;
      out_b[c] = b;
    }
    __syncthreads();
    return;
  }
  const int c = threadIdx.x % cols, slot = threadIdx.x / cols;
  if (slot < slots) {
    float a = 0.0f, b = 0.0f;
    for (int t = slot; t < nr; t += slots) {
      const float2 v = term((size_t)t * cols + c, c);
      a += v.x;
      b += v.y;
    }
    red[slot * cols + c] = a;
    red[(slots + slot) * cols + c] = b;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < cols; col += blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int s = 0; s < slots; ++s) {
      a += red[s * cols + col];
      b += red[(slots + s) * cols + col];
    }
    out_a[col] = a;
    out_b[col] = b;
  }
  __syncthreads();
}

template <typename T, int ACT>
__device__ __forceinline__ float dx_of(T xv, T gv, float mean, float inv, float sc,
                                       float bi, float m1, float m2) {
  const float xn = (gn::to_f32(xv) - mean) * inv;
  const float dxn = gn::to_f32(gv) * gn::activate_grad<ACT>(xn * sc + bi) * sc;
  return (dxn - m1 - xn * m2) * inv;
}

// Two blocks an SM (at most 64 registers a thread), so the clusters of a
// launch need not wait for whole SMs.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
gn_bwd_onepass_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, const T* __restrict__ g,
                      T* __restrict__ dx, float* __restrict__ dscale_p,
                      float* __restrict__ dbias_p, int rows, int cols, int groups,
                      float eps, RankSplit split) {
  extern __shared__ __align__(16) unsigned char smem[];
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = (cols + k - 1) / k;  // columns whose dscale / dbias a rank writes
  float* col_a = reinterpret_cast<float*>(smem);  // sum x (local)
  float* col_b = col_a + cols;                      // sum x^2 (local)
  float* col_da = col_b + cols;                     // sum da (local)
  float* col_daxn = col_da + cols;                  // sum da*xn (local)
  float* part = col_daxn + cols;                    // [k, 2, groups] ranks' (s, q)
  float* part2 = part + 2 * k * groups;             // [k, 2, groups] ranks' dxn sums
  float* slice = part2 + 2 * k * groups;            // [2, k, per] ranks' da, da*xn sums
  float* g_mean = slice + 2 * k * per;
  float* g_inv = g_mean + groups;
  float* red = g_inv + groups;                      // [2, kThreads] row slots' sums (local)
  // group means of dxn and dxn*xn: col_a's and col_b's space, free once
  // step 1 has reduced them
  float* g_m1 = col_a;
  float* g_m2 = col_a + groups;

  // every rank of the cluster is running before any writes into another
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int sample = blockIdx.x / k;
  const int r0 = split.begin[rank], r1 = split.begin[rank + 1];
  const int nr = r1 - r0;
  const int cg = cols / groups;
  const size_t n = (size_t)nr * cols;
  const size_t off = ((size_t)sample * rows + r0) * cols;
  int most = 0;
  for (int r = 0; r < k; ++r) most = max(most, split.begin[r + 1] - split.begin[r]);
  T* xs = reinterpret_cast<T*>(smem + stage_offset(cols, groups, k));
  T* gs = reinterpret_cast<T*>(smem + stage_offset(cols, groups, k) +
                               round16((size_t)most * cols * sizeof(T)));
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = cols % kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(dx) & 15) == 0;

  // Stage this rank's rows of x and g: their only reads from HBM.
  stage(x + off, xs, n, vec);
  stage(g + off, gs, n, vec);
  gn::cp_async_wait_all();
  __syncthreads();

  // 1. Column sums of x and x^2 over this rank's rows, then group partials
  // into this rank's slot of every rank.
  column_sums(nr, cols, red, col_a, col_b, [&](size_t i, int) {
    const float v = gn::to_f32(xs[i]);
    return make_float2(v, v * v);
  });
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  push_group_sums(cluster, col_a, col_b, nullptr, part, groups, cg, rank, k);
  cluster.sync();  // every rank's (s, q) partials are in every rank

  // 2. The sample's statistics from the ranks' partials, in rank order.
  const float denom = (float)rows * (float)cg;
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    const float2 sq = slot_sums(part, grp, groups + grp, 2 * groups, k);
    gn::finalize(sq.x, sq.y, denom, eps, &g_mean[grp], &g_inv[grp]);
  }
  __syncthreads();

  // 3. Column sums of da and da*xn over this rank's rows; times scale they
  // are those of dxn and dxn*xn, whose group partials go into this rank's
  // slot of every rank, and each column's sums into its owner's slot.
  column_sums(nr, cols, red, col_da, col_daxn, [&](size_t i, int c) {
    const int grp = c / cg;
    const float xn = (gn::to_f32(xs[i]) - g_mean[grp]) * g_inv[grp];
    const float da = gn::to_f32(gs[i]) * gn::activate_grad<ACT>(xn * scale[c] + bias[c]);
    return make_float2(da, da * xn);
  });
  push_group_sums(cluster, col_da, col_daxn, scale, part2, groups, cg, rank, k);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int owner = c / per;
    float* remote = cluster.map_shared_rank(slice, owner);
    remote[(size_t)rank * per + c - owner * per] = col_da[c];
    remote[(size_t)(k + rank) * per + c - owner * per] = col_daxn[c];
  }
  cluster.sync();  // every rank's partials and column sums are in place

  // 4. Group means of dxn and dxn*xn in rank order (the same bits on every
  // rank), and the dscale / dbias partials of this rank's columns.
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    const float2 m = slot_sums(part2, grp, groups + grp, 2 * groups, k);
    g_m1[grp] = m.x / denom;
    g_m2[grp] = m.y / denom;
  }
  const int c_end = min(cols, (rank + 1) * per);
  for (int c = rank * per + (int)threadIdx.x; c < c_end; c += blockDim.x) {
    const int j = c - rank * per;
    const float2 sums = slot_sums(slice, j, k * per + j, per, k);
    dbias_p[(size_t)sample * cols + c] = sums.x;
    dscale_p[(size_t)sample * cols + c] = sums.y;
  }
  __syncthreads();  // g_m1, g_m2 published

  // 5. dx for this rank's rows: the only write to HBM. A thread's column
  // advances by blockDim % width per step (no division per element).
  T* db = dx + off;
  if (vec) {
    const int per_row = cols / kVec;  // vectors a row
    const int stride = (int)(blockDim.x % per_row);
    int v = (int)(threadIdx.x % per_row);
    for (size_t i = threadIdx.x; i < n / kVec; i += blockDim.x) {
      const int c0 = v * kVec;
      const uint4 xraw = reinterpret_cast<const uint4*>(xs)[i];
      const uint4 graw = reinterpret_cast<const uint4*>(gs)[i];
      const T* xv = reinterpret_cast<const T*>(&xraw);
      const T* gv = reinterpret_cast<const T*>(&graw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = c0 + e, grp = c / cg;
        o[e] = gn::from_f32<T>(dx_of<T, ACT>(xv[e], gv[e], g_mean[grp], g_inv[grp],
                                             scale[c], bias[c], g_m1[grp], g_m2[grp]));
      }
      reinterpret_cast<uint4*>(db)[i] = res;
      v += stride;
      if (v >= per_row) v -= per_row;
    }
  } else {
    const int stride = (int)(blockDim.x % cols);
    int c = (int)(threadIdx.x % cols);
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
      const int grp = c / cg;
      db[i] = gn::from_f32<T>(dx_of<T, ACT>(xs[i], gs[i], g_mean[grp], g_inv[grp],
                                            scale[c], bias[c], g_m1[grp], g_m2[grp]));
      c += stride;
      if (c >= cols) c -= cols;
    }
  }
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  const void* g;
  void* dx;
  float* dscale_p;
  float* dbias_p;
  int batch, rows, cols, groups;
  float eps;
  RankSplit split;
  cudaStream_t stream;

  template <typename T, int ACT>
  int operator()() const {
    int most = 0;
    for (int r = 0; r < kCluster; ++r) most = std::max(most, split.begin[r + 1] - split.begin[r]);
    const size_t staged = (size_t)most * cols * sizeof(T);
    const size_t smem = stage_offset(cols, groups, kCluster) + round16(staged) + staged;
    auto kernel = gn_bwd_onepass_kernel<T, ACT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), scale, bias,
                             static_cast<const T*>(g), static_cast<T*>(dx), dscale_p,
                             dbias_p, rows, cols, groups, eps, split);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

}  // namespace

// dscale_p, dbias_p: [B, C] f32 per-sample partials. kCluster blocks per
// sample; `rank_begin` (host memory, kCluster + 1 ints from 0 to rows, not
// decreasing) gives each rank's rows. Returns a cudaError_t code:
// 0 when the kernel was launched.
extern "C" int gn_bwd_onepass(const void* x, const void* scale, const void* bias,
                              const void* g, void* dx, void* dscale_p, void* dbias_p,
                              int batch, int rows, int cols, int groups, float eps,
                              int dtype, int act, const int* rank_begin,
                              void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      rank_begin == nullptr || rank_begin[0] != 0 || rank_begin[kCluster] != rows)
    return (int)cudaErrorInvalidValue;
  RankSplit split{};
  for (int r = 0; r <= kCluster; ++r) {
    if (r > 0 && rank_begin[r] < rank_begin[r - 1]) return (int)cudaErrorInvalidValue;
    split.begin[r] = rank_begin[r];
  }
  Launch launch{x,     static_cast<const float*>(scale), static_cast<const float*>(bias),
                g,     dx, static_cast<float*>(dscale_p), static_cast<float*>(dbias_p),
                batch, rows, cols, groups, eps, split,
                static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
