// gn_bwd_stats: phase A of the two-pass GroupNorm + activation backward.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_bwd_stats_kernel
// (reached through _tiled_backward, the custom_vjp of tiled_group_norm_gelu)
// together with the XLA tile sum and division that follow it
// (jnp.sum(gsums, axis=1) / denom). Given x, the gradient g of
// out = act(xn * scale + bias) and the forward's [B, 2, G] statistics
// (mean, inv), it computes per sample
//   msums[b, 0, grp] = mean over the group of dxn,
//   msums[b, 1, grp] = mean over the group of dxn * xn,
//   dscale_p[b, c]   = sum_t da * xn,   dbias_p[b, c] = sum_t da,
// with da = g * act'(y), dxn = da * scale. gn_bwd_apply then forms dx.
//
// Bound on an H100: bytes. It reads x and g once (2 x B*T*C*elem bytes) and
// writes 2 x B*C floats; at the 95008-wide readout in bf16 and B = 16 that is
// 1.22 GB, about 0.36 ms at 3.35 TB/s.
//
// Design. The earlier design gave each thread one column and walked the T
// rows in series in 128-thread blocks, and added the per-tile group sums in a
// second launch. Here each sample is one thread-block cluster of K blocks
// (K = kCluster, 8: 128 blocks at B = 16), launched with cudaLaunchKernelEx.
// The caller gives the column split: rank r owns columns [col_begin[r],
// col_begin[r + 1]) (the Python wrapper's bwd_stats_columns: contiguous
// slices on 16-byte boundaries). A thread owns VEC adjacent columns (one
// 16-byte vector of x and one of g per row where C and the group width
// allow, else VEC = 1) and one row slot: a chunk of the slice is laid out as
// (row slots) x (chunk / VEC) threads, so a narrow slice (C <= 5120: 64-640
// columns a rank, 512 threads) splits its rows over many slots and the wide
// one (the 95008-wide readout: 11880 columns a rank, 1024 threads) walks its
// slice in three chunks of two slots; every row's loads are coalesced along
// C. The loads go through a ring in shared memory (cp.async, kDepth rows in
// flight a thread, no registers held). Each thread sums da and da * xn over
// its rows; the slots' sums meet in shared memory and are added in slot
// order. Those column sums are the dbias / dscale partials (a column lies in
// one chunk, so they are complete); times scale they are the column sums of
// dxn and dxn * xn, which go, one warp per group the chunk touches, into the
// block's group partials, chunk after chunk in order. After a cluster
// barrier rank 0 reads the K ranks' group partials through distributed
// shared memory in rank order and writes msums; a last barrier keeps every
// rank's shared memory alive until it has. One launch for every shape, no
// atomics: two runs give the same bits.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): at C = 95008 the streaming
// reaches ~2.2 TB/s without the activation's derivative (0.55 ms) and 0.72
// ms with it: one block an SM on 128 of the 132 SMs, and the derivative's
// arithmetic, bound the issue rate; the narrow launches (C <= 5120, gelu)
// are bound by erff's arithmetic and the launch's fixed latency.
#include <cooperative_groups.h>

#include <algorithm>

#include "gn_common.cuh"

namespace cgrp = cooperative_groups;

namespace {

// Threads of a block: kNarrow where a rank's slice has at most kNarrow
// vectors of columns, else kWide (the 95008-wide readout: 0.72 against 0.74
// ms with 512 threads, NVIDIA H100 80GB HBM3 at 700 W).
constexpr int kNarrow = 512, kWide = 1024;
// Rows whose 16-byte loads a thread keeps in flight (cp.async into its own
// slots of a shared-memory ring, so they hold no registers; depth 3 measured
// the same at C = 95008, depth 6 with 512 threads slower).
constexpr int kDepth = 4;
// Blocks a sample: the portable cluster size (ONEPASS_CLUSTER in
// groupnorm_gelu.py, which builds the column split for it).
constexpr int kCluster = 8;

using ColSplit = gn::ColSplit<kCluster>;

// Dynamic shared memory: the load ring [kDepth, 2, threads] of 16-byte
// vectors, whose space the row slots' sums [slots, 2, width] reuse once the
// rows are read (slots x width <= threads x vec); then the chunk's column
// sums of dxn and dxn * xn [2, threads / 2 * vec]; then the block's group
// partials [2, groups].
__host__ __device__ inline size_t ring_bytes(int vec, int threads) {
  const size_t ring = vec > 1 ? (size_t)kDepth * 2 * threads * 16 : 0;
  const size_t red = 2 * (size_t)threads * vec * sizeof(float);
  return ring > red ? ring : red;
}
__host__ __device__ inline size_t smem_bytes(int groups, int vec, int threads) {
  return ring_bytes(vec, threads) + (size_t)threads * vec * sizeof(float) +
         2 * (size_t)groups * sizeof(float);
}

// The sums over a cluster's k ranks (k <= kCluster), in rank order, of
// a[i] and b[j] in each rank's shared memory (distributed shared memory);
// every load is issued before the first add.
__device__ __forceinline__ float2 ranks_sum(const cgrp::cluster_group& cluster,
                                            float* a, int i, float* b, int j, int k) {
  float va[kCluster], vb[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    if (r < k) {
      va[r] = cluster.map_shared_rank(a, r)[i];
      vb[r] = cluster.map_shared_rank(b, r)[j];
    }
  }
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    if (r < k) {
      sa += va[r];
      sb += vb[r];
    }
  }
  return make_float2(sa, sb);
}

template <typename T, int ACT, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
gn_bwd_stats_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const T* __restrict__ g,
                    const float* __restrict__ stats, float* __restrict__ msums,
                    float* __restrict__ dscale_p, float* __restrict__ dbias_p, int rows,
                    int cols, int groups, ColSplit split) {
  constexpr int kChunk = THREADS / 2 * VEC;  // most columns a block sums in one pass
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);                // [kDepth, 2, THREADS]
  float* red = reinterpret_cast<float*>(smem);                 // [slots, 2, width]
  float* chunk_sum = reinterpret_cast<float*>(smem + ring_bytes(VEC, THREADS));  // [2, kChunk]
  float* blk = chunk_sum + 2 * kChunk;                         // [2, groups] group sums

  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / k;
  const int cg = cols / groups;
  const float* st = stats + (size_t)b * 2 * groups;
  const T* xb = x + (size_t)b * rows * cols;
  const T* gb = g + (size_t)b * rows * cols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < 2 * groups; i += blockDim.x) blk[i] = 0.0f;

  // The slice in chunks of equal width: one where its vectors fit half the
  // threads (at least two row slots), else as many as keep that true.
  const int lo = split.begin[rank], hi = split.begin[rank + 1];
  const int vectors = (hi - lo + VEC - 1) / VEC;
  const int chunks = max(1, (2 * vectors + THREADS - 1) / THREADS);
  const int step = (vectors + chunks - 1) / chunks * VEC;
  for (int c0 = lo; c0 < hi; c0 += step) {
    const int width = min(step, hi - c0);
    const int lanes = (width + VEC - 1) / VEC;  // threads along the chunk's columns
    const int slots = THREADS / lanes;           // row slots
    const int lc = threadIdx.x % lanes, slot = threadIdx.x / lanes;
    const int c = c0 + lc * VEC;
    // Per column: sums over this slot's rows of da and da * xn. Those of
    // dxn = da * scale and dxn * xn are scale times these, taken per column
    // once the rows are summed.
    float s_da[VEC], s_daxn[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_da[e] = s_daxn[e] = 0.0f;
    if (slot < slots) {
      // A thread's VEC columns lie in at most two groups (VEC > 1 needs
      // C / G >= VEC): the first `split` in group g0, the rest in g0 + 1.
      const int g0 = c / cg;
      const int split = min(VEC, (g0 + 1) * cg - c);
      const float inv0 = st[groups + g0], shift0 = -st[g0] * inv0;  // xn = x * inv + shift
      const int g1 = min(g0 + 1, groups - 1);
      const float inv1 = st[groups + g1], shift1 = -st[g1] * inv1;
      float sc[VEC], bi[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sc[e] = scale[c + e];
        bi[e] = bias[c + e];
      }
      auto add_row = [&](const gn::Pack<T, VEC>& xv, const gn::Pack<T, VEC>& gv) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const bool first = e < split;
          const float xn = fmaf(gn::to_f32(xv.v[e]), first ? inv0 : inv1,
                                first ? shift0 : shift1);
          const float da =
              gn::to_f32(gv.v[e]) * gn::activate_grad<ACT>(fmaf(xn, sc[e], bi[e]));
          s_da[e] += da;
          s_daxn[e] = fmaf(da, xn, s_daxn[e]);
        }
      };
      // The thread's rows t = slot + j * slots in order of j.
      const int my_rows = (rows - slot + slots - 1) / slots;
      if constexpr (VEC * sizeof(T) == 16) {
        // the loads of the next kDepth - 1 rows in flight while one is summed
        auto issue = [&](int j) {
          if (j < my_rows) {
            const size_t i = (size_t)(slot + j * slots) * cols + c;
            gn::cp_async16(&ring[((j % kDepth) * 2) * THREADS + threadIdx.x], xb + i);
            gn::cp_async16(&ring[((j % kDepth) * 2 + 1) * THREADS + threadIdx.x], gb + i);
          }
          gn::cp_async_commit();
        };
#pragma unroll
        for (int j = 0; j < kDepth - 1; ++j) issue(j);
        for (int j = 0; j < my_rows; ++j) {
          issue(j + kDepth - 1);
          asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
          gn::Pack<T, VEC> xv, gv;
          *reinterpret_cast<uint4*>(xv.v) = ring[((j % kDepth) * 2) * THREADS + threadIdx.x];
          *reinterpret_cast<uint4*>(gv.v) = ring[((j % kDepth) * 2 + 1) * THREADS + threadIdx.x];
          add_row(xv, gv);
        }
      } else {  // VEC = 1: one element a row
#pragma unroll 4
        for (int j = 0; j < my_rows; ++j) {
          const size_t i = (size_t)(slot + j * slots) * cols + c;
          gn::Pack<T, VEC> xv, gv;
          xv.v[0] = xb[i];
          gv.v[0] = gb[i];
          add_row(xv, gv);
        }
      }
    }
    gn::cp_async_wait_all();
    __syncthreads();  // every thread is done with the ring, whose space red reuses
    if (slot < slots) {
      float* r = red + (size_t)slot * 2 * width + lc * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        r[e] = s_da[e];
        r[width + e] = s_daxn[e];
      }
    }
    __syncthreads();

    // the row slots' sums, added in slot order
    for (int j = threadIdx.x; j < 2 * width; j += blockDim.x) {
      const int q = j / width, col = j % width;
      float acc = 0.0f;
      for (int s = 0; s < slots; ++s) acc += red[((size_t)s * 2 + q) * width + col];
      (q == 0 ? dbias_p : dscale_p)[(size_t)b * cols + c0 + col] = acc;
      chunk_sum[q * kChunk + col] = acc * scale[c0 + col];
    }
    __syncthreads();

    // the groups this chunk touches: one warp each, added to the block's sums
    const int g_lo = c0 / cg, g_hi = (c0 + width - 1) / cg;
    for (int grp = g_lo + warp; grp <= g_hi; grp += nwarps) {
      const int a0 = max(grp * cg, c0) - c0, a1 = min((grp + 1) * cg, c0 + width) - c0;
      float a = 0.0f, q = 0.0f;
      for (int i = a0 + lane; i < a1; i += 32) {
        a += chunk_sum[i];
        q += chunk_sum[kChunk + i];
      }
      a = gn::warp_sum(a);
      q = gn::warp_sum(q);
      if (lane == 0) {
        blk[grp] += a;
        blk[groups + grp] += q;
      }
    }
    __syncthreads();  // red and chunk_sum are reused by the next chunk
  }

  cluster.sync();  // every rank's group sums are final
  if (rank == 0) {
    const float denom = (float)rows * (float)cg;
    for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
      const float2 sum = ranks_sum(cluster, blk, grp, blk, groups + grp, k);
      msums[(size_t)b * 2 * groups + grp] = sum.x / denom;
      msums[(size_t)b * 2 * groups + groups + grp] = sum.y / denom;
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  const void* g;
  const float* stats;
  float* msums;
  float* dscale_p;
  float* dbias_p;
  int batch, rows, cols, groups;
  ColSplit split;
  cudaStream_t stream;

  template <typename T, int ACT, int VEC, int THREADS>
  int run() const {
    const size_t smem = smem_bytes(groups, VEC, THREADS);
    auto kernel = gn_bwd_stats_kernel<T, ACT, VEC, THREADS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * kCluster);
    cfg.blockDim = dim3(THREADS);
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
                             static_cast<const T*>(g), stats, msums, dscale_p, dbias_p,
                             rows, cols, groups, split);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }

  template <typename T, int ACT>
  int operator()() const {
    constexpr int kVec = 16 / sizeof(T);
    // 16-byte loads need every row and every rank's first column on a
    // 16-byte boundary, and groups at least as wide as a load
    bool vec = cols % kVec == 0 && cols / groups >= kVec &&
               (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
               (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    int widest = 0;
    for (int r = 0; r < kCluster; ++r) {
      vec = vec && split.begin[r] % kVec == 0;
      widest = std::max(widest, split.begin[r + 1] - split.begin[r]);
    }
    if (vec)
      return (widest + kVec - 1) / kVec > kNarrow ? run<T, ACT, kVec, kWide>()
                                                 : run<T, ACT, kVec, kNarrow>();
    return widest > kNarrow ? run<T, ACT, 1, kWide>() : run<T, ACT, 1, kNarrow>();
  }
};

}  // namespace

// msums: [B, 2, G] f32; dscale_p, dbias_p: [B, C] f32. kCluster blocks per
// sample; `col_begin` (host memory, kCluster + 1 ints from 0 to cols, not
// decreasing) gives each rank's columns. Returns a cudaError_t code.
extern "C" int gn_bwd_stats(const void* x, const void* scale, const void* bias,
                            const void* g, const void* stats, void* msums,
                            void* dscale_p, void* dbias_p, int batch, int rows, int cols,
                            int groups, int dtype, int act, const int* col_begin,
                            void* stream) {
  ColSplit split{};
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      !split.read(col_begin, cols))
    return (int)cudaErrorInvalidValue;
  Launch launch{x,
                static_cast<const float*>(scale),
                static_cast<const float*>(bias),
                g,
                static_cast<const float*>(stats),
                static_cast<float*>(msums),
                static_cast<float*>(dscale_p),
                static_cast<float*>(dbias_p),
                batch, rows, cols, groups, split,
                static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
