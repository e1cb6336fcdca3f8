// gn_stats: per-(sample, group) mean and rsqrt(var + eps) of a [B, T, C] map.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_stats_kernel
// (reached through _tiled_stats) together with the XLA finalize that follows
// it (_tiled_stats, mean / var / rsqrt over the per-tile partials).
//
// Bound on an H100: bytes. The kernel reads x once (B*T*C*elem bytes) and
// writes B*2*G floats; at the 95008-wide readout in bf16 and B = 16 that is
// 608 MB, about 0.18 ms at 3.35 TB/s. The narrow maps of a decode (C = 1024
// to 5120: 2-10 us of bytes) are bound by a launch's fixed latency.
//
// Design. The earlier design gave each thread one column of a 128-column
// block (11888 blocks at C = 95008), walked the T rows in series with one
// element a load, and added the tiles' partials in a second launch. Here
// each sample is one thread-block cluster of kCluster = 6 blocks (96 blocks
// at B = 16), one launch with cudaLaunchKernelEx. The caller gives the
// column split: rank r owns columns [col_begin[r], col_begin[r + 1]) (the
// wrapper's cluster_columns: contiguous slices on 128-byte boundaries), in
// chunks of at most kMaxVec * kThreads vectors of VEC adjacent columns (16
// bytes where C and the group width allow, else VEC = 1). Where a chunk
// has at most kThreads vectors (C <= 5120: 24-112 a rank) a thread owns one
// and a row slot, and the rows are dealt round the slots; where it has more
// (C = 95008: 1984 a rank) a thread owns up to kMaxVec of every row. The
// loads go through a ring in shared memory (cp.async, kRing 16-byte slots a
// thread, so they hold no registers; the L2::256B hint has L2 fetch whole
// 256-byte blocks). A vector's columns lie in at most two groups (the
// 11876-wide groups of the readout in bf16 put a boundary inside some):
// each thread sums x and x^2 of its vectors' columns in their first group,
// and of those in the next, over its rows, in registers. Then, for each
// group the chunk touches, the warp's shuffle tree, and the warps' shares
// added in warp order into the block's sums. Each rank writes its sums into
// its slot of rank 0's shared memory (distributed shared memory) and
// arrives on the cluster barrier; rank 0 waits, adds them in rank order and
// writes (mean, inv) with gn::finalize; the other ranks leave at once (no
// one reads their shared memory). No second launch, no partials in HBM, no
// atomics: two runs give the same bits.
//
// Why a cluster of 6 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --ab
// gn-stats-clusters): the card holds 17 clusters of 6 blocks that each take
// a whole SM at once, but only 15 of 7 or of 8 (a cluster lives in one
// GPC). With clusters of 8 at two blocks an SM allowed, the 16th sample's
// cluster shared its SMs with another and both ended last: the map's time
// was theirs. With 6, the 16 clusters of B = 16 run on 96 SMs of their own.
// What bounds it (chip_smoke.py --ab gn-stats): memory at C = 95008 (90% of
// the byte bound's rate, each of the 96 blocks streaming a 6.3 MB slice); at
// C <= 5120 the launch of a cluster and its barriers (about 4.5 us at T = 1).
#include <cooperative_groups.h>

#include "gn_common.cuh"

namespace cgrp = cooperative_groups;

namespace {

// Threads of a block (GN_STATS_THREADS and GN_STATS_CLUSTER: measurement
// builds, _build.VARIANTS).
#ifndef GN_STATS_THREADS
#define GN_STATS_THREADS 640
#endif
constexpr int kThreads = GN_STATS_THREADS;
// 16-byte slots a thread holds in the shared-memory load ring (cp.async, so
// loads in flight hold no registers): kRing / n rows of n vectors each.
constexpr int kRing = 8;
// Vectors of a row a thread loads at most (a chunk is at most kMaxVec *
// kThreads vectors wide); two rows of them still fit its ring.
constexpr int kMaxVec = 4;
static_assert(2 * kMaxVec <= kRing, "two rows of a thread's vectors in its ring");
// Blocks a sample (STATS_CLUSTER in groupnorm_gelu.py, which builds the
// column split for it).
#ifndef GN_STATS_CLUSTER
#define GN_STATS_CLUSTER 6
#endif
constexpr int kCluster = GN_STATS_CLUSTER;
constexpr int kWarps = kThreads / 32;

using ColSplit = gn::ColSplit<kCluster>;

// Dynamic shared memory: the load ring [kRing, kThreads] of 16-byte vectors;
// the block's group sums [2, groups]; the warps' shares of a chunk's group
// sums [2, groups, kWarps]; the cluster's group sums [kCluster, 2, groups],
// which rank 0's block receives.
constexpr size_t kRingBytes = (size_t)kRing * kThreads * 16;
inline size_t smem_bytes(int groups) {
  return kRingBytes + 2 * (size_t)groups * (1 + kWarps + kCluster) * sizeof(float);
}

// One chunk [c0, c0 + width) of sample xb, NV vectors a thread: where the
// chunk has at most kThreads vectors (NV = 1) thread i owns vector i % lanes
// and row slot i / lanes (rows slot, slot + slots, ...); else it owns vectors
// i, i + kThreads, ... of every row. A vector's first `cut` columns lie in
// its first group, the rest in the next: the thread sums x and x^2 of each
// part over its rows. Then, for each group g_lo + gi the chunk touches, the
// thread's parts in that group, the warp's shuffle tree, into
// part[{0, 1}][gi][warp].
template <typename T, int VEC, int NV>
__device__ __forceinline__ void chunk_sums(const T* __restrict__ xb, int rows, int cols,
                                           int c0, int lanes, int slots, int cg, int g_lo,
                                           int ng, int groups, uint4* ring, float* part) {
  const int slot = NV == 1 ? threadIdx.x / lanes : 0;
  const int v0 = NV == 1 ? threadIdx.x % lanes : threadIdx.x;
  const int my_rows = slot < slots ? (rows - slot + slots - 1) / slots : 0;
  float acc[NV][4];
  int cut[NV], first[NV];  // first: the vector's first group, -1 for none
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int c = c0 + (v0 + u * kThreads) * VEC;
    const bool mine = v0 + u * kThreads < lanes && my_rows > 0;
    first[u] = mine ? c / cg : -1;
    cut[u] = min(VEC, (c / cg + 1) * cg - c);
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;
  }
  auto add = [&](float* a, int cu, const gn::Pack<T, VEC>& xv) {
    if (cu == VEC) {  // the whole vector in one group
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = gn::to_f32(xv.v[e]);
        s += f;
        q = fmaf(f, f, q);
      }
      a[0] += s;
      a[1] += q;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = gn::to_f32(xv.v[e]);
        if (e < cu) {
          a[0] += f;
          a[1] = fmaf(f, f, a[1]);
        } else {
          a[2] += f;
          a[3] = fmaf(f, f, a[3]);
        }
      }
    }
  };
  // row slot + j * slots of the thread's vector u (a running 64-bit pointer
  // was slower on the card)
  auto at = [&](int j, int u) {
    return xb + (size_t)(slot + j * slots) * cols + c0 + (v0 + u * kThreads) * VEC;
  };
  if constexpr (VEC * sizeof(T) == 16) {
    // the loads of the next kDepth - 1 rows in flight while one is summed
    constexpr int kDepth = kRing / NV;
    auto issue = [&](int j) {
      if (j < my_rows) {
#pragma unroll
        for (int u = 0; u < NV; ++u)
          if (first[u] >= 0)
            gn::cp_async16_l2(&ring[((j % kDepth) * NV + u) * kThreads + threadIdx.x], at(j, u));
      }
      gn::cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kDepth - 1; ++j) issue(j);
    for (int j = 0; j < my_rows; ++j) {
      issue(j + kDepth - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (first[u] < 0) continue;
        gn::Pack<T, VEC> xv;
        *reinterpret_cast<uint4*>(xv.v) = ring[((j % kDepth) * NV + u) * kThreads + threadIdx.x];
        add(acc[u], cut[u], xv);
      }
    }
    gn::cp_async_wait_all();  // (none left in flight: the ring is the next chunk's)
  } else {  // VEC = 1: one element a load
    for (int j = 0; j < my_rows; ++j) {
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (first[u] < 0) continue;
        gn::Pack<T, VEC> xv;
        xv.v[0] = *at(j, u);
        add(acc[u], cut[u], xv);
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gi = 0; gi < ng; ++gi) {
    const int grp = g_lo + gi;
    float a = 0.0f, aq = 0.0f;
    bool any = false;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if (first[u] == grp) {
        a += acc[u][0];
        aq += acc[u][1];
        any = true;
      } else if (first[u] >= 0 && cut[u] < VEC && first[u] + 1 == grp) {
        a += acc[u][2];
        aq += acc[u][3];
        any = true;
      }
    }
    if (__any_sync(0xffffffffu, any)) {
      a = gn::warp_sum(a);
      aq = gn::warp_sum(aq);
    }
    if (lane == 0) {
      part[gi * kWarps + warp] = a;
      part[(groups + gi) * kWarps + warp] = aq;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int rows, int cols,
                int groups, float eps, const __grid_constant__ ColSplit split) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);               // [kRing, kThreads]
  float* blk = reinterpret_cast<float*>(smem + kRingBytes);  // [2, groups]
  float* part = blk + 2 * groups;                             // [2, groups, kWarps]
  float* ranks = part + 2 * groups * kWarps;                  // [kCluster, 2, groups]

  // every rank of the cluster is running before any writes into rank 0
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / k;
  const int cg = cols / groups;
  const T* xb = x + (size_t)b * rows * cols;

  for (int i = threadIdx.x; i < 2 * groups; i += kThreads) blk[i] = 0.0f;

  // The slice in chunks of at most kMaxVec * kThreads vectors, of equal width.
  const int lo = split.begin[rank], hi = split.begin[rank + 1];
  const int vectors = (hi - lo + VEC - 1) / VEC;
  const int chunks = max(1, (vectors + kMaxVec * kThreads - 1) / (kMaxVec * kThreads));
  const int step = (vectors + chunks - 1) / chunks * VEC;
  for (int c0 = lo; c0 < hi; c0 += step) {
    const int width = min(step, hi - c0);
    const int lanes = (width + VEC - 1) / VEC;         // vectors a row of the chunk
    const int nv = (lanes + kThreads - 1) / kThreads;  // vectors a thread
    const int slots = nv == 1 ? kThreads / lanes : 1;  // row slots
    const int g_lo = c0 / cg, ng = (c0 + width - 1) / cg - g_lo + 1;  // groups touched
    if (nv == 1)
      chunk_sums<T, VEC, 1>(xb, rows, cols, c0, lanes, slots, cg, g_lo, ng, groups, ring, part);
    else if (nv == 2)
      chunk_sums<T, VEC, 2>(xb, rows, cols, c0, lanes, slots, cg, g_lo, ng, groups, ring, part);
    else if (nv == 3)
      chunk_sums<T, VEC, 3>(xb, rows, cols, c0, lanes, slots, cg, g_lo, ng, groups, ring, part);
    else
      chunk_sums<T, VEC, kMaxVec>(xb, rows, cols, c0, lanes, slots, cg, g_lo, ng, groups, ring,
                                  part);
    __syncthreads();
    // each touched group's warp shares, in warp order, added to the block's sums
    for (int i = threadIdx.x; i < 2 * ng; i += kThreads) {
      const int gi = i % ng, row = i / ng;  // row 0: sums, 1: sums of squares
      const float* w = part + (row * groups + gi) * kWarps;
      float a = 0.0f;
#pragma unroll
      for (int p = 0; p < kWarps; ++p) a += w[p];
      blk[row * groups + g_lo + gi] += a;
    }
    __syncthreads();  // part is the next chunk's; blk is final after the last
  }

  // This rank's group sums into its slot of rank 0's shared memory; rank 0
  // waits for every rank's, adds them in rank order and finalizes. The other
  // ranks leave: no one reads their shared memory.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* slot0 = cluster.map_shared_rank(ranks, 0) + (size_t)rank * 2 * groups;
  for (int i = threadIdx.x; i < 2 * groups; i += kThreads) slot0[i] = blk[i];
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank == 0) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    const float denom = (float)rows * (float)cg;
    float* out = stats + (size_t)b * 2 * groups;
    for (int grp = threadIdx.x; grp < groups; grp += kThreads) {
      float s = 0.0f, q = 0.0f;
      for (int r = 0; r < k; ++r) {
        s += ranks[(size_t)r * 2 * groups + grp];
        q += ranks[(size_t)r * 2 * groups + groups + grp];
      }
      gn::finalize(s, q, denom, eps, &out[grp], &out[groups + grp]);
    }
  }
}

// The launch of gn_stats_kernel with `smem` bytes a block: a cluster of
// kCluster blocks per sample.
cudaLaunchConfig_t launch_config(int batch, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Launch {
  const void* x;
  float* stats;
  int batch, rows, cols, groups;
  float eps;
  ColSplit split;
  cudaStream_t stream;

  template <typename T, int VEC>
  int run() const {
    const size_t smem = smem_bytes(groups);
    auto kernel = gn_stats_kernel<T, VEC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(batch, smem, stream, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), stats, rows, cols,
                             groups, eps, split);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }

  template <typename T>
  int dispatch() const {
    constexpr int kVec = 16 / sizeof(T);
    // 16-byte loads need every row and every rank's first column on a
    // 16-byte boundary, and groups at least as wide as a load (a vector's
    // columns in at most two groups)
    bool vec = cols % kVec == 0 && cols / groups >= kVec &&
               (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    for (int r = 0; r < kCluster; ++r) vec = vec && split.begin[r] % kVec == 0;
    return vec ? run<T, kVec>() : run<T, 1>();
  }
};

}  // namespace

// stats: [B, 2, G] f32 (row 0 mean, row 1 inv). kCluster blocks per sample;
// `col_begin` (host memory, kCluster + 1 ints from 0 to cols, not
// decreasing) gives each rank's columns. Returns a cudaError_t code.
extern "C" int gn_stats(const void* x, void* stats, int batch, int rows, int cols,
                        int groups, float eps, int dtype, const int* col_begin,
                        void* stream) {
  ColSplit split{};
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      !split.read(col_begin, cols))
    return (int)cudaErrorInvalidValue;
  const Launch launch{x,    static_cast<float*>(stats), batch, rows, cols, groups, eps,
                      split, static_cast<cudaStream_t>(stream)};
  if (dtype == gn::kF32) return launch.dispatch<float>();
  if (dtype == gn::kBF16) return launch.dispatch<__nv_bfloat16>();
  return (int)cudaErrorInvalidValue;
}

#ifdef GN_STATS_PROBE
// Measurement build only: the most clusters of this build's bf16 kernel
// (16-byte loads, G = 8) the device holds at once, with its own shared
// memory a block or, with `whole_sm`, with as much as keeps one block an SM;
// negative: a cudaError_t code.
extern "C" int gn_stats_clusters(int whole_sm) {
  auto kernel = gn_stats_kernel<__nv_bfloat16, 8>;
  const size_t smem = whole_sm ? 200 * 1024 : smem_bytes(8);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(16, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
#endif
