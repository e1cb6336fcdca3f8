// readout_bwd_fused: the fused readout's backward that never writes dy.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/readout_chain.py:_bwd_fused_dw_kernel
// (with _bwd_common). From y, the target x, the forward's [B, 2, G] statistics,
// readout_bwd_stats' group means msums = (m1, m2) and g = (gl, gm, inv_sigma)
// it recomputes, per element and in f32, what readout_bwd_dy writes,
//   dy = (da * scale - m1 - xn * m2) * inv_std,
// rounds it to the map's type and contracts it at once, in the kernel's body,
// into both weight-side gradients (f32 accumulation, before the inv_sigma
// scaling the caller applies):
//   dW[c, f]    = sum over the B*T rows r of dy[r, c] * h[r, f]      ([C, F])
//   dh[r, f]    = sum over the C columns c of dy[r, c] * W[c, f]     ([B*T, F])
// plus, from the f32 dy, dbias[c] = sum_r dy[r, c] and the partials of
// d inv_sigma = sum(dy * (y - bias) / inv_sigma). The [B, T, C] dy map is
// never written or read.
//
// Bound on an H100, at B = 16, T = 200, F = 1024, C = 95008 in bf16, three
// limits close together:
//  * operations: two products of 2 * B*T * C * F = 0.623 TFLOP each, 1.26 ms
//    at 989 TFLOP/s;
//  * bytes: the two passes below each read y and x (2 x 1.22 GB), and h
//    (7 MB) and W (195 MB) are read, f32 dW (389 MB) and dh (13 MB) written:
//    3.0 GB, 0.91 ms at 3.35 TB/s (a design reading y and x once would move
//    1.8 GB, 0.54 ms);
//  * the recomputation: 2 x 304M elements of 25 (dh pass) to 60 (dW pass)
//    operations each, 0.3-0.7 ms of CUDA-core issue.
//
// Design of the bf16 path. The TPU kernel walks a sequential grid and keeps
// the whole f32 dh resident while dW tiles retire one by one; a CUDA grid has
// no order, and the two contractions reduce over different axes of the one
// dy, so there are two passes (two launches) and no atomics (two runs give
// the same bits):
//  * the dW pass: an output tile is 128 columns of the map x 256 of F; its
//    loop runs over the B*T rows in steps of 64. dy is the MN-major A operand
//    (its rows are the loop's k), h the N-major B operand;
//  * the dh pass: an output tile is 128 rows x 256 of F; its loop runs over
//    the C columns in steps of 64. dy is the K-major A operand, W the N-major
//    B operand.
// dy once a pass: a thread-block cluster spans the F tiles of one output tile
// (4 ranks of 256 at F = 1024, one rank of 128 or 256 at F <= 256; at most 8,
// and further clusters along F beyond 2048). Each rank recomputes one
// contiguous slice of the rows of each dy stage (16 of 64 in the dW pass, 32
// of 128 in the dh pass at 4 ranks) into its own stage, rounded to bf16 in the
// wgmma layout with 128-byte swizzle, and a publisher thread carries the slice
// into the same stage of every other rank with bulk copies (distributed
// shared memory) that complete on that rank's dy_full barrier by their bytes,
// as TMA does. So each element's dy is computed once a pass, where a block
// owning one F tile would compute it once per F tile.
// Warp specialisation, one block per SM: warpgroup 0 holds the producers (one
// thread issues the TMA loads of this rank's slice of y and x into a ring of
// stages, another those of the h or W tile, 64 x 256, into a second ring)
// and the publisher (one thread: the bulk copies, and the arrivals on every
// rank's dy_empty once this rank's products of a stage are done);
// warpgroups 1 and 2 (setmaxnreg: 232 registers) each own 64 output rows,
// issue wgmma m64n256k16 (f32 accumulators, 128 a thread) and recompute the
// dy slices, two steps ahead of their products (the recomputation of step
// k + 2 runs while the asynchronous product of step k does: wgmma
// commit_group / wait_group 1), so that the other ranks' slices have a
// step's time to arrive. The consumers only arrive on barriers of their own
// block; the publisher does all traffic between blocks. Why the consumers
// recompute, and no warpgroups of their own: the 128 accumulators leave
// about 100 registers a thread beside them, enough for the recomputation,
// while a third warpgroup would take registers from the accumulators
// (readout_matmul_stats.cu splits the same 64K registers 40 / 232 / 232).
// What measurements on an H100 (700 W) taught this design: barriers at
// cluster scope (acquire and release .cluster, a proxy fence at cluster
// scope) and stores into other ranks' shared memory from every consumer
// cost more than the work; the arrivals of one thread per rank at block
// scope and bulk copies did not. The
// recomputation is latency-bound with only 8 warps an SM: per-element
// branches (masks, group lookups, a division's slow path) serialised its
// eight element chains, so a vector inside the map and inside one group
// takes a path without branches; the per-(sample, group) statistics sit in
// a table in shared memory, and the dh pass's scale and norm bias ride in
// its y/x stage (bulk copies); the loss is dispatched once, around the whole
// consumer loop, so that one copy of the recomputation is in the loop.
// Persistent grid: as many clusters as the card holds at once
// (cudaOccupancyMaxActiveClusters) walk the output tiles. Where a pass has too
// few tiles to fill the card (the dh pass's 25 row tiles at the flagship
// shape), its loop is cut into slabs: each (tile, slab) is a unit of work
// with its own partial output in scratch, added in slab order afterwards.
// Sums: the dW pass's threads keep per column the f32 sum of the f32 dy of
// the rows they recompute (dbias) and an f64 sum of the f32 partials of
// dy * (y - bias) over each vector of 8 columns (d inv_sigma). Per tile, a
// rank adds its 16 row lanes per column in order and its threads' d inv_sigma
// (divided by inv_sigma, in f32) warp by warp, and writes both to its slot of
// the (slab, rank) partials, which are added in (slab, rank) order afterwards.
// TMA needs rows on 16-byte boundaries; where C % 8 != 0 (ragged maps) y and x
// come through a cp.async instantiation instead (the producer warp copies the
// 4-byte words around each row slice and completes the stage with
// cp.async.mbarrier.arrive), everything else alike.
// Edges: dy = 0 outside the map; TMA zero-fills rows and columns past the
// tensors; F beyond the last tile is never stored.
//
// The f32 path (plain FMA, never TF32), kept for the f32 checks: two
// launches of blocks that each own a 64 x 64 output tile and recompute their
// dy tile for every step of their loop, as the first port of this kernel did.
#include "hopper.cuh"
#include "readout_common.cuh"

namespace {

using namespace hop;

// Everything the recomputation of dy reads.
struct Maps {
  const void* y;
  const void* x;
  const float* scale;
  const float* norm_bias;
  const float* bias;
  const float* stats;
  const float* msums;
  const float* g;
  float n_elem;
  int rows;    // B * T rows of the flattened map
  int t_rows;  // T rows per sample
  int cols, groups;
};

__device__ __forceinline__ float loss_grad(int loss, float o, float x) {
  if (loss == ro::kMSE) return ro::elem_loss_grad<ro::kMSE>(o, x);
  if (loss == ro::kMAE) return ro::elem_loss_grad<ro::kMAE>(o, x);
  return ro::elem_loss_grad<ro::kHuber>(o, x);
}

template <int VEC>
__device__ __forceinline__ void load_f32s(const float* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = __ldg(p + i);
  }
}

// dy of map rows r0 .. r0 + TR - 1 and columns c0 .. c0 + TC - 1, rounded to T
// and written to tile[row * SR + col * SC] (zeros outside the map). A thread
// keeps one vector of columns for the whole tile (and, the tile's columns
// being the block's, for the whole kernel), so with `sums` it can keep
// s_dy[i] += dy and s_dinv += dy * (y - bias) of the f32 dy. s_dinv is a
// double: its terms of both signs cancel to a small rest, and a thread adds
// thousands of them.
template <typename T, int VEC, int TR, int TC, int SR, int SC, int THREADS>
__device__ __forceinline__ void dy_tile(const Maps& p, int loss, float gl, float gm2, int r0,
                                        int c0, T* __restrict__ tile, bool sums,
                                        float (&s_dy)[VEC], double& s_dinv) {
  constexpr int NV = TC / VEC;         // vectors per tile row
  constexpr int LANES = THREADS / NV;  // tile rows in flight
  constexpr int PER = TR / LANES;      // rows per thread
  static_assert(TC % VEC == 0 && THREADS % NV == 0 && TR % LANES == 0, "tile and block");
  const int cv = threadIdx.x % NV, lane_r = threadIdx.x / NV;
  const int c = c0 + cv * VEC;
  const bool c_ok = c < p.cols;  // cols % VEC == 0: a vector is inside or outside
  const int cg = p.cols / p.groups;
  float sc[VEC], nb[VEC], bi[VEC];
  int g_lo = 0;
  bool one_group = true;
  if (c_ok) {
    load_f32s<VEC>(p.scale + c, sc);
    load_f32s<VEC>(p.norm_bias + c, nb);
    load_f32s<VEC>(p.bias + c, bi);
    g_lo = c / cg;
    one_group = (c + VEC - 1) / cg == g_lo;
  }
  const T* yb = static_cast<const T*>(p.y);
  const T* xb = static_cast<const T*>(p.x);
#pragma unroll(PER <= 4 ? PER : 2)
  for (int j = 0; j < PER; ++j) {
    const int rt = lane_r + j * LANES;
    const int r = r0 + rt;
    float d[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) d[i] = 0.0f;
    if (c_ok && r < p.rows) {
      const int b = r / p.t_rows;
      const float* st = p.stats + (size_t)b * 2 * p.groups;
      const float* ms = p.msums + (size_t)b * 2 * p.groups;
      float yv[VEC], xv[VEC];
      const size_t off = (size_t)r * p.cols + c;
      ro::load_vec<T, VEC>(yb + off, yv);
      ro::load_vec<T, VEC>(xb + off, xv);
      float mean = st[g_lo], inv = st[p.groups + g_lo];
      float m1 = ms[g_lo], m2 = ms[p.groups + g_lo];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (!one_group) {
          const int grp = (c + i) / cg;
          mean = st[grp];
          inv = st[p.groups + grp];
          m1 = ms[grp];
          m2 = ms[p.groups + grp];
        }
        const float xn = (yv[i] - mean) * inv;
        const float o = tanhf(xn * sc[i] + nb[i]);
        const float dl_do = gl * loss_grad(loss, o, xv[i]) + gm2 * (o - xv[i]);
        const float da = dl_do * (1.0f - o * o);
        const float dd = (da * sc[i] - m1 - xn * m2) * inv;
        d[i] = dd;
        if (sums) {
          s_dy[i] += dd;
          s_dinv += (double)(dd * (yv[i] - bi[i]));
        }
      }
    }
    if constexpr (SC == 1 && VEC > 1) {
      ro::store_vec<T, VEC>(tile + rt * SR + cv * VEC, d);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) tile[rt * SR + (cv * VEC + i) * SC] = gn::from_f32<T>(d[i]);
    }
  }
}

// The lead block's sums: dbias[c] from the threads' per-column sums, added
// over the row lanes in a fixed order through `red` (LANES x TC floats of
// shared memory), and the block's d inv_sigma partial. Call with all threads.
template <int VEC, int TC, int THREADS>
__device__ __forceinline__ void write_sums(const float (&s_dy)[VEC], double s_dinv, float inv_sigma,
                                           float* red, float* scratch, int c0, int cols,
                                           float* __restrict__ dbias,
                                           float* __restrict__ dinv_slot) {
  constexpr int NV = TC / VEC, LANES = THREADS / NV;
  const int cv = threadIdx.x % NV, lane_r = threadIdx.x / NV;
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[lane_r * TC + cv * VEC + i] = s_dy[i];
  __syncthreads();
  for (int col = threadIdx.x; col < TC; col += THREADS) {
    float a = 0.0f;
    for (int l = 0; l < LANES; ++l) a += red[l * TC + col];
    if (c0 + col < cols) dbias[c0 + col] = a;
  }
  // sum(dy * (y - bias) / inv_sigma): the division once per thread
  const float total = ro::block_sum((float)(s_dinv / (double)inv_sigma), scratch);
  if (threadIdx.x == 0) *dinv_slot = total;
}


// -- bf16: wgmma fed by TMA, dy shared across a cluster -------------------------

constexpr int kBM = 128;                  // output rows of a tile: 2 consumer warpgroups of 64
constexpr int kBK = 64;                   // loop step: map rows (dW pass), columns (dh pass)
constexpr int kMaxRanks = 8;              // F tiles a cluster spans, at most
constexpr int kConsumerThreads = 256;     // warpgroups 1 and 2
constexpr int kThreads = 128 + kConsumerThreads;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kDyBytes = kBM * kBK * 2;   // one dy stage, bf16
constexpr int kSwBlock = 64 * 128;        // 64 rows of 128 bytes: a swizzled block
constexpr int kCpPitchDw = 272, kCpPitchDh = 144;  // cp.async rows: 16-byte units around 128 / 64
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may use
constexpr int kRedLanes = kConsumerThreads / (kBM / 8);  // row lanes of the dW pass: 16
constexpr int kTabMax = 512;  // (sample, group) statistics kept in shared memory, at most

// Bytes of a rank's y and x slices in one stage of the ring; the dh pass's
// TMA stage also holds the step's 64 columns of scale and norm_bias.
__host__ __device__ constexpr int yx_bytes(bool dw, bool tma, int piece) {
  return tma ? 2 * (dw ? 2 : 1) * piece * 128 + (dw ? 0 : 2 * kBK * 4)
             : 2 * piece * (dw ? kCpPitchDw : kCpPitchDh);
}

struct Rings {
  int yx, op, dy;  // stages of the y/x ring, the h/W ring and the dy ring
};

// Offsets from the 1024-aligned start of shared memory, and the bytes a block
// asks for (with the alignment slack).
struct Layout {
  int dy, op, yx, red, tab, bars, bytes;
};

__host__ __device__ constexpr Layout layout_of(bool dw, int bn, bool tma, int piece, Rings r) {
  Layout l{};
  l.dy = 0;
  l.op = r.dy * kDyBytes;
  l.yx = l.op + r.op * kBK * bn * 2;
  l.red = l.yx + r.yx * yx_bytes(dw, tma, piece);
  l.tab = l.red + (dw ? (kRedLanes * kBM + 32) * 4 + kConsumerThreads * 8 : 0);
  l.bars = l.tab + kTabMax * 16;
  l.bytes = l.bars + 16 * (r.yx + r.op + 2 * r.dy) + 1024;
  return l;
}

// One pass's geometry and pointers (a kernel argument).
struct Pass {
  const float* scale;
  const float* norm_bias;
  const float* bias;
  const float* stats;
  const float* msums;
  const float* g;
  const __nv_bfloat16* y;  // read here only by the cp.async instantiation
  const __nv_bfloat16* x;
  float* out;    // [slabs, m_total, depth]: dW or dh, or their slab partials
  float* dbias;  // dW pass: [slabs * ranks, cols]
  float* dinv;   // dW pass: [slabs * ranks, m_tiles]
  float n_elem;
  int rows, t_rows, cols, groups, depth;
  int m_total, m_tiles, k_steps;  // output rows and their tiles; loop steps
  int slabs, k_per;               // slabs of the loop, steps a slab
  int ranks, fgroups, units;      // F tiles a cluster; clusters along F; units of work
  int piece;                      // rows of a rank's slice of a dy stage
  Rings rings;
  int tab;                        // B * G where the statistics fit kTabMax, else 0
  int loss;
};

// A cursor over the (unit, step)s of one cluster: units cluster, cluster +
// clusters, ...; a unit is (F group, slab, output tile), the tile fastest.
struct Work {
  int unit, k, k_end, mt, z, fg;

  __device__ __forceinline__ void start(const Pass& p, int u) {
    unit = u;
    if (u >= p.units) return;
    mt = u % p.m_tiles;
    z = (u / p.m_tiles) % p.slabs;
    fg = u / (p.m_tiles * p.slabs);
    k = z * p.k_per;
    k_end = min(p.k_steps, k + p.k_per);
  }
  __device__ __forceinline__ void next(const Pass& p, int clusters) {
    if (++k == k_end) start(p, unit + clusters);
  }
};

struct Ring {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The per-(sample, group) statistics of a row's normalization and of dy.
struct RowConsts {
  float mean, inv, m1, m2;
};

// The loss cotangents as dy needs them: g0, g1x2 = those of the loss and of
// the mse (times 2); n, rn = n_elem and its reciprocal rounded to nearest.
struct Cot {
  float g0, g1x2, n, rn;
  float gl, gm2;  // g0 / n, g1x2 / n
};

// a / n rounded to nearest, branch-free: q = a rn, then q + (a - q n) rn is
// the correctly rounded quotient when rn is the correctly rounded reciprocal
// (Markstein; no overflow or subnormals here).
__device__ __forceinline__ float div_n(float a, const Cot& k) {
  const float q = __fmul_rn(a, k.rn);
  return __fmaf_rn(__fmaf_rn(-q, k.n, a), k.rn, q);
}

// tanh(z) = 1 - 2 / (1 + e^{2z}) from ex2.approx and rcp.approx (absolute
// error about 1e-7; exact at both ends, e = 0 or inf).
__device__ __forceinline__ float fast_tanh(float z) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * 2.88539008177792681f));  // 2 log2(e)
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return fmaf(-2.0f, r, 1.0f);
}

// dy of one element. SUMS (the dW pass, whose f32 dy also feeds d bias and
// d inv_sigma): operation by operation as the plain version computes it in
// f32 (no contraction into FMAs, tanhf, the division by n_elem last), so
// that it rounds as the plain version's does. The d inv_sigma sum cancels to
// a small rest of the sum of its terms' magnitudes: cotangents divided by
// n_elem beforehand (da off by a fixed factor against msums) moved it by a
// fixed fraction of that sum, the same sign at every shape, enough to miss
// the check's 2e-3 where the rest is small, and the fast tanh moved it too. Else
// (the dh pass, whose dy only feeds the bf16 product): contracted, the fast
// tanh, the cotangents divided beforehand (gl, gm2), about a third of the
// operations; the two passes' f32 dy then differ by about 1e-7 relative,
// which their rounding to bf16 rarely shows.
template <int LOSS, bool SUMS>
__device__ __forceinline__ float dy_elem(float y, float x, float sc, float nb,
                                         const RowConsts& q, const Cot& k) {
  if constexpr (SUMS) {
    const float xn = __fmul_rn(__fsub_rn(y, q.mean), q.inv);
    const float o = tanhf(__fadd_rn(__fmul_rn(xn, sc), nb));
    const float dl_do = div_n(__fadd_rn(__fmul_rn(k.g0, ro::elem_loss_grad<LOSS>(o, x)),
                                        __fmul_rn(k.g1x2, __fsub_rn(o, x))),
                              k);
    const float da = __fmul_rn(dl_do, __fsub_rn(1.0f, __fmul_rn(o, o)));
    return __fmul_rn(__fsub_rn(__fsub_rn(__fmul_rn(da, sc), q.m1), __fmul_rn(xn, q.m2)), q.inv);
  } else {
    const float xn = (y - q.mean) * q.inv;
    const float o = fast_tanh(xn * sc + nb);
    const float dl_do = k.gl * ro::elem_loss_grad<LOSS>(o, x) + k.gm2 * (o - x);
    const float da = dl_do * (1.0f - o * o);
    return (da * sc - q.m1 - xn * q.m2) * q.inv;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// 16 bytes from global to shared memory, the first `bytes` of them read (the
// rest zeros).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

template <bool DW, int BN, bool TMA>
struct Kernel {
  static constexpr int kAcc = BN / 2;          // f32 accumulators a consumer thread
  static constexpr int kVpr = DW ? kBM / 8 : kBK / 8;  // vectors of 8 in a stage row
  static constexpr int kLanes = kConsumerThreads / kVpr;  // row lanes: 16 (dW), 32 (dh)
  static constexpr int kStageRows = DW ? kBK : kBM;       // rows of a dy stage
  static constexpr int kOpBytes = kBK * BN * 2;

  const Pass& p;
  unsigned char* smem;
  Layout L;
  uint64_t *yx_full, *yx_empty, *op_full, *op_empty, *dy_full, *dy_empty, *sliced, *read;
  int rank, cluster, clusters;

  __device__ __forceinline__ Kernel(const Pass& pass, unsigned char* base)
      : p(pass), smem(base) {
    L = layout_of(DW, BN, TMA, p.piece, p.rings);
    yx_full = reinterpret_cast<uint64_t*>(smem + L.bars);
    yx_empty = yx_full + p.rings.yx;
    op_full = yx_empty + p.rings.yx;
    op_empty = op_full + p.rings.op;
    dy_full = op_empty + p.rings.op;
    dy_empty = dy_full + p.rings.dy;
    sliced = dy_empty + p.rings.dy;
    read = sliced + p.rings.dy;
    rank = (int)cluster_rank();
    cluster = blockIdx.x / p.ranks;
    clusters = gridDim.x / p.ranks;
  }

  // (mean, inv_std, m1, m2) of sample b, group grp: from the table in shared
  // memory, which the consumers fill at the start where it fits.
  __device__ __forceinline__ RowConsts row_consts(int b, int grp) const {
    if (p.tab) {
      const float4 t = reinterpret_cast<const float4*>(smem + L.tab)[b * p.groups + grp];
      return {t.x, t.y, t.z, t.w};
    }
    const float* st = p.stats + (size_t)b * 2 * p.groups;
    const float* ms = p.msums + (size_t)b * 2 * p.groups;
    return {__ldg(st + grp), __ldg(st + p.groups + grp), __ldg(ms + grp),
            __ldg(ms + p.groups + grp)};
  }

  // The first map row and column of step w's stage.
  __device__ __forceinline__ int stage_row0(const Work& w) const {
    return DW ? w.k * kBK : w.mt * kBM;
  }
  __device__ __forceinline__ int stage_col0(const Work& w) const {
    return DW ? w.mt * kBM : w.k * kBK;
  }

  // -- producers ---------------------------------------------------------------

  // This rank's slice of y and x for every step, one TMA box of 64 columns x
  // `piece` rows each (two a tensor in the dW pass); in the dh pass also the
  // step's columns of scale and norm_bias (bulk copies, as far as the map
  // goes).
  __device__ void produce_yx_tma(const CUtensorMap* map_y, const CUtensorMap* map_x) {
    const int stage = yx_bytes(DW, true, p.piece);
    const int box = p.piece * 128;
    Ring r;
    Work w;
    for (w.start(p, cluster); w.unit < p.units; w.next(p, clusters)) {
      mbar_wait(&yx_empty[r.s], r.ph ^ 1);
      unsigned char* dst = smem + L.yx + r.s * stage;
      const int r0 = stage_row0(w) + rank * p.piece, c0 = stage_col0(w);
      if constexpr (DW) {
        mbar_expect_tx(&yx_full[r.s], 4 * box);
        tma_load(dst, map_y, c0, r0, &yx_full[r.s]);
        tma_load(dst + box, map_y, c0 + 64, r0, &yx_full[r.s]);
        tma_load(dst + 2 * box, map_x, c0, r0, &yx_full[r.s]);
        tma_load(dst + 3 * box, map_x, c0 + 64, r0, &yx_full[r.s]);
      } else {
        const int col_bytes = min(kBK, p.cols - c0) * 4;  // cols % 8 == 0: 32-byte pieces
        mbar_expect_tx(&yx_full[r.s], 2 * box + 2 * col_bytes);
        tma_load(dst, map_y, c0, r0, &yx_full[r.s]);
        tma_load(dst + box, map_x, c0, r0, &yx_full[r.s]);
        bulk_load(dst + 2 * box, p.scale + c0, col_bytes, &yx_full[r.s]);
        bulk_load(dst + 2 * box + kBK * 4, p.norm_bias + c0, col_bytes, &yx_full[r.s]);
      }
      r.next(p.rings.yx);
    }
  }

  // The same slices through cp.async (rows off 16-byte boundaries): each row's
  // 16-byte units around its columns, so that element c of the slice's row
  // lies at its element (row * cols + c0) % 8 + c; bytes past the map read as
  // zeros. The 32 lanes of warp 0 copy; each completes the stage on yx_full
  // (32 arrivals) when its copies have landed.
  __device__ void produce_yx_cp(int lane) {
    constexpr int kUnits = (DW ? kBM : kBK) * 2 / 16 + 1;  // the columns of a stage, and one
    constexpr int kPitch = DW ? kCpPitchDw : kCpPitchDh;
    const size_t total = (size_t)p.rows * p.cols * 2;  // bytes of the map
    const int bytes = yx_bytes(DW, false, p.piece);
    Ring r;
    Work w;
    for (w.start(p, cluster); w.unit < p.units; w.next(p, clusters)) {
      mbar_wait(&yx_empty[r.s], r.ph ^ 1);
      unsigned char* dst = smem + L.yx + r.s * bytes;
      const int r0 = stage_row0(w) + rank * p.piece, c0 = stage_col0(w);
      for (int t = 0; t < 2; ++t) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(t ? p.x : p.y);
        for (int pr = 0; pr < p.piece; ++pr) {
          const size_t u0 = ((size_t)(r0 + pr) * p.cols + c0) * 2 / 16;
          for (int i = lane; i < kUnits; i += 32) {
            const size_t at = (u0 + i) * 16;  // the unit's first byte
            const int n = at + 16 <= total ? 16 : (at < total ? (int)(total - at) : 0);
            cp_async16(dst + (t * p.piece + pr) * kPitch + 16 * i, n ? src + at : src, n);
          }
        }
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                       smem_u32(&yx_full[r.s]))
                   : "memory");
      r.next(p.rings.yx);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // The h (dW pass) or W (dh pass) tile of every step: 64 rows x BN of F,
  // BN / 64 boxes of 64 x 64 with 128-byte swizzle.
  __device__ void produce_op(const CUtensorMap* map_op) {
    Ring r;
    Work w;
    for (w.start(p, cluster); w.unit < p.units; w.next(p, clusters)) {
      mbar_wait(&op_empty[r.s], r.ph ^ 1);
      mbar_expect_tx(&op_full[r.s], kOpBytes);
      unsigned char* dst = smem + L.op + r.s * kOpBytes;
      const int n0 = (w.fg * p.ranks + rank) * BN;
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_load(dst + b * kSwBlock, map_op, n0 + 64 * b, w.k * kBK, &op_full[r.s]);
      r.next(p.rings.op);
    }
  }

  // -- consumers ---------------------------------------------------------------

  // Iterations (steps of all units) of this cluster: the same on every rank.
  __device__ int iterations() const {
    int n = 0;
    Work w;
    for (w.start(p, cluster); w.unit < p.units; w.start(p, w.unit + clusters))
      n += w.k_end - w.k;
    return n;
  }

  // y and x of the vector of 8 columns at (slice row pr, stage column cl).
  __device__ __forceinline__ void load_yx(const unsigned char* st, int pr, int cl, size_t e0,
                                          float (&yv)[8], float (&xv)[8]) const {
    if constexpr (TMA) {
      const int box = p.piece * 128;
      const unsigned char* a = st + (DW ? (cl / 64) * box : 0) + pr * 128 + (cl % 64) * 2;
      const uint4 ry = *reinterpret_cast<const uint4*>(a);
      const uint4 rx = *reinterpret_cast<const uint4*>(a + (DW ? 2 : 1) * box);
      const __nv_bfloat162* by = reinterpret_cast<const __nv_bfloat162*>(&ry);
      const __nv_bfloat162* bx = reinterpret_cast<const __nv_bfloat162*>(&rx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fy = __bfloat1622float2(by[i]), fx = __bfloat1622float2(bx[i]);
        yv[2 * i] = fy.x, yv[2 * i + 1] = fy.y;
        xv[2 * i] = fx.x, xv[2 * i + 1] = fx.y;
      }
    } else {
      constexpr int kPitch = DW ? kCpPitchDw : kCpPitchDh;
      const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(st + pr * kPitch) +
                               (int)(e0 & 7) + cl;
      const __nv_bfloat16* b = a + p.piece * kPitch / 2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        yv[i] = __bfloat162float(a[i]);
        xv[i] = __bfloat162float(b[i]);
      }
    }
  }

  // 8 consecutive floats of `src` from column c (zeros past cols).
  __device__ __forceinline__ void load8(const float* __restrict__ src, int c,
                                        float (&out)[8]) const {
    if (TMA && c + 8 <= p.cols) {  // cols % 8 == 0: 32-byte aligned
      const float4 a = __ldg(reinterpret_cast<const float4*>(src + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src + c) + 1);
      out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
      out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = c + i < p.cols ? __ldg(src + c + i) : 0.0f;
    }
  }

  // Recomputes the thread's part of this rank's slice of dy for step w (up
  // to 4 rows of one vector of 8 columns) into the rank's own dy
  // stage `dys`, rounded to bf16 in the wgmma layout; in the dW pass also
  // adds the f32 dy to the thread's sums. A vector inside the map and inside
  // one group takes a path without a branch, so that its eight elements'
  // chains interleave; the others (the map's edge, a group boundary inside
  // the vector) take them one by one.
  template <int LOSS>
  __device__ __forceinline__ void compute(const Work& w, int yx_s, int dys, int v, int l,
                                          const Cot& cot, float (&s_dy)[8], double& s_dinv) {
    const unsigned char* st = smem + L.yx + yx_s * yx_bytes(DW, TMA, p.piece);
    unsigned char* dy = smem + L.dy + dys * kDyBytes;
    const int p_begin = rank * p.piece;
    const int p_end = min(kStageRows, p_begin + p.piece);
    const int r0 = stage_row0(w), c0 = stage_col0(w);
    const int cl = 8 * v, c = c0 + cl;  // the vector's first column: in the stage, in the map
    const int cg = p.cols / p.groups;
    const int g_lo = c / cg;
    const bool whole = c + 8 <= p.cols && (c + 7) / cg == g_lo;
    float scv[8], nbv[8], bi[8];
    if constexpr (DW) {  // the thread's columns for the whole unit: L1 hits after the first
      load8(p.scale, c, scv);
      load8(p.norm_bias, c, nbv);
      load8(p.bias, c, bi);
    } else if constexpr (TMA) {  // from the stage (past the map: not loaded, not used)
      const float* cs = reinterpret_cast<const float*>(st + 2 * p.piece * 128) + cl;
#pragma unroll
      for (int i = 0; i < 8; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(cs + i);
        const float4 b = *reinterpret_cast<const float4*>(cs + kBK + i);
        scv[i] = a.x, scv[i + 1] = a.y, scv[i + 2] = a.z, scv[i + 3] = a.w;
        nbv[i] = b.x, nbv[i + 1] = b.y, nbv[i + 2] = b.z, nbv[i + 3] = b.w;
      }
    } else {
      load8(p.scale, c, scv);
      load8(p.norm_bias, c, nbv);
    }
#pragma unroll 1
    for (int rr = p_begin + l; rr < p_end; rr += kLanes) {  // the row in the stage
      const int row = r0 + rr;                   // the map row
      float yv[8], xv[8], dv[8];
      load_yx(st, rr - p_begin, cl, (size_t)row * p.cols + c0, yv, xv);
      const bool row_ok = row < p.rows;
      const int b = row_ok ? row / p.t_rows : 0;
      if (row_ok && whole) {
        const RowConsts q = row_consts(b, g_lo);
#pragma unroll
        for (int i = 0; i < 8; ++i) dv[i] = dy_elem<LOSS, DW>(yv[i], xv[i], scv[i], nbv[i], q, cot);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dv[i] = row_ok && c + i < p.cols
                      ? dy_elem<LOSS, DW>(yv[i], xv[i], scv[i], nbv[i],
                                      row_consts(b, (c + i) / cg), cot)
                      : 0.0f;
        }
      }
      if constexpr (DW) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s_dy[i] += dv[i];
          part = fmaf(dv[i], yv[i] - bi[i], part);
        }
        s_dinv += (double)part;
      }
      // the swizzled place of (rr, cl): 128-byte rows, 16-byte chunks XORed
      // with the row's place in its 8-row group; the dW stage is two blocks
      // of 64 columns
      const int off = (DW ? (cl / 64) * kSwBlock : 0) + rr * 128 +
                      ((((cl % 64) / 8) ^ (rr & 7)) << 4);
      *reinterpret_cast<uint4*>(dy + off) =
          make_uint4(pack_bf16(dv[0], dv[1]), pack_bf16(dv[2], dv[3]), pack_bf16(dv[4], dv[5]),
                     pack_bf16(dv[6], dv[7]));
    }
  }

  // The publisher (one thread of the producer warpgroup) keeps the remote
  // traffic off the consumers' path. For each step, in order: when this
  // rank's consumers have written their slice of the dy stage (`sliced`),
  // bulk copies (distributed shared memory) carry it into the same stage of
  // every other rank, each completing on that rank's dy_full by its bytes,
  // and dy_full here expects the other ranks' bytes (one rank: it just
  // arrives); then, when this rank's products of the step before are done
  // (`read`), it frees that stage on every rank (dy_empty). At the end it
  // waits until every rank has freed the last stages: then no rank still
  // reads this block's shared memory (a bulk copy's source), and no rank
  // arrives on its barriers any more, so the block may leave.
  __device__ void publish() {
    const int n_iter = iterations();
    const int p_begin = rank * p.piece;
    const int rows = min(kStageRows, p_begin + p.piece) - p_begin;
    constexpr int kBlocks = DW ? 2 : 1;  // blocks of 64 columns in a stage
    Ring pub, rel;
    auto release = [&]() {
      mbar_wait(&read[rel.s], rel.ph);
      const uint32_t bar = smem_u32(&dy_empty[rel.s]);
      for (int q = 0; q < p.ranks; ++q) mbar_arrive_remote(cluster_addr(bar, q));
      rel.next(p.rings.dy);
    };
    for (int j = 0; j < n_iter; ++j) {
      mbar_wait(&sliced[pub.s], pub.ph);
      if (p.ranks == 1) {
        mbar_arrive(&dy_full[pub.s]);
      } else {
        mbar_expect_tx(&dy_full[pub.s], kDyBytes - kBlocks * rows * 128);
        const unsigned char* stage = smem + L.dy + pub.s * kDyBytes;
        const uint32_t bar = smem_u32(&dy_full[pub.s]);
        for (int q = 0; q < p.ranks; ++q) {
          if (q == rank) continue;
          for (int blk = 0; blk < kBlocks; ++blk) {
            const unsigned char* src = stage + blk * kSwBlock + p_begin * 128;
            bulk_copy_cluster(cluster_addr(smem_u32(src), q), src, rows * 128,
                              cluster_addr(bar, q));
          }
        }
      }
      pub.next(p.rings.dy);
      if (j > 0) release();  // step j - 1
    }
    if (n_iter > 0) release();
    for (int j = max(0, n_iter - p.rings.dy); j < n_iter; ++j)
      mbar_wait(&dy_empty[j % p.rings.dy], (j / p.rings.dy) & 1);
  }

  template <int LOSS>
  __device__ void consume(int lane) {
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128, cwarp = ct / 32;
    const int v = ct % kVpr, l = ct / kVpr;
    for (int i = ct; i < p.tab; i += kConsumerThreads) {  // the statistics table
      const float* st = p.stats + (size_t)(i / p.groups) * 2 * p.groups + i % p.groups;
      const float* ms = p.msums + (size_t)(i / p.groups) * 2 * p.groups + i % p.groups;
      reinterpret_cast<float4*>(smem + L.tab)[i] =
          make_float4(__ldg(st), __ldg(st + p.groups), __ldg(ms), __ldg(ms + p.groups));
    }
    consumers_sync();
    const float n = p.n_elem;
    const float g0 = __ldg(p.g), g1x2 = __ldg(p.g + 1) * 2.0f;
    const Cot cot{g0, g1x2, n, __frcp_rn(n), g0 / n, g1x2 / n};
    const int n_iter = iterations();
    float acc[kAcc];
    // The dW pass's sums belong to the compute cursor's unit; it runs two
    // steps ahead of the products, so a unit's sums go to
    // shared memory (`red`) when it enters the next unit, before that unit's
    // tile is done (or when the tile is done, after the last unit).
    float s_dy[8] = {};
    double s_dinv = 0.0;
    float* red = reinterpret_cast<float*>(smem + L.red);  // [kRedLanes, kBM] d bias sums
    double* red_dinv = reinterpret_cast<double*>(red + kRedLanes * kBM);  // [threads]
    auto flush = [&]() {
      float4* dst = reinterpret_cast<float4*>(red + l * kBM + 8 * v);
      dst[0] = make_float4(s_dy[0], s_dy[1], s_dy[2], s_dy[3]);
      dst[1] = make_float4(s_dy[4], s_dy[5], s_dy[6], s_dy[7]);
      red_dinv[ct] = s_dinv;
#pragma unroll
      for (int i = 0; i < 8; ++i) s_dy[i] = 0.0f;
      s_dinv = 0.0;
    };
    Ring yx, dyw, dyr, op;
    Work wc, mw;  // the compute and the product cursors
    wc.start(p, cluster);
    mw.start(p, cluster);
    int unit_c = -1;

    // one step of the compute cursor: wait for y/x and for the dy stage to
    // be free on every rank, recompute this rank's slice, hand it to the
    // publisher, free the y/x stage
    auto step_compute = [&]() {
      mbar_wait(&yx_full[yx.s], yx.ph);
      mbar_wait(&dy_empty[dyw.s], dyw.ph ^ 1);
      if (DW && wc.unit != unit_c) {  // the dW pass's sums: the unit's, per thread
        if (unit_c >= 0) flush();
        unit_c = wc.unit;
      }
      compute<LOSS>(wc, yx.s, dyw.s, v, l, cot, s_dy, s_dinv);
      // the generic-proxy writes before the async-proxy reads (the products
      // here, the bulk copies to the other ranks)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&sliced[dyw.s]);
        mbar_arrive(&yx_empty[yx.s]);
      }
      yx.next(p.rings.yx);
      dyw.next(p.rings.dy);
      wc.next(p, clusters);
    };
    // step j's products are done: free its h/W stage, tell the publisher
    auto done = [&](int op_s, int dy_s) {
      if (lane == 0) {
        mbar_arrive(&op_empty[op_s]);
        mbar_arrive(&read[dy_s]);
      }
    };

    // the recomputation runs two steps ahead, so that the other ranks'
    // slices have a step's time to arrive
    for (int j = 0; j < 2 && j < n_iter; ++j) step_compute();
    int prev_op = 0, prev_dy_s = 0;
    bool pending = false;
    for (int j = 0; j < n_iter; ++j) {
      const int cur_op = op.s, cur_dy_s = dyr.s;
      if (mw.k == mw.z * p.k_per) {  // a unit's first step
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
        fence_acc(acc);
      }
      mbar_wait(&dy_full[dyr.s], dyr.ph);
      mbar_wait(&op_full[op.s], op.ph);
      const unsigned char* a = smem + L.dy + dyr.s * kDyBytes + cw * kSwBlock;
      const unsigned char* bt = smem + L.op + op.s * kOpBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = sw128_mn_desc(bt + kk * 16 * 128, kSwBlock);
        if constexpr (DW) {
          const uint64_t da = sw128_mn_desc(a + kk * 16 * 128, kSwBlock);
          if constexpr (BN == 256) wgmma_m64n256k16<1, 1>(acc, da, db);
          else wgmma_m64n128k16<1, 1>(acc, da, db);
        } else {
          const uint64_t da = sw128_desc(a) + 2 * kk;  // 16 deep = 32 bytes
          if constexpr (BN == 256) wgmma_m64n256k16<0, 1>(acc, da, db);
          else wgmma_m64n128k16<0, 1>(acc, da, db);
        }
      }
      wgmma_commit();
      op.next(p.rings.op);
      dyr.next(p.rings.dy);
      if (pending) {
        wgmma_wait<1>();
        done(prev_op, prev_dy_s);
      }
      if (mw.k + 1 == mw.k_end) {  // the unit's last step: its tile is done
        wgmma_wait<0>();
        fence_acc(acc);
        done(cur_op, cur_dy_s);
        pending = false;
        store_tile(mw, cw, ct, lane, acc);
        if constexpr (DW) {
          if (unit_c == mw.unit) flush();  // the last unit: the cursor did not move on
          tile_sums(mw, ct, cwarp, lane);
        }
      } else {
        pending = true;
        prev_op = cur_op;
        prev_dy_s = cur_dy_s;
      }
      if (j + 2 < n_iter) step_compute();
      mw.next(p, clusters);
    }
  }

  // The tile's accumulators to `out` (its slab's partial where the loop is
  // cut). wgmma m64nN: warp w of the warpgroup holds rows 16 w + lane / 4
  // (+ 8); acc[4 j + 2 h + e] is row (+ 8 h), column 8 j + 2 (lane % 4) + e.
  __device__ __forceinline__ void store_tile(const Work& w, int cw, int ct, int lane,
                                             const float (&acc)[kAcc]) const {
    const int m = w.mt * kBM + cw * 64 + ((ct % 128) / 32) * 16 + lane / 4;
    const int n = (w.fg * p.ranks + rank) * BN + 2 * (lane % 4);
    float* out = p.out + (size_t)w.z * p.m_total * p.depth;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m + 8 * h, col = n + 8 * j;
        if (row < p.m_total && col < p.depth)
          *reinterpret_cast<float2*>(out + (size_t)row * p.depth + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }

  // The dW pass's sums of one tile, from the threads' sums in `red`: per
  // column the row lanes' dbias sums in lane order; the threads' d inv_sigma
  // sums (over inv_sigma, in f32) warp by warp, then warps in order; to this
  // (slab, rank)'s slots. Only the first F group writes (the others
  // recompute the same dy).
  __device__ __forceinline__ void tile_sums(const Work& w, int ct, int cwarp, int lane) {
    const float* red = reinterpret_cast<const float*>(smem + L.red);
    const double* red_dinv = reinterpret_cast<const double*>(red + kRedLanes * kBM);
    float* wsum = reinterpret_cast<float*>(smem + L.red) + kRedLanes * kBM +
                  2 * kConsumerThreads;  // [8]
    const size_t slot = (size_t)w.z * p.ranks + rank;
    consumers_sync();  // every thread's sums are in red
    if (w.fg == 0) {
      const float part = gn::warp_sum((float)(red_dinv[ct] / (double)__ldg(p.g + 2)));
      if (lane == 0) wsum[cwarp] = part;
      const int col = w.mt * kBM + ct;
      if (ct < kBM && col < p.cols) {
        float a = 0.0f;
        for (int i = 0; i < kRedLanes; ++i) a += red[i * kBM + ct];
        p.dbias[slot * p.cols + col] = a;
      }
      consumers_sync();
      if (ct == 0) {
        float t = 0.0f;
        for (int i = 0; i < kConsumerWarps; ++i) t += wsum[i];
        p.dinv[slot * p.m_tiles + w.mt] = t;
      }
    }
    consumers_sync();  // red is free for the next unit's sums
  }
};

template <bool DW, int BN, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
fused_bf16_kernel(const __grid_constant__ CUtensorMap map_y,
                  const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_op, const __grid_constant__ Pass p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled stages need 1024-byte alignment; an offset from the array
  // (not a cast through an integer) keeps the accesses in the shared space
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Kernel<DW, BN, TMA> k(p, smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.rings.yx; ++s) {
      mbar_init(&k.yx_full[s], TMA ? 1 : 32);
      mbar_init(&k.yx_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < p.rings.op; ++s) {
      mbar_init(&k.op_full[s], 1);
      mbar_init(&k.op_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < p.rings.dy; ++s) {
      mbar_init(&k.dy_full[s], 1);                 // the publisher
      mbar_init(&k.dy_empty[s], p.ranks);          // every rank's publisher
      mbar_init(&k.sliced[s], kConsumerWarps);
      mbar_init(&k.read[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every rank's barriers exist before any rank arrives on them

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      if constexpr (TMA) {
        if (lane == 0) k.produce_yx_tma(&map_y, &map_x);
      } else {
        k.produce_yx_cp(lane);
      }
    } else if (warp == 1 && lane == 0) {
      k.produce_op(&map_op);
    } else if (warp == 2 && lane == 0) {
      k.publish();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // one instance of the consumers' loop runs: its code stays small enough
    // for the instruction cache (a loss dispatched at every step kept three
    // copies of the recomputation in the loop, which then ran far below the
    // issue rate)
    if (p.loss == ro::kMSE) k.template consume<ro::kMSE>(lane);
    else if (p.loss == ro::kMAE) k.template consume<ro::kMAE>(lane);
    else k.template consume<ro::kHuber>(lane);
  }
}

// -- f32: plain FMA ---------------------------------------------------------------

constexpr int kFM = 64, kFK = 16, kFThreads = 256, kFLd = kFM + 4;

template <int VEC, bool DW>
__global__ void __launch_bounds__(kFThreads)
fused_f32_kernel(Maps p, const float* __restrict__ op, float* __restrict__ out,
                 float* __restrict__ dbias, float* __restrict__ dinv_p, int depth, int loss,
                 int k_per) {
  __shared__ __align__(16) float sm[2][kFK][kFLd];  // [0]: dy as [k][m]; [1]: op as [k][n]
  __shared__ float scratch[32];
  float (*as)[kFLd] = sm[0];
  float (*bs)[kFLd] = sm[1];
  const int m_total = DW ? p.cols : p.rows, k_total = DW ? p.rows : p.cols;
  const int n0 = blockIdx.x * kFM, m0 = blockIdx.y * kFM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float gl = p.g[0] / p.n_elem, gm2 = 2.0f * p.g[1] / p.n_elem;
  const bool lead = DW && blockIdx.x == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float s_dy[VEC];
  double s_dinv = 0.0;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s_dy[i] = 0.0f;

  const int k_end = min(k_total, (int)(blockIdx.z + 1) * k_per * kFK);
  out += (size_t)blockIdx.z * m_total * depth;
  for (int k0 = blockIdx.z * k_per * kFK; k0 < k_end; k0 += kFK) {
    if constexpr (DW) {
      dy_tile<float, VEC, kFK, kFM, kFLd, 1, kFThreads>(p, loss, gl, gm2, k0, m0, &as[0][0],
                                                        lead, s_dy, s_dinv);
    } else {
      dy_tile<float, VEC, kFM, kFK, 1, kFLd, kFThreads>(p, loss, gl, gm2, m0, k0, &as[0][0],
                                                        false, s_dy, s_dinv);
    }
#pragma unroll
    for (int i = 0; i < kFK * kFM / kFThreads; ++i) {
      const int idx = threadIdx.x + i * kFThreads;
      const int k = idx / kFM, n = idx % kFM;
      bs[k][n] = (k0 + k < k_total && n0 + n < depth) ? op[(size_t)(k0 + k) * depth + n0 + n]
                                                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (lead)
    write_sums<VEC, kFM, kFThreads>(s_dy, s_dinv, p.g[2], &sm[0][0][0], scratch, m0, p.cols,
                                    dbias + (size_t)blockIdx.z * p.cols,
                                    dinv_p + blockIdx.z * gridDim.y + blockIdx.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < depth) out[(size_t)m * depth + n] = acc[i][j];
    }
  }
}

// out[i] = sum over the slabs of part[s][i], added in slab order.
__global__ void sum_slabs_kernel(const float* __restrict__ part, int slabs, size_t n,
                                 float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = part[i];
    for (int s = 1; s < slabs; ++s) a += part[(size_t)s * n + i];
    out[i] = a;
  }
}

int sum_slabs(const float* part, int slabs, size_t n, float* out, cudaStream_t st) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_slabs_kernel<<<blocks, 256, 0, st>>>(part, slabs, n, out);
  return (int)cudaGetLastError();
}

// Slabs for a pass with `blocks` output tiles, `steps` loop steps, an output of
// `out_floats` and room for `slots` tiles on the card at once: the count (at
// most 32, within 256 MB of partial outputs) that needs the fewest loop steps
// in sequence, rounds of tiles times steps per slab, plus `slab_cost` steps
// for each slab's partial output where there are several; the smaller count
// on a tie. Returns the steps per slab; *slabs has no empty slab.
int cut(int blocks, int steps, size_t out_floats, int slots, int* slabs,
        double slab_cost = 0.0) {
  constexpr size_t kMaxFloats = (size_t)64 << 20;
  int best = 1;
  double best_cost = -1.0;
  for (int s = 1; s <= 32 && s <= steps && (s == 1 || (size_t)s * out_floats <= kMaxFloats);
       ++s) {
    const long long rounds = ((long long)blocks * s + slots - 1) / slots;
    const double cost = (double)(rounds * ((steps + s - 1) / s)) + (s > 1 ? s * slab_cost : 0.0);
    if (best_cost < 0.0 || cost < best_cost) best = s, best_cost = cost;
  }
  const int per = (steps + best - 1) / best;
  *slabs = (steps + per - 1) / per;
  return per;
}

// -- f32: how the two passes are cut ------------------------------------------------

struct Plan {
  int bm, bk, bn;            // output tile height, loop step, F tile
  int f_tiles, col_tiles, row_tiles;
  int dw_slabs, dw_per, dh_slabs, dh_per;  // slabs and loop steps per slab
  size_t dw_off, dbias_off, dh_off, floats;  // scratch layout (floats)
};

Plan make_plan(long long rows, int depth, int cols) {
  Plan pl;
  pl.bm = kFM;
  pl.bk = kFK;
  pl.bn = kFM;
  const int slots = 132 * 2;  // blocks the card holds at once
  pl.f_tiles = (depth + pl.bn - 1) / pl.bn;
  pl.col_tiles = (cols + pl.bm - 1) / pl.bm;
  pl.row_tiles = (int)((rows + pl.bm - 1) / pl.bm);
  const size_t dw_floats = (size_t)cols * depth, dh_floats = (size_t)rows * depth;
  pl.dw_per = cut(pl.f_tiles * pl.col_tiles, (int)((rows + pl.bk - 1) / pl.bk), dw_floats,
                  slots, &pl.dw_slabs);
  pl.dh_per = cut(pl.f_tiles * pl.row_tiles, (cols + pl.bk - 1) / pl.bk, dh_floats, slots,
                  &pl.dh_slabs);
  // one slab writes straight to the output and needs no scratch
  pl.dw_off = 0;
  pl.dbias_off = pl.dw_slabs > 1 ? (size_t)pl.dw_slabs * dw_floats : 0;
  pl.dh_off = pl.dbias_off + (pl.dw_slabs > 1 ? (size_t)pl.dw_slabs * cols : 0);
  pl.floats = pl.dh_off + (pl.dh_slabs > 1 ? (size_t)pl.dh_slabs * dh_floats : 0);
  return pl;
}

struct Outputs {
  float* dw;
  float* dh;
  float* dbias;
  float* dinv_p;
  float* scratch;
};

// Launches both passes through `pass(dw_pass, grid, out, dbias, k_per)` and
// adds the slabs.
template <typename F>
int run_passes(const Maps& p, const Plan& pl, const Outputs& o, int depth, cudaStream_t st,
               F&& pass) {
  const bool dw_cut = pl.dw_slabs > 1, dh_cut = pl.dh_slabs > 1;
  int err = pass(true, dim3(pl.f_tiles, pl.col_tiles, pl.dw_slabs),
                 dw_cut ? o.scratch + pl.dw_off : o.dw, dw_cut ? o.scratch + pl.dbias_off : o.dbias,
                 pl.dw_per);
  if (err) return err;
  err = pass(false, dim3(pl.f_tiles, pl.row_tiles, pl.dh_slabs),
             dh_cut ? o.scratch + pl.dh_off : o.dh, nullptr, pl.dh_per);
  if (err) return err;
  if (dw_cut) {
    err = sum_slabs(o.scratch + pl.dw_off, pl.dw_slabs, (size_t)p.cols * depth, o.dw, st);
    if (err) return err;
    err = sum_slabs(o.scratch + pl.dbias_off, pl.dw_slabs, (size_t)p.cols, o.dbias, st);
    if (err) return err;
  }
  if (dh_cut) err = sum_slabs(o.scratch + pl.dh_off, pl.dh_slabs, (size_t)p.rows * depth, o.dh, st);
  return err;
}

template <int VEC>
int launch_f32(const Maps& p, const Plan& pl, const void* h, const void* w, const Outputs& o,
               int depth, int loss, cudaStream_t st) {
  return run_passes(p, pl, o, depth, st, [&](bool dw, dim3 grid, float* out, float* dbias, int k_per) {
    if (dw)
      fused_f32_kernel<VEC, true><<<grid, kFThreads, 0, st>>>(
          p, static_cast<const float*>(h), out, dbias, o.dinv_p, depth, loss, k_per);
    else
      fused_f32_kernel<VEC, false><<<grid, kFThreads, 0, st>>>(
          p, static_cast<const float*>(w), out, nullptr, nullptr, depth, loss, k_per);
    return (int)cudaGetLastError();
  });
}

// -- bf16: how the two passes are cut ------------------------------------------------

// F tile of the bf16 passes: 256 (wgmma n256) where F > 128, else 128.
constexpr int bf16_bn(int depth) { return depth > 128 ? 256 : 128; }

template <bool DW, int BN, bool TMA>
cudaLaunchConfig_t pass_config(int clusters, int ranks, int smem, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of `ranks` blocks of one pass's kernel with `smem` bytes each
// that the card holds at once (the occupancy API; remembered per device and
// shape); negative: a cudaError_t code.
template <bool DW, int BN, bool TMA>
int clusters_at_once(int ranks, int smem) {
  struct Seen {
    int dev, ranks, smem, n;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].ranks == ranks && seen[i].smem == smem) return seen[i].n;
  auto kernel = fused_bf16_kernel<DW, BN, TMA>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = pass_config<DW, BN, TMA>(1, ranks, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  if (n_seen < 64) seen[n_seen++] = {dev, ranks, smem, n};
  return n;
}

// Ring depths that fit: all 4 deep, made shallower (h/W first, then y/x,
// never below 2; dy last, never below 3) until the block fits.
Rings fit_rings(bool dw, int bn, bool tma, int piece) {
  Rings r{4, 4, 4};
  while (layout_of(dw, bn, tma, piece, r).bytes > kSmemLimit) {
    if (r.op > 2 && r.op >= r.yx) --r.op;
    else if (r.yx > 2) --r.yx;
    else if (r.op > 2) --r.op;
    else if (r.dy > 3) --r.dy;
    else break;
  }
  return r;
}

struct PassPlan {
  int m_total, m_tiles, k_steps, slabs, k_per, piece, units, clusters, smem;
  Rings rings;
};

struct Bf16Plan {
  int bn, ranks, fgroups;
  bool tma;
  PassPlan dw, dh;
  size_t dw_off, dbias_off, dh_off, floats;  // scratch layout (floats)
  int tiles;                                 // d inv_sigma partials
};

template <bool DW, int BN, bool TMA>
int plan_pass(PassPlan& pp, int ranks, int fgroups, int m_total, int k_total, int depth) {
  pp.m_total = m_total;
  pp.m_tiles = (m_total + kBM - 1) / kBM;
  pp.k_steps = (k_total + kBK - 1) / kBK;
  const int stage_rows = DW ? kBK : kBM;
  pp.piece = (stage_rows + ranks - 1) / ranks;
  pp.rings = fit_rings(DW, BN, TMA, pp.piece);
  pp.smem = layout_of(DW, BN, TMA, pp.piece, pp.rings).bytes;
  if (pp.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int slots = clusters_at_once<DW, BN, TMA>(ranks, pp.smem);
  if (slots <= 0) return slots < 0 ? -slots : (int)cudaErrorInvalidConfiguration;
  // a slab's partial output costs its write and its read once more, counted
  // in loop steps of one cluster at the tensor cores' rate per SM (989 / 132
  // TFLOP/s) against the memory's 3.35 TB/s (a launch charged for cutting at
  // all chose too few slabs: one rank's steps take several microseconds)
  const double step_s = 2.0 * kBM * kBK * BN / 7.49e12;
  const double slab_cost = 8.0 * (double)m_total * depth / 3.35e12 / step_s;
  pp.k_per = cut(fgroups * pp.m_tiles, pp.k_steps, (size_t)m_total * depth, slots, &pp.slabs,
                 slab_cost);
  pp.units = fgroups * pp.slabs * pp.m_tiles;
  pp.clusters = pp.units < slots ? pp.units : slots;
  return 0;
}

template <int BN, bool TMA>
int plan_bf16_as(Bf16Plan& pl, long long rows, int depth, int cols) {
  int err = plan_pass<true, BN, TMA>(pl.dw, pl.ranks, pl.fgroups, cols, (int)rows, depth);
  if (err) return err;
  err = plan_pass<false, BN, TMA>(pl.dh, pl.ranks, pl.fgroups, (int)rows, cols, depth);
  if (err) return err;
  const size_t dw_floats = (size_t)cols * depth, dh_floats = (size_t)rows * depth;
  const int sum_slots = pl.dw.slabs * pl.ranks;  // dbias partials: (slab, rank)
  pl.dw_off = 0;
  pl.dbias_off = pl.dw.slabs > 1 ? (size_t)pl.dw.slabs * dw_floats : 0;
  pl.dh_off = pl.dbias_off + (sum_slots > 1 ? (size_t)sum_slots * cols : 0);
  pl.floats = pl.dh_off + (pl.dh.slabs > 1 ? (size_t)pl.dh.slabs * dh_floats : 0);
  pl.tiles = sum_slots * pl.dw.m_tiles;
  return 0;
}

// The bf16 plan of a shape: F tile, ranks (the F tiles one cluster spans),
// clusters along F, each pass's tiles, slabs, rings and grid, and scratch.
int plan_bf16(Bf16Plan& pl, long long rows, int depth, int cols) {
  pl.bn = bf16_bn(depth);
  const int f_tiles = (depth + pl.bn - 1) / pl.bn;
  pl.fgroups = (f_tiles + kMaxRanks - 1) / kMaxRanks;
  pl.ranks = (f_tiles + pl.fgroups - 1) / pl.fgroups;
  pl.tma = cols % 8 == 0;
  if (pl.bn == 256)
    return pl.tma ? plan_bf16_as<256, true>(pl, rows, depth, cols)
                  : plan_bf16_as<256, false>(pl, rows, depth, cols);
  return pl.tma ? plan_bf16_as<128, true>(pl, rows, depth, cols)
                : plan_bf16_as<128, false>(pl, rows, depth, cols);
}

template <bool DW, int BN, bool TMA>
int launch_pass(const CUtensorMap& my, const CUtensorMap& mx, const CUtensorMap& mop,
                const Pass& p, const PassPlan& pp, cudaStream_t st) {
  auto kernel = fused_bf16_kernel<DW, BN, TMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pp.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = pass_config<DW, BN, TMA>(pp.clusters, p.ranks, pp.smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, my, mx, mop, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

struct Bf16Args {
  const void *y, *x, *h, *w;
  const float *scale, *norm_bias, *bias, *stats, *msums, *g;
  float n_elem;
  int rows, t_rows, cols, groups, depth, loss;
};

template <int BN, bool TMA>
int launch_bf16(const Bf16Args& a, const Bf16Plan& pl, const Outputs& o, cudaStream_t st) {
  // y, x: [rows, cols] read in slices of 64 columns x `piece` rows; h: [rows,
  // depth] and W: [cols, depth] in 64 x 64 boxes with 128-byte swizzle
  CUtensorMap dw_y{}, dw_x{}, dh_y{}, dh_x{}, map_h{}, map_w{};
  if (TMA &&
      (!encode_map(&dw_y, a.y, a.rows, a.cols, pl.dw.piece, 64, CU_TENSOR_MAP_SWIZZLE_NONE) ||
       !encode_map(&dw_x, a.x, a.rows, a.cols, pl.dw.piece, 64, CU_TENSOR_MAP_SWIZZLE_NONE) ||
       !encode_map(&dh_y, a.y, a.rows, a.cols, pl.dh.piece, 64, CU_TENSOR_MAP_SWIZZLE_NONE) ||
       !encode_map(&dh_x, a.x, a.rows, a.cols, pl.dh.piece, 64, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  if (!encode_map(&map_h, a.h, a.rows, a.depth, kBK) ||
      !encode_map(&map_w, a.w, a.cols, a.depth, kBK))
    return (int)cudaErrorInvalidValue;
  Pass p{};
  p.scale = a.scale;
  p.norm_bias = a.norm_bias;
  p.bias = a.bias;
  p.stats = a.stats;
  p.msums = a.msums;
  p.g = a.g;
  p.y = static_cast<const __nv_bfloat16*>(a.y);
  p.x = static_cast<const __nv_bfloat16*>(a.x);
  p.n_elem = a.n_elem;
  p.rows = a.rows;
  p.t_rows = a.t_rows;
  p.cols = a.cols;
  p.groups = a.groups;
  p.depth = a.depth;
  p.ranks = pl.ranks;
  p.fgroups = pl.fgroups;
  p.loss = a.loss;
  const int stat_rows = a.rows / a.t_rows * a.groups;  // (sample, group)s
  p.tab = stat_rows <= kTabMax ? stat_rows : 0;
  auto set = [&](const PassPlan& pp) {
    p.m_total = pp.m_total;
    p.m_tiles = pp.m_tiles;
    p.k_steps = pp.k_steps;
    p.slabs = pp.slabs;
    p.k_per = pp.k_per;
    p.units = pp.units;
    p.piece = pp.piece;
    p.rings = pp.rings;
  };
  const int sum_slots = pl.dw.slabs * pl.ranks;
  const bool dw_cut = pl.dw.slabs > 1, dh_cut = pl.dh.slabs > 1;
  set(pl.dw);
  p.out = dw_cut ? o.scratch + pl.dw_off : o.dw;
  p.dbias = sum_slots > 1 ? o.scratch + pl.dbias_off : o.dbias;
  p.dinv = o.dinv_p;
  int err = launch_pass<true, BN, TMA>(dw_y, dw_x, map_h, p, pl.dw, st);
  if (err) return err;
  set(pl.dh);
  p.out = dh_cut ? o.scratch + pl.dh_off : o.dh;
  p.dbias = nullptr;
  p.dinv = nullptr;
  err = launch_pass<false, BN, TMA>(dh_y, dh_x, map_w, p, pl.dh, st);
  if (err) return err;
  if (dw_cut) {
    err = sum_slabs(o.scratch + pl.dw_off, pl.dw.slabs, (size_t)a.cols * a.depth, o.dw, st);
    if (err) return err;
  }
  if (sum_slots > 1) {
    err = sum_slabs(o.scratch + pl.dbias_off, sum_slots, (size_t)a.cols, o.dbias, st);
    if (err) return err;
  }
  if (dh_cut) err = sum_slabs(o.scratch + pl.dh_off, pl.dh.slabs, (size_t)a.rows * a.depth, o.dh, st);
  return err;
}

}  // namespace

// Length of dinv_p: one d inv_sigma partial per (slab, column tile) of the dW
// pass, and in bf16 per rank of its cluster too. A negative return is a
// cudaError_t code (the bf16 plan asks the card how many clusters it holds).
extern "C" int readout_bwd_fused_tiles(int batch, int t_rows, int depth, int cols, int dtype) {
  const long long rows = (long long)batch * t_rows;
  if (dtype == gn::kBF16) {
    Bf16Plan pl{};
    const int err = plan_bf16(pl, rows, depth, cols);
    return err ? -err : pl.tiles;
  }
  const Plan pl = make_plan(rows, depth, cols);
  return pl.dw_slabs * pl.col_tiles;
}

// Floats of scratch the call needs for its slabs and, in bf16, the ranks'
// d bias partials (0 when there are none; under 2^28: each pass's partial
// outputs are capped at 2^26 floats). Negative: a cudaError_t code.
extern "C" int readout_bwd_fused_scratch(int batch, int t_rows, int depth, int cols, int dtype) {
  const long long rows = (long long)batch * t_rows;
  if (dtype == gn::kBF16) {
    Bf16Plan pl{};
    const int err = plan_bf16(pl, rows, depth, cols);
    return err ? -err : (int)pl.floats;
  }
  return (int)make_plan(rows, depth, cols).floats;
}

// The bf16 plan of a shape (for measurements and checks): out[0 .. 3] = F
// tile, ranks, clusters along F, TMA (1) or cp.async (0) for y and x; then
// for the dW pass and the dh pass in turn: output tiles, loop steps, slabs,
// steps a slab, rows of a rank's slice, units, clusters launched, shared
// memory a block, y/x, h/W and dy ring depths (26 ints). Returns a
// cudaError_t code.
extern "C" int readout_bwd_fused_plan(int batch, int t_rows, int depth, int cols, int* out) {
  Bf16Plan pl{};
  const int err = plan_bf16(pl, (long long)batch * t_rows, depth, cols);
  if (err) return err;
  int* o = out;
  *o++ = pl.bn;
  *o++ = pl.ranks;
  *o++ = pl.fgroups;
  *o++ = pl.tma ? 1 : 0;
  const PassPlan* passes[2] = {&pl.dw, &pl.dh};
  for (const PassPlan* pp : passes) {
    const int v[11] = {pp->m_tiles, pp->k_steps, pp->slabs, pp->k_per, pp->piece, pp->units,
                       pp->clusters, pp->smem, pp->rings.yx, pp->rings.op, pp->rings.dy};
    for (int i = 0; i < 11; ++i) *o++ = v[i];
  }
  return 0;
}

// y, x: [B, T, C]; h: [B, T, F]; w: [C, F] (all in the map's type); scale,
// norm_bias, bias: [C] f32; stats, msums: [B, 2, G] f32; g: device f32 (gl, gm,
// inv_sigma). Outputs, all f32: dw [C, F], dh [B, T, F], dbias [C], dinv_p
// [readout_bwd_fused_tiles]; scratch: readout_bwd_fused_scratch floats. bf16
// needs F % 64 == 0 and 16-byte aligned y, x, h and w. Returns a cudaError_t
// code.
extern "C" int readout_bwd_fused(const void* y, const void* x, const void* scale,
                                 const void* norm_bias, const void* bias, const void* h,
                                 const void* w, const void* stats, const void* msums,
                                 const void* g, void* dw, void* dh, void* dbias, void* dinv_p,
                                 void* scratch, float n_elem, int batch, int t_rows, int depth,
                                 int cols, int groups, int dtype, int loss, void* stream) {
  if (batch <= 0 || t_rows <= 0 || depth <= 0 || cols <= 0 || groups <= 0 ||
      cols % groups != 0 || loss < ro::kMSE || loss > ro::kHuber ||
      (dtype != gn::kBF16 && dtype != gn::kF32))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * t_rows;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Outputs o{static_cast<float*>(dw), static_cast<float*>(dh), static_cast<float*>(dbias),
                  static_cast<float*>(dinv_p), static_cast<float*>(scratch)};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == gn::kBF16) {
    if (depth % kBK != 0) return (int)cudaErrorInvalidValue;
    Bf16Plan pl{};
    const int err = plan_bf16(pl, rows, depth, cols);
    if (err) return err;
    const Bf16Args a{y,
                     x,
                     h,
                     w,
                     static_cast<const float*>(scale),
                     static_cast<const float*>(norm_bias),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(stats),
                     static_cast<const float*>(msums),
                     static_cast<const float*>(g),
                     n_elem,
                     (int)rows,
                     t_rows,
                     cols,
                     groups,
                     depth,
                     loss};
    if (pl.bn == 256)
      return pl.tma ? launch_bf16<256, true>(a, pl, o, st) : launch_bf16<256, false>(a, pl, o, st);
    return pl.tma ? launch_bf16<128, true>(a, pl, o, st) : launch_bf16<128, false>(a, pl, o, st);
  }
  const Maps p{y,
               x,
               static_cast<const float*>(scale),
               static_cast<const float*>(norm_bias),
               static_cast<const float*>(bias),
               static_cast<const float*>(stats),
               static_cast<const float*>(msums),
               static_cast<const float*>(g),
               n_elem,
               (int)rows,
               t_rows,
               cols,
               groups};
  const Plan pl = make_plan(rows, depth, cols);
  if (pl.col_tiles > 65535 || pl.row_tiles > 65535) return (int)cudaErrorInvalidValue;
  if (cols % 4 == 0) return launch_f32<4>(p, pl, h, w, o, depth, loss, st);
  return launch_f32<1>(p, pl, h, w, o, depth, loss, st);
}
