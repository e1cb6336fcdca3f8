// readout_matmul_stats: the readout product with GroupNorm statistics in its epilogue.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/readout_chain.py:_matmul_stats_kernel
// (phase 1 of _forward_parts) together with the XLA finalize after it
// (sum of the partials, mean, rsqrt(max(var, 0) + eps)). For h [B, T, F] and
// W [C, F] (both with the depth F contiguous) it computes, accumulating in f32,
//   y[b, t, c] = round(sum_f h[b, t, f] * W[c, f] * inv_sigma + bias[c])
// with the f32 bias added before the one rounding to the map's type, writes y
// once, and takes the per-(sample, group) sum and sum of squares OF THE
// ROUNDED y in the same pass, so the statistics equal those of a separate
// pass over the stored map and no such pass is needed.
//
// Bound on an H100: operations in bf16. 2 * B*T * C * F = 0.62 TFLOP at
// B = 16, T = 200, F = 1024, C = 95008: 0.63 ms at 989 TFLOP/s; the bytes
// (h, W read once, y written once: 0.81 GB) would take 0.24 ms.
//
// Design of the bf16 path (Hopper: wgmma fed by TMA). The earlier design, an
// mma.sync tile whose operands came through cp.async with a block barrier and
// fragment reloads from unswizzled shared memory at every k-step, ran at a
// fifth of the tensor cores' rate (3.7 ms on an H100 SXM at 700 W); this one
// keeps them fed:
//  * Rows are the B*T rows of h viewed as [M, F]: 128-row tiles run across
//    sample boundaries (M = 3200 = 25 tiles at the flagship shape, no padding
//    rows), columns in 256-wide tiles. A persistent grid of one block per SM
//    walks the tiles row tile fastest, so the blocks in flight share a few
//    W column tiles through L2 and W streams from memory about once.
//  * One producer thread issues TMA loads (cp.async.bulk.tensor) of a 128 x 64
//    h tile and a 256 x 64 W tile per stage into a 4-stage ring with 128-byte
//    swizzle, full and empty mbarriers between it and the consumers. TMA
//    zero-fills rows past M and past C (the last W tile holds 32 columns).
//  * Two consumer warpgroups (setmaxnreg moves registers to them) each own
//    64 rows of the 128 x 256 tile and issue wgmma m64n256k16 with both
//    operands read from the swizzled stages: 128 f32 accumulators a thread,
//    one wgmma group kept in flight while the stage before it is released.
//  * The epilogue works from the accumulator registers, with the tile's bias
//    (read before the product) in shared memory: scale, bias, round, then y
//    leaves through a warp's staging rows as 16-byte stores where C % 8 == 0
//    (element stores otherwise: C = 300 or 1100 rows are not 16-byte
//    aligned), and the rounded values feed the statistics. The store path is
//    chosen once per tile, so the unrolled loop has no branch and does not
//    spill. Per group the tile's columns touch: each thread sums its two
//    rows, the four lanes of a row add by shuffles, rows meet in shared
//    memory, and one warp per sample slot adds the slot's rows in order into
//    a partial of (row tile, column tile, sample slot, 2, G). A 128-row tile
//    touches at most ceil(127 / T) + 1 samples. The caller gives the slots as
//    a table of (sample, first row, end row) per (row tile, slot): the Python
//    wrapper's slot_table, which the epilogue and the finalize both read. A
//    second small launch adds, per sample and group, the partials of the
//    (row tile, slot)s that hold its rows, row tile outer, and of the column
//    tiles the group spans, in a fixed order. No atomics: two runs give the
//    same bits.
//  * What bounds it now (H100 SXM, 700 W; a build without the epilogue and
//    the finalize timed against the whole): the product alone runs at ~910
//    TFLOP/s, the whole kernel at ~600: the epilogue, about a third of the
//    time, does not overlap the tensor cores, since both warpgroups reach it
//    together.
// The f32 path (plain FMA, never TF32) is kept for the f32 checks; its tiles
// stay within a sample and it has its own finalize.
#include "hopper.cuh"
#include "readout_common.cuh"

namespace {

using namespace hop;

// -- bf16: wgmma from a TMA ring ---------------------------------------------------

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                       // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);    // warpgroup 0 produces
constexpr int kTileA = kBM * kBK * 2, kTileB = kBN * kBK * 2;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kBarOffset = kStages * kStageBytes;   // full[kStages], empty[kStages]
constexpr int kRowOffset = kBarOffset + 2 * kStages * 8;
constexpr int kBiasOffset = kRowOffset + kBM * 8;
constexpr int kYStageOffset = kBiasOffset + kBN * 4;
// A consumer warp stages 16 rows x 64 columns of y at a time: 32 words of
// bf16 pairs a row, padded to 36 so that the eight rows a store touches fall
// in different banks.
constexpr int kStageWords = 36;
constexpr int kSmemBytes =
    kYStageOffset + 4 * kConsumers * 16 * kStageWords * 4 + 1024;  // + alignment of the ring

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

struct Flat {
  int rows;       // M = B * T
  int per;        // T: rows per sample
  int cols;       // C
  int groups;     // G
  int k_tiles, m_tiles, n_tiles, slots;
};

// Shared memory of the consumers besides the ring.
struct EpilogueSmem {
  float2* rowbuf;         // [kBM]: (s, q) of each row of the tile for one group
  float* biasbuf;         // [kBN]: the tile's bias
  uint32_t* ystage;       // [8 warps][16 rows][kStageWords]: y pairs on their way out
};

// One group's per-row sums -> one partial per sample slot: the four lanes of a
// row add by shuffles, rows meet in shared memory, one warp per slot adds the
// slot's rows (from the tile's rows of the slot table) in order.
__device__ __forceinline__ void slot_partials(float sa, float qa, float sb, float qb, int g,
                                              const Flat& f, int m0, const int* tile_slots,
                                              int rl, int lane, int cwarp, float* tile_part,
                                              float2* rowbuf) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    qa += __shfl_xor_sync(0xffffffffu, qa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
    qb += __shfl_xor_sync(0xffffffffu, qb, off);
  }
  if ((lane & 3) == 0) {
    rowbuf[rl] = make_float2(sa, qa);
    rowbuf[rl + 8] = make_float2(sb, qb);
  }
  consumers_sync();
  for (int s = cwarp; s < f.slots; s += 4 * kConsumers) {
    const int r_lo = tile_slots[3 * s + 1] - m0, r_hi = tile_slots[3 * s + 2] - m0;
    float ss = 0.0f, qq = 0.0f;
    for (int r = r_lo + lane; r < r_hi; r += 32) {
      ss += rowbuf[r].x;
      qq += rowbuf[r].y;
    }
    ss = gn::warp_sum(ss);
    qq = gn::warp_sum(qq);
    if (lane == 0) {
      tile_part[(size_t)s * 2 * f.groups + g] = ss;
      tile_part[(size_t)s * 2 * f.groups + f.groups + g] = qq;
    }
  }
  consumers_sync();  // rowbuf (and biasbuf) are free again
}

// Scale, bias, round and store one tile's y from the accumulators, which are
// left holding the rounded values (0 outside the map); returns the sums of
// the two rows of this thread in sa, qa (row rl) and sb, qb (row rl + 8).
// STAGED (C % 8 == 0): every 8-column block is wholly in or out of the map and
// y leaves through the warp's staging rows as 16-byte stores, 64 columns at a
// time; else plain element stores.
template <bool STAGED>
__device__ __forceinline__ void round_store(float (&acc)[128], const Flat& f, int m0, int n0,
                                            int rl, int lane, float inv, const float* biasbuf,
                                            uint32_t* ws, __nv_bfloat16* __restrict__ y,
                                            float& sa, float& qa, float& sb, float& qb) {
  const int ra = m0 + rl, rb = ra + 8;
  const bool va = ra < f.rows, vb = rb < f.rows;
  const int q2 = 2 * (lane % 4);
  const int wrow0 = m0 + (rl & ~15);  // first row of this warp's 16
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = n0 + 8 * j + q2;
    const bool ok0 = STAGED ? n0 + 8 * j < f.cols : c < f.cols;
    const bool ok1 = STAGED ? ok0 : c + 1 < f.cols;
    const float2 bb = *reinterpret_cast<const float2*>(biasbuf + 8 * j + q2);
    const __nv_bfloat162 pa = __floats2bfloat162_rn(acc[4 * j] * inv + bb.x,
                                                    acc[4 * j + 1] * inv + bb.y);
    const __nv_bfloat162 pb = __floats2bfloat162_rn(acc[4 * j + 2] * inv + bb.x,
                                                    acc[4 * j + 3] * inv + bb.y);
    if constexpr (STAGED) {
      const int w = (lane / 4) * kStageWords + 4 * (j % 8) + lane % 4;
      ws[w] = *reinterpret_cast<const uint32_t*>(&pa);
      ws[w + 8 * kStageWords] = *reinterpret_cast<const uint32_t*>(&pb);
      if (j % 8 == 7) {  // 16 rows x 64 columns staged: out as whole 16-byte pieces
        __syncwarp();
        const int col = n0 + 64 * (j / 8) + 8 * (lane & 7);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = (lane >> 3) + 4 * i, row = wrow0 + rr;
          const uint4 v = *reinterpret_cast<const uint4*>(ws + rr * kStageWords + 4 * (lane & 7));
          if (row < f.rows && col < f.cols)
            *reinterpret_cast<uint4*>(y + (size_t)row * f.cols + col) = v;
        }
        __syncwarp();
      }
    } else {
      __nv_bfloat16* ya = y + (size_t)ra * f.cols;
      __nv_bfloat16* yb = y + (size_t)rb * f.cols;
      if (va && ok0) ya[c] = pa.x;
      if (va && ok1) ya[c + 1] = pa.y;
      if (vb && ok0) yb[c] = pb.x;
      if (vb && ok1) yb[c + 1] = pb.y;
    }
    const float2 fa = __bfloat1622float2(pa), fb = __bfloat1622float2(pb);
    acc[4 * j] = va && ok0 ? fa.x : 0.0f;
    acc[4 * j + 1] = va && ok1 ? fa.y : 0.0f;
    acc[4 * j + 2] = vb && ok0 ? fb.x : 0.0f;
    acc[4 * j + 3] = vb && ok1 ? fb.y : 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // the statistics of a tile within one group
      sa += acc[4 * j + e];
      qa = fmaf(acc[4 * j + e], acc[4 * j + e], qa);
      sb += acc[4 * j + 2 + e];
      qb = fmaf(acc[4 * j + 2 + e], acc[4 * j + 2 + e], qb);
    }
  }
}

// The epilogue of one tile for one consumer thread. Accumulator layout of
// wgmma m64nNk16: warp w of the warpgroup holds rows 16 w + lane / 4 (+ 8);
// d[4 j + 2 h + e] is row (+ 8 h), column 8 j + 2 (lane % 4) + e.
// `bias_reg` is bias[n0 + ct], loaded before the tile's product.
__device__ __forceinline__ void epilogue(float (&acc)[128], const Flat& f, int mt, int nt,
                                         int cw, int warp, int lane, int ct, float bias_reg,
                                         float inv, __nv_bfloat16* __restrict__ y,
                                         float* __restrict__ partials,
                                         const int* __restrict__ slot_tab,
                                         const EpilogueSmem& sm) {
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int rl = cw * 64 + warp * 16 + lane / 4;  // local row of d[.. 2 h = 0]
  sm.biasbuf[ct] = bias_reg;
  consumers_sync();
  float sa = 0.0f, qa = 0.0f, sb = 0.0f, qb = 0.0f;
  if (f.cols % 8 == 0)
    round_store<true>(acc, f, m0, n0, rl, lane, inv, sm.biasbuf,
                      sm.ystage + (cw * 4 + warp) * 16 * kStageWords, y, sa, qa, sb, qb);
  else
    round_store<false>(acc, f, m0, n0, rl, lane, inv, sm.biasbuf, nullptr, y, sa, qa, sb, qb);

  // statistics of the rounded values per group the tile's columns touch
  const int cg = f.cols / f.groups;
  const int g_lo = n0 / cg, g_hi = (min(n0 + kBN, f.cols) - 1) / cg;
  const int cwarp = ct >> 5;  // 0 .. 4 * kConsumers - 1
  float* tile_part = partials + ((size_t)mt * f.n_tiles + nt) * f.slots * 2 * f.groups;
  const int* tile_slots = slot_tab + (size_t)mt * f.slots * 3;
  if (g_lo == g_hi) {
    slot_partials(sa, qa, sb, qb, g_lo, f, m0, tile_slots, rl, lane, cwarp, tile_part,
                  sm.rowbuf);
    return;
  }
  const int cq = n0 + 2 * (lane % 4);
  for (int g = g_lo; g <= g_hi; ++g) {  // a tile across group boundaries: column by column
    const int lo = g * cg, hi = lo + cg;
    sa = qa = sb = qb = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cq + 8 * j + e;
        const bool in = c >= lo && c < hi;
        const float xa = in ? acc[4 * j + e] : 0.0f;
        const float xb = in ? acc[4 * j + 2 + e] : 0.0f;
        sa += xa;
        qa = fmaf(xa, xa, qa);
        sb += xb;
        qb = fmaf(xb, xb, qb);
      }
    }
    slot_partials(sa, qa, sb, qb, g, f, m0, tile_slots, rl, lane, cwarp, tile_part,
                  sm.rowbuf);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                          const __grid_constant__ CUtensorMap map_w,
                          const float* __restrict__ bias, const float* __restrict__ inv_sigma,
                          __nv_bfloat16* __restrict__ y, float* __restrict__ partials,
                          const int* __restrict__ slot_tab, Flat f) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled stages need 1024-byte alignment; an offset from the array
  // (not a cast through an integer) keeps the accesses in the shared space
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  const EpilogueSmem sm{reinterpret_cast<float2*>(smem + kRowOffset),
                        reinterpret_cast<float*>(smem + kBiasOffset),
                        reinterpret_cast<uint32_t*>(smem + kYStageOffset)};
  auto stage_a = [&](int s) { return smem + s * kStageBytes; };
  auto stage_b = [&](int s) { return smem + s * kStageBytes + kTileA; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = f.m_tiles * f.n_tiles;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread keeps the ring full -----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile % f.m_tiles, nt = tile / f.m_tiles;
        for (int kt = 0; kt < f.k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load(stage_a(s), &map_h, kt * kBK, mt * kBM, &full[s]);
          tma_load(stage_b(s), &map_w, kt * kBK, nt * kBN, &full[s]);
        }
      }
    }
  } else {
    // -- consumers: wgmma, then the epilogue from registers --------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;  // 0 .. 128 * kConsumers - 1
    const int cw = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const float inv = *inv_sigma;
    float acc[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile % f.m_tiles, nt = tile / f.m_tiles;
      const int cb = nt * kBN + ct;  // this thread's bias column, read behind the product
      const float bias_reg = cb < f.cols ? bias[cb] : 0.0f;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      for (int kt = 0; kt < f.k_tiles; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint64_t da = sw128_desc(stage_a(s) + cw * 64 * kBK * 2);
        const uint64_t db = sw128_desc(stage_b(s));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 16 deep = 32 bytes = 2 descriptor units
          wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        if (kt > 0) {  // the group before this one is done: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      epilogue(acc, f, mt, nt, cw, warp, lane, ct, bias_reg, inv, y, partials, slot_tab, sm);
    }
  }
}

// Adds, per sample and group, the partials of the (row tile, slot)s the slot
// table gives to the sample and of the column tiles the group spans, row tile
// outer, column tile inner; writes (mean, inv_std).
__global__ void matmul_stats_finalize_flat_kernel(const float* __restrict__ partials,
                                                  const int* __restrict__ slot_tab,
                                                  float* __restrict__ stats, Flat f, float eps) {
  const int b = blockIdx.x;
  const int cg = f.cols / f.groups;
  const float denom = (float)f.per * (float)cg;
  for (int grp = threadIdx.x; grp < f.groups; grp += blockDim.x) {
    const int t0 = (grp * cg) / kBN, t1 = ((grp + 1) * cg - 1) / kBN;
    float s = 0.0f, q = 0.0f;
    for (int i = 0; i < f.m_tiles * f.slots; ++i) {
      if (slot_tab[3 * i] != b) continue;
      const int rt = i / f.slots, slot = i % f.slots;
      for (int t = t0; t <= t1; ++t) {
        const float* p =
            partials + (((size_t)rt * f.n_tiles + t) * f.slots + slot) * 2 * f.groups;
        s += p[grp];
        q += p[f.groups + grp];
      }
    }
    float* o = stats + (size_t)b * 2 * f.groups;
    gn::finalize(s, q, denom, eps, &o[grp], &o[f.groups + grp]);
  }
}

// f32 path: scale, bias, round, store and take the statistics of one BM x BN tile held
// as f32 in shared memory (ctile, row stride ldc). Thread (slice, col) walks
// BM / SLICES rows of one column, so stores are coalesced along C.
template <typename T, int BM, int BN, int THREADS>
__device__ __forceinline__ void smem_tile_epilogue(const float* ctile, int ldc,
                                         const float* __restrict__ bias, float inv_sigma,
                                         T* __restrict__ y, float* __restrict__ part, int b,
                                         int row0, int col0, int rows, int cols,
                                         int groups) {
  constexpr int SLICES = THREADS / BN;
  constexpr int RPS = BM / SLICES;
  static_assert(THREADS % BN == 0 && BM % SLICES == 0, "tile and block must divide");
  __shared__ float col_s[2][SLICES][BN];
  const int col = threadIdx.x % BN, slice = threadIdx.x / BN;
  const int c = col0 + col;
  float s = 0.0f, q = 0.0f;
  if (c < cols) {
    const float bi = bias[c];
    const int r_end = min(RPS, rows - row0 - slice * RPS);
    T* yp = y + ((size_t)b * rows + row0 + slice * RPS) * cols + c;
    const float* cp = ctile + (size_t)slice * RPS * ldc + col;
    for (int r = 0; r < r_end; ++r) {
      const T stored = gn::from_f32<T>(cp[(size_t)r * ldc] * inv_sigma + bi);
      yp[(size_t)r * cols] = stored;
      const float v = gn::to_f32(stored);
      s += v;
      q += v * v;
    }
  }
  col_s[0][slice][col] = s;
  col_s[1][slice][col] = q;
  __syncthreads();
  if (threadIdx.x < BN) {
    float a = col_s[0][0][col], d = col_s[1][0][col];
#pragma unroll
    for (int i = 1; i < SLICES; ++i) {
      a += col_s[0][i][col];
      d += col_s[1][i][col];
    }
    col_s[0][0][col] = a;
    col_s[1][0][col] = d;
  }
  __syncthreads();
  ro::group_partials(col_s[0][0], col_s[1][0], col0, BN, cols, groups, part);
}

// -- f32: plain FMA ---------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256;
constexpr int kFLd = kFM + 4;

__global__ void __launch_bounds__(kFThreads)
matmul_stats_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ inv_sigma,
                        float* __restrict__ y, float* __restrict__ partials, int rows,
                        int depth, int cols, int groups, int row_tiles) {
  __shared__ __align__(16) float as[kFK][kFLd];
  __shared__ __align__(16) float bs[kFK][kFLd];
  __shared__ __align__(16) float ctile[kFM][kFLd];
  const int b = blockIdx.x / row_tiles, rt = blockIdx.x % row_tiles, ct = blockIdx.y;
  const int row0 = rt * kFM, col0 = ct * kFN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* h_b = h + (size_t)b * rows * depth;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < depth; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + i * kFThreads;
      const int m = idx / kFK, k = idx % kFK;
      const bool k_ok = k0 + k < depth;
      as[k][m] = (k_ok && row0 + m < rows) ? h_b[(size_t)(row0 + m) * depth + k0 + k] : 0.0f;
      bs[k][m] = (k_ok && col0 + m < cols) ? w[(size_t)(col0 + m) * depth + k0 + k] : 0.0f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ctile[ty * 4 + i][tx * 4 + j] = acc[i][j];
  __syncthreads();
  const size_t tile_index = ((size_t)b * row_tiles + rt) * gridDim.y + ct;
  smem_tile_epilogue<float, kFM, kFN, kFThreads>(&ctile[0][0], kFLd, bias, *inv_sigma, y,
                                       partials + tile_index * 2 * groups, b, row0, col0,
                                       rows, cols, groups);
}

// Adds, per sample and group, the partials of every row tile and of the
// column tiles the group spans, in a fixed order; writes (mean, inv_std).
__global__ void matmul_stats_finalize_kernel(const float* __restrict__ partials,
                                             float* __restrict__ stats, int rows, int cols,
                                             int groups, int row_tiles, int col_tiles,
                                             int tile_cols, float eps) {
  const int b = blockIdx.x;
  const int cg = cols / groups;
  const float denom = (float)rows * (float)cg;
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    const int t0 = (grp * cg) / tile_cols, t1 = ((grp + 1) * cg - 1) / tile_cols;
    float s = 0.0f, q = 0.0f;
    for (int rt = 0; rt < row_tiles; ++rt) {
      for (int t = t0; t <= t1; ++t) {
        const float* p = partials + (((size_t)b * row_tiles + rt) * col_tiles + t) * 2 * groups;
        s += p[grp];
        q += p[groups + grp];
      }
    }
    float* o = stats + (size_t)b * 2 * groups;
    gn::finalize(s, q, denom, eps, &o[grp], &o[groups + grp]);
  }
}


}  // namespace

// Tile height (which = 0) or width (which = 1) for a dtype code. bf16: rows
// over the flattened B*T rows, partials [row tiles, column tiles, sample
// slots, 2, G]; f32: rows within a sample, partials [B, row tiles, column
// tiles, 2, G].
extern "C" int readout_matmul_stats_tile(int dtype, int which) {
  if (dtype == gn::kBF16) return which == 0 ? kBM : kBN;
  return which == 0 ? kFM : kFN;
}

// h: [B, T, F]; w: [C, F]; bias: [C] f32; inv_sigma: one f32 on the device;
// y: [B, T, C]; stats: [B, 2, G] f32. bf16 needs F % 64 == 0 and 16-byte
// aligned h and w, and `slot_table` on the device: int32 [row tiles, slots,
// 3] of (sample or -1, first flattened row, end row) for each sample slot of
// each 128-row tile, with `slots` at least the samples a tile touches. f32
// takes neither. Returns a cudaError_t code.
extern "C" int readout_matmul_stats(const void* h, const void* w, const void* bias,
                                    const void* inv_sigma, void* y, void* partials,
                                    void* stats, int batch, int rows, int depth, int cols,
                                    int groups, float eps, int dtype, int slots,
                                    const void* slot_table, void* stream) {
  if (batch <= 0 || rows <= 0 || depth <= 0 || cols <= 0 || groups <= 0 ||
      cols % groups != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* bi = static_cast<const float*>(bias);
  auto* inv = static_cast<const float*>(inv_sigma);
  auto* part = static_cast<float*>(partials);
  if (dtype == gn::kBF16) {
    const long long m = (long long)batch * rows;
    auto* tab = static_cast<const int*>(slot_table);
    if (depth % kBK != 0 || m > 0x7fffffff || slots < 1 || tab == nullptr)
      return (int)cudaErrorInvalidValue;
    Flat f{(int)m, rows, cols, groups, depth / kBK, (int)((m + kBM - 1) / kBM),
           (cols + kBN - 1) / kBN, slots};
    CUtensorMap map_h, map_w;
    if (!encode_map(&map_h, h, f.rows, depth, kBM) || !encode_map(&map_w, w, cols, depth, kBN))
      return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(matmul_stats_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (long long)f.m_tiles * f.n_tiles;
    const int grid = tiles < sms ? (int)tiles : sms;
    matmul_stats_wgmma_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        map_h, map_w, bi, inv, static_cast<__nv_bfloat16*>(y), part, tab, f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    matmul_stats_finalize_flat_kernel<<<batch, 32, 0, st>>>(part, tab, static_cast<float*>(stats),
                                                            f, eps);
    err = cudaGetLastError();
    return (int)err;
  }
  if (dtype != gn::kF32) return (int)cudaErrorInvalidValue;
  const int row_tiles = (rows + kFM - 1) / kFM;
  const int col_tiles = (cols + kFN - 1) / kFN;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  matmul_stats_f32_kernel<<<dim3(batch * row_tiles, col_tiles), kFThreads, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), bi, inv,
      static_cast<float*>(y), part, rows, depth, cols, groups, row_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  matmul_stats_finalize_kernel<<<batch, 32, 0, st>>>(part, static_cast<float*>(stats), rows,
                                                     cols, groups, row_tiles, col_tiles, kFN,
                                                     eps);
  return (int)cudaGetLastError();
}
