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
// plus, from the f32 dy, dbias[c] = sum_r dy[r, c] and the per-column-tile
// partials of d inv_sigma = sum(dy * (y - bias) / inv_sigma). The [B, T, C]
// dy map is never written or read.
//
// Bound on an H100: operations. Two products of 2 * B*T * C * F: at B = 16,
// T = 200, F = 1024, C = 95008 that is 2 x 0.62 TFLOP, 1.26 ms at 989 TFLOP/s
// in bf16; the bytes (y, x, h, W read, f32 dW and dh written: 1.8 GB) would
// take 0.54 ms. What bounds THIS kernel is neither: see below.
//
// Design. The TPU kernel walks a sequential grid and keeps the whole f32 dh
// resident while dW tiles retire one by one; a CUDA grid has no order, and
// the two contractions reduce over different axes of the one dy. So there are
// two launches that each recompute dy from y and x and each finish their
// outputs alone, with no reduction across blocks and no atomics (two runs
// give the same bits):
//  * the dW pass: a block owns a tile of columns x a tile of F and loops over
//    all B*T rows; the block of the first F tile also keeps the per-column sums
//    of the f32 dy (dbias) and its d inv_sigma partial;
//  * the dh pass: a block owns a tile of rows x a tile of F and loops over
//    all C columns.
// Where a pass has too few output tiles to fill the card (a narrow F, a short
// map), its loop is cut into slabs (blockIdx.z), each block writes its slab's
// partial output to scratch, and a small launch adds the slabs in order; the
// flagship dW pass has blocks enough and writes dW straight out.
// Row tiles need not stop at sample boundaries (nothing per sample is summed
// here): the per-sample statistics are looked up per row.
// Both passes are one kernel template. In a step of the loop the block first
// computes its dy tile into shared memory in the layout the fragment loads
// want ([k][m] for dW, whose dy is the transposed operand: a col_major
// matrix_a; [m][k] for dh), while cp.async brings the other operand's next
// stage (rows of h, or rows of W: both [K, F] row-major, so one loader), then
// multiplies. bf16: tensor cores through nvcuda::wmma (mma.sync), a 128 x BN
// output tile (BN = 256 where F is a multiple of 256, else 128), warps of
// 64 x 32, 64 deep. f32: a 64 x 64 tile with a 4 x 4
// micro-tile per thread and plain fmaf (never TF32), kept for the f32 checks.
// Ragged edges: rows and columns beyond the map give dy = 0, the operand's
// rows beyond K and columns beyond F are zero-filled on load, and edge
// fragments go to global memory through a per-warp patch with masked stores.
// Vector width follows readout_bwd_dy: 16-byte loads of y and x where every
// row starts on a 16-byte boundary, else one column per load.
//
// Cost of the design: dy is recomputed once per F tile in both passes
// (F / BN times: one tanhf and ~40 more operations per element each time),
// and that recomputation, not the mma work, is the larger part of the time at
// F = 1024.
#include <mma.h>

#include <type_traits>

#include "readout_common.cuh"

namespace {

using namespace nvcuda;

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

// -- bf16: tensor cores ---------------------------------------------------------

constexpr int kBM = 128, kBK = 64;
constexpr int kLdDw = kBM + 8;  // dy tile [k][m] of the dW pass (bf16 elements)
constexpr int kLdDh = kBK + 8;  // dy tile [m][k] of the dh pass
constexpr int kDyElems = kBM * kLdDh > kBK * kLdDw ? kBM * kLdDh : kBK * kLdDw;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BN>
constexpr int bf16_smem_bytes() {
  return (kDyElems + 2 * kBK * (BN + 8)) * 2;
}

// DW: out = dW [cols, depth], the loop runs over the rows, op = h [rows, depth].
// else: out = dh [rows, depth], the loop runs over the columns, op = W [cols, depth].
// Grid (F tiles, M tiles, slabs): the blocks that recompute the same dy run
// together; slab z takes k_per steps of the loop and writes out, dbias and
// dinv_p of its own ([slabs, M, depth], [slabs, cols], [slabs, M tiles]).
// (On an H100 at the flagship shape: two blocks per SM at 128 wide took 24 ms
// against 36 ms with one; 256 wide 17 ms.)
template <int VEC, bool DW, int BN>
__global__ void __launch_bounds__(2 * BN, BN == 128 ? 2 : 1)
fused_bf16_kernel(Maps p, const __nv_bfloat16* __restrict__ op, float* __restrict__ out,
                  float* __restrict__ dbias, float* __restrict__ dinv_p, int depth, int loss,
                  int k_per) {
  constexpr int THREADS = 2 * BN, WARPS_N = BN / 32, LDB = BN + 8;
  constexpr int LDA = DW ? kLdDw : kLdDh;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[32];
  __nv_bfloat16* dy_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* op_s = dy_s + kDyElems;

  const int m_total = DW ? p.cols : p.rows, k_total = DW ? p.rows : p.cols;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;  // 2 x WARPS_N warps of 64 x 32
  const float gl = p.g[0] / p.n_elem, gm2 = 2.0f * p.g[1] / p.n_elem;
  const bool lead = DW && blockIdx.x == 0;

  auto load_op = [&](int stage, int kt) {
    __nv_bfloat16* bs = op_s + (size_t)stage * kBK * LDB;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBK * (BN / 8) / THREADS; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int r = q / (BN / 8), nc = (q % (BN / 8)) * 8;
      const bool ok = k0 + r < k_total && n0 + nc < depth;
      cp_async16(bs + r * LDB + nc, op + (ok ? (size_t)(k0 + r) * depth + n0 + nc : 0), ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  float s_dy[VEC];
  double s_dinv = 0.0;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s_dy[i] = 0.0f;

  const int kt_begin = blockIdx.z * k_per;
  const int k_tiles = min((k_total + kBK - 1) / kBK, kt_begin + k_per);
  out += (size_t)blockIdx.z * m_total * depth;
  load_op(0, kt_begin);
  cp_async_commit();
  for (int kt = kt_begin; kt < k_tiles; ++kt) {
    if constexpr (DW) {
      dy_tile<__nv_bfloat16, VEC, kBK, kBM, kLdDw, 1, THREADS>(p, loss, gl, gm2, kt * kBK, m0,
                                                              dy_s, lead, s_dy, s_dinv);
    } else {
      dy_tile<__nv_bfloat16, VEC, kBM, kBK, kLdDh, 1, THREADS>(p, loss, gl, gm2, m0, kt * kBK,
                                                              dy_s, false, s_dy, s_dinv);
    }
    if (kt + 1 < k_tiles) load_op((kt + 1 - kt_begin) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the dy tile is written and stage kt has landed

    const __nv_bfloat16* bs = op_s + (size_t)((kt - kt_begin) & 1) * kBK * LDB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        using ALayout = std::conditional_t<DW, wmma::col_major, wmma::row_major>;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa;
        const int m = wm * 64 + i * 16;
        wmma::load_matrix_sync(fa, DW ? dy_s + kk * LDA + m : dy_s + m * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
    __syncthreads();  // every warp is done with the dy tile and with stage kt
  }
  cp_async_wait<0>();

  float* fsm = reinterpret_cast<float*>(smem_raw);
  if (lead) {
    write_sums<VEC, kBM, THREADS>(s_dy, s_dinv, p.g[2], fsm, scratch, m0, p.cols,
                                  dbias + (size_t)blockIdx.z * p.cols,
                                  dinv_p + blockIdx.z * gridDim.y + blockIdx.y);
    __syncthreads();
  }
  float* patch = fsm + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + wm * 64 + i * 16, n = n0 + wn * 32 + j * 16;
      if (m >= m_total || n >= depth) continue;  // depth % 16 == 0: n is inside or outside
      if (m + 16 <= m_total) {
        wmma::store_matrix_sync(out + (size_t)m * depth + n, acc[i][j], depth,
                                wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e / 16, cc = e % 16;
          if (m + rr < m_total) out[(size_t)(m + rr) * depth + n + cc] = patch[e];
        }
        __syncwarp();
      }
    }
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

// F tile of the bf16 passes: 256 wide (16 warps) where F allows, which halves
// the recomputations of dy; 128 (8 warps, two blocks per SM) for a narrow F.
constexpr int bf16_bn(int depth) { return depth % 256 == 0 ? 256 : 128; }

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

// How the two passes are cut: tiles, slabs of the loop, and scratch.
struct Plan {
  int bm, bk, bn;            // output tile height, loop step, F tile
  int f_tiles, col_tiles, row_tiles;
  int dw_slabs, dw_per, dh_slabs, dh_per;  // slabs and loop steps per slab
  size_t dw_off, dbias_off, dh_off, floats;  // scratch layout (floats)
};

// Slabs for a pass with `blocks` output tiles, `steps` loop steps, an output of
// `out_floats` and room for `slots` blocks on the card at once: the count (at
// most 32, within 256 MB of partial outputs) that needs the fewest loop steps
// in sequence, rounds of blocks times steps per slab; the smaller count on a
// tie. Returns the steps per slab; *slabs has no empty slab.
int cut(int blocks, int steps, size_t out_floats, int slots, int* slabs) {
  constexpr size_t kMaxFloats = (size_t)64 << 20;
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= 32 && s <= steps && (s == 1 || (size_t)s * out_floats <= kMaxFloats);
       ++s) {
    const long long rounds = ((long long)blocks * s + slots - 1) / slots;
    const long long cost = rounds * ((steps + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  const int per = (steps + best - 1) / best;
  *slabs = (steps + per - 1) / per;
  return per;
}

Plan make_plan(long long rows, int depth, int cols, int dtype) {
  Plan pl;
  const bool bf16 = dtype == gn::kBF16;
  pl.bm = bf16 ? kBM : kFM;
  pl.bk = bf16 ? kBK : kFK;
  pl.bn = bf16 ? bf16_bn(depth) : kFM;
  const int slots = 132 * (bf16 && pl.bn == 256 ? 1 : 2);  // blocks the card holds at once
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

template <int VEC, int BN>
int launch_bf16(const Maps& p, const Plan& pl, const void* h, const void* w, const Outputs& o,
                int depth, int loss, cudaStream_t st) {
  constexpr int smem = bf16_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(fused_bf16_kernel<VEC, true, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_bf16_kernel<VEC, false, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return run_passes(p, pl, o, depth, st, [&](bool dw, dim3 grid, float* out, float* dbias, int k_per) {
    if (dw)
      fused_bf16_kernel<VEC, true, BN><<<grid, 2 * BN, smem, st>>>(
          p, static_cast<const __nv_bfloat16*>(h), out, dbias, o.dinv_p, depth, loss, k_per);
    else
      fused_bf16_kernel<VEC, false, BN><<<grid, 2 * BN, smem, st>>>(
          p, static_cast<const __nv_bfloat16*>(w), out, nullptr, nullptr, depth, loss, k_per);
    return (int)cudaGetLastError();
  });
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

}  // namespace

// Length of dinv_p: one d inv_sigma partial per (slab, column tile) of the dW pass.
extern "C" int readout_bwd_fused_tiles(int batch, int t_rows, int depth, int cols, int dtype) {
  const Plan pl = make_plan((long long)batch * t_rows, depth, cols, dtype);
  return pl.dw_slabs * pl.col_tiles;
}

// Floats of scratch the call needs for its slabs (0 when neither pass is cut;
// under 2^28: each pass's partial outputs are capped at 2^26 floats).
extern "C" int readout_bwd_fused_scratch(int batch, int t_rows, int depth, int cols, int dtype) {
  return (int)make_plan((long long)batch * t_rows, depth, cols, dtype).floats;
}

// y, x: [B, T, C]; h: [B, T, F]; w: [C, F] (all in the map's type); scale,
// norm_bias, bias: [C] f32; stats, msums: [B, 2, G] f32; g: device f32 (gl, gm,
// inv_sigma). Outputs, all f32: dw [C, F], dh [B, T, F], dbias [C], dinv_p
// [readout_bwd_fused_tiles]; scratch: readout_bwd_fused_scratch floats. bf16
// needs F % 64 == 0 and 16-byte aligned h and w. Returns a cudaError_t code.
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
  const Plan pl = make_plan(rows, depth, cols, dtype);
  if (pl.col_tiles > 65535 || pl.row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const Outputs o{static_cast<float*>(dw), static_cast<float*>(dh), static_cast<float*>(dbias),
                  static_cast<float*>(dinv_p), static_cast<float*>(scratch)};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == gn::kBF16) {
    if (depth % kBK != 0) return (int)cudaErrorInvalidValue;
    if (pl.bn == 256) {
      if (cols % 8 == 0) return launch_bf16<8, 256>(p, pl, h, w, o, depth, loss, st);
      return launch_bf16<1, 256>(p, pl, h, w, o, depth, loss, st);
    }
    if (cols % 8 == 0) return launch_bf16<8, 128>(p, pl, h, w, o, depth, loss, st);
    return launch_bf16<1, 128>(p, pl, h, w, o, depth, loss, st);
  }
  if (cols % 4 == 0) return launch_f32<4>(p, pl, h, w, o, depth, loss, st);
  return launch_f32<1>(p, pl, h, w, o, depth, loss, st);
}
