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
// Design. The product is computed here, not by a library. bf16: one block per
// 128 x 128 tile of one sample's y, 8 warps of 64 x 32 each on the tensor
// cores (mma.sync through nvcuda::wmma, f32 accumulators), operands staged
// through a 3-stage cp.async ring in shared memory, 64 deep. f32: a 64 x 64
// tile with a 4 x 4 micro-tile per thread and plain fmaf accumulation (full
// f32, never TF32): slow, kept for the f32 checks. Both leave their tile in
// shared memory as f32 and share one epilogue.
//  * Row tiles never straddle samples (T = 200 is no multiple of the tile):
//    tiles are cut within a sample and the ragged last one is zero-filled on
//    load and masked on store, so a block's sums belong to one sample.
//  * Column tiles cross group boundaries (11876-wide groups): the epilogue
//    keeps per-column sums and one warp per group adds its columns in a fixed
//    order into per-(sample, row tile, column tile, group) partials. A second
//    small launch adds the partials of the tiles each group spans, in order,
//    and writes (mean, inv_std). No atomics: two runs give the same bits.
//  * The last column tile (C = 742 * 128 + 32) is zero-filled on the loads of
//    W and masked on the loads of bias and the stores of y.
//  * Row tiles are the fast grid axis, so the blocks that share a W tile run
//    together and W streams from device memory about once; h (6.5 MB) stays
//    in L2.
#include <mma.h>

#include "readout_common.cuh"

namespace {

using namespace nvcuda;

// Scale, bias, round, store and take the statistics of one BM x BN tile held
// as f32 in shared memory (ctile, row stride ldc). Thread (slice, col) walks
// BM / SLICES rows of one column, so stores are coalesced along C.
template <typename T, int BM, int BN, int THREADS>
__device__ __forceinline__ void epilogue(const float* ctile, int ldc,
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

// -- bf16: tensor cores ---------------------------------------------------------

// 64 deep: measured 3.6 ms at the flagship shape against 4.2 ms at 32 (half
// the barriers per product); 256-wide column tiles and a fourth stage gained
// nothing.
constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kThreads = 256;
constexpr int kWnFrags = kBN / 64;  // 16-column fragments per warp: 2 x 4 warps of 64 x (kBN / 4)
constexpr int kChunks = kBK / 8;    // 16-byte chunks per operand row of a stage
constexpr int kLds = kBK + 8;   // operand row stride in shared memory (bf16 elements)
constexpr int kLdc = kBN + 4;   // f32 tile row stride
constexpr int kStageElems = (kBM + kBN) * kLds;
constexpr int kSmemBytes =
    kStages * kStageElems * 2 > kBM * kLdc * 4 ? kStages * kStageElems * 2 : kBM * kLdc * 4;

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

__global__ void __launch_bounds__(kThreads)
matmul_stats_bf16_kernel(const __nv_bfloat16* __restrict__ h,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias, const float* __restrict__ inv_sigma,
                         __nv_bfloat16* __restrict__ y, float* __restrict__ partials,
                         int rows, int depth, int cols, int groups, int row_tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* ctile = reinterpret_cast<float*>(smem_raw);

  const int b = blockIdx.x / row_tiles, rt = blockIdx.x % row_tiles, ct = blockIdx.y;
  const int row0 = rt * kBM, col0 = ct * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x (kBN / 4)
  const __nv_bfloat16* h_b = h + (size_t)b * rows * depth;

  // A stage holds kBM rows of h and kBN rows of W, kChunks 16-byte chunks each.
  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* as = stages + (size_t)stage * kStageElems;
    __nv_bfloat16* bs = as + kBM * kLds;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBM * kChunks / kThreads; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int r = q / kChunks, kc = (q % kChunks) * 8;
      const bool ok = row0 + r < rows;
      cp_async16(as + r * kLds + kc, h_b + (size_t)(ok ? row0 + r : 0) * depth + k0 + kc, ok);
    }
#pragma unroll
    for (int i = 0; i < kBN * kChunks / kThreads; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int r = q / kChunks, kc = (q % kChunks) * 8;
      const bool ok = col0 + r < cols;
      cp_async16(bs + r * kLds + kc, w + (size_t)(ok ? col0 + r : 0) * depth + k0 + kc, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][kWnFrags];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWnFrags; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  // 16-row fragments of this warp that hold any valid row (warp-uniform)
  const int live = min(4, max(0, (rows - row0 - wm * 64 + 15) / 16));

  const int k_tiles = depth / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; the stage of tile kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const __nv_bfloat16* as = stages + (size_t)(kt % kStages) * kStageElems;
    const __nv_bfloat16* bs = as + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[kWnFrags];
#pragma unroll
      for (int j = 0; j < kWnFrags; ++j)
        wmma::load_matrix_sync(fb[j], bs + (wn * (kBN / 4) + j * 16) * kLds + kk, kLds);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < live) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, as + (wm * 64 + i * 16) * kLds + kk, kLds);
#pragma unroll
          for (int j = 0; j < kWnFrags; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the operand stages: reuse them for the tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWnFrags; ++j)
      wmma::store_matrix_sync(ctile + (wm * 64 + i * 16) * kLdc + wn * (kBN / 4) + j * 16, acc[i][j],
                              kLdc, wmma::mem_row_major);
  __syncthreads();
  const size_t tile_index = ((size_t)b * row_tiles + rt) * gridDim.y + ct;
  epilogue<__nv_bfloat16, kBM, kBN, kThreads>(ctile, kLdc, bias, *inv_sigma, y,
                                              partials + tile_index * 2 * groups, b, row0,
                                              col0, rows, cols, groups);
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
  epilogue<float, kFM, kFN, kFThreads>(&ctile[0][0], kFLd, bias, *inv_sigma, y,
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

// Tile height (which = 0) or width (which = 1) for a dtype code: the wrapper
// allocates partials of [B, row tiles, column tiles, 2, G].
extern "C" int readout_matmul_stats_tile(int dtype, int which) {
  if (dtype == gn::kBF16) return which == 0 ? kBM : kBN;
  return which == 0 ? kFM : kFN;
}

// h: [B, T, F]; w: [C, F]; bias: [C] f32; inv_sigma: one f32 on the device;
// y: [B, T, C]; stats: [B, 2, G] f32. bf16 needs F % 64 == 0 and 16-byte
// aligned h and w. Returns a cudaError_t code.
extern "C" int readout_matmul_stats(const void* h, const void* w, const void* bias,
                                    const void* inv_sigma, void* y, void* partials,
                                    void* stats, int batch, int rows, int depth, int cols,
                                    int groups, float eps, int dtype, void* stream) {
  if (batch <= 0 || rows <= 0 || depth <= 0 || cols <= 0 || groups <= 0 ||
      cols % groups != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* bi = static_cast<const float*>(bias);
  auto* inv = static_cast<const float*>(inv_sigma);
  auto* part = static_cast<float*>(partials);
  int row_tiles, col_tiles, tile_cols;
  if (dtype == gn::kBF16) {
    if (depth % kBK != 0) return (int)cudaErrorInvalidValue;
    row_tiles = (rows + kBM - 1) / kBM;
    col_tiles = (cols + kBN - 1) / kBN;
    tile_cols = kBN;
    if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        matmul_stats_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    matmul_stats_bf16_kernel<<<dim3(batch * row_tiles, col_tiles), kThreads, kSmemBytes, st>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w), bi, inv,
        static_cast<__nv_bfloat16*>(y), part, rows, depth, cols, groups, row_tiles);
  } else if (dtype == gn::kF32) {
    row_tiles = (rows + kFM - 1) / kFM;
    col_tiles = (cols + kFN - 1) / kFN;
    tile_cols = kFN;
    if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
    matmul_stats_f32_kernel<<<dim3(batch * row_tiles, col_tiles), kFThreads, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), bi, inv,
        static_cast<float*>(y), part, rows, depth, cols, groups, row_tiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  matmul_stats_finalize_kernel<<<batch, 32, 0, st>>>(part, static_cast<float*>(stats), rows,
                                                     cols, groups, row_tiles, col_tiles,
                                                     tile_cols, eps);
  return (int)cudaGetLastError();
}
