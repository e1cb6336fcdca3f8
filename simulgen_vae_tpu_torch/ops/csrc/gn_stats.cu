// gn_stats: per-(sample, group) mean and rsqrt(var + eps) of a [B, T, C] map.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_stats_kernel
// (reached through _tiled_stats) together with the XLA finalize that follows
// it (_tiled_stats, mean / var / rsqrt over the per-tile partials).
//
// Bound on an H100: bytes. The kernel reads x once (B*T*C*elem bytes) and
// writes B*2*G floats; at the 95008-wide readout in bf16 and B = 16 that is
// 608 MB, about 0.18 ms at 3.35 TB/s.
//
// Design: the TPU walked its sequential grid over C tiles, carrying nothing;
// here each block owns 128 consecutive columns of one sample (grid
// (ceil(C / 128), B)), and a loop over the T rows takes the place of the
// TPU's per-tile [T, CT] block. Each thread sums one column, so every row's
// loads are coalesced along C. A block may span parts of several groups
// (group id = column / (C / G), any group width, C need not be a multiple of
// 32): one warp per group reduces the block's columns in a fixed order and
// writes per-(sample, tile, group) partial sums in f32, zeros for groups the
// tile does not touch. A second launch of one block per sample adds the
// partials of the tiles each group spans, in tile order, and writes
// (mean, inv). No atomics: the result has the same bits on every run.
// Known weakness: with gn_apply the readout map is read twice from HBM.
#include "gn_common.cuh"

namespace {

constexpr int kCols = 128;  // columns per block = threads per block

template <typename T>
__global__ void __launch_bounds__(kCols)
gn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                        int rows, int cols, int groups, int tiles) {
  __shared__ float col_sum[kCols];
  __shared__ float col_sq[kCols];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int c0 = tile * kCols;
  const int c = c0 + threadIdx.x;

  float s = 0.0f, q = 0.0f;
  if (c < cols) {
    const T* p = x + (size_t)b * rows * cols + c;
#pragma unroll 8
    for (int t = 0; t < rows; ++t) {
      const float v = gn::to_f32(p[(size_t)t * cols]);
      s += v;
      q += v * v;
    }
  }
  col_sum[threadIdx.x] = s;
  col_sq[threadIdx.x] = q;
  __syncthreads();

  const int cg = cols / groups;
  const int c_end = min(c0 + kCols, cols);
  const int g_lo = c0 / cg, g_hi = (c_end - 1) / cg;
  float* out = partials + ((size_t)b * tiles + tile) * 2 * groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < groups; g += kCols / 32) {
    float gs = 0.0f, gq = 0.0f;
    if (g >= g_lo && g <= g_hi) {
      const int lo = max(g * cg, c0) - c0;
      const int hi = min((g + 1) * cg, c_end) - c0;
      for (int i = lo + lane; i < hi; i += 32) {
        gs += col_sum[i];
        gq += col_sq[i];
      }
      gs = gn::warp_sum(gs);
      gq = gn::warp_sum(gq);
    }
    if (lane == 0) {
      out[g] = gs;
      out[groups + g] = gq;
    }
  }
}

__global__ void gn_stats_finalize_kernel(const float* __restrict__ partials,
                                         float* __restrict__ stats, int rows,
                                         int cols, int groups, int tiles,
                                         float eps) {
  const int b = blockIdx.x;
  const int cg = cols / groups;
  const float denom = (float)rows * (float)cg;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int t0 = (g * cg) / kCols, t1 = ((g + 1) * cg - 1) / kCols;
    float s = 0.0f, q = 0.0f;
    for (int t = t0; t <= t1; ++t) {
      const float* p = partials + ((size_t)b * tiles + t) * 2 * groups;
      s += p[g];
      q += p[groups + g];
    }
    float* o = stats + (size_t)b * 2 * groups;
    gn::finalize(s, q, denom, eps, &o[g], &o[groups + g]);
  }
}

template <typename T>
int launch(const void* x, float* partials, float* stats, int batch, int rows,
           int cols, int groups, float eps, cudaStream_t stream) {
  const int tiles = (cols + kCols - 1) / kCols;
  gn_stats_partial_kernel<T><<<dim3(tiles, batch), kCols, 0, stream>>>(
      static_cast<const T*>(x), partials, rows, cols, groups, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_stats_finalize_kernel<<<batch, 32, 0, stream>>>(partials, stats, rows, cols,
                                                     groups, tiles, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of column tiles: the wrapper allocates partials of [B, tiles, 2, G].
extern "C" int gn_stats_tiles(int cols) { return (cols + kCols - 1) / kCols; }

// stats: [B, 2, G] f32 (row 0 mean, row 1 inv). Returns a cudaError_t code.
extern "C" int gn_stats(const void* x, void* partials, void* stats, int batch,
                        int rows, int cols, int groups, float eps, int dtype,
                        void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  auto* p = static_cast<float*>(partials);
  auto* s = static_cast<float*>(stats);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == gn::kF32) return launch<float>(x, p, s, batch, rows, cols, groups, eps, st);
  if (dtype == gn::kBF16)
    return launch<__nv_bfloat16>(x, p, s, batch, rows, cols, groups, eps, st);
  return (int)cudaErrorInvalidValue;
}
