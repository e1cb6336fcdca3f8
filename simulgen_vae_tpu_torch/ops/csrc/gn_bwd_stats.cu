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
// 1.22 GB, about 0.36 ms at 3.35 TB/s. With gn_bwd_apply the pair reads x and
// g twice: 3 x 608 MB at least for one read of each and one write of dx
// (0.54 ms), 5 x 608 MB as designed (0.91 ms).
//
// Design: as gn_stats. The TPU walked a sequential grid over column tiles;
// here each block owns 128 consecutive columns of one sample (grid
// (ceil(C / 128), B)), one thread per column looping over the T rows, so every
// row's loads are coalesced along C and each column's dscale/dbias sum over T
// stays in one thread (a column lies in one tile). Tiles cross group
// boundaries (group id = column / (C / G)): one warp per group reduces the
// block's column sums in a fixed order and writes per-(sample, tile, group)
// partials, zeros for groups the tile does not touch. A second launch of one
// block per sample adds the partials of the tiles each group spans, in tile
// order. No atomics: the same bits on every run.
#include "gn_common.cuh"

namespace {

constexpr int kCols = 128;  // columns per block = threads per block

template <typename T, int ACT>
__global__ void __launch_bounds__(kCols)
gn_bwd_stats_partial_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ bias, const T* __restrict__ g,
                            const float* __restrict__ stats,
                            float* __restrict__ partials, float* __restrict__ dscale_p,
                            float* __restrict__ dbias_p, int rows, int cols,
                            int groups, int tiles) {
  __shared__ float col_s1[kCols];
  __shared__ float col_s2[kCols];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int c0 = tile * kCols;
  const int c = c0 + threadIdx.x;
  const int cg = cols / groups;

  float s1 = 0.0f, s2 = 0.0f;
  if (c < cols) {
    const int grp = c / cg;
    const float* st = stats + (size_t)b * 2 * groups;
    const float mean = st[grp], inv = st[groups + grp];
    const float sc = scale[c], bi = bias[c];
    const size_t base = (size_t)b * rows * cols + c;
    float s_da = 0.0f, s_daxn = 0.0f;
#pragma unroll 4
    for (int t = 0; t < rows; ++t) {
      const size_t i = base + (size_t)t * cols;
      const float xn = (gn::to_f32(x[i]) - mean) * inv;
      const float da = gn::to_f32(g[i]) * gn::activate_grad<ACT>(xn * sc + bi);
      const float dxn = da * sc;
      s_da += da;
      s_daxn += da * xn;
      s1 += dxn;
      s2 += dxn * xn;
    }
    dbias_p[(size_t)b * cols + c] = s_da;
    dscale_p[(size_t)b * cols + c] = s_daxn;
  }
  col_s1[threadIdx.x] = s1;
  col_s2[threadIdx.x] = s2;
  __syncthreads();

  const int c_end = min(c0 + kCols, cols);
  const int g_lo = c0 / cg, g_hi = (c_end - 1) / cg;
  float* out = partials + ((size_t)b * tiles + tile) * 2 * groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int grp = warp; grp < groups; grp += kCols / 32) {
    float a = 0.0f, q = 0.0f;
    if (grp >= g_lo && grp <= g_hi) {
      const int lo = max(grp * cg, c0) - c0;
      const int hi = min((grp + 1) * cg, c_end) - c0;
      for (int i = lo + lane; i < hi; i += 32) {
        a += col_s1[i];
        q += col_s2[i];
      }
      a = gn::warp_sum(a);
      q = gn::warp_sum(q);
    }
    if (lane == 0) {
      out[grp] = a;
      out[groups + grp] = q;
    }
  }
}

__global__ void gn_bwd_stats_finalize_kernel(const float* __restrict__ partials,
                                             float* __restrict__ msums, int rows,
                                             int cols, int groups, int tiles) {
  const int b = blockIdx.x;
  const int cg = cols / groups;
  const float denom = (float)rows * (float)cg;
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    const int t0 = (grp * cg) / kCols, t1 = ((grp + 1) * cg - 1) / kCols;
    float a = 0.0f, q = 0.0f;
    for (int t = t0; t <= t1; ++t) {
      const float* p = partials + ((size_t)b * tiles + t) * 2 * groups;
      a += p[grp];
      q += p[groups + grp];
    }
    float* o = msums + (size_t)b * 2 * groups;
    o[grp] = a / denom;
    o[groups + grp] = q / denom;
  }
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  const void* g;
  const float* stats;
  float* partials;
  float* msums;
  float* dscale_p;
  float* dbias_p;
  int batch, rows, cols, groups;
  cudaStream_t stream;

  template <typename T, int ACT>
  int operator()() const {
    const int tiles = (cols + kCols - 1) / kCols;
    gn_bwd_stats_partial_kernel<T, ACT><<<dim3(tiles, batch), kCols, 0, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<const T*>(g), stats,
        partials, dscale_p, dbias_p, rows, cols, groups, tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gn_bwd_stats_finalize_kernel<<<batch, 32, 0, stream>>>(partials, msums, rows, cols,
                                                           groups, tiles);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Number of column tiles: the wrapper allocates partials of [B, tiles, 2, G].
extern "C" int gn_bwd_stats_tiles(int cols) { return (cols + kCols - 1) / kCols; }

// msums: [B, 2, G] f32; dscale_p, dbias_p: [B, C] f32. Returns a cudaError_t code.
extern "C" int gn_bwd_stats(const void* x, const void* scale, const void* bias,
                            const void* g, const void* stats, void* partials,
                            void* msums, void* dscale_p, void* dbias_p, int batch,
                            int rows, int cols, int groups, int dtype, int act,
                            void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Launch launch{x,
                static_cast<const float*>(scale),
                static_cast<const float*>(bias),
                g,
                static_cast<const float*>(stats),
                static_cast<float*>(partials),
                static_cast<float*>(msums),
                static_cast<float*>(dscale_p),
                static_cast<float*>(dbias_p),
                batch, rows, cols, groups,
                static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
