// readout_bwd_stats: phase A of the fused readout's materializing backward.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/readout_chain.py:_bwd_stats_kernel
// (with _bwd_common) and the XLA tile sum and division after it
// (jnp.sum(gsums, axis=1) / denom). From y, the target x, the forward's
// [B, 2, G] statistics and the cotangents g = (gl, gm) of (loss, mse) it
// recomputes per element, in f32,
//   xn = (y - mean) * inv_std,  o = tanh(xn * scale + norm_bias),
//   da = (gl * elem_loss'(o, x) + gm * 2 (o - x)) / n_elem * (1 - o^2),
// and writes
//   msums[b, 0, grp] = mean over the group of dxn,       dxn = da * scale,
//   msums[b, 1, grp] = mean over the group of dxn * xn,
//   dscale_p[b, c]   = sum_t da * xn,   dnb_p[b, c] = sum_t da.
// readout_bwd_dy then forms dy.
//
// Bound on an H100: bytes. y and x read once, 2 x B*C floats written; at
// B = 16, T = 200, C = 95008 in bf16 that is 1.23 GB, about 0.37 ms at
// 3.35 TB/s. One tanhf per element beside it.
//
// Design: a thread owns one 16-byte vector of columns (8 bf16 or 4 f32; one
// column where rows do not start on 16-byte boundaries) and loops over all T
// rows, so the per-column sums over T never leave the thread; a block owns
// 128 vectors, the grid is (column tiles, samples). The group sums follow
// from the column sums (sum_t dxn = scale * sum_t da): one warp per group adds
// the block's columns of that group in a fixed order into per-(sample, tile,
// group) partials, and a second launch of one block per sample adds the tiles
// each group spans, in tile order, and divides. No atomics.
#include "readout_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int VEC, int LOSS>
__global__ void __launch_bounds__(kThreads)
readout_bwd_stats_kernel(const T* __restrict__ y, const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ norm_bias,
                         const float* __restrict__ stats, const float* __restrict__ g,
                         float* __restrict__ partials, float* __restrict__ dscale_p,
                         float* __restrict__ dnb_p, float n_elem, int rows, int cols,
                         int groups, int tiles) {
  __shared__ float col_s1[kThreads * VEC];
  __shared__ float col_s2[kThreads * VEC];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int c0 = tile * kThreads * VEC;
  const int c = c0 + threadIdx.x * VEC;
  const float gl = g[0] / n_elem, gm2 = 2.0f * g[1] / n_elem;

  float s_da[VEC], s_daxn[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s_da[i] = s_daxn[i] = 0.0f;
  ro::Columns<VEC> col;
  if (c < cols) {
    ro::load_columns<VEC>(col, stats, scale, norm_bias, b, c, cols, groups);
    const size_t base = (size_t)b * rows * cols + c;
    const T* yp = y + base;
    const T* xp = x + base;
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float yv[VEC], xv[VEC];
      ro::load_vec<T, VEC>(yp, yv);
      ro::load_vec<T, VEC>(xp, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xn = (yv[i] - col.mean[i]) * col.inv[i];
        const float o = tanhf(xn * col.sc[i] + col.nb[i]);
        const float dl_do = gl * ro::elem_loss_grad<LOSS>(o, xv[i]) + gm2 * (o - xv[i]);
        const float da = dl_do * (1.0f - o * o);
        s_da[i] += da;
        s_daxn[i] += da * xn;
      }
      yp += cols;
      xp += cols;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dnb_p[(size_t)b * cols + c + i] = s_da[i];
      dscale_p[(size_t)b * cols + c + i] = s_daxn[i];
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const bool live = c < cols;
    col_s1[threadIdx.x * VEC + i] = live ? s_da[i] * col.sc[i] : 0.0f;
    col_s2[threadIdx.x * VEC + i] = live ? s_daxn[i] * col.sc[i] : 0.0f;
  }
  __syncthreads();
  ro::group_partials(col_s1, col_s2, c0, kThreads * VEC, cols, groups,
                     partials + ((size_t)b * tiles + tile) * 2 * groups);
}

__global__ void readout_bwd_stats_finalize_kernel(const float* __restrict__ partials,
                                                  float* __restrict__ msums, int rows,
                                                  int cols, int groups, int tiles,
                                                  int width) {
  const int b = blockIdx.x;
  const int cg = cols / groups;
  const float denom = (float)rows * (float)cg;
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    const int t0 = (grp * cg) / width, t1 = ((grp + 1) * cg - 1) / width;
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
  const void* y;
  const void* x;
  const float* scale;
  const float* norm_bias;
  const float* stats;
  const float* g;
  float* partials;
  float* msums;
  float* dscale_p;
  float* dnb_p;
  float n_elem;
  int batch, rows, cols, groups;
  cudaStream_t stream;

  template <typename T, int VEC, int LOSS>
  int operator()() const {
    const int width = kThreads * VEC;
    const int tiles = (cols + width - 1) / width;
    readout_bwd_stats_kernel<T, VEC, LOSS><<<dim3(tiles, batch), kThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(x), scale, norm_bias, stats, g,
        partials, dscale_p, dnb_p, n_elem, rows, cols, groups, tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    readout_bwd_stats_finalize_kernel<<<batch, 32, 0, stream>>>(partials, msums, rows, cols,
                                                                groups, tiles, width);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Column tiles per sample: the wrapper allocates partials of [B, tiles, 2, G].
extern "C" int readout_bwd_stats_tiles(int cols, int dtype) {
  const int width = kThreads * readout_vec(dtype, cols);
  return (cols + width - 1) / width;
}

// msums: [B, 2, G] f32; dscale_p, dnb_p: [B, C] f32; g: device f32 (gl, gm, ...).
// Returns a cudaError_t code.
extern "C" int readout_bwd_stats(const void* y, const void* x, const void* scale,
                                 const void* norm_bias, const void* stats, const void* g,
                                 void* partials, void* msums, void* dscale_p, void* dnb_p,
                                 float n_elem, int batch, int rows, int cols, int groups,
                                 int dtype, int loss, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Launch launch{y,
                x,
                static_cast<const float*>(scale),
                static_cast<const float*>(norm_bias),
                static_cast<const float*>(stats),
                static_cast<const float*>(g),
                static_cast<float*>(partials),
                static_cast<float*>(msums),
                static_cast<float*>(dscale_p),
                static_cast<float*>(dnb_p),
                n_elem, batch, rows, cols, groups,
                static_cast<cudaStream_t>(stream)};
  return readout_dispatch(dtype, cols, loss, launch);
}
