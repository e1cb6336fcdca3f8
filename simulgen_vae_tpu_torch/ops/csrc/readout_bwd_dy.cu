// readout_bwd_dy: phase B of the fused readout's materializing backward.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/readout_chain.py:_bwd_dy_kernel
// (with _bwd_common). From y, the target x, the forward's [B, 2, G]
// statistics, readout_bwd_stats' group means msums = (m1, m2) and
// g = (gl, gm, inv_sigma) it recomputes xn, o and da as phase A does and
// writes, per element,
//   dy = (da * scale - m1 - xn * m2) * inv_std          (in the map's type)
// with per sample and column dbias_p[b, c] = sum_t dy (of the f32 dy) and per
// block the partial of d inv_sigma, sum(dy * (y - bias) / inv_sigma). dy is
// the gradient of y = yr * inv_sigma + bias; the caller contracts it into dW
// and dh.
//
// Bound on an H100: bytes. y and x read once, dy written once; at B = 16,
// T = 200, C = 95008 in bf16 that is 1.83 GB, about 0.55 ms at 3.35 TB/s.
//
// Design: as readout_bwd_stats. A thread owns one 16-byte vector of columns
// (one column where rows do not start on 16-byte boundaries) and loops over
// all T rows, so d bias per column stays in the thread; 128 vectors per
// block, grid (column tiles, samples). The d inv_sigma partial is one block
// sum per (sample, tile), added in order by the wrapper. No atomics.
#include "readout_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int VEC, int LOSS>
__global__ void __launch_bounds__(kThreads)
readout_bwd_dy_kernel(const T* __restrict__ y, const T* __restrict__ x,
                      const float* __restrict__ scale, const float* __restrict__ norm_bias,
                      const float* __restrict__ bias, const float* __restrict__ stats,
                      const float* __restrict__ msums, const float* __restrict__ g,
                      T* __restrict__ dy, float* __restrict__ dbias_p,
                      float* __restrict__ dinv_p, float n_elem, int rows, int cols,
                      int groups, int tiles) {
  __shared__ float scratch[32];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int c = (tile * kThreads + threadIdx.x) * VEC;
  const float gl = g[0] / n_elem, gm2 = 2.0f * g[1] / n_elem, inv_sigma = g[2];

  float dinv = 0.0f;
  if (c < cols) {
    ro::Columns<VEC> col;
    ro::load_columns<VEC>(col, stats, scale, norm_bias, b, c, cols, groups);
    float m1[VEC], m2[VEC], bi[VEC], s_dy[VEC];
    const int cg = cols / groups;
    const float* ms = msums + (size_t)b * 2 * groups;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int grp = (c + i) / cg;
      m1[i] = ms[grp];
      m2[i] = ms[groups + grp];
      bi[i] = bias[c + i];
      s_dy[i] = 0.0f;
    }
    const size_t base = (size_t)b * rows * cols + c;
    const T* yp = y + base;
    const T* xp = x + base;
    T* dp = dy + base;
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float yv[VEC], xv[VEC], dv[VEC];
      ro::load_vec<T, VEC>(yp, yv);
      ro::load_vec<T, VEC>(xp, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xn = (yv[i] - col.mean[i]) * col.inv[i];
        const float o = tanhf(xn * col.sc[i] + col.nb[i]);
        const float dl_do = gl * ro::elem_loss_grad<LOSS>(o, xv[i]) + gm2 * (o - xv[i]);
        const float da = dl_do * (1.0f - o * o);
        const float d = (da * col.sc[i] - m1[i] - xn * m2[i]) * col.inv[i];
        dv[i] = d;
        s_dy[i] += d;
        dinv += d * (yv[i] - bi[i]);
      }
      ro::store_vec<T, VEC>(dp, dv);
      yp += cols;
      xp += cols;
      dp += cols;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dbias_p[(size_t)b * cols + c + i] = s_dy[i];
  }
  // sum(dy * (y - bias) / inv_sigma): the division once per thread
  const float total = ro::block_sum(dinv / inv_sigma, scratch);
  if (threadIdx.x == 0) dinv_p[(size_t)b * tiles + tile] = total;
}

struct Launch {
  const void* y;
  const void* x;
  const float* scale;
  const float* norm_bias;
  const float* bias;
  const float* stats;
  const float* msums;
  const float* g;
  void* dy;
  float* dbias_p;
  float* dinv_p;
  float n_elem;
  int batch, rows, cols, groups;
  cudaStream_t stream;

  template <typename T, int VEC, int LOSS>
  int operator()() const {
    const int width = kThreads * VEC;
    const int tiles = (cols + width - 1) / width;
    readout_bwd_dy_kernel<T, VEC, LOSS><<<dim3(tiles, batch), kThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(x), scale, norm_bias, bias, stats,
        msums, g, static_cast<T*>(dy), dbias_p, dinv_p, n_elem, rows, cols, groups, tiles);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Column tiles per sample: the wrapper allocates dinv_p of [B, tiles].
extern "C" int readout_bwd_dy_tiles(int cols, int dtype) {
  const int width = kThreads * readout_vec(dtype, cols);
  return (cols + width - 1) / width;
}

// dy: [B, T, C] in the map's type; dbias_p: [B, C] f32; dinv_p: [B, tiles] f32;
// g: device f32 (gl, gm, inv_sigma). Returns a cudaError_t code.
extern "C" int readout_bwd_dy(const void* y, const void* x, const void* scale,
                              const void* norm_bias, const void* bias, const void* stats,
                              const void* msums, const void* g, void* dy, void* dbias_p,
                              void* dinv_p, float n_elem, int batch, int rows, int cols,
                              int groups, int dtype, int loss, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Launch launch{y,
                x,
                static_cast<const float*>(scale),
                static_cast<const float*>(norm_bias),
                static_cast<const float*>(bias),
                static_cast<const float*>(stats),
                static_cast<const float*>(msums),
                static_cast<const float*>(g),
                dy,
                static_cast<float*>(dbias_p),
                static_cast<float*>(dinv_p),
                n_elem, batch, rows, cols, groups,
                static_cast<cudaStream_t>(stream)};
  return readout_dispatch(dtype, cols, loss, launch);
}
