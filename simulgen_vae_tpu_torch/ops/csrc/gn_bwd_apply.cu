// gn_bwd_apply: phase B of the two-pass GroupNorm + activation backward.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_bwd_apply_kernel
// (reached through _tiled_backward). With the forward's statistics (mean, inv)
// and gn_bwd_stats's group means m1 = mean(dxn), m2 = mean(dxn * xn) it
// recomputes xn, y = xn * scale + bias, dxn = g * act'(y) * scale, and writes
//   dx = (dxn - m1 - xn * m2) * inv
// in x's dtype.
//
// Bound on an H100: bytes. It reads x and g once and writes dx once, about
// 20 operations per element; at the 95008-wide readout in bf16 and B = 16
// that is 3 x 608 MB, about 0.54 ms at 3.35 TB/s.
//
// Design: as gn_apply, grid (ceil(C / 128), ceil(T / 16), B). Each thread owns
// one column of one sample, loads its group's four scalars and its scale and
// bias once and walks 16 rows; loads and stores are coalesced along C, and
// splitting T over blocks gives the wide maps enough blocks for 132 SMs.
#include "gn_common.cuh"

namespace {

constexpr int kCols = 128;  // columns per block = threads per block
constexpr int kRows = 16;   // rows per block

template <typename T, int ACT>
__global__ void __launch_bounds__(kCols)
gn_bwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const T* __restrict__ g,
                    const float* __restrict__ stats, const float* __restrict__ msums,
                    T* __restrict__ dx, int rows, int cols, int groups) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= cols) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kRows;
  const int t1 = min(t0 + kRows, rows);
  const int grp = c / (cols / groups);
  const float* st = stats + (size_t)b * 2 * groups;
  const float* ms = msums + (size_t)b * 2 * groups;
  const float mean = st[grp], inv = st[groups + grp];
  const float m1 = ms[grp], m2 = ms[groups + grp];
  const float sc = scale[c], bi = bias[c];
  const size_t base = (size_t)b * rows * cols + c;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const size_t i = base + (size_t)t * cols;
    const float xn = (gn::to_f32(x[i]) - mean) * inv;
    const float dxn = gn::to_f32(g[i]) * gn::activate_grad<ACT>(xn * sc + bi) * sc;
    dx[i] = gn::from_f32<T>((dxn - m1 - xn * m2) * inv);
  }
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  const void* g;
  const float* stats;
  const float* msums;
  void* dx;
  int batch, rows, cols, groups;
  cudaStream_t stream;

  template <typename T, int ACT>
  int operator()() const {
    const dim3 grid((cols + kCols - 1) / kCols, (rows + kRows - 1) / kRows, batch);
    gn_bwd_apply_kernel<T, ACT><<<grid, kCols, 0, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<const T*>(g), stats, msums,
        static_cast<T*>(dx), rows, cols, groups);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int gn_bwd_apply(const void* x, const void* scale, const void* bias,
                            const void* g, const void* stats, const void* msums,
                            void* dx, int batch, int rows, int cols, int groups,
                            int dtype, int act, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      batch > 65535 || (rows + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  Launch launch{x,
                static_cast<const float*>(scale),
                static_cast<const float*>(bias),
                g,
                static_cast<const float*>(stats),
                static_cast<const float*>(msums),
                dx,
                batch, rows, cols, groups,
                static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
