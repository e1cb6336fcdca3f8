// gn_apply: normalise a [B, T, C] map with finished group statistics, then
// affine and activation, written in x's dtype.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_apply_kernel
// (reached through _tiled_forward).
//
// Bound on an H100: bytes. It reads x once and writes out once, ~10
// operations per element; at the 95008-wide readout in bf16 and B = 16 that
// is 2 x 608 MB, about 0.36 ms at 3.35 TB/s.
//
// Design: grid (ceil(C / 128), ceil(T / 16), B). Each thread owns one column
// of one sample, loads its group's mean and inv (from gn_stats, [B, 2, G])
// and its scale and bias once, and walks 16 rows; loads and stores are
// coalesced along C. Splitting T over blocks gives the wide maps enough
// blocks to fill the 132 SMs (the TPU kernel's per-tile [T, CT] block held
// all rows because its grid ran in order on one core).
#include "gn_common.cuh"

namespace {

constexpr int kCols = 128;  // columns per block = threads per block
constexpr int kRows = 16;   // rows per block

template <typename T, int ACT>
__global__ void __launch_bounds__(kCols)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ stats,
                T* __restrict__ out, int rows, int cols, int groups) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= cols) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kRows;
  const int t1 = min(t0 + kRows, rows);
  const int g = c / (cols / groups);
  const float* st = stats + (size_t)b * 2 * groups;
  const float mean = st[g], inv = st[groups + g];
  const float sc = scale[c], bi = bias[c];
  const size_t base = (size_t)b * rows * cols + c;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const size_t i = base + (size_t)t * cols;
    const float xn = (gn::to_f32(x[i]) - mean) * inv;
    out[i] = gn::from_f32<T>(gn::activate<ACT>(xn * sc + bi));
  }
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  const float* stats;
  void* out;
  int batch, rows, cols, groups;
  cudaStream_t stream;

  template <typename T, int ACT>
  int operator()() const {
    const dim3 grid((cols + kCols - 1) / kCols, (rows + kRows - 1) / kRows, batch);
    gn_apply_kernel<T, ACT><<<grid, kCols, 0, stream>>>(
        static_cast<const T*>(x), scale, bias, stats, static_cast<T*>(out), rows,
        cols, groups);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int gn_apply(const void* x, const void* scale, const void* bias,
                        const void* stats, void* out, int batch, int rows, int cols,
                        int groups, int dtype, int act, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      batch > 65535 || (rows + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  Launch launch{x,     static_cast<const float*>(scale), static_cast<const float*>(bias),
                static_cast<const float*>(stats), out, batch, rows, cols, groups,
                static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
