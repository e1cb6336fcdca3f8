// readout_loss: the reconstruction losses of the fused readout, x_hat unwritten.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/readout_chain.py:_loss_kernel
// (phase 2 of _forward_parts). Reads y (the rounded readout product) and the
// target x once, and per element computes in f32
//   xn = (y - mean) * inv_std,  o = tanh(xn * scale + norm_bias),
// then adds elem_loss(o, x) (MSE, MAE or Huber/smoothL1) and (o - x)^2 into
// per-block partial sums [B, blocks, 2]. The wrapper adds the partials in a
// fixed order and divides by the element count. o is never stored.
//
// Bound on an H100: bytes. Two maps read once (2 x B*T*C*elem bytes); at
// B = 16, T = 200, C = 95008 in bf16 that is 1.22 GB, about 0.36 ms at
// 3.35 TB/s. One tanhf per element (304M) keeps the f32 pipes busy beside it.
//
// Design: the TPU walked a sequential (sample, column tile) grid with a
// [T, CT] block in VMEM. Here a thread owns one 16-byte vector of columns
// (8 bf16 or 4 f32; one column where C is not a multiple of that, so rows
// do not start on 16-byte boundaries) and walks kRows rows; a block owns
// 128 such vectors, the grid is (column tiles, row chunks, samples). The
// per-column constants (group mean and inv_std by the column's own group id,
// scale, norm_bias) are loaded once per thread. No atomics: one partial pair
// per block, summed in order afterwards.
#include "readout_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 50;  // rows per block

template <typename T, int VEC, int LOSS>
__global__ void __launch_bounds__(kThreads)
readout_loss_kernel(const T* __restrict__ y, const T* __restrict__ x,
                    const float* __restrict__ scale, const float* __restrict__ norm_bias,
                    const float* __restrict__ stats, float* __restrict__ partials,
                    int rows, int cols, int groups) {
  __shared__ float scratch[32];
  const int tile = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int c = (tile * kThreads + threadIdx.x) * VEC;
  float lsum = 0.0f, msum = 0.0f;
  if (c < cols) {
    ro::Columns<VEC> col;
    ro::load_columns<VEC>(col, stats, scale, norm_bias, b, c, cols, groups);
    const int r0 = chunk * kRows, r1 = min(r0 + kRows, rows);
    const size_t base = ((size_t)b * rows + r0) * cols + c;
    const T* yp = y + base;
    const T* xp = x + base;
#pragma unroll 2
    for (int r = r0; r < r1; ++r) {
      float yv[VEC], xv[VEC];
      ro::load_vec<T, VEC>(yp, yv);
      ro::load_vec<T, VEC>(xp, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xn = (yv[i] - col.mean[i]) * col.inv[i];
        const float o = tanhf(xn * col.sc[i] + col.nb[i]);
        const float d = o - xv[i];
        lsum += ro::elem_loss<LOSS>(o, xv[i]);
        msum += d * d;
      }
      yp += cols;
      xp += cols;
    }
  }
  const float l = ro::block_sum(lsum, scratch);
  const float m = ro::block_sum(msum, scratch);
  if (threadIdx.x == 0) {
    float* out = partials + (((size_t)b * gridDim.y + chunk) * gridDim.x + tile) * 2;
    out[0] = l;
    out[1] = m;
  }
}

struct Launch {
  const void* y;
  const void* x;
  const float* scale;
  const float* norm_bias;
  const float* stats;
  float* partials;
  int batch, rows, cols, groups;
  cudaStream_t stream;

  template <typename T, int VEC, int LOSS>
  int operator()() const {
    const int tiles = (cols + kThreads * VEC - 1) / (kThreads * VEC);
    const int chunks = (rows + kRows - 1) / kRows;
    readout_loss_kernel<T, VEC, LOSS><<<dim3(tiles, chunks, batch), kThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(x), scale, norm_bias, stats,
        partials, rows, cols, groups);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Blocks per sample: the wrapper allocates partials of [B, blocks, 2].
extern "C" int readout_loss_blocks(int rows, int cols, int dtype) {
  const int width = kThreads * readout_vec(dtype, cols);
  return ((cols + width - 1) / width) * ((rows + kRows - 1) / kRows);
}

// partials: [B, blocks, 2] f32 of (loss sum, squared-error sum). Returns a
// cudaError_t code.
extern "C" int readout_loss(const void* y, const void* x, const void* scale,
                            const void* norm_bias, const void* stats, void* partials,
                            int batch, int rows, int cols, int groups, int dtype, int loss,
                            void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 ||
      batch > 65535 || (rows + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  Launch launch{y,
                x,
                static_cast<const float*>(scale),
                static_cast<const float*>(norm_bias),
                static_cast<const float*>(stats),
                static_cast<float*>(partials),
                batch, rows, cols, groups,
                static_cast<cudaStream_t>(stream)};
  return readout_dispatch(dtype, cols, loss, launch);
}
