// gn_act_onepass: GroupNorm + activation with the whole sample on chip.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_kernel
// (reached through _pallas_forward / fused_group_norm_gelu): per-sample
// GroupNorm over a [T, C] block, then affine, then gelu / tanh / none.
//
// Bound on an H100: bytes. The work is ~10 operations per element against
// 2 x elem_size bytes moved, far below the ~295 operations per byte where the
// tensor cores (or even the f32 units) would limit it. The least time is
// (read x once + write out once) / 3.35 TB/s.
//
// Design: one block of 1024 threads per sample. The sample is copied from
// HBM into dynamic shared memory once (16-byte vector loads where aligned)
// and kept in its own dtype, so bf16 maps up to T*C*2 <= ~227 KB stay on
// chip: at T = 200 that is C <= 512 in bf16 and C <= 256 in f32. Column
// sums and sums of squares come from shared memory, each group is reduced by
// one warp in a fixed order (no atomics, same bits on every run), and the
// normalised, activated output is written to HBM once. Known weakness: a
// batch of B samples gives only B blocks, so at B = 16 most of the 132 SMs
// idle; the engage rule in ops/groupnorm_gelu.py sends wider maps to the
// two-phase gn_stats + gn_apply pair.
#include "gn_common.cuh"

namespace {

constexpr int kThreads = 1024;

__host__ __device__ inline size_t stage_offset(int cols, int groups) {
  const size_t head = (2 * (size_t)cols + 2 * (size_t)groups) * sizeof(float);
  return (head + 15) & ~(size_t)15;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
gn_act_onepass_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int rows, int cols, int groups, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* col_sum = reinterpret_cast<float*>(smem);
  float* col_sq = col_sum + cols;
  float* g_mean = col_sq + cols;
  float* g_inv = g_mean + groups;
  T* xs = reinterpret_cast<T*>(smem + stage_offset(cols, groups));

  const int cg = cols / groups;
  const size_t n = (size_t)rows * cols;
  const T* xb = x + (size_t)blockIdx.x * n;
  T* ob = out + (size_t)blockIdx.x * n;

  // 1. Stage the sample: the only read of x from HBM.
  if ((reinterpret_cast<uintptr_t>(xb) & 15) == 0 && (n * sizeof(T)) % 16 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(xb);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    const size_t nv = n * sizeof(T) / 16;
    for (size_t i = threadIdx.x; i < nv; i += blockDim.x) dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) xs[i] = xb[i];
  }
  __syncthreads();

  // 2. Per-column sum and sum of squares over the T rows, in f32.
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int t = 0; t < rows; ++t) {
      const float v = gn::to_f32(xs[(size_t)t * cols + c]);
      s += v;
      q += v * v;
    }
    col_sum[c] = s;
    col_sq[c] = q;
  }
  __syncthreads();

  // 3. Per-group statistics, one warp per group.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float denom = (float)rows * (float)cg;
  for (int g = warp; g < groups; g += nwarps) {
    float s = 0.0f, q = 0.0f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      s += col_sum[c];
      q += col_sq[c];
    }
    s = gn::warp_sum(s);
    q = gn::warp_sum(q);
    if (lane == 0) gn::finalize(s, q, denom, eps, &g_mean[g], &g_inv[g]);
  }
  __syncthreads();

  // 4. Normalise, affine, activate: the only write of out to HBM. The
  // column of element i advances by blockDim % cols per step.
  int c = threadIdx.x % cols;
  const int step = blockDim.x % cols;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = c / cg;
    const float xn = (gn::to_f32(xs[i]) - g_mean[g]) * g_inv[g];
    ob[i] = gn::from_f32<T>(gn::activate<ACT>(xn * scale[c] + bias[c]));
    c += step;
    if (c >= cols) c -= cols;
  }
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  void* out;
  int batch, rows, cols, groups;
  float eps;
  cudaStream_t stream;

  template <typename T, int ACT>
  int operator()() const {
    const size_t smem = stage_offset(cols, groups) + (size_t)rows * cols * sizeof(T);
    auto kernel = gn_act_onepass_kernel<T, ACT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<batch, kThreads, smem, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows, cols,
        groups, eps);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int gn_act_onepass(const void* x, const void* scale, const void* bias,
                              void* out, int batch, int rows, int cols, int groups,
                              float eps, int dtype, int act, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0)
    return (int)cudaErrorInvalidValue;
  Launch launch{x,    static_cast<const float*>(scale), static_cast<const float*>(bias),
                out,  batch, rows, cols, groups, eps,
                static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
