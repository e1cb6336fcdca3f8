// gn_bwd_onepass: backward of GroupNorm + activation with one sample on chip.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/groupnorm_gelu.py:_bwd_kernel
// (reached through _pallas_backward, the custom_vjp of
// fused_group_norm_gelu). Given x and the gradient g of out = act(xn * scale
// + bias), it recomputes the statistics and xn, then
//   da   = g * act'(y)
//   dxn  = da * scale
//   dx   = (dxn - mean_g(dxn) - xn * mean_g(dxn * xn)) * inv_g
// and writes per-sample column sums of da * xn (dscale) and da (dbias), which
// the wrapper adds over the batch.
//
// Bound on an H100: bytes. About 40 operations per element against
// 3 x elem_size bytes moved (read x and g once, write dx once), far below the
// ~295 operations per byte where arithmetic would limit it; least time is
// those bytes over 3.35 TB/s.
//
// Design: one block of 1024 threads per sample. x and g are copied into
// dynamic shared memory once (16-byte vector loads where aligned), in their
// own dtype, so the sample is read from HBM once. Column sums come from shared
// memory, one thread per column looping over the T rows in order; each group
// is reduced by one warp in a fixed order (no atomics, the same bits every
// run). Because two maps are staged, the engage rule is its own and tighter
// than the forward's: at T = 200, C <= 284 in bf16 and C <= 143 in f32
// (ops/groupnorm_gelu.onepass_bwd_fits). Known weakness: B blocks only, so at
// B = 16 most SMs idle, and the column loops use C of the 1024 threads.
#include "gn_common.cuh"

namespace {

constexpr int kThreads = 1024;

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) & ~(size_t)15; }

__host__ __device__ inline size_t stage_offset(int cols, int groups) {
  return round16((4 * (size_t)cols + 4 * (size_t)groups) * sizeof(float));
}

template <typename T>
__device__ void stage(const T* __restrict__ src, T* dst, size_t n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n * sizeof(T)) % 16 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const size_t nv = n * sizeof(T) / 16;
    for (size_t i = threadIdx.x; i < nv; i += blockDim.x) d[i] = s[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
gn_bwd_onepass_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, const T* __restrict__ g,
                      T* __restrict__ dx, float* __restrict__ dscale_p,
                      float* __restrict__ dbias_p, int rows, int cols, int groups,
                      float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* col_a = reinterpret_cast<float*>(smem);  // sum x, then sum dxn
  float* col_b = col_a + cols;                      // sum x^2, then sum dxn*xn
  float* col_da = col_b + cols;                     // sum da      (dbias)
  float* col_daxn = col_da + cols;                  // sum da*xn   (dscale)
  float* g_mean = col_daxn + cols;
  float* g_inv = g_mean + groups;
  float* g_m1 = g_inv + groups;
  float* g_m2 = g_m1 + groups;

  const int cg = cols / groups;
  const size_t n = (size_t)rows * cols;
  T* xs = reinterpret_cast<T*>(smem + stage_offset(cols, groups));
  T* gs = reinterpret_cast<T*>(smem + stage_offset(cols, groups) + round16(n * sizeof(T)));
  const size_t off = (size_t)blockIdx.x * n;

  // 1. Stage the sample's x and g: their only reads from HBM.
  stage(x + off, xs, n);
  stage(g + off, gs, n);
  __syncthreads();

  // 2. Column sum and sum of squares of x.
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int t = 0; t < rows; ++t) {
      const float v = gn::to_f32(xs[(size_t)t * cols + c]);
      s += v;
      q += v * v;
    }
    col_a[c] = s;
    col_b[c] = q;
  }
  __syncthreads();

  // 3. Group statistics, one warp per group.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float denom = (float)rows * (float)cg;
  for (int grp = warp; grp < groups; grp += nwarps) {
    float s = 0.0f, q = 0.0f;
    for (int c = grp * cg + lane; c < (grp + 1) * cg; c += 32) {
      s += col_a[c];
      q += col_b[c];
    }
    s = gn::warp_sum(s);
    q = gn::warp_sum(q);
    if (lane == 0) gn::finalize(s, q, denom, eps, &g_mean[grp], &g_inv[grp]);
  }
  __syncthreads();

  // 4. Column sums over T of da, da*xn, dxn and dxn*xn.
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int grp = c / cg;
    const float mean = g_mean[grp], inv = g_inv[grp];
    const float sc = scale[c], bi = bias[c];
    float s_da = 0.0f, s_daxn = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int t = 0; t < rows; ++t) {
      const size_t i = (size_t)t * cols + c;
      const float xn = (gn::to_f32(xs[i]) - mean) * inv;
      const float da = gn::to_f32(gs[i]) * gn::activate_grad<ACT>(xn * sc + bi);
      const float dxn = da * sc;
      s_da += da;
      s_daxn += da * xn;
      s1 += dxn;
      s2 += dxn * xn;
    }
    col_da[c] = s_da;
    col_daxn[c] = s_daxn;
    col_a[c] = s1;
    col_b[c] = s2;
    dbias_p[(size_t)blockIdx.x * cols + c] = s_da;
    dscale_p[(size_t)blockIdx.x * cols + c] = s_daxn;
  }
  __syncthreads();

  // 5. Group means of dxn and dxn*xn.
  for (int grp = warp; grp < groups; grp += nwarps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = grp * cg + lane; c < (grp + 1) * cg; c += 32) {
      s1 += col_a[c];
      s2 += col_b[c];
    }
    s1 = gn::warp_sum(s1);
    s2 = gn::warp_sum(s2);
    if (lane == 0) {
      g_m1[grp] = s1 / denom;
      g_m2[grp] = s2 / denom;
    }
  }
  __syncthreads();

  // 6. dx: the only write to HBM. The column of element i advances by
  // blockDim % cols per step.
  T* db = dx + off;
  int c = threadIdx.x % cols;
  const int step = blockDim.x % cols;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int grp = c / cg;
    const float inv = g_inv[grp], sc = scale[c];
    const float xn = (gn::to_f32(xs[i]) - g_mean[grp]) * inv;
    const float dxn = gn::to_f32(gs[i]) * gn::activate_grad<ACT>(xn * sc + bias[c]) * sc;
    db[i] = gn::from_f32<T>((dxn - g_m1[grp] - xn * g_m2[grp]) * inv);
    c += step;
    if (c >= cols) c -= cols;
  }
}

struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  const void* g;
  void* dx;
  float* dscale_p;
  float* dbias_p;
  int batch, rows, cols, groups;
  float eps;
  cudaStream_t stream;

  template <typename T, int ACT>
  int operator()() const {
    const size_t n = (size_t)rows * cols;
    const size_t smem = stage_offset(cols, groups) + round16(n * sizeof(T)) + n * sizeof(T);
    auto kernel = gn_bwd_onepass_kernel<T, ACT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<batch, kThreads, smem, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<const T*>(g),
        static_cast<T*>(dx), dscale_p, dbias_p, rows, cols, groups, eps);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// dscale_p, dbias_p: [B, C] f32 per-sample partials. Returns a cudaError_t
// code: 0 when the kernel was launched.
extern "C" int gn_bwd_onepass(const void* x, const void* scale, const void* bias,
                              const void* g, void* dx, void* dscale_p, void* dbias_p,
                              int batch, int rows, int cols, int groups, float eps,
                              int dtype, int act, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0)
    return (int)cudaErrorInvalidValue;
  Launch launch{x,     static_cast<const float*>(scale), static_cast<const float*>(bias),
                g,     dx, static_cast<float*>(dscale_p), static_cast<float*>(dbias_p),
                batch, rows, cols, groups, eps, static_cast<cudaStream_t>(stream)};
  return gn_dispatch(dtype, act, launch);
}
