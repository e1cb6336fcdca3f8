// recon_loss_pair: the VAE's reconstruction loss pair, the mean of the
// configured flavor's element loss and the mean of the squared error of the
// decoded field against its target, and the pair's gradient, in two passes.
//
// Replaces no Pallas kernel. The JAX package writes the pair as
// losses.make_recon_loss_pair's f32 expression inside the jitted step, and XLA
// fuses its casts, differences, squares and means into the loops around
// them. Apart on the card, PyTorch runs that expression as ~14 passes over f32
// copies of the [B, T, N] maps (about 43 GB a step at B = 16, T = 200, N =
// 95008); these two kernels stand where XLA's fusion stood.
//
// Bound on an H100: bytes. The forward reads pred and target once; the
// backward reads them once more and writes the gradient once: 10 bytes an
// element in bf16, 3.04 GB or 0.91 ms at 3.35 TB/s for 16 x 200 x 95008.
//
// Design:
// - A flat walk. The maps are contiguous and the loss sums every element, so
//   each thread of a persistent grid (the blocks the card holds at once)
//   walks 16-byte vectors (8 bf16 or 4 f32) with a grid stride, two vectors
//   of each map in flight. The last n % V elements, or every element where a
//   base is off 16 bytes, are taken one at a time.
// - The forward's sums: a vector's element losses are added in f32 (at most
//   eight terms), then into a double held by the thread; the warp, the
//   block's warps and a one-block finalize add in a fixed order, and the
//   means are rounded to f32 once, from double. No atomics: the same inputs
//   give the same bits on every call, eager or replayed from a CUDA graph.
// - The backward is bit-equal to the plain backward as PyTorch runs it on the
//   card: each operation rounded once (__fsub_rn, __fmul_rn, __fadd_rn, so
//   nothing is contracted into an FMA), and the division by the element
//   count and by the smooth L1 threshold taken as PyTorch takes a division by
//   a host scalar, a multiply by its f32 reciprocal. The upstream gradients
//   are read from device memory, so a captured step waits for nothing.
// - The flavor is a template parameter (squared, absolute, smooth L1, Huber),
//   its threshold a run-time argument.
// - Apart from readout_common.cuh's elem_loss / elem_loss_grad on purpose:
//   those follow ops/readout_chain.py's plain version (torch.sign, 0 at
//   d = 0; Huber at delta = 1 alone), to which the fused readout's tests
//   hold them, where these follow losses.make_recon_loss_pair (+1 at d = 0,
//   the JAX package's convention; every threshold) bit for bit. One shared
//   table would change one path's gradients.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Kind : int { kSquared = 0, kAbsolute = 1, kSmoothL1 = 2, kHuber = 3 };

template <typename T>
struct Vec;  // 16 bytes of T as they are loaded and stored
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using raw = uint4;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using raw = float4;
  static __device__ __forceinline__ void widen(const float4& v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ float4 narrow(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// The flavor's element loss of d = pred - target, as losses.py writes it
// (the forward is held to the plain means within rounding, not bit for bit).
template <int K>
__device__ __forceinline__ float element_loss(float d, float thr, float inv_thr) {
  const float a = fabsf(d);
  if (K == kSquared) return __fmul_rn(d, d);
  if (K == kAbsolute) return a;
  const float half_sq = __fmul_rn(0.5f, __fmul_rn(d, d));
  const float linear = __fsub_rn(a, __fmul_rn(0.5f, thr));
  if (K == kSmoothL1) return a < thr ? __fmul_rn(half_sq, inv_thr) : linear;
  return a < thr ? half_sq : __fmul_rn(thr, linear);
}

// (g_flavor * dflavor(d) + g_mse * (2 d)) / n, each operation as the plain
// backward's own kernel rounds it; dflavor's sign is +1 at d = 0 (and -1 at
// NaN), as torch.where(d >= 0, 1.0, -1.0) gives it.
template <int K>
__device__ __forceinline__ float element_grad(float d, float gf, float gm, float thr,
                                              float inv_thr, float inv_n) {
  const float two_d = __fmul_rn(2.0f, d);
  const float sgn = d >= 0.0f ? 1.0f : -1.0f;
  float df;
  if (K == kSquared) {
    df = two_d;
  } else if (K == kAbsolute) {
    df = sgn;
  } else if (K == kSmoothL1) {
    df = fabsf(d) < thr ? __fmul_rn(d, inv_thr) : sgn;
  } else {
    df = fabsf(d) < thr ? d : __fmul_rn(thr, sgn);
  }
  return __fmul_rn(__fadd_rn(__fmul_rn(gf, df), __fmul_rn(gm, two_d)), inv_n);
}

// Sum of n f32 values, pairwise in a fixed order.
template <int N>
__device__ __forceinline__ float pairwise(float* v) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] = __fadd_rn(v[i], v[i + w]);
  }
  return v[0];
}

template <typename T, int K>
__device__ __forceinline__ void add_vector(const typename Vec<T>::raw& rp,
                                           const typename Vec<T>::raw& rt, float thr,
                                           float inv_thr, double& acc_f, double& acc_m) {
  constexpr int V = Vec<T>::kN;
  float p[V], t[V], lf[V], lm[V];
  Vec<T>::widen(rp, p);
  Vec<T>::widen(rt, t);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = __fsub_rn(p[i], t[i]);
    lm[i] = __fmul_rn(d, d);
    if (K != kSquared) lf[i] = element_loss<K>(d, thr, inv_thr);
  }
  acc_m += (double)pairwise<V>(lm);
  if (K != kSquared) acc_f += (double)pairwise<V>(lf);
}

// The block's sum of v, in thread 0; every thread of the block must call it.
__device__ __forceinline__ double block_sum(double v, double* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += smem[w];
  }
  __syncthreads();
  return s;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
recon_loss_pair_fwd_kernel(const T* __restrict__ p, const T* __restrict__ t, long long n,
                           long long nv, float thr, float inv_thr,
                           double* __restrict__ partials) {
  using R = typename Vec<T>::raw;
  constexpr int V = Vec<T>::kN;
  const R* pv = reinterpret_cast<const R*>(p);
  const R* tv = reinterpret_cast<const R*>(t);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  double acc_f = 0.0, acc_m = 0.0;
  long long i = first;
  for (; i + stride < nv; i += 2 * stride) {
    const R p0 = __ldcs(pv + i), t0 = __ldcs(tv + i);
    const R p1 = __ldcs(pv + i + stride), t1 = __ldcs(tv + i + stride);
    add_vector<T, K>(p0, t0, thr, inv_thr, acc_f, acc_m);
    add_vector<T, K>(p1, t1, thr, inv_thr, acc_f, acc_m);
  }
  if (i < nv) add_vector<T, K>(__ldcs(pv + i), __ldcs(tv + i), thr, inv_thr, acc_f, acc_m);
  for (long long e = nv * V + first; e < n; e += stride) {
    const float d = __fsub_rn(to_f32(p[e]), to_f32(t[e]));
    acc_m += (double)__fmul_rn(d, d);
    if (K != kSquared) acc_f += (double)element_loss<K>(d, thr, inv_thr);
  }
  __shared__ double smem[kWarps];
  const double sf = block_sum(acc_f, smem);
  const double sm = block_sum(acc_m, smem);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = sf;
    partials[2 * blockIdx.x + 1] = sm;
  }
}

// One block: the per-block sums in block order, then the two means.
__global__ void __launch_bounds__(kThreads)
recon_loss_pair_fwd_finalize_kernel(const double* __restrict__ partials, int blocks,
                                    long long n, int squared, float* __restrict__ out_flavor,
                                    float* __restrict__ out_mse) {
  double f = 0.0, m = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    f += partials[2 * b];
    m += partials[2 * b + 1];
  }
  __shared__ double smem[kWarps];
  f = block_sum(f, smem);
  m = block_sum(m, smem);
  if (threadIdx.x == 0) {
    *out_mse = (float)(m / (double)n);
    *out_flavor = (float)((squared ? m : f) / (double)n);
  }
}

template <typename T, int K>
__device__ __forceinline__ void grad_vector(const typename Vec<T>::raw& rp,
                                            const typename Vec<T>::raw& rt, float gf, float gm,
                                            float thr, float inv_thr, float inv_n,
                                            typename Vec<T>::raw* gp, typename Vec<T>::raw* gt) {
  constexpr int V = Vec<T>::kN;
  float p[V], t[V], g[V];
  Vec<T>::widen(rp, p);
  Vec<T>::widen(rt, t);
#pragma unroll
  for (int i = 0; i < V; ++i)
    g[i] = element_grad<K>(__fsub_rn(p[i], t[i]), gf, gm, thr, inv_thr, inv_n);
  if (gp != nullptr) *gp = Vec<T>::narrow(g);
  if (gt != nullptr) {
#pragma unroll
    for (int i = 0; i < V; ++i) g[i] = -g[i];
    *gt = Vec<T>::narrow(g);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
recon_loss_pair_bwd_kernel(const T* __restrict__ p, const T* __restrict__ t,
                           const float* __restrict__ g_flavor, const float* __restrict__ g_mse,
                           T* __restrict__ gp, T* __restrict__ gt, long long n, long long nv,
                           float thr, float inv_thr, float inv_n) {
  using R = typename Vec<T>::raw;
  constexpr int V = Vec<T>::kN;
  const float gf = __ldg(g_flavor), gm = __ldg(g_mse);
  const R* pv = reinterpret_cast<const R*>(p);
  const R* tv = reinterpret_cast<const R*>(t);
  R* gpv = reinterpret_cast<R*>(gp);
  R* gtv = reinterpret_cast<R*>(gt);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long i = first;
  for (; i + stride < nv; i += 2 * stride) {
    const R p0 = __ldcs(pv + i), t0 = __ldcs(tv + i);
    const R p1 = __ldcs(pv + i + stride), t1 = __ldcs(tv + i + stride);
    grad_vector<T, K>(p0, t0, gf, gm, thr, inv_thr, inv_n, gp ? gpv + i : nullptr,
                      gt ? gtv + i : nullptr);
    grad_vector<T, K>(p1, t1, gf, gm, thr, inv_thr, inv_n, gp ? gpv + i + stride : nullptr,
                      gt ? gtv + i + stride : nullptr);
  }
  if (i < nv)
    grad_vector<T, K>(__ldcs(pv + i), __ldcs(tv + i), gf, gm, thr, inv_thr, inv_n,
                      gp ? gpv + i : nullptr, gt ? gtv + i : nullptr);
  for (long long e = nv * V + first; e < n; e += stride) {
    const float g =
        element_grad<K>(__fsub_rn(to_f32(p[e]), to_f32(t[e])), gf, gm, thr, inv_thr, inv_n);
    if (gp != nullptr) gp[e] = from_f32<T>(g);
    if (gt != nullptr) gt[e] = from_f32<T>(-g);
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks of kThreads the card holds at once, at most `cap`, and no more than
// the `units` of work (vectors, or elements on the scalar walk) need.
template <typename Kernel>
cudaError_t grid_blocks(Kernel kernel, long long units, long long cap, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  long long b = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (units + kThreads - 1) / kThreads;
  if (b > need) b = need;
  if (b > cap) b = cap;
  *blocks = (int)(b < 1 ? 1 : b);
  return err;
}

template <typename T, int K>
int launch_fwd(const void* pred, const void* target, long long n, float thr, float inv_thr,
               double* partials, int capacity, float* out_flavor, float* out_mse,
               cudaStream_t stream) {
  const long long nv = aligned(pred) && aligned(target) ? n / Vec<T>::kN : 0;
  int blocks = 0;
  cudaError_t err =
      grid_blocks(recon_loss_pair_fwd_kernel<T, K>, nv > 0 ? nv : n, capacity, &blocks);
  if (err != cudaSuccess) return (int)err;
  recon_loss_pair_fwd_kernel<T, K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(pred), static_cast<const T*>(target), n, nv, thr, inv_thr, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recon_loss_pair_fwd_finalize_kernel<<<1, kThreads, 0, stream>>>(
      partials, blocks, n, K == kSquared, out_flavor, out_mse);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_bwd(const void* pred, const void* target, const float* g_flavor, const float* g_mse,
               void* grad_pred, void* grad_target, long long n, float thr, float inv_thr,
               float inv_n, cudaStream_t stream) {
  const bool vec = aligned(pred) && aligned(target) &&
                   (grad_pred == nullptr || aligned(grad_pred)) &&
                   (grad_target == nullptr || aligned(grad_target));
  const long long nv = vec ? n / Vec<T>::kN : 0;
  int blocks = 0;
  cudaError_t err =
      grid_blocks(recon_loss_pair_bwd_kernel<T, K>, nv > 0 ? nv : n, 1LL << 30, &blocks);
  if (err != cudaSuccess) return (int)err;
  recon_loss_pair_bwd_kernel<T, K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(pred), static_cast<const T*>(target), g_flavor, g_mse,
      static_cast<T*>(grad_pred), static_cast<T*>(grad_target), n, nv, thr, inv_thr, inv_n);
  return (int)cudaGetLastError();
}

template <int K>
int fwd_of(int dtype, const void* pred, const void* target, long long n, float thr,
           float inv_thr, double* partials, int capacity, float* out_flavor, float* out_mse,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_fwd<float, K>(pred, target, n, thr, inv_thr, partials, capacity, out_flavor,
                                out_mse, stream);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, K>(pred, target, n, thr, inv_thr, partials, capacity,
                                        out_flavor, out_mse, stream);
  return (int)cudaErrorInvalidValue;
}

template <int K>
int bwd_of(int dtype, const void* pred, const void* target, const float* g_flavor,
           const float* g_mse, void* grad_pred, void* grad_target, long long n, float thr,
           float inv_thr, float inv_n, cudaStream_t stream) {
  if (dtype == 0)
    return launch_bwd<float, K>(pred, target, g_flavor, g_mse, grad_pred, grad_target, n, thr,
                                inv_thr, inv_n, stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, K>(pred, target, g_flavor, g_mse, grad_pred, grad_target,
                                        n, thr, inv_thr, inv_n, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// pred, target: n contiguous elements of one dtype (0 = f32, 1 = bf16); kind:
// 0 squared, 1 absolute, 2 smooth L1, 3 Huber, with the threshold thr and its
// f32 reciprocal inv_thr; partials: 2 x capacity doubles of scratch (the grid
// takes at most `capacity` blocks); out_flavor, out_mse: one f32 each, the two
// means. Returns a cudaError_t code: 0 when both kernels were launched.
extern "C" int recon_loss_pair_fwd(const void* pred, const void* target, long long n, int dtype,
                                   int kind, float thr, float inv_thr, void* partials,
                                   int capacity, void* out_flavor, void* out_mse, void* stream) {
  if (n <= 0 || capacity <= 0) return (int)cudaErrorInvalidValue;
  auto* ps = static_cast<double*>(partials);
  auto* of = static_cast<float*>(out_flavor);
  auto* om = static_cast<float*>(out_mse);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSquared:
      return fwd_of<kSquared>(dtype, pred, target, n, thr, inv_thr, ps, capacity, of, om, st);
    case kAbsolute:
      return fwd_of<kAbsolute>(dtype, pred, target, n, thr, inv_thr, ps, capacity, of, om, st);
    case kSmoothL1:
      return fwd_of<kSmoothL1>(dtype, pred, target, n, thr, inv_thr, ps, capacity, of, om, st);
    case kHuber:
      return fwd_of<kHuber>(dtype, pred, target, n, thr, inv_thr, ps, capacity, of, om, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// g_flavor, g_mse: the two upstream gradients, one f32 each in device memory;
// grad_pred, grad_target: n elements of the inputs' dtype, or null where that
// gradient is not wanted (grad_target gets -(the f32 gradient), rounded);
// inv_n: the f32 reciprocal of n, as PyTorch forms it. Returns a cudaError_t
// code: 0 when the kernel was launched.
extern "C" int recon_loss_pair_bwd(const void* pred, const void* target, const void* g_flavor,
                                   const void* g_mse, void* grad_pred, void* grad_target,
                                   long long n, int dtype, int kind, float thr, float inv_thr,
                                   float inv_n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  auto* gf = static_cast<const float*>(g_flavor);
  auto* gm = static_cast<const float*>(g_mse);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSquared:
      return bwd_of<kSquared>(dtype, pred, target, gf, gm, grad_pred, grad_target, n, thr,
                              inv_thr, inv_n, st);
    case kAbsolute:
      return bwd_of<kAbsolute>(dtype, pred, target, gf, gm, grad_pred, grad_target, n, thr,
                               inv_thr, inv_n, st);
    case kSmoothL1:
      return bwd_of<kSmoothL1>(dtype, pred, target, gf, gm, grad_pred, grad_target, n, thr,
                               inv_thr, inv_n, st);
    case kHuber:
      return bwd_of<kHuber>(dtype, pred, target, gf, gm, grad_pred, grad_target, n, thr,
                            inv_thr, inv_n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
