// fused_adamw: AdamW over many tensors in one sweep, with the gradient norm.
//
// Replaces no TPU kernel: in the JAX package XLA fuses
// simulgen_vae_tpu/train/optim.py:FusedAdamW.apply into one pass per leaf with
// the stochastic-rounding dither (_sr_round_bf16_fused) computed inline. Eager
// PyTorch runs the same update as a dozen torch._foreach_* sweeps and the
// dither as ten more passes of integer tensor ops, so the counterpart on the
// card is this kernel. Per element, all in f32 (optim.py:160-171):
//   m2 = b1 * m + (1 - b1) * g           v2 = b2 * v + ((1 - b2) * g) * g
//   p  = p - lr * ((m2 / c1) / (sqrt(v2 / c2) + eps) + wd * p)
// with every product, sum, quotient and root rounded once in that order
// (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn: no contraction into FMAs),
// so the result has the bits of the plain PyTorch composition. m and v are
// stored as f32, as bf16 by round-to-nearest-even, or as bf16 by stochastic
// rounding: bits(x) + (lowbias32(idx * 0x9E3779B9 + seed) & 0xFFFF), masked to
// the high 16 bits, idx the element's linear index in its tensor, the seed per
// (step, leaf, moment) from the wrapper. The parameter update uses the
// unrounded m2 and v2. The same pass sums g^2.
//
// Bound on an H100: bytes. p, g, m, v read and p, m, v written: 28 bytes per
// parameter with f32 moments, 20 with bf16 moments; at 403.5M parameters
// 11.3 GB or 8.07 GB, 3.4 or 2.41 ms at 3.35 TB/s.
//
// Design: a multi-tensor launch. The table of up to kMaxTensors tensors
// (pointers, sizes, leaf indices, first block) travels in the kernel's
// arguments (under 4 KB), so nothing is staged in pinned memory and a new
// gradient tensor every step costs nothing; the wrapper launches once per
// kMaxTensors tensors. A block owns a span of kSpan consecutive elements of one
// tensor (found by bisection of the first-block table): 16-byte vector loads
// where all four pointers allow, a scalar tail at the tensor's end. The block
// adds its threads' g^2 in a fixed order and writes one partial; a last launch
// of one block adds every partial in order and writes sqrt(sum) to a device
// scalar. No atomics and no host sync: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256, kVec = 4, kIters = 8;
constexpr int kSpan = kThreads * kVec * kIters;  // elements per block
constexpr int kMaxTensors = 72;
enum Store { kStoreF32 = 0, kStoreBF16 = 1, kStoreBF16SR = 2 };

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* m[kMaxTensors];
  void* v[kMaxTensors];
  unsigned n[kMaxTensors];           // elements
  unsigned leaf[kMaxTensors];        // index of the tensor in the parameter order
  unsigned char vec[kMaxTensors];    // all four pointers take 16-byte (f32) / 8-byte (bf16) loads
  int first_block[kMaxTensors + 1];  // blocks before tensor i within this launch
  int count;
};

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, wd, lr, c1, c2;
  unsigned sr_step;  // count * 0x85EBCA6B (mod 2^32)
};

__device__ __forceinline__ uint32_t lowbias32(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

// How a moment is stored: its type, and the rounding of the f32 value of
// element i of its tensor.
template <int STORE>
struct Moment;
template <>
struct Moment<kStoreF32> {
  using type = float;
  __device__ static float round(float x, size_t, uint32_t) { return x; }
};
template <>
struct Moment<kStoreBF16> {
  using type = __nv_bfloat16;
  __device__ static __nv_bfloat16 round(float x, size_t, uint32_t) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Moment<kStoreBF16SR> {
  using type = __nv_bfloat16;
  __device__ static __nv_bfloat16 round(float x, size_t i, uint32_t seed) {
    const uint32_t dither = lowbias32((uint32_t)i * 0x9E3779B9u + seed) & 0xFFFFu;
    const uint32_t bits = (__float_as_uint(x) + dither) & 0xFFFF0000u;
    return __ushort_as_bfloat16((unsigned short)(bits >> 16));
  }
};

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Elem {
  float p, m, v;
};

__device__ __forceinline__ Elem update(float p, float g, float m, float v, const Hyper& h) {
  Elem e;
  e.m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  e.v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  const float mhat = __fdiv_rn(e.m, h.c1);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(e.v, h.c2)), h.eps);
  const float upd = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(h.wd, p));
  e.p = __fsub_rn(p, __fmul_rn(h.lr, upd));
  return e;
}

// 4 moments at element i (a multiple of 4, pointers aligned): one load or store.
__device__ __forceinline__ void load4(const float* p, size_t i, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p + i);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, size_t i, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = __bfloat162float(v[k]);
}

__device__ __forceinline__ void store4(float* p, size_t i, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, size_t i, const __nv_bfloat16 (&x)[4]) {
  *reinterpret_cast<uint2*>(p + i) = *reinterpret_cast<const uint2*>(x);
}

template <int MS, int VS>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(Table t, Hyper h, float* __restrict__ partials) {
  using MT = typename Moment<MS>::type;
  using VT = typename Moment<VS>::type;
  __shared__ float scratch[kThreads / 32];
  // the tensor this block works on: the last i with first_block[i] <= blockIdx.x
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const int ti = lo;
  float* __restrict__ p = t.p[ti];
  const float* __restrict__ g = t.g[ti];
  MT* __restrict__ m = static_cast<MT*>(t.m[ti]);
  VT* __restrict__ v = static_cast<VT*>(t.v[ti]);
  const size_t n = t.n[ti];
  const size_t base = (size_t)(blockIdx.x - t.first_block[ti]) * kSpan;
  const uint32_t leaf = t.leaf[ti];
  const uint32_t seed_m = h.sr_step + (2u * leaf) * 0xC2B2AE35u;
  const uint32_t seed_v = h.sr_step + (2u * leaf + 1u) * 0xC2B2AE35u;
  const bool vec = t.vec[ti];

  float sumsq = 0.0f;
#pragma unroll 2
  for (int it = 0; it < kIters; ++it) {
    const size_t i = base + ((size_t)it * kThreads + threadIdx.x) * kVec;
    if (i >= n) break;
    if (vec && i + kVec <= n) {
      float pv[4], gv[4], mv[4], vv[4];
      load4(p, i, pv);
      load4(g, i, gv);
      load4(m, i, mv);
      load4(v, i, vv);
      float po[4];
      __align__(8) MT mo[4];
      __align__(8) VT vo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Elem e = update(pv[k], gv[k], mv[k], vv[k], h);
        po[k] = e.p;
        mo[k] = Moment<MS>::round(e.m, i + k, seed_m);
        vo[k] = Moment<VS>::round(e.v, i + k, seed_v);
        sumsq = __fadd_rn(sumsq, __fmul_rn(gv[k], gv[k]));
      }
      store4(p, i, po);
      store4(m, i, mo);
      store4(v, i, vo);
    } else {
      const size_t end = i + kVec < n ? i + kVec : n;
      for (size_t q = i; q < end; ++q) {
        const float gq = g[q];
        const Elem e = update(p[q], gq, as_f32(m[q]), as_f32(v[q]), h);
        p[q] = e.p;
        m[q] = Moment<MS>::round(e.m, q, seed_m);
        v[q] = Moment<VS>::round(e.v, q, seed_v);
        sumsq = __fadd_rn(sumsq, __fmul_rn(gq, gq));
      }
    }
  }
  // the block's sum of g^2, added lane by lane and warp by warp in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = sumsq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
    partials[blockIdx.x] = total;
  }
}

// sqrt of the sum of all partials, added in a fixed order by one block.
__global__ void __launch_bounds__(1024)
grad_norm_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float scratch[32];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += 1024) s += partials[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < 32; ++w) total += scratch[w];
    *out = sqrtf(total);
  }
}

template <int MS>
int dispatch_v(int v_store, const Table& t, const Hyper& h, float* partials, int blocks,
               cudaStream_t st) {
  if (v_store == kStoreF32)
    fused_adamw_kernel<MS, kStoreF32><<<blocks, kThreads, 0, st>>>(t, h, partials);
  else if (v_store == kStoreBF16)
    fused_adamw_kernel<MS, kStoreBF16><<<blocks, kThreads, 0, st>>>(t, h, partials);
  else if (v_store == kStoreBF16SR)
    fused_adamw_kernel<MS, kStoreBF16SR><<<blocks, kThreads, 0, st>>>(t, h, partials);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_adamw_max_tensors() { return kMaxTensors; }
extern "C" int fused_adamw_span() { return kSpan; }

// One sweep over `count` (<= fused_adamw_max_tensors()) tensors. p, g, m, v:
// host arrays of device pointers (p, g f32; m, v f32 or bf16 by m_store /
// v_store: 0 f32, 1 bf16 round-to-nearest, 2 bf16 stochastic); n: elements
// (< 2^32) of each; leaf: each tensor's index in the parameter order; partials:
// device f32, one slot per block of this launch (ceil(n / span) per tensor, in
// order). hyper: b1, b2, 1 - b1, 1 - b2, eps, wd, lr, c1, c2. Returns a
// cudaError_t code.
extern "C" int fused_adamw(const void* const* p, const void* const* g, const void* const* m,
                           const void* const* v, const unsigned* n, const unsigned* leaf,
                           int count, int m_store, int v_store, const float* hyper,
                           unsigned sr_step, void* partials, void* stream) {
  if (count <= 0 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  Table t;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] == 0) return (int)cudaErrorInvalidValue;
    t.p[i] = static_cast<float*>(const_cast<void*>(p[i]));
    t.g[i] = static_cast<const float*>(g[i]);
    t.m[i] = const_cast<void*>(m[i]);
    t.v[i] = const_cast<void*>(v[i]);
    t.n[i] = n[i];
    t.leaf[i] = leaf[i];
    const uintptr_t m_mask = m_store == kStoreF32 ? 15 : 7, v_mask = v_store == kStoreF32 ? 15 : 7;
    t.vec[i] = ((uintptr_t)p[i] & 15) == 0 && ((uintptr_t)g[i] & 15) == 0 &&
               ((uintptr_t)m[i] & m_mask) == 0 && ((uintptr_t)v[i] & v_mask) == 0;
    t.first_block[i] = blocks;
    blocks += (int)((n[i] + kSpan - 1) / kSpan);
  }
  t.first_block[count] = blocks;
  t.count = count;
  const Hyper h{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                hyper[5], hyper[6], hyper[7], hyper[8], sr_step};
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partials);
  if (m_store == kStoreF32) return dispatch_v<kStoreF32>(v_store, t, h, part, blocks, st);
  if (m_store == kStoreBF16) return dispatch_v<kStoreBF16>(v_store, t, h, part, blocks, st);
  if (m_store == kStoreBF16SR) return dispatch_v<kStoreBF16SR>(v_store, t, h, part, blocks, st);
  return (int)cudaErrorInvalidValue;
}

// out = sqrt(sum of partials[0 .. n - 1]): the global gradient norm.
extern "C" int fused_adamw_grad_norm(const void* partials, int n, void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  grad_norm_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
