// gather_augment: batch assembly for the VAE train step in one pass.
//
// Replaces the TPU kernel simulgen_vae_tpu/ops/gather_augment.py:_kernel
// (reached through gather_augment). For each batch row i it reads
// data[idx[i]] and data[pidx[i]] (rows of T * N elements) and writes
//   x   = data[idx[i]] + n * sd[i]         (n ~ N(0, 1), only when sd[i] != 0)
//   out = lam[i] * (x * amp[i]) + (1 - lam[i]) * data[pidx[i]]
// in the data's dtype, with every product and sum rounded once in f32 in that
// order (__fmul_rn / __fadd_rn: no contraction into FMAs), so that without
// noise the result has the bits of the plain PyTorch composition.
//
// Bound on an H100: bytes. Two rows read and one written: 3 x 608 MB at the
// flagship batch (16 x 200 x 95008 bf16), about 0.54 ms at 3.35 TB/s. The
// noise (Philox plus Box-Muller, ~30 operations per element on the half of
// the rows that draw it) stays below the f32 rate.
//
// Design: grid (blocks per row, B), one sample per blockIdx.y. The block loads
// idx[i], pidx[i] and the three per-sample scalars itself (the TPU used scalar
// prefetch) and walks its slice of the row with 16-byte vector loads (8 bf16
// or 4 f32 elements per thread and step) where the rows are 16-byte aligned,
// with a scalar tail. The noise comes from Philox-4x32-10 written here, keyed
// by the wrapper's seed, with the counter (element / 4, sample): each call
// gives 4 uniforms, turned by Box-Muller into the normals of 4 consecutive
// elements (both cos and sin outputs used), so the bits do not depend on the
// block shape. Rows with sd == 0 skip the draw, as the TPU's lax.cond did.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerRow = 1024;

struct Philox {
  static constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  static constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

  // Philox-4x32 with 10 rounds (Salmon et al., SC'11).
  __device__ static uint4 draw(uint4 ctr, uint2 key) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
      const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
      ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
      key.x += kW0;
      key.y += kW1;
    }
    return ctr;
  }
};

// Four standard normals for elements 4q .. 4q+3 of sample i.
__device__ __forceinline__ void normals4(uint32_t seed, uint32_t i, uint64_t q,
                                         float n[4]) {
  const uint4 r = Philox::draw(make_uint4((uint32_t)q, (uint32_t)(q >> 32), i, 0u),
                               make_uint2(seed, 0x5EED5EEDu));
  const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    // u1 in (0, 1] keeps the log finite; u2 in [0, 1).
    const float u1 = ((float)(bits[2 * k] >> 8) + 1.0f) * (1.0f / 16777216.0f);
    const float u2 = (float)(bits[2 * k + 1] >> 8) * (1.0f / 16777216.0f);
    const float rad = sqrtf(-2.0f * logf(u1));
    float s, c;
    sincospif(2.0f * u2, &s, &c);
    n[2 * k] = rad * c;
    n[2 * k + 1] = rad * s;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float mix(float x, float p, float a, float l, float ml) {
  return __fadd_rn(__fmul_rn(l, __fmul_rn(x, a)), __fmul_rn(ml, p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_augment_kernel(const T* __restrict__ data, const int* __restrict__ idx,
                      const int* __restrict__ pidx, const float* __restrict__ lam,
                      const float* __restrict__ amp, const float* __restrict__ sd,
                      T* __restrict__ out, size_t row_len, uint32_t seed, int vec_ok) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  const uint32_t i = blockIdx.y;
  const T* src = data + (size_t)idx[i] * row_len;
  const T* par = data + (size_t)pidx[i] * row_len;
  T* dst = out + (size_t)i * row_len;
  const float s = sd[i], a = amp[i], l = lam[i];
  const float ml = 1.0f - l;
  const bool noise = s != 0.0f;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;

  const size_t nvec = vec_ok ? row_len / kVec : 0;
  for (size_t v = tid; v < nvec; v += stride) {
    const uint4 xu = reinterpret_cast<const uint4*>(src)[v];
    const uint4 pu = reinterpret_cast<const uint4*>(par)[v];
    uint4 ou;
    const T* xe = reinterpret_cast<const T*>(&xu);
    const T* pe = reinterpret_cast<const T*>(&pu);
    T* oe = reinterpret_cast<T*>(&ou);
    float xf[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) xf[k] = to_f32(xe[k]);
    if (noise) {
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        float n[4];
        normals4(seed, i, (v * kVec) / 4 + q, n);
#pragma unroll
        for (int k = 0; k < 4; ++k) xf[4 * q + k] = __fadd_rn(xf[4 * q + k], __fmul_rn(n[k], s));
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) oe[k] = from_f32<T>(mix(xf[k], to_f32(pe[k]), a, l, ml));
    reinterpret_cast<uint4*>(dst)[v] = ou;
  }
  for (size_t e = nvec * kVec + tid; e < row_len; e += stride) {
    float xf = to_f32(src[e]);
    if (noise) {
      float n[4];
      normals4(seed, i, e / 4, n);
      xf = __fadd_rn(xf, __fmul_rn(n[e % 4], s));
    }
    dst[e] = from_f32<T>(mix(xf, to_f32(par[e]), a, l, ml));
  }
}

template <typename T>
int launch(const void* data, const int* idx, const int* pidx, const float* lam,
           const float* amp, const float* sd, void* out, int batch, size_t row_len,
           uint32_t seed, cudaStream_t stream) {
  const int vec_ok = (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                     ((row_len * sizeof(T)) % 16 == 0);
  const size_t units = vec_ok ? row_len / (16 / sizeof(T)) : row_len;
  const size_t want = (units + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocksPerRow ? (want > 0 ? want : 1) : kMaxBlocksPerRow);
  gather_augment_kernel<T><<<dim3(blocks, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(data), idx, pidx, lam, amp, sd, static_cast<T*>(out),
      row_len, seed, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

// data: [n, T, N]; idx, pidx: [batch] int32 in [0, n); lam, amp, sd: [batch]
// f32; out: [batch, T, N] in data's dtype (0 = f32, 1 = bf16). Returns a
// cudaError_t code: 0 when the kernel was launched.
extern "C" int gather_augment(const void* data, const void* idx, const void* pidx,
                              const void* lam, const void* amp, const void* sd,
                              void* out, int batch, long long row_len,
                              unsigned int seed, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || row_len <= 0) return (int)cudaErrorInvalidValue;
  auto* i = static_cast<const int*>(idx);
  auto* p = static_cast<const int*>(pidx);
  auto* l = static_cast<const float*>(lam);
  auto* a = static_cast<const float*>(amp);
  auto* s = static_cast<const float*>(sd);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(data, i, p, l, a, s, out, batch, (size_t)row_len, seed, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data, i, p, l, a, s, out, batch, (size_t)row_len, seed, st);
  return (int)cudaErrorInvalidValue;
}
