// Shared helpers for the GroupNorm + activation kernels (gn_*.cu).
//
// Layout everywhere: x is [B, T, C] row-major (time, then channels), groups
// split C into `groups` contiguous slices of C / groups columns. Statistics
// are f32 whatever the storage type; outputs are written in x's type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace gn {

// Codes shared with the Python wrappers (ops/groupnorm_gelu.py).
enum Act { kActNone = 0, kActGelu = 1, kActTanh = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Exact GELU through CUDA's erff (the TPU kernel used a rational erf only
// because Mosaic has no erf lowering).
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kActGelu) {
    return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  } else if constexpr (ACT == kActTanh) {
    return tanhf(v);
  } else {
    return v;
  }
}

// d activate(y) / dy, for the backward kernels.
template <int ACT>
__device__ __forceinline__ float activate_grad(float y) {
  if constexpr (ACT == kActGelu) {
    return 0.5f * (1.0f + erff(y * 0.70710678118654752f)) +
           y * 0.39894228040143268f * expf(-0.5f * y * y);
  } else if constexpr (ACT == kActTanh) {
    // 1 - tanh(y)^2 = sech(y)^2 = 4 e / (1 + e)^2 with e = exp(-2 |y|) <= 1:
    // branch-free (tanhf branches on |y|), no cancellation near |y| large,
    // no overflow; e = 0 gives 0. The fast intrinsics: __expf's error grows
    // with |y| only where e, and so the derivative, is tiny, and d is in
    // [1, 2]. gn_bwd_apply's f32 error against its plain version at the
    // 95008-wide tanh map is the same with the accurate expf and division
    // (1.4e-6, 1.1e-5 with the scale 8x), which make gn_bwd_stats a third
    // slower there (0.96 against 0.72 ms; H100 80GB HBM3, 700 W).
    const float e = __expf(-2.0f * fabsf(y));
    const float d = 1.0f + e;
    return __fdividef(4.0f * e, d * d);
  } else {
    return 1.0f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// mean and rsqrt(max(var, 0) + eps) from a group's sum and sum of squares.
__device__ __forceinline__ void finalize(float s, float q, float denom,
                                         float eps, float* mean, float* inv) {
  const float m = s / denom;
  const float var = fmaxf(q / denom - m * m, 0.0f);
  *mean = m;
  *inv = rsqrtf(var + eps);
}

// A 16-byte copy from global to shared memory that does not wait for the
// data (cp.async); cp_async_commit closes a group of them, cp_async_wait_all
// waits for all of this thread's.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// The same copy with the hint that L2 fetch the 256-byte block around it
// from memory (gn_stats streams its 95008-wide map faster with it).
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// VEC adjacent elements of one 16-byte load (or of a single element).
template <typename T, int VEC>
struct alignas(16) Pack {
  T v[VEC];
};

// Each of a cluster's K ranks' first column, then the end (a kernel argument,
// by value).
template <int K>
struct ColSplit {
  int begin[K + 1];

  // From K + 1 ints in host memory, from 0 to `end` and not decreasing;
  // false where they are not.
  bool read(const int* src, int end) {
    if (src == nullptr || src[0] != 0 || src[K] != end) return false;
    for (int r = 0; r <= K; ++r) {
      if (r > 0 && src[r] < src[r - 1]) return false;
      begin[r] = src[r];
    }
    return true;
  }
};

}  // namespace gn

// Instantiates `launch.template operator()<T, ACT>()` for the runtime dtype
// and activation codes; returns cudaErrorInvalidValue for unknown codes.
template <typename F>
static int gn_dispatch(int dtype, int act, F&& launch) {
  if (dtype == gn::kF32) {
    if (act == gn::kActNone) return launch.template operator()<float, gn::kActNone>();
    if (act == gn::kActGelu) return launch.template operator()<float, gn::kActGelu>();
    if (act == gn::kActTanh) return launch.template operator()<float, gn::kActTanh>();
  } else if (dtype == gn::kBF16) {
    if (act == gn::kActNone) return launch.template operator()<__nv_bfloat16, gn::kActNone>();
    if (act == gn::kActGelu) return launch.template operator()<__nv_bfloat16, gn::kActGelu>();
    if (act == gn::kActTanh) return launch.template operator()<__nv_bfloat16, gn::kActTanh>();
  }
  return (int)cudaErrorInvalidValue;
}
