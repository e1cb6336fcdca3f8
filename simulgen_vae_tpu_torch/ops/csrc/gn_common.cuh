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
    const float th = tanhf(y);
    return 1.0f - th * th;
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
