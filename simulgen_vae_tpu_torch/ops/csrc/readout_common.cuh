// Shared device code of the fused-readout kernels (readout_*.cu).
//
// Layout everywhere: maps are [B, T, C] row-major, groups split C into
// `groups` contiguous slices of C / groups columns (any width: tiles and
// 16-byte vectors may cross group boundaries, so the group id is per column).
// Statistics, sums and all elementwise math are f32 whatever the storage type.
#pragma once

#include "gn_common.cuh"

namespace ro {

// Loss codes shared with the Python wrappers (ops/readout_chain.py). smoothL1
// with beta = 1 and Huber with delta = 1 are the same function.
enum Loss { kMSE = 0, kMAE = 1, kHuber = 2 };

template <int LOSS>
__device__ __forceinline__ float elem_loss(float o, float x) {
  const float d = o - x;
  if constexpr (LOSS == kMSE) {
    return d * d;
  } else if constexpr (LOSS == kMAE) {
    return fabsf(d);
  } else {
    const float ad = fabsf(d);
    return ad < 1.0f ? 0.5f * ad * ad : ad - 0.5f;
  }
}

// d elem_loss / d o.
template <int LOSS>
__device__ __forceinline__ float elem_loss_grad(float o, float x) {
  const float d = o - x;
  const float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
  if constexpr (LOSS == kMSE) {
    return 2.0f * d;
  } else if constexpr (LOSS == kMAE) {
    return s;
  } else {
    return fabsf(d) < 1.0f ? d : s;
  }
}

// VEC consecutive elements as f32; VEC * sizeof(T) is 16 bytes (one load) or
// VEC is 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = gn::to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = gn::to_f32(v[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&in)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = gn::from_f32<T>(in[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is one 16-byte store");
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = gn::from_f32<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Per-column constants of the normalize + affine + tanh chain.
template <int VEC>
struct Columns {
  float mean[VEC], inv[VEC], sc[VEC], nb[VEC];
};

// Fills `col` for columns c .. c + VEC - 1 (all below `cols`) of sample b.
template <int VEC>
__device__ __forceinline__ void load_columns(Columns<VEC>& col, const float* __restrict__ stats,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ norm_bias, int b,
                                             int c, int cols, int groups) {
  const int cg = cols / groups;
  const float* st = stats + (size_t)b * 2 * groups;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int grp = (c + i) / cg;
    col.mean[i] = st[grp];
    col.inv[i] = st[groups + grp];
    col.sc[i] = scale[c + i];
    col.nb[i] = norm_bias[c + i];
  }
}

// Sum over a block of up to 1024 threads, added warp by warp in a fixed
// order; the result is valid in thread 0. `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = gn::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    const int warps = (blockDim.x + 31) >> 5;
    for (int w = 0; w < warps; ++w) total += scratch[w];
  }
  return total;
}

// Per-(block, group) sums of two per-column arrays held in shared memory:
// the block owns columns c0 .. c0 + width - 1 (clipped to `cols`); one warp
// per group adds the block's columns of that group in a fixed order and
// writes out[grp] and out[groups + grp], zeros for groups the block does not
// touch. Call with all threads after a __syncthreads() that publishes
// col_s1 / col_s2.
__device__ __forceinline__ void group_partials(const float* col_s1, const float* col_s2,
                                               int c0, int width, int cols, int groups,
                                               float* __restrict__ out) {
  const int cg = cols / groups;
  const int c_end = min(c0 + width, cols);
  const int g_lo = c0 / cg, g_hi = (c_end - 1) / cg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int grp = warp; grp < groups; grp += warps) {
    float a = 0.0f, q = 0.0f;
    if (grp >= g_lo && grp <= g_hi) {
      const int lo = max(grp * cg, c0) - c0;
      const int hi = min((grp + 1) * cg, c_end) - c0;
      for (int i = lo + lane; i < hi; i += 32) {
        a += col_s1[i];
        q += col_s2[i];
      }
      a = gn::warp_sum(a);
      q = gn::warp_sum(q);
    }
    if (lane == 0) {
      out[grp] = a;
      out[groups + grp] = q;
    }
  }
}

}  // namespace ro

// Instantiates `launch.template operator()<T, VEC, LOSS>()` for the runtime
// dtype and loss codes. VEC is 16 bytes' worth of elements when every row of
// the map starts on a 16-byte boundary (cols % VEC == 0), else 1. Returns
// cudaErrorInvalidValue for unknown codes.
template <typename T, int VEC, typename F>
static int readout_dispatch_loss(int loss, F&& launch) {
  if (loss == ro::kMSE) return launch.template operator()<T, VEC, ro::kMSE>();
  if (loss == ro::kMAE) return launch.template operator()<T, VEC, ro::kMAE>();
  if (loss == ro::kHuber) return launch.template operator()<T, VEC, ro::kHuber>();
  return (int)cudaErrorInvalidValue;
}

template <typename F>
static int readout_dispatch(int dtype, int cols, int loss, F&& launch) {
  if (dtype == gn::kF32) {
    if (cols % 4 == 0) return readout_dispatch_loss<float, 4>(loss, launch);
    return readout_dispatch_loss<float, 1>(loss, launch);
  }
  if (dtype == gn::kBF16) {
    if (cols % 8 == 0) return readout_dispatch_loss<__nv_bfloat16, 8>(loss, launch);
    return readout_dispatch_loss<__nv_bfloat16, 1>(loss, launch);
  }
  return (int)cudaErrorInvalidValue;
}

// Elements per 16-byte vector for a dtype code and width (as readout_dispatch).
static inline int readout_vec(int dtype, int cols) {
  const int v = dtype == gn::kBF16 ? 8 : 4;
  return cols % v == 0 ? v : 1;
}
