// field_epilogue: a decoded field chunk to its rows of the served field, in
// physical units, in one pass.
//
// Replaces no Pallas kernel. Serving ends with the data scaler's inverse,
// (float(x) - min_[n]) / scale_[n] over a [rows, T, N] field; on the TPU XLA
// fused the f32 cast, the subtract and the divide into one loop that wrote
// the result where the request's field lives. In PyTorch the same expression
// is three passes (a cast, two broadcast operators) and a concatenation of
// the chunks; this kernel restores the one loop and writes straight into the
// chunk's rows of the request's output.
//
// Bound on an H100: bytes. Each element is read once in the decoder's dtype
// and written once in f32: 6 bytes in bf16, 8 in f32. A 128-field request
// at T = 200, N = 95008 in bf16 moves 4.86 GB in and 9.73 GB out, 4.36 ms at
// 3.35 TB/s. The correctly rounded divide costs ~10 instructions an element,
// a fifth of the card's issue rate at that pace.
//
// Design:
// - Bit-equal to PyTorch's (x.float() - min_) / scale_ on the card:
//   __fsub_rn then __fdiv_rn, so nothing is contracted and the divide is
//   correctly rounded, as PyTorch's (compiled without fast math) is.
// - Main path (N % 4 == 0, 16-byte aligned bases): the chunk is one flat
//   run of quads (4 consecutive elements of a row). A persistent grid of as
//   many 256-thread blocks as the SMs hold at once walks it with a grid
//   stride, so the whole grid sweeps device memory front to back; each
//   thread has kUnroll quads loaded before it stores any. A quad is one
//   load (8 bytes of bf16, 16 of f32) and one 16-byte f32 store with the
//   streaming hint (st.global.cs: nothing reads the field back soon), so
//   each warp's load and store covers one contiguous span and writes every
//   32-byte sector whole. min_ and scale_ (760 KB at N = 95008, resident in
//   L2) come through the read-only path a quad at a time; the thread's node
//   advances by the grid's stride modulo N.
// - Measured on an H100 at 700 W, one 128-field request: 5.25 ms here;
//   8 consecutive elements a thread (two stores 32 bytes apart, each
//   writing half of every sector it touches) 6.2-6.9 ms; blocks owning
//   column ranges and walking rows 5.6-5.7 ms.
// - Any other N or base: blocks walk whole rows with a grid stride. A row is
//   a scalar head up to the first element where both the input and the
//   output are aligned for a quad, quads, and a scalar tail; where the two
//   bases never align together every element takes the scalar path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuad = 4;    // elements a thread loads and stores at once
constexpr int kUnroll = 2;  // quads a thread has loaded before it stores

__device__ __forceinline__ float descale(float x, float mn, float sc) {
  return __fdiv_rn(__fsub_rn(x, mn), sc);
}

__device__ __forceinline__ float4 descale4(float4 v, float4 m, float4 s) {
  return make_float4(descale(v.x, m.x, s.x), descale(v.y, m.y, s.y), descale(v.z, m.z, s.z),
                     descale(v.w, m.w, s.w));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 4 elements from an aligned address as f32, read once (evict first).
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load_stats(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// 4 f32 values to a 16-byte aligned address, streaming.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
field_epilogue_flat_kernel(const T* __restrict__ x, const float* __restrict__ mn,
                           const float* __restrict__ sc, float* __restrict__ out,
                           long long quads, int cols) {
  const long long stride = (long long)gridDim.x * kThreads;
  const int step = (int)(stride * kQuad % cols);  // the node's advance a stride
  long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  int c = (int)(q * kQuad % cols);
  for (; q + (kUnroll - 1) * stride < quads; q += kUnroll * stride) {
    float4 v[kUnroll], m[kUnroll], s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = load4(x + (size_t)(q + u * stride) * kQuad);
      m[u] = load_stats(mn + c);
      s[u] = load_stats(sc + c);
      c += step;
      if (c >= cols) c -= cols;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      store4(out + (size_t)(q + u * stride) * kQuad, descale4(v[u], m[u], s[u]));
  }
  for (; q < quads; q += stride) {
    const size_t i = (size_t)q * kQuad;
    store4(out + i, descale4(load4(x + i), load_stats(mn + c), load_stats(sc + c)));
    c += step;
    if (c >= cols) c -= cols;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
field_epilogue_rows_kernel(const T* __restrict__ x, const float* __restrict__ mn,
                           const float* __restrict__ sc, float* __restrict__ out,
                           long long rows, int cols, int vec_ok) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + (size_t)r * cols;
    float* orow = out + (size_t)r * cols;
    // With both bases 16-byte aligned, element e of the whole field is
    // aligned for a quad's load and store once e % 4 == 0.
    const int head = vec_ok ? min(cols, (int)((kQuad - (size_t)r * cols % kQuad) % kQuad)) : cols;
    const int quads = (cols - head) / kQuad;
    for (int c = threadIdx.x; c < head; c += kThreads)
      orow[c] = descale(to_f32(xr[c]), __ldg(mn + c), __ldg(sc + c));
    for (int q = threadIdx.x; q < quads; q += kThreads) {
      const int c = head + q * kQuad;
      const float4 m = make_float4(__ldg(mn + c), __ldg(mn + c + 1), __ldg(mn + c + 2),
                                   __ldg(mn + c + 3));
      const float4 s = make_float4(__ldg(sc + c), __ldg(sc + c + 1), __ldg(sc + c + 2),
                                   __ldg(sc + c + 3));
      store4(orow + c, descale4(load4(xr + c), m, s));
    }
    for (int c = head + quads * kQuad + threadIdx.x; c < cols; c += kThreads)
      orow[c] = descale(to_f32(xr[c]), __ldg(mn + c), __ldg(sc + c));
  }
}

template <typename T>
int launch(const void* x, const float* mn, const float* sc, float* out, long long rows,
           int cols, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool bases = aligned(x) && aligned(out);
  const bool flat = bases && aligned(mn) && aligned(sc) && cols % kQuad == 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = flat ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm, field_epilogue_flat_kernel<T>, kThreads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm, field_epilogue_rows_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (flat) {
    const long long quads = rows * (cols / kQuad);
    const long long want = (quads + kThreads - 1) / kThreads;
    field_epilogue_flat_kernel<T><<<(unsigned)(resident < want ? resident : want), kThreads, 0,
                                    stream>>>(static_cast<const T*>(x), mn, sc, out, quads,
                                              cols);
  } else {
    field_epilogue_rows_kernel<T><<<(unsigned)(resident < rows ? resident : rows), kThreads, 0,
                                    stream>>>(static_cast<const T*>(x), mn, sc, out, rows, cols,
                                              bases ? 1 : 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [rows, cols] contiguous in the decoder's dtype (0 = f32, 1 = bf16);
// min_, scale: [cols] f32; out: [rows, cols] contiguous f32 (a chunk's rows
// of the request's field). Returns a cudaError_t code: 0 when the kernel was
// launched.
extern "C" int field_epilogue(const void* x, const void* min_, const void* scale, void* out,
                              long long rows, int cols, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  auto* mn = static_cast<const float*>(min_);
  auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, mn, sc, o, rows, cols, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, mn, sc, o, rows, cols, st);
  return (int)cudaErrorInvalidValue;
}
