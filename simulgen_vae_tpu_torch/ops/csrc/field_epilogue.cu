// gn_apply_field_epilogue: the readout's GroupNorm apply, tanh and rounding
// to the decoder's dtype, then the data scaler's inverse, from the readout
// product's pre-norm [rows, T, N] map straight into the request's f32 rows of
// the served field, in one pass.
//
// Replaces no Pallas kernel. On the TPU the readout's _apply_kernel
// (simulgen_vae_tpu/ops/groupnorm_gelu.py) wrote the tanh'd map and XLA fused
// the f32 cast, subtract and divide of (float(x) - min_[n]) / scale_[n] into
// one loop that wrote where the request's field lives. Apart on the card, the
// apply wrote the tanh'd map in bf16 and the descale read it straight back
// (4.86 GB each way a 128-field request); this kernel reads the pre-norm map
// once and writes the field once.
//
// Bound on an H100: bytes. Each element of the map is read once in its dtype
// and written once in f32: 6 bytes in bf16, so a 128-field request at T =
// 200, N = 95008 is 4.356 ms at 3.35 TB/s. It also issues ~50 instructions an
// element (tanhf's two branches, both run; the normalise and affine; two
// conversions; the correctly rounded divide), over half the card's issue rate
// at that pace.
//
// Design:
// - Bit-equal to gn_apply(act=tanh) then PyTorch's (x.float() - min_) /
//   scale_ on the card: xn = (x - mean) * inv and activate<kActTanh>(xn * sc
//   + bi) as gn_apply_kernel writes them (nvcc contracts xn * sc + bi to the
//   same FMA under the same flags), from_f32<T> then to_f32, then descale():
//   __fsub_rn then __fdiv_rn, so nothing is contracted and the divide is
//   correctly rounded, as PyTorch's (compiled without fast math) is. In f32
//   the rounding step is the identity.
// - Four [N] vectors (GroupNorm scale and bias, min_, scale_) and per
//   (sample, group) statistics: a flat quad walk would read 64 bytes of
//   them from L2 for every 24 bytes of HBM traffic. So a thread owns one
//   column quad (4 consecutive elements of a row) for the whole launch and
//   holds its four vectors in registers; its quad lies in one group (group
//   width % 4 == 0), whose mean and inv it reloads when its row crosses into
//   the next sample.
// - Thread i holds quad i % Q (Q = N / 4) and starts at row i / Q; it walks
//   rows with the stride `bands`, the number of whole rows of quads the
//   card holds at once (7 at the flagship width), so the resident grid
//   sweeps the map front to back in bands of rows. A thread loads its next
//   row (8 bytes of bf16, 16 of f32, streaming) before it computes and
//   stores this one (16 bytes, st.global.cs: nothing reads the field back
//   soon), and advances its pointers by a band, with no index arithmetic in
//   the loop.
// - Measured on an H100 at 700 W, one 128-field request (two 64-row
//   chunks), bf16: 5.67-5.71 ms here with 64-, 128- or 256-thread blocks;
//   the same walk with the addresses recomputed from the row each step,
//   6.3-7.3 ms (slower wherever the registers cut the resident rows to 5);
//   a flat quad walk (a persistent grid stride over the map's quads) with
//   the four vectors read a quad at a time, 6.9-7.5 ms; gn_apply then a
//   stand-alone descale kernel of that flat walk, 9.0-9.1 ms.
// - The rows written are `out`'s: the padded tail chunk's extra rows of the
//   map are read from nowhere and written nowhere.
// - Any other shape or base (N or the group width not a multiple of 4, a
//   base off 16 bytes): blocks walk whole rows with a grid stride, every
//   element on its own.
#include "gn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQuad = 4;    // elements a thread loads and stores at once

__device__ __forceinline__ float descale(float x, float mn, float sc) {
  return __fdiv_rn(__fsub_rn(x, mn), sc);
}

__device__ __forceinline__ float4 load_stats(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// 4 f32 values to a 16-byte aligned address, streaming.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// Blocks of `threads` the card holds at once.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, long long* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

constexpr int kFusedThreads = 128;

template <typename T>
struct Raw;  // a quad of T as it is loaded
template <>
struct Raw<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ uint2 load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ float4 widen(uint2 u) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
template <>
struct Raw<float> {
  using type = float4;
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 widen(float4 v) { return v; }
};

// One element: gn_apply_kernel's normalise, affine and tanh, rounded to T,
// then descaled.
template <typename T>
__device__ __forceinline__ float norm_tanh_descale(float x, float mean, float inv, float sc,
                                                   float bi, float mn, float ds) {
  const float xn = (x - mean) * inv;
  return descale(gn::to_f32(gn::from_f32<T>(gn::activate<gn::kActTanh>(xn * sc + bi))), mn, ds);
}

template <typename T>
__device__ __forceinline__ float4 norm_tanh_descale4(float4 x, float mean, float inv, float4 sc,
                                                     float4 bi, float4 mn, float4 ds) {
  return make_float4(norm_tanh_descale<T>(x.x, mean, inv, sc.x, bi.x, mn.x, ds.x),
                     norm_tanh_descale<T>(x.y, mean, inv, sc.y, bi.y, mn.y, ds.y),
                     norm_tanh_descale<T>(x.z, mean, inv, sc.z, bi.z, mn.z, ds.z),
                     norm_tanh_descale<T>(x.w, mean, inv, sc.w, bi.w, mn.w, ds.w));
}

template <typename T>
__global__ void __launch_bounds__(kFusedThreads)
gn_apply_field_epilogue_kernel(const T* __restrict__ y, const float* __restrict__ stats,
                               const float* __restrict__ gsc, const float* __restrict__ gbi,
                               const float* __restrict__ mn, const float* __restrict__ ds,
                               float* __restrict__ out, int rows, int t, int quads,
                               int group_quads, int groups, int bands) {
  const int i = blockIdx.x * kFusedThreads + threadIdx.x;
  if (i >= quads * bands) return;
  const int q = i % quads;
  const int c = q * kQuad;
  const size_t step = (size_t)bands * quads * kQuad;
  int row = i / quads;
  int b = row / t, tb = row - b * t;
  const float* st = stats + q / group_quads;
  float mean = __ldg(st + (size_t)b * 2 * groups);
  float inv = __ldg(st + (size_t)b * 2 * groups + groups);
  const float4 sc = load_stats(gsc + c), bi = load_stats(gbi + c), m = load_stats(mn + c),
               s = load_stats(ds + c);
  const T* yp = y + (size_t)row * quads * kQuad + c;
  float* op = out + (size_t)row * quads * kQuad + c;
  typename Raw<T>::type cur = Raw<T>::load(yp);
  for (;;) {
    const int next = row + bands;
    typename Raw<T>::type nxt;
    if (next < rows) nxt = Raw<T>::load(yp + step);
    store4(op, norm_tanh_descale4<T>(Raw<T>::widen(cur), mean, inv, sc, bi, m, s));
    if (next >= rows) break;
    row = next;
    yp += step;
    op += step;
    tb += bands;
    if (tb >= t) {
      do {
        tb -= t;
        ++b;
      } while (tb >= t);
      mean = __ldg(st + (size_t)b * 2 * groups);
      inv = __ldg(st + (size_t)b * 2 * groups + groups);
    }
    cur = nxt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_field_epilogue_rows_kernel(const T* __restrict__ y, const float* __restrict__ stats,
                                    const float* __restrict__ gsc,
                                    const float* __restrict__ gbi,
                                    const float* __restrict__ mn, const float* __restrict__ ds,
                                    float* __restrict__ out, int rows, int t, int cols,
                                    int group_cols, int groups) {
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* st = stats + (size_t)(r / t) * 2 * groups;
    const T* yr = y + (size_t)r * cols;
    float* orow = out + (size_t)r * cols;
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      const int g = c / group_cols;
      orow[c] = norm_tanh_descale<T>(gn::to_f32(yr[c]), __ldg(st + g), __ldg(st + groups + g),
                                     __ldg(gsc + c), __ldg(gbi + c), __ldg(mn + c),
                                     __ldg(ds + c));
    }
  }
}

template <typename T>
int launch_fused(const void* y, const float* stats, const float* gsc, const float* gbi,
                 const float* mn, const float* ds, float* out, int rows, int t, int cols,
                 int groups, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int group_cols = cols / groups;
  const bool quads_ok = aligned(y) && aligned(out) && aligned(gsc) && aligned(gbi) &&
                        aligned(mn) && aligned(ds) && group_cols % kQuad == 0;
  const T* yt = static_cast<const T*>(y);
  long long resident = 0;
  cudaError_t err;
  if (quads_ok) {
    err = resident_blocks(gn_apply_field_epilogue_kernel<T>, kFusedThreads, &resident);
    if (err != cudaSuccess) return (int)err;
    const int quads = cols / kQuad;
    const long long fit = resident * kFusedThreads / quads;
    const int bands = (int)(fit < 1 ? 1 : (fit > rows ? rows : fit));
    const long long blocks = ((long long)quads * bands + kFusedThreads - 1) / kFusedThreads;
    gn_apply_field_epilogue_kernel<T><<<(unsigned)blocks, kFusedThreads, 0, stream>>>(
        yt, stats, gsc, gbi, mn, ds, out, rows, t, quads, group_cols / kQuad, groups, bands);
  } else {
    err = resident_blocks(gn_apply_field_epilogue_rows_kernel<T>, kThreads, &resident);
    if (err != cudaSuccess) return (int)err;
    gn_apply_field_epilogue_rows_kernel<T><<<(unsigned)(resident < rows ? resident : rows),
                                             kThreads, 0, stream>>>(
        yt, stats, gsc, gbi, mn, ds, out, rows, t, cols, group_cols, groups);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y: the readout's [B, t, cols] pre-norm map, contiguous, in the decoder's
// dtype (0 = f32, 1 = bf16); stats: [B, 2, groups] f32 (mean, inv) from
// gn_stats; gscale, gbias, min_, scale: [cols] f32; out: [rows / t, t, cols]
// contiguous f32, its rows the first of y's (rows <= B * t). Returns a
// cudaError_t code: 0 when the kernel was launched.
extern "C" int gn_apply_field_epilogue(const void* y, const void* stats, const void* gscale,
                                       const void* gbias, const void* min_, const void* scale,
                                       void* out, long long rows, int t, int cols, int groups,
                                       int dtype, void* stream) {
  if (rows <= 0 || t <= 0 || cols <= 0 || groups <= 0 || cols % groups != 0 || rows % t != 0 ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fused<float>(y, f(stats), f(gscale), f(gbias), f(min_), f(scale), o, (int)rows,
                               t, cols, groups, st);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16>(y, f(stats), f(gscale), f(gbias), f(min_), f(scale), o,
                                       (int)rows, t, cols, groups, st);
  return (int)cudaErrorInvalidValue;
}
