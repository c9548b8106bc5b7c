// LayerNorm / RMSNorm over the last dim of a (rows, C) tensor.
//
// Replaces the Pallas kernel vmg_tpu/ops/fused_norm.py `_fused_norm2d_impl`
// (`_norm_kernel`, `_norm_kernel_nobias`): one pass, read + write, the f32
// statistics never leave registers.
//
// Bound on H100: bytes.  Per element it reads and writes one value and
// does ~6 float operations; at the stage-0 serving shape (942,080 rows x
// 112 bf16) read + write is 422 MB, 0.126 ms at 3.35 TB/s.
//
// Design: one warp per row, 8 rows per 256-thread block.  Each lane loads
// its share of the row with 16-byte vector loads (8 bf16 or 4 f32; every
// width on the serving path is a multiple of 8) into registers, so the
// row is read once; f32 sum and sum of squares reduce across the warp
// with butterfly shuffles (every lane ends with the totals).  Math of the
// Pallas kernel: f32 one-pass moments of the f32-converted inputs,
// var = E[x^2] - mean^2, rsqrt(var + eps), then scale (+ bias) in f32 and
// one rounding to the output dtype.  RMS: ms = E[x^2], y = x rsqrt(ms +
// eps) * scale.  Widths that are not a multiple of the vector or rows that
// are not 16-byte aligned take scalar loads (C <= 256).  Any row count.
#include "common.cuh"

namespace vmg {

constexpr int kNormRows = kThreads / 32;  // rows per block, one per warp

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = to_f<T>(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f<T>(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// NV: vectors per lane (C <= 32 NV VEC).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
norm_kernel(const T* __restrict__ x, const T* __restrict__ g,
            const T* __restrict__ b, T* __restrict__ out, long long rows,
            int C, float eps, int rms) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kNormRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * C;
  T* orow = out + row * C;
  const int nvec = C / VEC;
  float v[NV][VEC];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = lane + 32 * k;
    if (vi < nvec) {
      load_vec<T, VEC>(xr + vi * VEC, v[k]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s += v[k][i];
        ss += v[k][i] * v[k][i];
      }
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    ss += __shfl_xor_sync(0xffffffffu, ss, m);
  }
  const float inv_c = 1.0f / (float)C;
  const float mean = rms ? 0.f : s * inv_c;
  const float var = rms ? ss * inv_c : ss * inv_c - mean * mean;
  const float r = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = lane + 32 * k;
    if (vi < nvec) {
      float y[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = vi * VEC + i;
        float t = (v[k][i] - mean) * r;
        t = t * to_f<T>(g[c]);
        if (b != nullptr) t = t + to_f<T>(b[c]);
        y[i] = t;
      }
      store_vec<T, VEC>(orow + vi * VEC, y);
    }
  }
}

template <typename T, int VEC>
int launch_norm(const T* x, const T* g, const T* b, T* out, long long rows,
                int C, float eps, int rms, cudaStream_t stream) {
  const int nvec = C / VEC;
  const unsigned blocks = (unsigned)((rows + kNormRows - 1) / kNormRows);
  if (rows <= 0) return 0;
  if (nvec <= 32)
    norm_kernel<T, VEC, 1><<<blocks, kThreads, 0, stream>>>(x, g, b, out, rows, C, eps, rms);
  else if (nvec <= 64)
    norm_kernel<T, VEC, 2><<<blocks, kThreads, 0, stream>>>(x, g, b, out, rows, C, eps, rms);
  else if (nvec <= 128)
    norm_kernel<T, VEC, 4><<<blocks, kThreads, 0, stream>>>(x, g, b, out, rows, C, eps, rms);
  else if (nvec <= 256)
    norm_kernel<T, VEC, 8><<<blocks, kThreads, 0, stream>>>(x, g, b, out, rows, C, eps, rms);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_norm(const void* x, const void* g, const void* b, void* out,
                  long long rows, int C, float eps, int rms, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned && C % VEC == 0)
    return launch_norm<T, VEC>((const T*)x, (const T*)g, (const T*)b, (T*)out, rows, C,
                               eps, rms, s);
  return launch_norm<T, 1>((const T*)x, (const T*)g, (const T*)b, (T*)out, rows, C, eps,
                           rms, s);
}

}  // namespace vmg

// x, out: (rows, C); g, b: (C,) in the same dtype (b may be null: no bias).
// rms: 0 LayerNorm, 1 RMSNorm.  C <= 2048 (bf16) / 1024 (f32) with vector
// loads, C <= 256 otherwise.
extern "C" int vmg_fused_norm(const void* x, const void* g, const void* b,
                              void* out, long long rows, int C, float eps,
                              int rms, int dtype, void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, return vmg::dispatch_norm<T>(x, g, b, out, rows, C, eps, rms, s));
  return (int)cudaErrorInvalidValue;
}
