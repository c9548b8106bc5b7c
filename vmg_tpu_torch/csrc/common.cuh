// Shared helpers for the VMG Hopper kernels.
//
// Every kernel takes float32 or bfloat16 tensors (dtype code 0 / 1) and
// computes in float32 registers.  rnd<T>() rounds a float through T, so a
// kernel reproduces the roundings of the plain PyTorch version it sits
// beside (a bf16 elementwise op in PyTorch computes in float and rounds
// its result to bf16); for T = float it is the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace vmg {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

// GELU on a float: act 0 = exact erf form, 1 = tanh approximation
// (jax.nn.gelu(approximate=True) == torch approximate='tanh').
__device__ __forceinline__ float gelu(float v, int act) {
  if (act == 0) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
  const float k = 0.79788456080286535588f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// Register micro-tiles shared by the FFN and combine kernels: 256 threads
// as 16 (tx, output-channel lanes) x 16 (ty, pixel lanes).  A thread owns
// PR pixels (ty + 16 i) x OR output channels (tx + 16 j), OR = C / 16;
// PR is picked so that PR * ORMAX <= 28 accumulators.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Tensor-core tiles (bf16 paths): nvcuda::wmma 16x16x16 fragments, f32
// accumulation.  Shared-memory rows that fragments load or store are
// padded by 16 bytes: with strides that are multiples of 128 bytes (or 64)
// the 8 rows one fragment access touches at once fall on the same banks;
// padded, they spread over all 32.
namespace wm = nvcuda::wmma;
typedef wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> FragA;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> FragB;
typedef wm::fragment<wm::accumulator, 16, 16, 16, float> FragC;
constexpr int kPadH = 8, kPadF = 4;  // 16 bytes of bf16 / f32

// Asynchronous 16-byte global -> shared copies (cp.async): start one,
// commit the started copies as one group, wait until at most N groups are
// pending.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Shared memory one block may use on Hopper (227 KB, opt-in above 48 KB).
constexpr size_t kMaxSmem = 232448;

}  // namespace vmg

#define VMG_DISPATCH_DTYPE(code, T, ...)          \
  do {                                            \
    if ((code) == 0) {                            \
      typedef float T;                            \
      __VA_ARGS__;                                \
    } else if ((code) == 1) {                     \
      typedef vmg::bf16 T;                        \
      __VA_ARGS__;                                \
    } else {                                      \
      return (int)cudaErrorInvalidValue;          \
    }                                             \
  } while (0)
