// Hopper building blocks shared by the wgmma and bulk-copy kernels
// (conv_chain.cu, group_ffn.cu, morphfc.cu's combine, ltam.cu's forward):
// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, for every N
// the kernels take (a multiple of 16 up to 240, and 56), and m64nNk8, f32
// += tf32 x tf32 with the 3xTF32 split (WgmmaTF32, tf32_split), with A from
// shared memory (Wgmma<N>; Wgmma<N>::mmaT<TA, TB> reads A and / or B
// MN-major, "transposed") or from registers (WgmmaRA<N>) and B from shared
// memory through matrix descriptors; mbarriers, bulk and TMA copies both
// ways, and the tensor-map encoders.
//
// d: the warpgroup's 64 x N f32 accumulator tile, N / 2 registers a thread
// (wgmma's fragment layout: register 4j + 2h + e holds row 16 * warp + lane
// / 4 + 8h, column 8j + 2 (lane % 4) + e); scale_d = 0 overwrites d instead
// of adding to it.  A register-A fragment of a k16 step is 4 registers of
// two bf16 each: (row r, columns 2 (lane % 4) + {0, 1}), (r + 8, the same),
// (r, 8 + those), (r + 8, 8 + those), r = 16 * warp + lane / 4 -- so the
// columns 16s .. 16s + 15 of an accumulator d become an A fragment as
// pairs (d[8s], d[8s+1]), (d[8s+2], d[8s+3]), (d[8s+4], d[8s+5]),
// (d[8s+6], d[8s+7]).  The PTX names every accumulator register, so the
// operand list %0 .. %(N/2 - 1) and its constraints are built 8 registers
// at a time, and one macro writes the instruction for each width.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime's driver entry points
#include <cuda_runtime.h>
#include <stdint.h>

namespace vmg {

#define VMG_WG_OPS4 "%0, %1, %2, %3"
#define VMG_WG_OPS8 VMG_WG_OPS4 ", %4, %5, %6, %7"
#define VMG_WG_OPS12 VMG_WG_OPS8 ", %8, %9, %10, %11"
#define VMG_WG_OPS16 VMG_WG_OPS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define VMG_WG_OPS20 VMG_WG_OPS16 ", %16, %17, %18, %19"
#define VMG_WG_OPS24 VMG_WG_OPS16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define VMG_WG_OPS28 VMG_WG_OPS24 ", %24, %25, %26, %27"
#define VMG_WG_OPS32 VMG_WG_OPS24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define VMG_WG_OPS40 VMG_WG_OPS32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define VMG_WG_OPS48 VMG_WG_OPS40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define VMG_WG_OPS56 VMG_WG_OPS48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define VMG_WG_OPS64 VMG_WG_OPS56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define VMG_WG_OPS72 VMG_WG_OPS64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define VMG_WG_OPS80 VMG_WG_OPS72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define VMG_WG_OPS88 VMG_WG_OPS80 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define VMG_WG_OPS96 VMG_WG_OPS88 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define VMG_WG_OPS104 VMG_WG_OPS96 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define VMG_WG_OPS112 VMG_WG_OPS104 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define VMG_WG_OPS120 VMG_WG_OPS112 ", %112, %113, %114, %115, %116, %117, %118, %119"

#define VMG_WG_D(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VMG_WG_D4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define VMG_WG_D8 VMG_WG_D(0)
#define VMG_WG_D12 VMG_WG_D8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
#define VMG_WG_D16 VMG_WG_D8, VMG_WG_D(8)
#define VMG_WG_D20 VMG_WG_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
#define VMG_WG_D24 VMG_WG_D16, VMG_WG_D(16)
#define VMG_WG_D28 VMG_WG_D24, "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
#define VMG_WG_D32 VMG_WG_D24, VMG_WG_D(24)
#define VMG_WG_D40 VMG_WG_D32, VMG_WG_D(32)
#define VMG_WG_D48 VMG_WG_D40, VMG_WG_D(40)
#define VMG_WG_D56 VMG_WG_D48, VMG_WG_D(48)
#define VMG_WG_D64 VMG_WG_D56, VMG_WG_D(56)
#define VMG_WG_D72 VMG_WG_D64, VMG_WG_D(64)
#define VMG_WG_D80 VMG_WG_D72, VMG_WG_D(72)
#define VMG_WG_D88 VMG_WG_D80, VMG_WG_D(80)
#define VMG_WG_D96 VMG_WG_D88, VMG_WG_D(88)
#define VMG_WG_D104 VMG_WG_D96, VMG_WG_D(96)
#define VMG_WG_D112 VMG_WG_D104, VMG_WG_D(104)
#define VMG_WG_D120 VMG_WG_D112, VMG_WG_D(112)

template <int N> struct Wgmma;
template <int N> struct WgmmaRA;

// N, its R = N / 2 accumulator registers; Wgmma: the A and B descriptors
// and scale_d follow them as operands R, R + 1, R + 2 (mmaT: then the
// transpose flags, immediates R + 3 and R + 4); WgmmaRA: the four A
// registers R .. R + 3, then the B descriptor and scale_d, R + 4 and R + 5
#define VMG_WGMMA(N, R, R1, R2, R3, R4, R5)                                            \
  template <> struct Wgmma<N> {                                                        \
    static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da, uint64_t db, \
                                               int scale_d) {                          \
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #R2 ", 0;\n"                 \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"         \
                   VMG_WG_OPS##R "}, %" #R ", %" #R1 ", p, 1, 1, 0, 0;\n}\n"           \
                   : VMG_WG_D##R                                                       \
                   : "l"(da), "l"(db), "r"(scale_d));                                  \
    }                                                                                  \
    template <int TA, int TB>                                                          \
    static __device__ __forceinline__ void mmaT(float (&d)[R], uint64_t da, uint64_t db, \
                                                int scale_d) {                         \
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #R2 ", 0;\n"                 \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"         \
                   VMG_WG_OPS##R "}, %" #R ", %" #R1 ", p, 1, 1, %" #R3 ", %" #R4 ";\n}\n" \
                   : VMG_WG_D##R                                                       \
                   : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));                \
    }                                                                                  \
  };                                                                                   \
  template <> struct WgmmaRA<N> {                                                      \
    static __device__ __forceinline__ void mma(float (&d)[R], const uint32_t (&a)[4],  \
                                               uint64_t db, int scale_d) {             \
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #R5 ", 0;\n"                 \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"         \
                   VMG_WG_OPS##R "}, {%" #R ", %" #R1 ", %" #R2 ", %" #R3 "}, %" #R4    \
                   ", p, 1, 1, 0;\n}\n"                                                 \
                   : VMG_WG_D##R                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
                     "r"(scale_d));                                                    \
    }                                                                                  \
  };

VMG_WGMMA(16, 8, 9, 10, 11, 12, 13)
VMG_WGMMA(32, 16, 17, 18, 19, 20, 21)
VMG_WGMMA(48, 24, 25, 26, 27, 28, 29)
VMG_WGMMA(56, 28, 29, 30, 31, 32, 33)
VMG_WGMMA(64, 32, 33, 34, 35, 36, 37)
VMG_WGMMA(80, 40, 41, 42, 43, 44, 45)
VMG_WGMMA(96, 48, 49, 50, 51, 52, 53)
VMG_WGMMA(112, 56, 57, 58, 59, 60, 61)
VMG_WGMMA(128, 64, 65, 66, 67, 68, 69)
VMG_WGMMA(144, 72, 73, 74, 75, 76, 77)
VMG_WGMMA(160, 80, 81, 82, 83, 84, 85)
VMG_WGMMA(176, 88, 89, 90, 91, 92, 93)
VMG_WGMMA(192, 96, 97, 98, 99, 100, 101)
VMG_WGMMA(208, 104, 105, 106, 107, 108, 109)
VMG_WGMMA(224, 112, 113, 114, 115, 116, 117)
VMG_WGMMA(240, 120, 121, 122, 123, 124, 125)

#undef VMG_WGMMA

// m64nNk8, f32 += tf32 x tf32, A from registers, B K-major from shared
// memory (TF32 takes no transposed operand).  A register-A fragment of a k8
// step is 4 registers of one tf32 each: (row r, k = lane % 4), (r + 8, the
// same), (r, 4 + lane % 4), (r + 8, 4 + lane % 4), r = 16 * warp + lane / 4.
// The unit reads the upper 19 bits of each register (sign, exponent, 10
// mantissa bits) and ignores the low 13, so a raw float is its truncation.
// Operands as WgmmaRA's.
template <int N> struct WgmmaTF32;
#define VMG_WGMMA_TF32(N, R, R1, R2, R3, R4, R5)                                       \
  template <> struct WgmmaTF32<N> {                                                    \
    static __device__ __forceinline__ void mma(float (&d)[R], const uint32_t (&a)[4],  \
                                               uint64_t db, int scale_d) {             \
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #R5 ", 0;\n"                 \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"          \
                   VMG_WG_OPS##R "}, {%" #R ", %" #R1 ", %" #R2 ", %" #R3 "}, %" #R4    \
                   ", p, 1, 1;\n}\n"                                                    \
                   : VMG_WG_D##R                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
                     "r"(scale_d));                                                    \
    }                                                                                  \
  };

VMG_WGMMA_TF32(8, 4, 5, 6, 7, 8, 9)
VMG_WGMMA_TF32(16, 8, 9, 10, 11, 12, 13)
VMG_WGMMA_TF32(24, 12, 13, 14, 15, 16, 17)
VMG_WGMMA_TF32(32, 16, 17, 18, 19, 20, 21)
VMG_WGMMA_TF32(40, 20, 21, 22, 23, 24, 25)
VMG_WGMMA_TF32(48, 24, 25, 26, 27, 28, 29)
VMG_WGMMA_TF32(56, 28, 29, 30, 31, 32, 33)
VMG_WGMMA_TF32(64, 32, 33, 34, 35, 36, 37)
VMG_WGMMA_TF32(80, 40, 41, 42, 43, 44, 45)
VMG_WGMMA_TF32(96, 48, 49, 50, 51, 52, 53)
VMG_WGMMA_TF32(112, 56, 57, 58, 59, 60, 61)
VMG_WGMMA_TF32(128, 64, 65, 66, 67, 68, 69)
VMG_WGMMA_TF32(144, 72, 73, 74, 75, 76, 77)
VMG_WGMMA_TF32(160, 80, 81, 82, 83, 84, 85)
VMG_WGMMA_TF32(176, 88, 89, 90, 91, 92, 93)
VMG_WGMMA_TF32(192, 96, 97, 98, 99, 100, 101)
VMG_WGMMA_TF32(208, 104, 105, 106, 107, 108, 109)
VMG_WGMMA_TF32(224, 112, 113, 114, 115, 116, 117)
VMG_WGMMA_TF32(240, 120, 121, 122, 123, 124, 125)

#undef VMG_WGMMA_TF32

// v = hi + lo with hi rounded to TF32 (nearest, ties away: the low 13
// mantissa bits zero) and lo = v - hi exactly; lo goes to the tensor cores
// raw and loses its low 13 bits there (2^-21 of |v| at most).  3xTF32:
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, about f32's accuracy.
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// ---- mbarriers, bulk and TMA copies, descriptors ------------------------

// A position in a ring of n buffers: the buffer and the parity of its
// current phase.
struct RingPos {
  int i = 0;
  unsigned ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++i == n) i = 0, ph ^= 1;
  }
};

__device__ __forceinline__ unsigned su32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// Each takes shared-memory addresses (su32), or generic pointers.
__device__ __forceinline__ void mbar_init(unsigned b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait of more
// than ~2^35 cycles (a lost arrival) traps instead of holding the card
__device__ __forceinline__ void mbar_wait(unsigned b, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, unsigned b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(b)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, int c4, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      ::"r"(su32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(su32(b))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(su32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(su32(b))
      : "memory");
}
// shared -> global: a TMA box, or `bytes` contiguous bytes; each in the
// issuing thread's current bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(su32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(su32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(su32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(su32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issuing thread's bulk groups: all but N have read their shared memory
// (.read) or are complete
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) { mbar_init(su32(b), count); }
__device__ __forceinline__ void mbar_arrive(uint64_t* b) { mbar_arrive(su32(b)); }
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  mbar_expect(su32(b), bytes);
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  mbar_wait(su32(b), parity);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* b) {
  bulk_load(su32(dst), src, bytes, su32(b));
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* b) {
  tma_load_4d(su32(dst), map, c0, c1, c2, c3, su32(b));
}

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes (128 contiguous bytes); lbo: bytes between the two core matrices of a
// k16 step, sbo: bytes between 8-row groups.
__device__ __forceinline__ uint64_t mat_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
// The same with a swizzle mode (bits 62-63: 1 the 128-byte swizzle, 2 the
// 64-byte, 3 the 32-byte), base offset 0.  The swizzle applies to absolute
// shared-memory address bits, as TMA's does: an operand may start anywhere
// in a swizzled image (K-major ones step along K, or down whole rows, by
// moving addr; the probes' tile GEMM checks both on the card).
__device__ __forceinline__ uint64_t mat_desc_sw(unsigned addr, unsigned lbo, unsigned sbo,
                                                unsigned mode) {
  return mat_desc(addr, lbo, sbo) | ((uint64_t)mode << 62);
}
// generic-proxy writes to shared memory, made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
// keep the compiler from moving accumulator reads or writes across wgmma
template <int R>
__device__ __forceinline__ void pin_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// ---- host ------------------------------------------------------------------

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A 4-D tensor map over an (N, H, W, C) bf16 (or, f32 true, float32)
// tensor: boxes of box_c (8 by default) channels x box_w columns x box_h
// rows of one frame, no swizzle, zeros out of bounds (also at negative
// coordinates).
inline int nhwc_box_map(CUtensorMap* map, const void* t, int N, int H, int W, int C, int box_w,
                        int box_h, int box_c = 8, bool f32 = false) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * e, (cuuint64_t)W * C * e,
                                 (cuuint64_t)H * W * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w, (cuuint32_t)box_h, 1},
                   elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(t), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 5-D tensor map over an (N, H, W, C) bf16 (or, f32 true, float32)
// tensor with C split into nsp pieces of C / nsp (a box dimension holds at
// most 256 elements): boxes of all C channels x box_w columns x box_h rows
// of one frame, landing in shared memory as (box_h, box_w, C), no swizzle,
// zeros out of bounds.
inline int nhwc_split_map(CUtensorMap* map, const void* t, int N, int H, int W, int C, int nsp,
                          int box_w, int box_h, bool f32 = false) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int cs = C / nsp;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[5] = {(cuuint64_t)cs, (cuuint64_t)nsp, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[4] = {(cuuint64_t)cs * e, (cuuint64_t)C * e, (cuuint64_t)W * C * e,
                                 (cuuint64_t)H * W * C * e};
  const cuuint32_t box[5] = {(cuuint32_t)cs, (cuuint32_t)nsp, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1},
                   elem[5] = {1, 1, 1, 1, 1};
  CUresult r = enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   5, const_cast<void*>(t), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 3-D tensor map over a (d2, d1, d0) bf16 (or, f32 true, float32) tensor,
// d0 innermost: boxes of box0 x box1 x 1, zeros out of bounds; swizzle128:
// the 128-byte swizzle (128-byte box rows -- box0 = 64 bf16 or 32 f32 --,
// 16-byte chunk i of row r at chunk i ^ (r % 8); the box's shared memory
// 1024-byte aligned), else none.
inline int bf16_box_map3(CUtensorMap* map, const void* t, int d0, int d1, int d2, int box0,
                         int box1, bool swizzle128, bool f32 = false) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * e, (cuuint64_t)d1 * d0 * e};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1}, elem[3] = {1, 1, 1};
  CUresult r = enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   3, const_cast<void*>(t), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A tensor map over a bf16 tensor of `rank` (<= 5) dimensions, innermost
// first, with the given strides (bytes, dimensions 1 ..) and box; zeros out
// of bounds.
inline int bf16_map(CUtensorMap* map, const void* t, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle sw) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(t),
                   dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// SMs of the current device (the persistent grids' size), asked once.
inline int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

}  // namespace vmg
