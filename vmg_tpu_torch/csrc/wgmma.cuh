// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, both operands from shared
// memory through matrix descriptors, for every N the conv kernel takes (a
// multiple of 16 up to 128).  d: the warpgroup's 64 x N f32 accumulator
// tile, N / 2 registers a thread (wgmma's fragment layout: register
// 4j + 2h + e holds row 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4)
// + e); scale_d = 0 overwrites d instead of adding to it.  The PTX names
// every accumulator register, so the operand list %0 .. %(N/2 - 1) and its
// constraints are built 8 registers at a time, and one macro writes the
// instruction for each width.
#pragma once

#include <stdint.h>

namespace vmg {

#define VMG_WG_OPS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define VMG_WG_OPS16 VMG_WG_OPS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define VMG_WG_OPS24 VMG_WG_OPS16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define VMG_WG_OPS32 VMG_WG_OPS24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define VMG_WG_OPS40 VMG_WG_OPS32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define VMG_WG_OPS48 VMG_WG_OPS40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define VMG_WG_OPS56 VMG_WG_OPS48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define VMG_WG_OPS64 VMG_WG_OPS56 ", %56, %57, %58, %59, %60, %61, %62, %63"

#define VMG_WG_D(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VMG_WG_D8 VMG_WG_D(0)
#define VMG_WG_D16 VMG_WG_D8, VMG_WG_D(8)
#define VMG_WG_D24 VMG_WG_D16, VMG_WG_D(16)
#define VMG_WG_D32 VMG_WG_D24, VMG_WG_D(24)
#define VMG_WG_D40 VMG_WG_D32, VMG_WG_D(32)
#define VMG_WG_D48 VMG_WG_D40, VMG_WG_D(40)
#define VMG_WG_D56 VMG_WG_D48, VMG_WG_D(48)
#define VMG_WG_D64 VMG_WG_D56, VMG_WG_D(56)

template <int N> struct Wgmma;

// N, its R = N / 2 accumulator registers, and the operand numbers of the A
// and B descriptors and of scale_d, which follow them: R, R + 1, R + 2
#define VMG_WGMMA(N, R, A, B, P)                                                       \
  template <> struct Wgmma<N> {                                                        \
    static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da, uint64_t db, \
                                               int scale_d) {                          \
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #P ", 0;\n"                  \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"         \
                   VMG_WG_OPS##R "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"             \
                   : VMG_WG_D##R                                                       \
                   : "l"(da), "l"(db), "r"(scale_d));                                  \
    }                                                                                  \
  };

VMG_WGMMA(16, 8, 8, 9, 10)
VMG_WGMMA(32, 16, 16, 17, 18)
VMG_WGMMA(48, 24, 24, 25, 26)
VMG_WGMMA(64, 32, 32, 33, 34)
VMG_WGMMA(80, 40, 40, 41, 42)
VMG_WGMMA(96, 48, 48, 49, 50)
VMG_WGMMA(112, 56, 56, 57, 58)
VMG_WGMMA(128, 64, 64, 65, 66)

#undef VMG_WGMMA

}  // namespace vmg
