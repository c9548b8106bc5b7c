// Chained 3x3 convolutions: out = conv2(act(conv1(x) + b1)) + b2,
// optionally x + s * out, optionally with f32 per-frame sums of out; and
// the identity copy that stands in for the TPU's layout pin.
//
// Replaces the Pallas kernels vmg_tpu/ops/conv_chain.py `fused_conv_chain`
// (`_chain_kernel:104`) and `layout_pin` (`_identity_kernel:160`).
//
// Bound on H100: operations.  At C = 112 each pixel costs 2 x 9 C^2 MACs
// (two convs) against ~4 C bytes of bf16 traffic: 26.6 GFLOP for one
// 184x320 frame, 0.0269 ms at 989 TFLOP/s (bf16 tensor cores) against
// 0.008 ms of device-memory traffic.
//
// Numerics of the TPU kernel: conv1 accumulates in f32, adds the bias and
// applies the activation in f32 and rounds once to the dtype; conv1 values
// outside the image are ZEROS (conv2's SAME padding), not conv1 evaluated
// over the padding; conv2 accumulates in f32, adds its bias, rounds once;
// the residual is x + round(s * y) in the dtype's arithmetic; the sums are
// f32 sums of the rounded output over the real (H, W) extent.
//
// * bf16 (serving): two launches of one implicit-GEMM 3x3 conv kernel on
//   wgmma.  The first writes bf16(act(conv1(x) + b1)) into an (N, H, W, Cm)
//   scratch; the second reads it with SAME padding -- exactly the TPU
//   kernel's zeros outside the image -- and adds bias, residual and sums.
//   The TPU kernel fused the two to keep the intermediate out of HBM; here
//   one frame's intermediate (13.2 MB) stays in the 50 MB L2, and at 16
//   frames its round trip (0.126 ms) is small beside the 0.43 ms compute
//   bound, while a fused tile recomputes 20-27% of the MACs in its halo.
//   - Operands: the output tile is 4 rows x 64 columns (256 positions).
//     TMA stages its 6 x 66 input slab from a 4-D tensor map over the NHWC
//     tensor, one box of 8 channels per 8-channel chunk, starting at
//     (x0 - 1, y0 - 1): out-of-image (also negative) coordinates and the
//     channel padding arrive as zeros, with no per-element instruction.  In
//     shared memory a chunk holds the slab's positions 16 bytes apart, so
//     8 consecutive positions are one 128-byte wgmma core matrix (no
//     swizzle, no bank conflicts), and the A operand of tap (dy, dx) for
//     64 output columns is the same descriptor shifted by dy * 66 + dx
//     positions: nine accumulations over shifted views, no im2col.  B is
//     the tap's K x N weight matrix, packed once per parameter state in
//     the same core-matrix form (pack_conv_taps).  wgmma m64nNk16, N = the
//     padded output channels (<= 128), K = 16 per step: 112 channels are 7
//     steps, nothing padded to 128.  Where a tensor's rows are not 16-byte
//     multiples (C * 2 % 16 != 0), TMA cannot describe it, and the
//     producer warp stages that slab with plain loads into the same layout.
//   - Weights: the producer warpgroup's first warp streams the nine taps
//     (25 KB each at C = 112) through a 3-stage ring with cp.async.bulk on mbarriers; the
//     two consumer warpgroups (2 x 2 m64 sub-tiles, 112 f32 accumulators a
//     thread; setmaxnreg moves the producer warpgroup's registers to them)
//     run wgmma on the taps that have arrived and release a stage
//     when its products complete (wgmma.wait_group 1): no block-wide
//     barrier in the main loop.  256 positions a tile keep the nine taps'
//     re-reads from L2 at ~2 TB/s at half the bf16 peak.
//   - Persistent grid: one block per SM walks the tiles (230 for one
//     184x320 frame: two rounds on 132 SMs).  The next tile's slab loads
//     while this tile's epilogue runs.
//   - Epilogue: bias and activation in registers, the rounded tile staged
//     in shared memory (61 KB at C = 112, beside the slab and the ring;
//     where the whole tile does not fit, as at 128 channels, it is staged
//     in halves or quarters), then written -- and the residual read -- in
//     16-byte vectors along the tile's rows, which are contiguous in the
//     output (one element at a time where Cout % 8 != 0).  (Storing two
//     channels per 4-byte store straight from the accumulator layout, 8
//     rows per warp instruction, was the kernel's largest cost after the
//     products.)
//     Sums: each tile writes one f32 partial per channel, its rows added
//     in order, and a second pass adds the tiles' partials in a fixed tree
//     order -- deterministic, no atomics, independent of which block took
//     a tile.
// * f32 (parity runs): scalar FMA, one block per 8 x 8 output tile, the
//   12 x 12 slab and the 10 x 10 intermediate in shared memory, 16 x 16
//   register micro-tiles; unpadded weights.
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime's driver entry points

#include "common.cuh"
#include "wgmma.cuh"

namespace vmg {

constexpr int kMaxNT = 8;  // channels <= 128 in 16-channel tiles

__device__ __forceinline__ float chain_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v >= 0.f ? v : 0.1f * v;
  return v;
}
// the residual in the dtype's arithmetic: round(x + round(s * y))
__device__ __forceinline__ bf16 chain_residual(bf16 x, bf16 y, float s) {
  return __float2bfloat16_rn(__bfloat162float(x) + rnd<bf16>(s * __bfloat162float(y)));
}

// ---- bf16: implicit-GEMM 3x3 conv on wgmma ---------------------------------

constexpr int kTR = 4, kTW = 64;                 // output tile: rows x columns
constexpr int kSR = kTR + 2, kSW = kTW + 2;      // input slab
constexpr int kSP = (kSR * kSW + 7) / 8 * 8;     // slab positions per chunk (a 128-byte multiple)
constexpr int kStages = 3;                       // weight ring
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kConvThreads = kConsumers + 128;   // + the producer warpgroup
constexpr unsigned kBoxBytes = 8 * kSW * kSR * 2;  // one chunk's TMA box

__host__ __device__ inline size_t conv_slab_bytes(int Kp) { return (size_t)(Kp / 8) * kSP * 16; }
__host__ __device__ inline size_t conv_stage_bytes(int Kp, int Np) { return (size_t)Kp * Np * 2; }
// slab, ring, 8 mbarriers, alignment slack
__host__ __device__ inline size_t conv_smem(int Kp, int Np) {
  return conv_slab_bytes(Kp) + kStages * conv_stage_bytes(Kp, Np) + 128 + 128;
}
// The output staged for 16-byte stores, `subs` of the tile's kTR 64-position
// rows at a time; positions 2 Np + 16 bytes apart (the 8 rows a warp writes
// at once fall on distinct banks).
__host__ __device__ inline int conv_out_pitch(int Np) { return 2 * Np + 16; }
__host__ __device__ inline size_t conv_out_bytes(int Np, int subs) {
  return (size_t)subs * kTW * conv_out_pitch(Np);
}

struct ConvArgs {
  const bf16* src;      // (N, H, W, Cin): read by the producer warp when use_tma == 0
  const bf16* w;        // (9, Kp / 8, Np, 8): each tap's B image
  const float* bias;    // (Np,)
  bf16* out;            // (N, H, W, Cout)
  const bf16* res;      // (N, H, W, Cout) or null: out = res + round(s * y)
  float* partial;       // (N, tiles, Cout) or null
  int H, W, Cin, Kp, Cout, act, use_tma, tiles_w, tiles, total;
  int subs;  // tile rows staged at once by the epilogue: 4, 2 or 1
  float res_scale;
};

__device__ __forceinline__ unsigned su32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(su32(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(su32(b)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait of more
// than ~2^35 cycles (a lost arrival) traps instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(su32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(su32(dst)), "l"(src), "r"(bytes), "r"(su32(b))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(su32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(su32(b))
      : "memory");
}

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes (128 contiguous bytes); lbo: bytes between the two core matrices of a
// k16 step, sbo: bytes between 8-row groups.
__device__ __forceinline__ uint64_t mat_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
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
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// One 3x3 conv, SAME padding, Np output channels (the template), f32
// accumulation.  Epilogue: out = res ? round(res + round(s * round(y))) :
// round(act(y)) with y = acc + bias; channels >= Cout are not stored.
// Grid: persistent, tile = blockIdx.x + i * gridDim.x.
template <int Np>
__global__ void __launch_bounds__(kConvThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap src_map, const ConvArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  unsigned char* slab = base;
  const unsigned stage_bytes = (unsigned)conv_stage_bytes(a.Kp, Np);
  unsigned char* ring = slab + conv_slab_bytes(a.Kp);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)kStages * stage_bytes);
  unsigned char* otile = reinterpret_cast<unsigned char*>(bars) + 128;  // staged output
  uint64_t *slab_full = bars, *slab_empty = bars + 1, *wfull = bars + 2,
           *wempty = bars + 2 + kStages;
  const int KC8 = a.Kp / 8;

  if (threadIdx.x == 0) {
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, 2);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: its first warp loads the slabs and the
    // weight ring; the group gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    for (int it = 0, tile = blockIdx.x; tile < a.total; ++it, tile += gridDim.x) {
      const int n = tile / a.tiles, t = tile % a.tiles;
      const int y0 = (t / a.tiles_w) * kTR, x0 = (t % a.tiles_w) * kTW;
      for (int tap = 0; tap < 9; ++tap) {
        if (tap == kStages - 1) {  // the slab, after the tile's first taps
          mbar_wait(slab_empty, (it & 1) ^ 1);
          if (a.use_tma) {
            if (lane == 0) {
              mbar_expect(slab_full, KC8 * kBoxBytes);
              for (int c = 0; c < KC8; ++c)
                tma_load_4d(slab + (size_t)c * kSP * 16, &src_map, 8 * c, x0 - 1, y0 - 1, n,
                            slab_full);
            }
          } else {  // rows that TMA cannot describe: plain loads, zeros outside
            for (int e = lane; e < KC8 * kSR * kSW; e += 32) {
              const int c = e / (kSR * kSW), p = e % (kSR * kSW);
              const int gy = y0 - 1 + p / kSW, gx = x0 - 1 + p % kSW;
              uint4 v = make_uint4(0u, 0u, 0u, 0u);
              if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
                const bf16* s = a.src + ((size_t)(n * a.H + gy) * a.W + gx) * a.Cin;
                bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
                for (int i = 0; i < 8; ++i)
                  if (8 * c + i < a.Cin) h[i] = s[8 * c + i];
              }
              *reinterpret_cast<uint4*>(slab + ((size_t)c * kSP + p) * 16) = v;
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
            if (lane == 0) mbar_arrive(slab_full);
          }
        }
        const int q = it * 9 + tap, st = q % kStages;
        mbar_wait(&wempty[st], ((q / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect(&wfull[st], stage_bytes);
          bulk_load(ring + (size_t)st * stage_bytes, a.w + (size_t)tap * a.Kp * Np, stage_bytes,
                    &wfull[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g computes output rows 2g, 2g + 1 ------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const unsigned slab_a = su32(slab), ring_a = su32(ring);
  // this thread's channels 8j + 2 (lane % 4) + e: their biases, held for
  // the whole walk
  float bias[Np / 4];
#pragma unroll
  for (int j = 0; j < Np / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[2 * j + e] = a.bias[8 * j + 2 * (lane & 3) + e];
  float acc[2][Np / 2];
  for (int it = 0, tile = blockIdx.x; tile < a.total; ++it, tile += gridDim.x) {
    const int n = tile / a.tiles, t = tile % a.tiles;
    const int y0 = (t / a.tiles_w) * kTR, x0 = (t % a.tiles_w) * kTW;
    for (int tap = 0; tap < 9; ++tap) {
      const int q = it * 9 + tap, st = q % kStages;
      mbar_wait(&wfull[st], (q / kStages) & 1);
      if (tap == 0) mbar_wait(slab_full, it & 1);
      wg_fence();
      pin_regs(acc[0]);
      pin_regs(acc[1]);
      const unsigned b0 = ring_a + st * stage_bytes;
      const unsigned a0 = slab_a + ((2 * g + tap / 3) * kSW + tap % 3) * 16;
      for (int kc = 0; kc < a.Kp / 16; ++kc) {
        const uint64_t db = mat_desc(b0 + kc * 2 * Np * 16, Np * 16, 128);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          Wgmma<Np>::mma(acc[s], mat_desc(a0 + (kc * 2 * kSP + s * kSW) * 16, kSP * 16, 128),
                         db, tap | kc);
      }
      wg_commit();
      pin_regs(acc[0]);
      pin_regs(acc[1]);
      if (tap > 0) {
        wg_wait<1>();  // the previous tap's products are done with its stage
        if ((threadIdx.x & 127) == 0) mbar_arrive(&wempty[(q - 1) % kStages]);
      }
    }
    wg_wait<0>();
    pin_regs(acc[0]);
    pin_regs(acc[1]);
    if ((threadIdx.x & 127) == 0) {
      mbar_arrive(&wempty[(it * 9 + 8) % kStages]);
      mbar_arrive(slab_empty);  // the producer loads the next slab during the epilogue
    }

    // epilogue: register 4j + 2h + e is (row 16 wq + lane / 4 + 8h, channel
    // 8j + 2 (lane % 4) + e) of sub-tile s, which is row u = 2g + s of the
    // tile.  The rounded rows go into shared memory, a.subs of them at a
    // time (row u's position r at u % a.subs * 64 + r), then out along the
    // tile's rows, which are contiguous in the output, with the residual
    // read beside them; the sums from the staged final values, one channel
    // a thread, positions in order.
    const int pitch = conv_out_pitch(Np), rows = a.subs * kTW;
    float sum = 0.f;
    for (int u0 = 0; u0 < kTR; u0 += a.subs) {
      consumers_sync();  // the previous rows' readers are done with them
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int u = 2 * g + s - u0;
        if (u < 0 || u >= a.subs) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned char* row = otile + (size_t)(kTW * u + 16 * wq + lane / 4 + 8 * h) * pitch;
#pragma unroll
          for (int j = 0; j < Np / 8; ++j) {
            const int c = 8 * j + 2 * (lane & 3);
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float y = acc[s][4 * j + 2 * h + e] + bias[2 * j + e];
              v[e] = a.res != nullptr ? rnd<bf16>(y) : rnd<bf16>(chain_act(y, a.act));
            }
            *reinterpret_cast<__nv_bfloat162*>(row + 2 * c) = __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      }
      consumers_sync();
      // out = round(res + round(s * y)) where there is a residual; 16-byte
      // vectors where Cout % 8 == 0, else one element at a time
      const int cv = a.Cout % 8 == 0 ? a.Cout / 8 : a.Cout, width = a.Cout % 8 == 0 ? 8 : 1;
      for (int e = threadIdx.x; e < rows * cv; e += kConsumers) {
        const int r = e / cv, q = e % cv;
        const int gy = y0 + u0 + r / kTW, gx = x0 + r % kTW;
        if (gy >= a.H || gx >= a.W) continue;
        bf16* sv = reinterpret_cast<bf16*>(otile + (size_t)r * pitch) + width * q;
        const size_t pix = ((size_t)(n * a.H + gy) * a.W + gx) * a.Cout + width * q;
        if (width == 8) {
          uint4 v = *reinterpret_cast<const uint4*>(sv);
          if (a.res != nullptr) {
            const uint4 xv = __ldg(reinterpret_cast<const uint4*>(a.res + pix));
            const bf16* xh = reinterpret_cast<const bf16*>(&xv);
            bf16* vh = reinterpret_cast<bf16*>(&v);
#pragma unroll
            for (int i = 0; i < 8; ++i) vh[i] = chain_residual(xh[i], vh[i], a.res_scale);
            if (a.partial != nullptr) *reinterpret_cast<uint4*>(sv) = v;
          }
          *reinterpret_cast<uint4*>(a.out + pix) = v;
        } else {
          bf16 v = *sv;
          if (a.res != nullptr) {
            v = chain_residual(a.res[pix], v, a.res_scale);
            if (a.partial != nullptr) *sv = v;
          }
          a.out[pix] = v;
        }
      }
      if (a.partial != nullptr) {
        consumers_sync();
        const int cols = min(kTW, a.W - x0);
        if (threadIdx.x < a.Cout)
          for (int k = 0; k < a.subs && y0 + u0 + k < a.H; ++k) {
            const unsigned char* col = otile + (size_t)k * kTW * pitch + 2 * threadIdx.x;
#pragma unroll 8
            for (int r = 0; r < kTW; ++r)
              if (r < cols) sum += __bfloat162float(*reinterpret_cast<const bf16*>(col + (size_t)r * pitch));
          }
      }
    }
    if (a.partial != nullptr && threadIdx.x < a.Cout)
      a.partial[((size_t)n * a.tiles + t) * a.Cout + threadIdx.x] = sum;
  }
}

// ---- f32: scalar FMA ------------------------------------------------------

constexpr int kFR = 8, kFTW = 8;                 // output tile
constexpr int kFSH = kFR + 4, kFSW = kFTW + 4;   // slab
constexpr int kFYH = kFR + 2, kFYW = kFTW + 2;   // conv1 output

__host__ __device__ inline size_t chain_smem_f32(int Cin, int Cm, int Cout) {
  return sizeof(float) * ((size_t)kFSH * kFSW * Cin + (size_t)kFYH * kFYW * Cm + 16 * Cout);
}

__global__ void __launch_bounds__(kThreads)
conv_chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      float* __restrict__ partial, int H, int W, int Cin, int Cm,
                      int Cout, int act, int has_res, float res_scale, int tiles_w) {
  extern __shared__ float fsm[];
  float* xs = fsm;                                // kFSH x kFSW x Cin
  float* ys = xs + kFSH * kFSW * Cin;             // kFYH x kFYW x Cm
  float* tps = ys + kFYH * kFYW * Cm;             // 16 x Cout sums
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / tiles_w) * kFR, x0 = (tile % tiles_w) * kFTW;

  for (int e = threadIdx.x; e < kFSH * kFSW * Cin; e += kThreads) {
    const int ci = e % Cin, p = e / Cin;
    const int gy = y0 + p / kFSW - 2, gx = x0 + p % kFSW - 2;
    xs[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                ? x[((size_t)(n * H + gy) * W + gx) * Cin + ci]
                : 0.f;
  }
  __syncthreads();

  // conv1: positions p = p0 + ty + 16 i of the kFYH x kFYW grid, channels
  // tx + 16 j
  for (int p0 = 0; p0 < kFYH * kFYW; p0 += 64) {
    float acc[4][kMaxNT];
    int pr[4], pc[4];
    bool pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty + 16 * i;
      pv[i] = p < kFYH * kFYW;
      pr[i] = pv[i] ? p / kFYW : 0;
      pc[i] = pv[i] ? p % kFYW : 0;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) acc[i][j] = 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int ci = 0; ci < Cin; ++ci) {
        float wv[kMaxNT];
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          const int ch = tx + 16 * j;
          wv[j] = ch < Cm ? w1[((size_t)tap * Cin + ci) * Cm + ch] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[((pr[i] + dy) * kFSW + pc[i] + dx) * Cin + ci];
#pragma unroll
          for (int j = 0; j < kMaxNT; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!pv[i]) continue;
      const int gy = y0 + pr[i] - 1, gx = x0 + pc[i] - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int ch = tx + 16 * j;
        if (ch < Cm)
          ys[(pr[i] * kFYW + pc[i]) * Cm + ch] = ok ? chain_act(acc[i][j] + b1[ch], act) : 0.f;
      }
    }
  }
  __syncthreads();

  // conv2: positions ty + 16 i of the kFR x kFTW tile
  float acc[4][kMaxNT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) acc[i][j] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    for (int ci = 0; ci < Cm; ++ci) {
      float wv[kMaxNT];
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int ch = tx + 16 * j;
        wv[j] = ch < Cout ? w2[((size_t)tap * Cm + ci) * Cout + ch] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        const float yv = ys[((p / kFTW + dy) * kFYW + p % kFTW + dx) * Cm + ci];
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) acc[i][j] = fmaf(yv, wv[j], acc[i][j]);
      }
    }
  }
  float ps[kMaxNT];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) ps[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    const int gy = y0 + p / kFTW, gx = x0 + p % kFTW;
    if (gy >= H || gx >= W) continue;
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      const int co = tx + 16 * j;
      if (co < Cout) {
        const size_t idx = ((size_t)(n * H + gy) * W + gx) * Cout + co;
        float v = acc[i][j] + b2[co];
        if (has_res) v = x[idx] + res_scale * v;
        out[idx] = v;
        ps[j] += v;
      }
    }
  }
  if (partial != nullptr) {
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j)
      if (tx + 16 * j < Cout) tps[ty * Cout + tx + 16 * j] = ps[j];
    __syncthreads();
    for (int co = threadIdx.x; co < Cout; co += kThreads) {
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += tps[t * Cout + co];
      partial[((size_t)n * gridDim.x + tile) * Cout + co] = s;
    }
  }
}

// psum[n, c] = the sum over tiles s of partial[n, s, c], in a fixed order:
// 32 channels per block (lanes, coalesced), warp w adds tiles w, w + 32,
// ... in turn, then the 32 warps' sums combine pairwise.  Deterministic,
// and no sequential chain is longer than S / 32 (one chain over the 920
// f32 tiles of a 184 x 320 frame lost ~1e-6 of the sum).
constexpr int kPsumWarps = 32;

__global__ void __launch_bounds__(32 * kPsumWarps)
chain_psum_kernel(const float* __restrict__ partial, float* __restrict__ psum, int C,
                  int S) {
  __shared__ float sm[kPsumWarps][33];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int n = blockIdx.y, c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < C)
    for (int k = wy; k < S; k += kPsumWarps) s += partial[((size_t)n * S + k) * C + c];
  sm[wy][lane] = s;
  __syncthreads();
  for (int half = kPsumWarps / 2; half > 0; half >>= 1) {
    if (wy < half) sm[wy][lane] += sm[wy + half][lane];
    __syncthreads();
  }
  if (wy == 0 && c < C) psum[(size_t)n * C + c] = sm[0][lane];
}

inline int chain_tiles(int H, int W, int dtype, int* tiles_w) {
  const int R = dtype == 1 ? kTR : kFR, TW = dtype == 1 ? kTW : kFTW;
  *tiles_w = (W + TW - 1) / TW;
  return ((H + R - 1) / R) * *tiles_w;
}

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

// The slab map over an (N, H, W, C) bf16 tensor: boxes of 8 channels x kSW
// columns x kSR rows of one frame, zeros out of bounds.
inline int slab_map(CUtensorMap* map, const void* t, int N, int H, int W, int C) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {8, kSW, kSR, 1}, elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static bool smem_limit_set[128 / 16 + 1];

// SMs of the current device (the persistent grids' size), asked once.
inline int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int Np>
int launch_conv(const bf16* src, ConvArgs a, int N, cudaStream_t s) {
  CUtensorMap map = {};
  if (a.use_tma) {
    const int e = slab_map(&map, src, N, a.H, a.W, a.Cin);
    if (e) return e;
  }
  // the epilogue stages the whole tile where it fits beside the slab and
  // the ring, else half or a quarter of it at a time (at Kp = Np = 128)
  a.subs = kTR;
  while (a.subs > 1 && conv_smem(a.Kp, Np) + conv_out_bytes(Np, a.subs) > kMaxSmem) a.subs /= 2;
  const size_t smem = conv_smem(a.Kp, Np) + conv_out_bytes(Np, a.subs);
  if (!smem_limit_set[Np / 16]) {  // the largest size, once per instantiation
    const int e = set_smem(conv3x3_wgmma_kernel<Np>, kMaxSmem);
    if (e) return e;
    smem_limit_set[Np / 16] = true;
  }
  const int sms = sm_count(), grid = a.total < sms ? a.total : sms;
  conv3x3_wgmma_kernel<Np><<<grid, kConvThreads, smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

inline int conv_bf16(const bf16* src, ConvArgs a, int Np, int N, cudaStream_t s) {
  switch (Np) {
    case 16: return launch_conv<16>(src, a, N, s);
    case 32: return launch_conv<32>(src, a, N, s);
    case 48: return launch_conv<48>(src, a, N, s);
    case 64: return launch_conv<64>(src, a, N, s);
    case 80: return launch_conv<80>(src, a, N, s);
    case 96: return launch_conv<96>(src, a, N, s);
    case 112: return launch_conv<112>(src, a, N, s);
    case 128: return launch_conv<128>(src, a, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- layout pin: identity copy ---------------------------------------------
//
// Bound: device memory (one read, one write).  A grid-stride copy over 4
// blocks per SM with kPinVec independent 16-byte streaming loads in flight
// per thread (a bulk-copy ring through shared memory ran slower at the
// trajectory shape on the H100).

constexpr int kPinVec = 4;
constexpr int kPinThreads = 256;

__global__ void __launch_bounds__(kPinThreads)
copy_vec_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * kPinThreads;
  long long i = (long long)blockIdx.x * kPinThreads + threadIdx.x;
  for (; i + (kPinVec - 1) * stride < n; i += kPinVec * stride) {
    uint4 v[kPinVec];
#pragma unroll
    for (int k = 0; k < kPinVec; ++k) v[k] = __ldcs(src + i + k * stride);
#pragma unroll
    for (int k = 0; k < kPinVec; ++k) __stcs(dst + i + k * stride, v[k]);
  }
  for (; i < n; i += stride) __stcs(dst + i, __ldcs(src + i));
}

__global__ void copy1_kernel(const unsigned char* __restrict__ src,
                             unsigned char* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

}  // namespace vmg

// Output tiles per frame of the kernel for this dtype: the rows of the
// (N, tiles, Cout) f32 scratch the sums need.
extern "C" int vmg_conv_chain_tiles(int H, int W, int dtype) {
  int tw;
  return vmg::chain_tiles(H, W, dtype, &tw);
}

// x: (N, H, W, Cin).  bf16: w1 (9, Cinp / 8, Cm, 8) and w2 (9, Cm / 8,
// Coutp, 8), the taps' B images (pack_conv_taps); Cinp, Cm, Coutp the
// multiples of 16 above Cin, the intermediate and Cout (<= 128), zeros in
// the padding; mid: (N, H, W, Cm) bf16 scratch for conv1's output.  f32:
// w1 (9, Cin, Cm), w2 (9, Cm, Cout), Cinp == Cin, Coutp == Cout, mid null.
// b1: (Cm,) f32, b2: (Coutp,) f32; out: (N, H, W, Cout).  act: 0 none,
// 1 relu, 2 lrelu(0.1).  has_res: out = x + res_scale * y (Cout == Cin).
// partial (N, vmg_conv_chain_tiles(H, W, dtype), Cout) f32 scratch and psum
// (N, Cout) f32: both null, or both set for the per-frame sums.
extern "C" int vmg_conv_chain(const void* x, const void* w1, const float* b1,
                              const void* w2, const float* b2, void* out, void* mid,
                              float* partial, float* psum, int N, int H, int W,
                              int Cin, int Cinp, int Cm, int Cout, int Coutp, int act,
                              int has_res, float res_scale, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535 || act < 0 || act > 2 ||
      (has_res && Cout != Cin) || Cout > Coutp || (partial == nullptr) != (psum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int tiles_w;
  const int S = vmg::chain_tiles(H, W, dtype, &tiles_w);
  if (dtype == 1) {
    if (Cinp % 16 || Cm % 16 || Coutp % 16 || Cinp < Cin || Cinp > 128 || Cm > 128 ||
        Coutp > 128 || mid == nullptr || (uintptr_t)x % 16 || (uintptr_t)mid % 16 ||
        (uintptr_t)w1 % 16 || (uintptr_t)w2 % 16 || (long long)N * S > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    typedef vmg::bf16 bf;
    vmg::ConvArgs a = {};
    a.H = H, a.W = W, a.tiles_w = tiles_w, a.tiles = S, a.total = N * S;
    // conv1: x -> mid = round(act(conv1(x) + b1)), all Cm channels
    a.src = (const bf*)x, a.w = (const bf*)w1, a.bias = b1, a.out = (bf*)mid;
    a.Cin = Cin, a.Kp = Cinp, a.Cout = Cm, a.act = act, a.use_tma = Cin % 8 == 0;
    int e = vmg::conv_bf16((const bf*)x, a, Cm, N, s);
    if (e) return e;
    // conv2: mid -> out = conv2(mid) + b2 [x + s * .], sums
    a.src = (const bf*)mid, a.w = (const bf*)w2, a.bias = b2, a.out = (bf*)out;
    a.res = has_res ? (const bf*)x : nullptr, a.res_scale = res_scale, a.partial = partial;
    a.Cin = Cm, a.Kp = Cm, a.Cout = Cout, a.act = 0, a.use_tma = 1;
    e = vmg::conv_bf16((const bf*)mid, a, Coutp, N, s);
    if (e) return e;
  } else if (dtype == 0) {
    if (Cinp != Cin || Coutp != Cout || Cin > 128 || Cm > 128 || Cout > 128)
      return (int)cudaErrorInvalidValue;
    const size_t smem = vmg::chain_smem_f32(Cin, Cm, Cout);
    int e = vmg::set_smem(vmg::conv_chain_f32_kernel, smem);
    if (e) return e;
    vmg::conv_chain_f32_kernel<<<dim3(S, N), vmg::kThreads, smem, s>>>(
        (const float*)x, (const float*)w1, b1, (const float*)w2, b2, (float*)out,
        partial, H, W, Cin, Cm, Cout, act, has_res, res_scale, tiles_w);
    e = (int)cudaGetLastError();
    if (e) return e;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (partial == nullptr) return 0;
  vmg::chain_psum_kernel<<<dim3((Cout + 31) / 32, N), 32 * vmg::kPsumWarps, 0, s>>>(
      partial, psum, Cout, S);
  return (int)cudaGetLastError();
}

// out = a fresh copy of the nbytes at x (16-byte vectors where both are
// aligned and nbytes allows, else bytes).
extern "C" int vmg_layout_pin(const void* x, void* out, long long nbytes, void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 && nbytes % 16 == 0) {
    const long long n = nbytes / 16;
    long long blocks = (n + vmg::kPinThreads - 1) / vmg::kPinThreads;
    if (blocks > 4LL * vmg::sm_count()) blocks = 4LL * vmg::sm_count();
    vmg::copy_vec_kernel<<<(unsigned)blocks, vmg::kPinThreads, 0, s>>>(
        (const uint4*)x, (uint4*)out, n);
  } else {
    vmg::copy1_kernel<<<(unsigned)((nbytes + 255) / 256), 256, 0, s>>>(
        (const unsigned char*)x, (unsigned char*)out, nbytes);
  }
  return (int)cudaGetLastError();
}
