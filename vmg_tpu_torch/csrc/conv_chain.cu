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
// * f32 (the evaluation command's dtype, in the kernel forms): the same two
//   launches of an implicit-GEMM conv on wgmma with every product as three
//   TF32 products (3xTF32), 2 x 64 tiles, the taps streamed in k8 steps
//   (notes at conv3x3_tf32_kernel).  Bound: 3 x 26.6 GFLOP at 494.7 TFLOP/s,
//   0.161 ms for one 184x320 frame.
#include "common.cuh"
#include "wgmma.cuh"

namespace vmg {

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

// ---- f32: implicit-GEMM 3x3 conv on wgmma, 3xTF32 ---------------------------
//
// The bf16 kernel's two launches, walk and producer, on f32 operands; every
// product as three TF32 products (a_hi b_hi + a_hi b_lo + a_lo b_hi,
// wgmma.cuh tf32_split; one TF32 product keeps ~3 digits and misses the f32
// tolerance).  What changes with f32:
// - Shared memory: an f32 slab of the bf16 tile (6 x 66 positions x 112
//   channels) is 177 KB and one tap's hi and lo images 100 KB, so the tile
//   is 2 rows x 64 columns (two m64 sub-tiles, one a consumer warpgroup), its
//   slab 4 x 66 positions in 8-channel boxes by TMA (32 bytes a position: a
//   warp's fragment reads cover 256 contiguous bytes, no bank conflict), and
//   the weights stream as ring stages of kcs k8 steps (across taps) rather
//   than whole taps: 118 KB of slab and 3 x 28 KB of ring at C = 112
//   (chain_tf32_plan in ops/conv_chain.py picks kcs and the stages).
// - Operands: TF32 wgmma reads B K-major only, so each k8 step of a tap is a
//   hi and a lo B image (pack_conv_taps), rows in the order 0, 2, 4, 6, 1,
//   3, 5, 7; A comes from registers: each thread reads its fragment pair
//   (channels 2 (lane % 4) and + 1 of the step's box) for rows r and r + 8
//   from the raw slab, shifted by dy 66 + dx positions for tap (dy, dx),
//   and splits them in registers.  Commit groups of KB = 2 steps (1 at 128
//   outputs) alternate between two register sets; a group's fragments are
//   read while the previous group's products run.
// - Accumulation: each group's products go into a fresh accumulator, added
//   into the tile's sum with f32 adds (round to nearest).  The tensor cores
//   truncate as they accumulate, so one 378-product chain (C = 112) drifts
//   toward zero by ~1e-5 of its value -- a frame's sums then miss the plain
//   version's by ~1e-5 of their terms; a 3- or 6-product chain does not.
// - Epilogue: from registers, bias and activation (conv1) or bias and
//   residual (conv2) in f32, stored as float2 where rows allow; the sums per
//   tile add each channel's 16 rows a warp by a fixed butterfly, then the 8
//   warps in order through shared memory (deterministic, no atomics).
// The scratch between the launches is f32 (N, H, W, Np1) and no longer sits
// in L2 at 16 frames (422 MB each way at RCAB's shape, ~0.25 ms against a
// 3xTF32 bound of 2.58 ms).  The scalar kernel this replaced (one block per
// 8 x 8 tile, both convs as FMAs, the weights read from global memory for
// every tap and channel) ran at 0.075 of its f32 bound and lost 5.3x to the
// module form's cuDNN convolutions (PERF.md).  ptxas: 168 registers at every
// width (the launch's share; setmaxnreg gives the consumers 224), no spill,
// C7519 lines expected; a spill is a regression.
constexpr int kFR = 2;                           // f32 output tile rows (one a warpgroup)
constexpr int kFSP = (kFR + 2) * kSW;            // f32 slab positions per 8-channel box (264)
constexpr unsigned kFBoxBytes = kFSP * 32;       // one box: 8448 bytes
// k8 steps a commit group: 2, and 1 at 128 outputs, where the group's
// products, the tile's sum and two fragment sets must fit the registers
__host__ __device__ constexpr int conv_tf32_kgroup(int Np) { return Np <= 112 ? 2 : 1; }
constexpr int kFMaxStages = 6;

// slab, ring, barriers, the per-warp channel sums (chain_tf32_smem in
// ops/conv_chain.py)
__host__ __device__ inline size_t conv_tf32_smem(int KS, int Np, int kcs, int nst) {
  return 128 + (size_t)KS * kFBoxBytes + (size_t)nst * kcs * 64 * Np + 128 + 8 * Np * 4;
}

struct ConvTfArgs {
  const float* src;     // (N, H, W, Cs): read by the producer warp when use_tma == 0
  const float* w;       // 9 KS k8 steps (tap-major), each its hi then its lo B image
  const float* bias;    // (Np,)
  float* out;           // (N, H, W, Cout)
  const float* res;     // (N, H, W, Cout) or null: out = res + s * y
  float* partial;       // (N, tiles, Cout) or null
  int H, W, Cs, KS, Cout, act, use_tma, tiles_w, tiles, total, kcs, nst;
  float res_scale;
};

// One 3x3 conv, SAME padding, f32, Np output channels (the template).
// Epilogue: out = res ? res + s y : act(y), y = acc + bias; channels >=
// Cout are not stored.  Grid: persistent, tile = blockIdx.x + i gridDim.x.
template <int Np>
__global__ void __launch_bounds__(kConvThreads, 1)
conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap src_map, const ConvTfArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  unsigned char* slab = base;
  const unsigned stage_bytes = (unsigned)a.kcs * 64 * Np;
  unsigned char* ring = slab + (size_t)a.KS * kFBoxBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)a.nst * stage_bytes);
  float* sums = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bars) + 128);
  uint64_t *slab_full = bars, *slab_empty = bars + 1, *wfull = bars + 2,
           *wempty = bars + 2 + kFMaxStages;
  const int nsteps = 9 * a.KS, nstg = (nsteps + a.kcs - 1) / a.kcs;

  if (threadIdx.x == 0) {
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, 2);
    for (int s = 0; s < a.nst; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: its first warp loads the slabs and the
    // weight ring; the group gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    // the tile's slab goes after its first `lead` weight stages, which the
    // ring takes while the consumers finish the previous tile
    const int lead = min(a.nst - 1, nstg);
    RingPos q;
    for (int it = 0, tile = blockIdx.x; tile < a.total; ++it, tile += gridDim.x) {
      const int n = tile / a.tiles, t = tile % a.tiles;
      const int y0 = (t / a.tiles_w) * kFR, x0 = (t % a.tiles_w) * kTW;
      for (int s = 0; s <= nstg; ++s) {
        if (s == lead) {
          mbar_wait(slab_empty, (it & 1) ^ 1);
          if (a.use_tma) {
            if (lane == 0) {
              mbar_expect(slab_full, a.KS * kFBoxBytes);
              for (int c = 0; c < a.KS; ++c)
                tma_load_4d(slab + (size_t)c * kFBoxBytes, &src_map, 8 * c, x0 - 1, y0 - 1, n,
                            slab_full);
            }
          } else {  // rows that TMA cannot describe: plain loads, zeros outside
            for (int e = lane; e < a.KS * kFSP; e += 32) {
              const int c = e / kFSP, p = e % kFSP;
              const int gy = y0 - 1 + p / kSW, gx = x0 - 1 + p % kSW;
              float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
              if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
                const float* sp = a.src + ((size_t)(n * a.H + gy) * a.W + gx) * a.Cs;
#pragma unroll
                for (int i = 0; i < 8; ++i)
                  if (8 * c + i < a.Cs) v[i] = sp[8 * c + i];
              }
              float4* d = reinterpret_cast<float4*>(slab + ((size_t)c * kFSP + p) * 32);
              d[0] = make_float4(v[0], v[1], v[2], v[3]);
              d[1] = make_float4(v[4], v[5], v[6], v[7]);
            }
            fence_async_shared();
            __syncwarp();
            if (lane == 0) mbar_arrive(slab_full);
          }
        }
        if (s == nstg) break;
        const int steps = min(a.kcs, nsteps - s * a.kcs);
        mbar_wait(&wempty[q.i], q.ph ^ 1);
        if (lane == 0) {
          mbar_expect(&wfull[q.i], (unsigned)steps * 64 * Np);
          bulk_load(ring + (size_t)q.i * stage_bytes, a.w + (size_t)s * a.kcs * 16 * Np,
                    (unsigned)steps * 64 * Np, &wfull[q.i]);
        }
        q.next(a.nst);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g computes output row y0 + g --------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  constexpr int KB = conv_tf32_kgroup(Np);
  const int g = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t4 = lane & 3, r = 16 * wq + (lane >> 2);  // fragment column pair, row
  const bool wg_leader = (threadIdx.x & 127) == 0;
  const unsigned ring_a = su32(ring);
  float acc[Np / 2], part[Np / 2];  // the tile's sum (f32 adds); a group's products
  uint32_t xh0[KB][4], xl0[KB][4], xh1[KB][4], xl1[KB][4];
  RingPos q;
  int pend = -1;  // the ring slot of the last issued products, not yet released
  // the products issued before this point are done: add them into acc, and
  // release their slot unless the next group reads it too
  auto drain = [&](int slot) {
    wg_wait<0>();
    pin_regs(part);
#pragma unroll
    for (int i = 0; i < Np / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    if (pend >= 0 && pend != slot && wg_leader) mbar_arrive(&wempty[pend]);
    pend = slot;
  };
  for (int it = 0, tile = blockIdx.x; tile < a.total; ++it, tile += gridDim.x) {
    const int n = tile / a.tiles, t = tile % a.tiles;
    const int y0 = (t / a.tiles_w) * kFR, x0 = (t % a.tiles_w) * kTW;
#pragma unroll
    for (int i = 0; i < Np / 2; ++i) acc[i] = part[i] = 0.f;
    mbar_wait(slab_full, it & 1);
    // this thread's row r of sub-tile g at tap (0, 0), its column pair
    const float* xs = reinterpret_cast<const float*>(slab) + (size_t)(g * kSW + r) * 8 + 2 * t4;
    // k8 steps j0 .. j0 + KB - 1 (those below nsteps): step j is tap j / KS,
    // slab box j % KS; a stage holds a whole number of groups.  The
    // fragments are read while the previous group's products run; each
    // group's products go into a fresh `part`, added into acc once done.
    auto group = [&](int j0, uint32_t(&xh)[KB][4], uint32_t(&xl)[KB][4]) {
      const int js = j0 % a.kcs;
      if (js == 0) {
        if (j0 > 0) q.next(a.nst);
        mbar_wait(&wfull[q.i], q.ph);
      }
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int j = j0 + u;
        if (j >= nsteps) break;
        const int tap = j / a.KS, kc = j - tap * a.KS, dy = tap / 3, dx = tap - 3 * dy;
        const float* src = xs + ((size_t)kc * kFSP + dy * kSW + dx) * 8;
        const float2 v0 = *reinterpret_cast<const float2*>(src);
        const float2 v1 = *reinterpret_cast<const float2*>(src + 64);  // row r + 8
        tf32_split(v0.x, xh[u][0], xl[u][0]);
        tf32_split(v1.x, xh[u][1], xl[u][1]);
        tf32_split(v0.y, xh[u][2], xl[u][2]);
        tf32_split(v1.y, xh[u][3], xl[u][3]);
      }
      drain(q.i);
      wg_fence();
      pin_regs(part);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int j = j0 + u;
        if (j >= nsteps) break;
        const unsigned bh = ring_a + q.i * stage_bytes + (js + u) * 64 * Np;
        const uint64_t dh = mat_desc(bh, Np * 16, 128), dl = mat_desc(bh + 32 * Np, Np * 16, 128);
        WgmmaTF32<Np>::mma(part, xh[u], dh, u != 0);
        WgmmaTF32<Np>::mma(part, xh[u], dl, 1);
        WgmmaTF32<Np>::mma(part, xl[u], dh, 1);
      }
      wg_commit();
      pin_regs(part);
    };
    for (int j = 0; j < nsteps; j += 2 * KB) {
      group(j, xh0, xl0);
      if (j + KB < nsteps) group(j + KB, xh1, xl1);
    }
    q.next(a.nst);
    drain(-1);  // releases the last stage
    if (wg_leader) mbar_arrive(slab_empty);  // the producer loads the next slab during the epilogue

    // epilogue: register 4 j + 2 hh + e is row r + 8 hh (column x0 + r + 8
    // hh of output row y0 + g), channel 8 j + 2 t4 + e
    const int gy = y0 + g;
    const bool pair = (a.Cout & 1) == 0;  // float2 stores and residual reads
    float ps[Np / 8][2];
#pragma unroll
    for (int j = 0; j < Np / 8; ++j) ps[j][0] = ps[j][1] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gx = x0 + r + 8 * hh;
      const bool live = gy < a.H && gx < a.W;
      const size_t pix = live ? ((size_t)(n * a.H + gy) * a.W + gx) * a.Cout : 0;
#pragma unroll
      for (int j = 0; j < Np / 8; ++j) {
        const int ch = 8 * j + 2 * t4;
        if (ch >= a.Cout) continue;
        const bool two = ch + 1 < a.Cout;
        const float2 bb = *reinterpret_cast<const float2*>(a.bias + ch);
        float v0 = acc[4 * j + 2 * hh] + bb.x, v1 = acc[4 * j + 2 * hh + 1] + bb.y;
        if (a.res != nullptr) {
          if (live) {
            float2 xv = make_float2(0.f, 0.f);
            if (pair) {
              xv = __ldg(reinterpret_cast<const float2*>(a.res + pix + ch));
            } else {
              xv.x = __ldg(a.res + pix + ch);
              if (two) xv.y = __ldg(a.res + pix + ch + 1);
            }
            v0 = xv.x + a.res_scale * v0;
            v1 = xv.y + a.res_scale * v1;
          }
        } else {
          v0 = chain_act(v0, a.act);
          v1 = chain_act(v1, a.act);
        }
        if (!live) continue;
        if (pair) {
          *reinterpret_cast<float2*>(a.out + pix + ch) = make_float2(v0, v1);
        } else {
          a.out[pix + ch] = v0;
          if (two) a.out[pix + ch + 1] = v1;
        }
        ps[j][0] += v0;
        ps[j][1] += two ? v1 : 0.f;
      }
    }
    if (a.partial != nullptr) {
      // per channel: the warp's 16 rows by a butterfly over the lanes of one
      // column pair (each add commutes, so every lane holds the same sum),
      // then the 8 warps in order
      consumers_sync();  // the previous tile's sums are read
#pragma unroll
      for (int j = 0; j < Np / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = ps[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) sums[(g * 4 + wq) * Np + 8 * j + 2 * t4 + e] = v;
        }
      consumers_sync();
      if (threadIdx.x < a.Cout) {
        float s = 0.f;
        for (int w8 = 0; w8 < 8; ++w8) s += sums[w8 * Np + threadIdx.x];
        a.partial[((size_t)n * a.tiles + t) * a.Cout + threadIdx.x] = s;
      }
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
  const int R = dtype == 1 ? kTR : kFR;
  *tiles_w = (W + kTW - 1) / kTW;
  return ((H + R - 1) / R) * *tiles_w;
}

// The slab map over an (N, H, W, C) bf16 tensor: boxes of 8 channels x kSW
// columns x kSR rows of one frame, zeros out of bounds.
inline int slab_map(CUtensorMap* map, const void* t, int N, int H, int W, int C) {
  return nhwc_box_map(map, t, N, H, W, C, kSW, kSR);
}

static bool smem_limit_set[128 / 16 + 1];

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

// The f32 conv: the plan (ops/conv_chain.py chain_tf32_plan: kcs k8 steps a
// ring stage, nst stages) checked against what the kernel reads.
static bool tf32_smem_set[128 / 16 + 1];

template <int Np>
int launch_conv_tf32(const float* src, ConvTfArgs a, int N, cudaStream_t s) {
  const size_t smem = conv_tf32_smem(a.KS, Np, a.kcs, a.nst);
  if (a.kcs < 2 || a.kcs % 2 != 0 || a.nst < 2 || a.nst > kFMaxStages || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (a.use_tma) {
    const int e = nhwc_box_map(&map, src, N, a.H, a.W, a.Cs, kSW, kFR + 2, 8, true);
    if (e) return e;
  }
  if (!tf32_smem_set[Np / 16]) {  // the largest size, once per instantiation
    const int e = set_smem(conv3x3_tf32_kernel<Np>, kMaxSmem);
    if (e) return e;
    tf32_smem_set[Np / 16] = true;
  }
  const int sms = sm_count(), grid = a.total < sms ? a.total : sms;
  conv3x3_tf32_kernel<Np><<<grid, kConvThreads, smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

inline int conv_f32(const float* src, ConvTfArgs a, int Np, int N, cudaStream_t s) {
  switch (Np) {
    case 16: return launch_conv_tf32<16>(src, a, N, s);
    case 32: return launch_conv_tf32<32>(src, a, N, s);
    case 48: return launch_conv_tf32<48>(src, a, N, s);
    case 64: return launch_conv_tf32<64>(src, a, N, s);
    case 80: return launch_conv_tf32<80>(src, a, N, s);
    case 96: return launch_conv_tf32<96>(src, a, N, s);
    case 112: return launch_conv_tf32<112>(src, a, N, s);
    case 128: return launch_conv_tf32<128>(src, a, N, s);
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
// w1 (9, Cinp / 8, 2, 2, Cmp, 4) and w2 (9, Cm / 8, 2, 2, Coutp, 4), each
// k8 step's hi and lo B images (pack_conv_taps); Cinp, Cm the multiples of 8
// above Cin and the intermediate, Cmp and Coutp the multiples of 16 above
// the intermediate and Cout; mid: (N, H, W, Cmp) f32 scratch; plan: the
// four ints of chain_tf32_plan_ints (kcs, nst of conv1, then of conv2).
// b1: (Cm,) f32 (f32: (Cmp,)), b2: (Coutp,) f32; out: (N, H, W, Cout).
// act: 0 none, 1 relu, 2 lrelu(0.1).  has_res: out = x + res_scale * y (Cout
// == Cin).  partial (N, vmg_conv_chain_tiles(H, W, dtype), Cout) f32
// scratch and psum (N, Cout) f32: both null, or both set for the per-frame
// sums.
extern "C" int vmg_conv_chain(const void* x, const void* w1, const float* b1,
                              const void* w2, const float* b2, void* out, void* mid,
                              float* partial, float* psum, int N, int H, int W,
                              int Cin, int Cinp, int Cm, int Cout, int Coutp, int act,
                              int has_res, float res_scale, const int* plan, int dtype,
                              void* stream) {
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
    const int Cmp = (Cm + 15) / 16 * 16;
    if (Cinp % 8 || Cm % 8 || Coutp % 16 || Cinp < Cin || Cinp - Cin >= 8 || Cinp > 128 ||
        Cmp > 128 || Coutp > 128 || Coutp - Cout >= 16 || plan == nullptr || mid == nullptr ||
        (uintptr_t)x % 16 || (uintptr_t)mid % 16 || (uintptr_t)w1 % 16 || (uintptr_t)w2 % 16 ||
        (uintptr_t)b1 % 8 || (uintptr_t)b2 % 8 || (long long)N * S > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    vmg::ConvTfArgs a = {};
    a.H = H, a.W = W, a.tiles_w = tiles_w, a.tiles = S, a.total = N * S;
    // conv1: x -> mid = act(conv1(x) + b1), all Cmp channels (the padding zero)
    a.src = (const float*)x, a.w = (const float*)w1, a.bias = b1, a.out = (float*)mid;
    a.Cs = Cin, a.KS = Cinp / 8, a.Cout = Cmp, a.act = act, a.use_tma = Cin % 4 == 0;
    a.kcs = plan[0], a.nst = plan[1];
    int e = vmg::conv_f32((const float*)x, a, Cmp, N, s);
    if (e) return e;
    // conv2: mid -> out = conv2(mid) + b2 [x + s * .], sums
    a.src = (const float*)mid, a.w = (const float*)w2, a.bias = b2, a.out = (float*)out;
    a.res = has_res ? (const float*)x : nullptr, a.res_scale = res_scale, a.partial = partial;
    a.Cs = Cmp, a.KS = Cm / 8, a.Cout = Cout, a.act = 0, a.use_tma = 1;
    a.kcs = plan[2], a.nst = plan[3];
    e = vmg::conv_f32((const float*)mid, a, Coutp, N, s);
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
