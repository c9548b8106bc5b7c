// Grouped-conv FFN: out = fc2(GELU(grouped_conv3x3(x) + b1)) + b2.
//
// Replaces the Pallas kernel vmg_tpu/ops/group_conv.py `_fused_group_ffn`
// (`_kernel`, pallas_call at :203): C -> 6C -> C with groups = 4 (any
// groups dividing C, 1 included), the hidden never written to device
// memory.
//
// Bound on H100: operations.  Per pixel the FFN does 2 x 6C x (9C/4 + C) =
// 39 C^2 FLOP against 4 C bytes of bf16 traffic (x in, out back): 460.9
// GFLOP at stage 0 (16 x 184 x 320 x 112), 0.466 ms at 989 TFLOP/s, against
// 0.126 ms for its 422 MB at 3.35 TB/s.  The hidden (6C per pixel) is what
// would make it memory-bound if it went through HBM.
//
// Numerics (both versions): the conv accumulates in f32, bias and GELU in
// f32, the hidden rounds once to the input dtype (as the TPU kernel does
// before its projection), the projection accumulates in f32 across all
// groups, b2 is added and the result rounds once.
//
// * bf16 (serving): one persistent launch of a warp-specialised implicit
//   GEMM on wgmma (csrc/wgmma.cuh), the conv chain's design
//   (conv_chain.cu) carried over:
//   - Tiles of 64 columns and 2S rows (S = 2, 256 positions, where the
//     output accumulator fits a warpgroup's registers twice: C <= 112; S =
//     1 up to C = 224) or one row (above 224); one block per SM walks them.
//     Up to C = 224 warpgroup g of the two consumer warpgroups owns S of
//     the tile's rows, an m64 sub-tile each, and all C output channels;
//     one producer warp feeds them (setmaxnreg moves the producer
//     warpgroup's registers to the consumers).
//   - Input: per (tile, group) TMA stages the group's (rows + 2) x 66 slab
//     from a 4-D tensor map over the NHWC input in 8-channel boxes, in
//     no-swizzle core-matrix form; each tap's A operand is the slab's
//     descriptor shifted by dy * 66 + dx positions (no im2col).  A box
//     starts on 16 bytes, so group b's slab starts at channel cg * b rounded
//     down to 8 and its channels sit at offset (cg * b) % 8 (4 for the odd
//     groups at cg = 28); K covers cg and that offset, rounded up to 16, the
//     other channels with zero weights: at cg = 28 (stage 0) four boxes, 32
//     channels (+14% conv MACs; past C the tensor map fills zeros); 56 ->
//     64 likewise; 112 and 144 are whole.  Two slab buffers where they fit
//     (the next group's slab loads during this one's products), else one.
//   - Weights: pack_ffn_weights lays w1 and w2 out once per parameter
//     state as one stream in walk order, in wgmma B-image form; the producer
//     streams it through a ring of up to 4 stages (cp.async.bulk on
//     mbarriers): per hidden chunk its 9 taps (9, 3 or 1 per stage, <= 32
//     KB), then its w2 rows (one stage per warpgroup above C = 224).  A
//     256-position tile at C = 112 re-reads the 563 KB of weights from L2
//     (~256 FLOP per L2 byte).
//   - Hidden on chip, never in device memory: fg (padded to 16) is walked
//     in chunks of 48 features (the last 16 or 32 wide: 176 = 3 x 48 + 32
//     at stage 0); the chunk's conv accumulates into f32 registers; b1,
//     GELU and the bf16 rounding happen in registers, which then are the
//     register-A operand of the projection's wgmma.  The projection
//     accumulates the tile's C output channels in f32 registers across
//     chunks and groups (2 x 56 registers a thread at C = 112).  The
//     chunk's products run beside the next chunk's conv (one wgmma group
//     in flight), stages released as their products complete.
//   - Above C = 224 (stage 3: 448) one warpgroup cannot hold the output
//     accumulator, so the warpgroups split the output channels (half of C
//     each, 112 registers a thread) and the work of each chunk of 64
//     features (fg padded to 32): warpgroup g computes features 32g ..
//     32g + 31 of the conv, rounds them and writes them into a chunk buffer
//     in shared memory in core-matrix form (two buffers, alternating); after
//     one consumer barrier each projects the whole chunk, as wgmma's shared
//     A operand, onto its own output channels.  No conv is computed twice.
//   - Epilogue: b2, one rounding, the tile staged in shared memory and
//     written in 16-byte vectors along its rows (the chain's epilogue).
// * f32 (parity runs): one block per (frame, tile of output pixels), 256
//   threads, scalar FMA in 16 x 16 register micro-tiles, the halo'd input
//   tile in shared memory; per group the hidden features in chunks of 64
//   parked in shared memory between the conv and the projection.
//   Operands unpadded, in one weight buffer: w1 (G, 9*cg, fg) with rows in
//   (dy, dx, ci) order, then w2 (G, fg, C); b1 (G*fg).
#include "common.cuh"
#include "wgmma.cuh"

#include <algorithm>

namespace vmg {

constexpr int kFR = 4;               // hidden features per thread, phase 1
constexpr int kFCH = 16 * kFR;       // hidden chunk width
constexpr int kHS = kFCH + 1;        // padded row stride of the chunk

// ---- f32: scalar FMA ------------------------------------------------------

template <int PR, int ORMAX>
__global__ void __launch_bounds__(kThreads)
group_ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int H, int W, int C, int G, int fg, int act, int TH,
                     int TW, int tiles_w) {
  extern __shared__ float smem[];
  const int cg = C / G;
  const int OR = C / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int HX = TH + 2, WX = TW + 2;
  float* xs = smem;                   // HX * WX * cg
  float* hs = xs + HX * WX * cg;      // (16 * PR) * kHS

  int py[PR], px[PR];
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    py[i] = (ty + 16 * i) / TW;
    px[i] = (ty + 16 * i) % TW;
  }
  float acc[PR][ORMAX];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < ORMAX; ++j) acc[i][j] = 0.f;

  for (int b = 0; b < G; ++b) {
    __syncthreads();  // the previous group's readers are done with xs
    for (int e = threadIdx.x; e < HX * WX * cg; e += kThreads) {
      const int ci = e % cg, pix = e / cg;
      const int gy = y0 + pix / WX - 1, gx = x0 + pix % WX - 1;
      xs[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? x[((size_t)(n * H + gy) * W + gx) * C + b * cg + ci]
                  : 0.f;
    }
    __syncthreads();
    const float* w1b = w1 + (size_t)b * 9 * cg * fg;
    const float* w2b = w2 + (size_t)b * fg * C;

    for (int f0 = 0; f0 < fg; f0 += kFCH) {
      // phase 1: hidden[p][f] for p = ty + 16 i, f = f0 + tx + 16 j
      float hacc[PR][kFR];
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < kFR; ++j) hacc[i][j] = 0.f;
      bool fok[kFR];
#pragma unroll
      for (int j = 0; j < kFR; ++j) fok[j] = f0 + tx + 16 * j < fg;

      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const float* xr[PR];
#pragma unroll
        for (int i = 0; i < PR; ++i)
          xr[i] = xs + ((py[i] + dy) * WX + (px[i] + dx)) * cg;
        const float* wt = w1b + (size_t)tap * cg * fg + f0 + tx;
        for (int ci = 0; ci < cg; ++ci) {
          float wv[kFR];
#pragma unroll
          for (int j = 0; j < kFR; ++j)
            wv[j] = fok[j] ? wt[(size_t)ci * fg + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < PR; ++i) {
            const float xv = xr[i][ci];
#pragma unroll
            for (int j = 0; j < kFR; ++j) hacc[i][j] = fmaf(xv, wv[j], hacc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kFR; ++j) {
        const float bias = fok[j] ? b1[b * fg + f0 + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < PR; ++i)
          hs[(ty + 16 * i) * kHS + tx + 16 * j] =
              fok[j] ? gelu(hacc[i][j] + bias, act) : 0.f;
      }
      __syncthreads();

      // phase 2: acc[p][o] += sum_f hidden[p][f] * w2[b][f0 + f][o]
      const int fl = min(kFCH, fg - f0);
      for (int f = 0; f < fl; ++f) {
        const float* w2r = w2b + (size_t)(f0 + f) * C + tx;
        float hv[PR];
#pragma unroll
        for (int i = 0; i < PR; ++i) hv[i] = hs[(ty + 16 * i) * kHS + f];
#pragma unroll
        for (int j = 0; j < ORMAX; ++j) {
          if (j < OR) {
            const float wv = w2r[16 * j];
#pragma unroll
            for (int i = 0; i < PR; ++i) acc[i][j] = fmaf(hv[i], wv, acc[i][j]);
          }
        }
      }
      __syncthreads();  // hs is rewritten by the next chunk
    }
  }

#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int gy = y0 + py[i], gx = x0 + px[i];
    if (gy >= H || gx >= W) continue;
    const size_t base = ((size_t)(n * H + gy) * W + gx) * C + tx;
#pragma unroll
    for (int j = 0; j < ORMAX; ++j)
      if (j < OR) out[base + 16 * j] = acc[i][j] + b2[tx + 16 * j];
  }
}

template <int PR, int ORMAX>
int launch_f32(const float* x, const float* w1, const float* b1,
               const float* w2, const float* b2, float* out, int N, int H,
               int W, int C, int G, int fg, int act, cudaStream_t stream) {
  const int TW = 8, TH = 2 * PR;  // 16 * PR pixels per tile
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const size_t smem =
      sizeof(float) * ((size_t)(TH + 2) * (TW + 2) * (C / G) + 16 * PR * kHS);
  auto kern = group_ffn_f32_kernel<PR, ORMAX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(tiles_h * tiles_w, N), kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, out, H, W, C, G, fg, act, TH, TW, tiles_w);
  return (int)cudaGetLastError();
}

// ---- bf16: wgmma implicit GEMM on TMA slabs, hidden kept on chip --------

constexpr int kTW = 64;                    // tile columns
constexpr int kSW = kTW + 2;               // slab columns
constexpr int kFC = 48;                    // hidden features per chunk
constexpr int kFCS = 64;                   // the same where the warpgroups split the outputs
constexpr int kMaxStages = 4;              // weight ring
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kFfnThreads = kConsumers + 128;  // + the producer warpgroup
constexpr unsigned kStageCap = 32768;      // bytes of conv taps per ring stage

struct FfnArgs {
  const bf16* w;    // the weight stream (pack_ffn_weights), in walk order
  const bf16* b1;   // (G * fgp,)
  const bf16* b2;   // (C,)
  bf16* out;        // (N, H, W, C)
  int H, W, C, G, cg, Kp, fgp, act;
  int one;                    // 1: the trip count of the tile body's loop (see the kernel)
  int tiles_w, tiles, total;  // tiles per row band and frame, in all
  int tps, nst, nslab;        // conv taps per stage, stages, slab buffers
  unsigned stage_bytes;
};

// Tile rows: 2S (each warpgroup owns S rows, an m64 sub-tile each), or one
// row that both warpgroups share (SPLIT).
__host__ __device__ constexpr int ffn_rows(int S, bool split) { return split ? 1 : 2 * S; }
// slab positions (a 128-byte multiple) of a tile of TR rows
__host__ __device__ constexpr int ffn_slab_pos(int TR) { return ((TR + 2) * kSW + 7) / 8 * 8; }
__host__ __device__ inline size_t ffn_smem(int TR, int NO, int Kp, int nslab, int nst,
                                           unsigned stage_bytes, unsigned hidden_bytes) {
  return 128 + (size_t)nslab * (Kp / 8) * ffn_slab_pos(TR) * 16 + (size_t)nst * stage_bytes +
         2 * (size_t)hidden_bytes + 256 + (size_t)TR * kTW * (2 * NO + 16);
}

__device__ __forceinline__ void ffn_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}
template <int R>
__device__ __forceinline__ void pin_u32(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}
// the conv of cw hidden features (48, 32 or 16) into the first cw / 2
// registers of d
template <int R>
__device__ __forceinline__ void conv_mma(int cw, float (&d)[R], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (R >= 24) {
    if (cw == 48) {
      Wgmma<48>::mma(*reinterpret_cast<float(*)[24]>(&d[0]), da, db, scale_d);
      return;
    }
  }
  if (cw == 32)
    Wgmma<32>::mma(*reinterpret_cast<float(*)[16]>(&d[0]), da, db, scale_d);
  else
    Wgmma<16>::mma(*reinterpret_cast<float(*)[8]>(&d[0]), da, db, scale_d);
}

// A position in a ring of n buffers: the buffer and the parity of its
// current phase.
struct RingPos {
  int i = 0;
  unsigned ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++i == n) i = 0, ph ^= 1;
  }
};

// The producer's next slab: into its buffer (shared address slab0 + i *
// slab_bytes) once the consumers released it, channels c0 .. c0 + 8 KC8 -
// 1 in 8-channel boxes; full / empty: the shared addresses of the slab
// buffers' first barriers.
__device__ __forceinline__ void send_slab(const CUtensorMap* map, unsigned slab0,
                                          unsigned slab_bytes, unsigned chunk_bytes,
                                          unsigned full, unsigned empty, RingPos& sl, int nslab,
                                          int c0, int x0, int y0, int n, int KC8, bool leader) {
  mbar_wait(empty + 8 * sl.i, sl.ph ^ 1);
  if (leader) {
    const unsigned dst = slab0 + sl.i * slab_bytes, bar = full + 8 * sl.i;
    mbar_expect(bar, KC8 * chunk_bytes);
    for (int c = 0; c < KC8; ++c)
      tma_load_4d(dst + c * (slab_bytes / KC8), map, c0 + 8 * c, x0 - 1, y0 - 1, n, bar);
  }
  sl.next(nslab);
}

// One launch: out = fc2(GELU(gconv3x3(x) + b1)) + b2 for every tile of TR
// rows x 64 columns.  Walk per tile: group b, hidden chunk c: the chunk's
// conv (9 taps, tps per weight stage) into f32 registers, bias + GELU +
// bf16, then hidden @ w2 rows, accumulated in f32 registers over every
// chunk and group.
// * !SPLIT (C <= 224): warpgroup g owns tile rows g S .. g S + S - 1 (one
//   m64 sub-tile each) and all NO = NW output channels; the rounded hidden
//   is the projection's register-A operand.
// * SPLIT (C > 224): one row; warpgroup g computes features g FC/2 ..
//   (g + 1) FC/2 - 1 of each chunk's conv and writes them, rounded, into a
//   shared chunk buffer in the A operand's core-matrix form (two buffers,
//   alternating); after one consumer barrier both project the whole chunk,
//   warpgroup g onto output channels g NW .. g NW + NW - 1 from w2 stage g.
template <int S, int NW, bool SPLIT>
__global__ void __launch_bounds__(kFfnThreads, 1)
group_ffn_wgmma_kernel(const __grid_constant__ CUtensorMap x_map, const FfnArgs a) {
  constexpr int TR = ffn_rows(S, SPLIT), SR = TR + 2, SP = ffn_slab_pos(TR);
  constexpr int FC = SPLIT ? kFCS : kFC;   // hidden features per chunk
  constexpr int CW = SPLIT ? FC / 2 : FC;  // of which one warpgroup's conv computes
  constexpr int HALVES = SPLIT ? 2 : 1;    // w2 stages per chunk
  constexpr int NO = HALVES * NW;          // output channels of a tile
  constexpr unsigned kBoxBytes = 8 * kSW * SR * 2;
  constexpr unsigned kHidBytes = SPLIT ? kTW * FC * 2 : 0;  // one hidden chunk buffer
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const int KC8 = a.Kp / 8;
  const unsigned slab_bytes = (unsigned)KC8 * SP * 16;
  unsigned char* slabs = base;
  unsigned char* ring = slabs + (size_t)a.nslab * slab_bytes;
  unsigned char* hidden = ring + (size_t)a.nst * a.stage_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(hidden + 2 * kHidBytes);
  unsigned char* otile = reinterpret_cast<unsigned char*>(bars) + 256;  // staged output
  uint64_t *slab_full = bars, *slab_empty = bars + 2, *wfull = bars + 4,
           *wempty = bars + 4 + kMaxStages;
  const int nchunks = (a.fgp + FC - 1) / FC, nconv = 9 / a.tps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nslab; ++i) {
      mbar_init(&slab_full[i], 1);
      mbar_init(&slab_empty[i], 2);
    }
    for (int i = 0; i < a.nst; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: its first warp streams the slabs (TMA) and
    // the weights (bulk copies); the group gives its registers away
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32) return;
    const bool leader = (threadIdx.x & 31) == 0;
    // with one slab buffer the next group's first weight stages go ahead of
    // its slab, so the ring does not drain while the slab is busy: as many
    // as the ring holds beside the previous chunk's w2 stages, which the
    // consumers release only once the next group's first conv runs
    const int lead = a.nslab == 1 ? a.nst - HALVES : 0;
    // shared addresses: the slabs, the ring, the barriers (slab full, slab
    // empty, weights full, weights empty at 0, 16, 32, 32 + 8 kMaxStages)
    const unsigned slab_s = su32(slabs), ring_s = su32(ring), bar_s = su32(bars);
    const unsigned wfull_s = bar_s + 32, wempty_s = bar_s + 32 + 8 * kMaxStages;
    RingPos q, sl;
    for (int tile = blockIdx.x; tile < a.total; tile += gridDim.x) {
      const int n = tile / a.tiles, t = tile % a.tiles;
      const int y0 = (t / a.tiles_w) * TR, x0 = (t % a.tiles_w) * kTW;
      const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(a.w);
      for (int once = 0; once < a.one; ++once) {
        for (int b = 0; b < a.G; ++b) {
          int issued = 0;
          for (int c = 0; c < nchunks; ++c) {
            const int fcw = min(FC, a.fgp - c * FC);
            for (int i = 0; i < nconv + HALVES; ++i, ++issued, q.next(a.nst)) {
              if (issued == lead)
                send_slab(&x_map, slab_s, slab_bytes, kBoxBytes, bar_s, bar_s + 16, sl, a.nslab,
                          (a.cg * b) & ~7, x0, y0, n, KC8, leader);
              const unsigned bytes = i < nconv ? (unsigned)(a.tps * a.Kp * fcw * 2)
                                               : (unsigned)(fcw * NW * 2);
              mbar_wait(wempty_s + 8 * q.i, q.ph ^ 1);
              if (leader) {
                mbar_expect(wfull_s + 8 * q.i, bytes);
                bulk_load(ring_s + q.i * a.stage_bytes, wsrc, bytes, wfull_s + 8 * q.i);
              }
              wsrc += bytes;
            }
          }
          if (issued <= lead)  // fewer weight stages in the group than the lead
            send_slab(&x_map, slab_s, slab_bytes, kBoxBytes, bar_s, bar_s + 16, sl, a.nslab,
                      (a.cg * b) & ~7, x0, y0, n, KC8, leader);
        }
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int g = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool wg_leader = (threadIdx.x & 127) == 0;
  const unsigned ring_a = su32(ring), hidden_a = su32(hidden);
  float hid[S][CW / 2];
  uint32_t afr[S][CW / 16][4];  // !SPLIT: the rounded hidden as register-A fragments
  float acc[S][NW / 2];
  RingPos q, sl;
  int pend = -1;   // the ring stage of the last committed products, not yet released
  unsigned hb = 0;  // SPLIT: the hidden buffer of the next chunk
  for (int tile = blockIdx.x; tile < a.total; tile += gridDim.x) {
    const int n = tile / a.tiles, t = tile % a.tiles;
    const int y0 = (t / a.tiles_w) * TR, x0 = (t % a.tiles_w) * kTW;
    // The tile's work sits in a loop of one trip whose count the compiler
    // cannot see (a.one = 1), here and in the producer: ptxas then
    // schedules the main loop so that stage 0 runs ~6% faster than without
    // it (PERF.md); the loop does nothing else.
    for (int once = 0; once < a.one; ++once) {
      for (int b = 0; b < a.G; ++b, sl.next(a.nslab)) {
        const int sb = sl.i;
        mbar_wait(&slab_full[sb], sl.ph);
        const unsigned slab_a = su32(slabs + (size_t)sb * slab_bytes);
        for (int c = 0; c < nchunks; ++c) {
          const int fcw = min(FC, a.fgp - c * FC), cw = SPLIT ? fcw / 2 : fcw, nk = fcw / 16;
          // the chunk's conv: hid[s] = slab taps @ w1 chunk (SPLIT: this
          // warpgroup's cw columns of it)
          for (int i = 0; i < nconv; ++i, q.next(a.nst)) {
            const int st = q.i;
            mbar_wait(&wfull[st], q.ph);
            wg_fence();
#pragma unroll
            for (int s = 0; s < S; ++s) pin_regs(hid[s]);
            for (int u = 0; u < a.tps; ++u) {
              const int tap = i * a.tps + u, dy = tap / 3, dx = tap % 3;
              const unsigned b0 = ring_a + st * a.stage_bytes + u * a.Kp * fcw * 2 +
                                  (SPLIT ? g * cw * 16 : 0);
              for (int kc = 0; kc < a.Kp / 16; ++kc) {
                const uint64_t db = mat_desc(b0 + kc * 2 * fcw * 16, fcw * 16, 128);
#pragma unroll
                for (int s = 0; s < S; ++s) {
                  const int row = (SPLIT ? 0 : g * S + s) + dy;
                  conv_mma(cw, hid[s],
                           mat_desc(slab_a + (row * kSW + dx) * 16 + kc * 2 * SP * 16,
                                    SP * 16, 128),
                           db, tap | kc);
                }
              }
            }
            wg_commit();
#pragma unroll
            for (int s = 0; s < S; ++s) pin_regs(hid[s]);
            wg_wait<1>();  // the products committed before these are done
            if (pend >= 0 && wg_leader) mbar_arrive(&wempty[pend]);
            pend = st;
          }
          wg_wait<0>();
#pragma unroll
          for (int s = 0; s < S; ++s) {
            pin_regs(hid[s]);
            pin_regs(acc[s]);
          }
          if constexpr (!SPLIT) {
            pin_u32(afr[0]);
            if (S > 1) pin_u32(afr[S - 1]);
          }
          if (wg_leader) {
            mbar_arrive(&wempty[pend]);
            if (c == nchunks - 1) mbar_arrive(&slab_empty[sb]);  // the group's convs are done
          }
          pend = -1;
          // bias, GELU in f32, one rounding: register 4j + 2h + e of hid[s]
          // is row 16 wq + lane / 4 + 8h and (this warpgroup's) hidden
          // feature 8j + 2 (lane % 4) + e of the chunk
          const bf16* b1c =
              a.b1 + (size_t)b * a.fgp + c * FC + (SPLIT ? g * cw : 0) + 2 * (lane & 3);
          if constexpr (!SPLIT) {
#pragma unroll
            for (int kk = 0; kk < FC / 16; ++kk) {
              if (kk >= nk) break;
              float bias[2][2];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  bias[jj][e] = __bfloat162float(b1c[8 * (2 * kk + jj) + e]);
#pragma unroll
              for (int s = 0; s < S; ++s)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int r = 4 * (2 * kk + jj) + 2 * h;
                    afr[s][kk][2 * jj + h] = pack_bf16x2(gelu(hid[s][r] + bias[jj][0], a.act),
                                                         gelu(hid[s][r + 1] + bias[jj][1], a.act));
                  }
            }
            // acc[s] += hidden @ w2 chunk rows
            const int st = q.i;
            mbar_wait(&wfull[st], q.ph);
            wg_fence();
#pragma unroll
            for (int s = 0; s < S; ++s) pin_regs(acc[s]);
            const unsigned b0 = ring_a + st * a.stage_bytes;
#pragma unroll
            for (int kk = 0; kk < FC / 16; ++kk) {
              if (kk >= nk) break;
              const uint64_t db = mat_desc(b0 + kk * 2 * NW * 16, NW * 16, 128);
#pragma unroll
              for (int s = 0; s < S; ++s)
                WgmmaRA<NW>::mma(acc[s], afr[s][kk], db, (b | c | kk) != 0);
            }
            wg_commit();
#pragma unroll
            for (int s = 0; s < S; ++s) pin_regs(acc[s]);
            pend = st;
            q.next(a.nst);
          } else {
            // this warpgroup's features into the chunk buffer: 8-feature
            // column j8 of the chunk at j8 * 64 * 16 bytes, position p at p * 16
            // (no-swizzle core matrices: the A operand of the projection)
            unsigned char* hbuf = hidden + hb * kHidBytes;
#pragma unroll
            for (int j = 0; j < CW / 8; ++j) {
              if (j >= cw / 8) break;
              const float bias0 = __bfloat162float(b1c[8 * j]);
              const float bias1 = __bfloat162float(b1c[8 * j + 1]);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 4 * j + 2 * h, p = 16 * wq + lane / 4 + 8 * h;
                *reinterpret_cast<uint32_t*>(hbuf + ((g * cw / 8 + j) * kTW + p) * 16 +
                                             4 * (lane & 3)) =
                    pack_bf16x2(gelu(hid[0][r] + bias0, a.act), gelu(hid[0][r + 1] + bias1, a.act));
              }
            }
            fence_async_shared();  // the writes, visible to wgmma
            ffn_consumers_sync();  // both halves of the chunk are in hbuf
            // acc += chunk @ w2 rows of this warpgroup's output channels
            const unsigned ha = hidden_a + hb * kHidBytes;
            for (int h = 0; h < HALVES; ++h, q.next(a.nst)) {
              const int st = q.i;
              mbar_wait(&wfull[st], q.ph);
              if (h != g) {  // the other warpgroup's stage
                if (wg_leader) mbar_arrive(&wempty[st]);
                continue;
              }
              wg_fence();
              pin_regs(acc[0]);
              const unsigned b0 = ring_a + st * a.stage_bytes;
#pragma unroll
              for (int kk = 0; kk < FC / 16; ++kk) {
                if (kk >= nk) break;
                Wgmma<NW>::mma(acc[0], mat_desc(ha + kk * 2 * kTW * 16, kTW * 16, 128),
                               mat_desc(b0 + kk * 2 * NW * 16, NW * 16, 128), (b | c | kk) != 0);
              }
              wg_commit();
              pin_regs(acc[0]);
              pend = st;
            }
            hb ^= 1;
          }
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int s = 0; s < S; ++s) pin_regs(acc[s]);
      if constexpr (!SPLIT) {
        pin_u32(afr[0]);
        if (S > 1) pin_u32(afr[S - 1]);
      }
      if (pend >= 0 && wg_leader) mbar_arrive(&wempty[pend]);
      pend = -1;

      // epilogue: + b2, one rounding, the tile staged in shared memory
      // (position r = 64 u + column at r * pitch), then 16-byte stores along
      // the tile's rows, which are contiguous in the output
      const int pitch = 2 * NO + 16, c0 = SPLIT ? g * NW : 0;
      ffn_consumers_sync();  // the previous tile's stores are done with otile
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned char* row = otile + (size_t)(kTW * (SPLIT ? 0 : g * S + s) + 16 * wq +
                                                lane / 4 + 8 * h) * pitch;
#pragma unroll
          for (int j = 0; j < NW / 8; ++j) {
            const int ch = c0 + 8 * j + 2 * (lane & 3);
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = acc[s][4 * j + 2 * h + e] +
                     (ch + e < a.C ? __bfloat162float(a.b2[ch + e]) : 0.f);
            *reinterpret_cast<uint32_t*>(row + 2 * ch) = pack_bf16x2(v[0], v[1]);
          }
        }
      ffn_consumers_sync();
      const int cv = a.C / 8;
      for (int e = threadIdx.x; e < TR * kTW * cv; e += kConsumers) {
        const int r = e / cv, v = e % cv;
        const int gy = y0 + r / kTW, gx = x0 + r % kTW;
        if (gy >= a.H || gx >= a.W) continue;
        *reinterpret_cast<uint4*>(a.out + ((size_t)(n * a.H + gy) * a.W + gx) * a.C + 8 * v) =
            *reinterpret_cast<const uint4*>(otile + (size_t)r * pitch + 16 * v);
      }
    }
  }
}

template <int S, int NW, bool SPLIT>
int launch_ffn(const bf16* x, FfnArgs a, int N, cudaStream_t s) {
  constexpr int TR = ffn_rows(S, SPLIT), FC = SPLIT ? kFCS : kFC, NO = (SPLIT ? 2 : 1) * NW;
  constexpr unsigned hidden_bytes = SPLIT ? kTW * FC * 2 : 0;
  a.tiles_w = (a.W + kTW - 1) / kTW;
  a.tiles = ((a.H + TR - 1) / TR) * a.tiles_w;
  if ((long long)N * a.tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.total = N * a.tiles;
  a.one = 1;
  a.tps = 9;
  while (a.tps > 1 && (unsigned)(a.tps * a.Kp * FC * 2) > kStageCap) a.tps /= 3;
  a.stage_bytes = (unsigned)std::max(a.tps * a.Kp * FC * 2, FC * NW * 2);
  // two slab buffers and four stages where they fit, else fewer
  const int plans[5][2] = {{2, 4}, {2, 3}, {1, 4}, {1, 3}, {1, 2}};
  size_t smem = 0;
  for (const auto& pl : plans) {
    a.nslab = pl[0], a.nst = pl[1];
    smem = ffn_smem(TR, NO, a.Kp, a.nslab, a.nst, a.stage_bytes, hidden_bytes);
    if (smem <= kMaxSmem) break;
  }
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  int e = nhwc_box_map(&map, x, N, a.H, a.W, a.C, kSW, TR + 2);
  if (e) return e;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    e = set_smem(group_ffn_wgmma_kernel<S, NW, SPLIT>, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  const int sms = sm_count(), grid = a.total < sms ? a.total : sms;
  group_ffn_wgmma_kernel<S, NW, SPLIT><<<grid, kFfnThreads, smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

// K rows per tap: group b's slab starts at channel (cg b) rounded down to 8,
// a 16-byte boundary (the TMA boxes' start), so its channels sit at offset
// (cg b) % 8; K covers the largest offset plus cg, rounded up to 16.  The
// weight stream holds zeros in the other rows (group_conv.slab_depth).
inline int ffn_slab_depth(int cg, int G) {
  int off = 0;
  for (int b = 0; b < G; ++b) off = std::max(off, (cg * b) % 8);
  return (cg + off + 15) / 16 * 16;
}

// Output channels a consumer warpgroup accumulates (group_conv.out_width):
// all C up to 224 (two m64 sub-tiles a warpgroup up to 112, one above);
// above 224 the two warpgroups split them, half of C rounded up to 16 each.
inline int ffn_out_width(int C) { return C <= 224 ? C : (C / 2 + 15) / 16 * 16; }

inline int ffn_bf16(const bf16* x, FfnArgs a, int N, cudaStream_t s) {
  if (a.C > 224) {
    switch (ffn_out_width(a.C)) {
      case 128: return launch_ffn<1, 128, true>(x, a, N, s);
      case 144: return launch_ffn<1, 144, true>(x, a, N, s);
      case 160: return launch_ffn<1, 160, true>(x, a, N, s);
      case 176: return launch_ffn<1, 176, true>(x, a, N, s);
      case 192: return launch_ffn<1, 192, true>(x, a, N, s);
      case 208: return launch_ffn<1, 208, true>(x, a, N, s);
      case 224: return launch_ffn<1, 224, true>(x, a, N, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (a.C) {
    case 16: return launch_ffn<2, 16, false>(x, a, N, s);
    case 32: return launch_ffn<2, 32, false>(x, a, N, s);
    case 48: return launch_ffn<2, 48, false>(x, a, N, s);
    case 64: return launch_ffn<2, 64, false>(x, a, N, s);
    case 80: return launch_ffn<2, 80, false>(x, a, N, s);
    case 96: return launch_ffn<2, 96, false>(x, a, N, s);
    case 112: return launch_ffn<2, 112, false>(x, a, N, s);
    case 128: return launch_ffn<1, 128, false>(x, a, N, s);
    case 144: return launch_ffn<1, 144, false>(x, a, N, s);
    case 160: return launch_ffn<1, 160, false>(x, a, N, s);
    case 176: return launch_ffn<1, 176, false>(x, a, N, s);
    case 192: return launch_ffn<1, 192, false>(x, a, N, s);
    case 208: return launch_ffn<1, 208, false>(x, a, N, s);
    case 224: return launch_ffn<1, 224, false>(x, a, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace vmg

// x, out: (N, H, W, C); w: the weights of pack_ffn_weights -- bf16: the
// weight stream (its layout follows ffn_out_width), f32: w1 (G, 9 cg, fg)
// then w2 (G, fg, C); b1 (G * fgp,), b2 (C,); fgp the hidden features per
// group (bf16: padded to a multiple of 16, 32 above C = 224).
extern "C" int vmg_group_ffn(const void* x, const void* w, const void* b1, const void* b2,
                             void* out, int N, int H, int W, int C, int G, int fgp, int act,
                             int dtype, void* stream) {
  if (C % 16 != 0 || G < 1 || C % G != 0 || C > 448 || N < 1 || H < 1 || W < 1 || N > 65535 ||
      fgp < 1 || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (fgp % (C > 224 ? 32 : 16) != 0 || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
        (uintptr_t)out % 16)
      return (int)cudaErrorInvalidValue;
    vmg::FfnArgs a = {};
    a.w = (const vmg::bf16*)w, a.b1 = (const vmg::bf16*)b1, a.b2 = (const vmg::bf16*)b2;
    a.out = (vmg::bf16*)out;
    a.H = H, a.W = W, a.C = C, a.G = G, a.cg = C / G, a.Kp = vmg::ffn_slab_depth(C / G, G);
    a.fgp = fgp, a.act = act;
    return vmg::ffn_bf16((const vmg::bf16*)x, a, N, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x, *w1f = (const float*)w;
  const float* w2f = w1f + (size_t)G * 9 * (C / G) * fgp;
  const float* b1f = (const float*)b1;
  const float* b2f = (const float*)b2;
  float* of = (float*)out;
  const int OR = C / 16;
  if (OR <= 7) return vmg::launch_f32<4, 7>(xf, w1f, b1f, w2f, b2f, of, N, H, W, C, G, fgp, act, s);
  if (OR <= 14) return vmg::launch_f32<2, 14>(xf, w1f, b1f, w2f, b2f, of, N, H, W, C, G, fgp, act, s);
  return vmg::launch_f32<1, 28>(xf, w1f, b1f, w2f, b2f, of, N, H, W, C, G, fgp, act, s);
}

extern "C" const char* vmg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
