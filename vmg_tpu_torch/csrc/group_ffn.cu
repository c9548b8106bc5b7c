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
//   (conv_chain.cu) carried over; the tile geometry is the host's
//   (group_conv.ffn_plan), checked by launch_ffn:
//   - Tiles of MS m64 sub-tiles (4 where the output accumulator fits a
//     warpgroup's registers twice: C <= 112; 2 up to C = 224; 1 above); one
//     block per SM walks them.  The columns are cut into bands of Wc <= 64;
//     a slab row holds P = Wc + 2 positions.  On 64-column bands a sub-tile
//     is one band row (PACKED false, the geometry known at compile time);
//     on narrower bands (stage 3's W = 40, the evaluator's 16 and 32) a
//     sub-tile is 64 consecutive band positions across rows (PACKED), so
//     only the two pad columns a row are dead: stage 3 walks 256 tiles,
//     not 368 one-row tiles with 40 of 64 positions live.  Up to C = 224
//     warpgroup g of the two consumer warpgroups owns S of the sub-tiles
//     and all C output channels; one producer warp feeds them (setmaxnreg
//     moves the producer warpgroup's registers to the consumers).
//   - Input: per (tile, group) TMA stages the group's slab (the tile's rows
//     plus the halo, P positions a row) from a 4-D tensor map over the NHWC
//     input in 8-channel boxes, in no-swizzle core-matrix form; tap (dy, dx)
//     of a sub-tile is the slab's descriptor shifted by dy P + dx positions
//     (no im2col; the tensor map's out-of-bounds zeros are the padding).  A
//     box starts on 16 bytes, so group b's slab starts at channel cg * b
//     rounded down to 8 and its channels sit at offset (cg * b) % 8; K
//     covers cg and that offset, rounded up to 16, the other channels with
//     zero weights (cg = 28 -> 32, 56 -> 64).  Two slab buffers where they
//     fit (the next group's slab loads during this one's products), else
//     one.
//   - Weights: pack_ffn_weights lays w1 and w2 out once per parameter
//     state as one stream in walk order, in wgmma B-image form; the producer
//     streams it through a ring of up to 12 slots (cp.async.bulk on
//     mbarriers): per hidden chunk its 9 taps (9, 3 or 1 a slot, <= 32 KB),
//     then its w2 rows (above C = 224: each warpgroup's half in two slots).
//   - Hidden on chip, never in device memory: fg (padded to 16) is walked
//     in chunks of 48 features (the last 16 or 32 wide); the chunk's conv
//     accumulates into f32 registers; b1, GELU and the bf16 rounding happen
//     in registers, which then are the register-A operand of the
//     projection's wgmma.  The projection accumulates the tile's C output
//     channels in f32 registers across chunks and groups (2 x 56 registers
//     a thread at C = 112).  The chunk's products run beside the next
//     chunk's conv (one wgmma group in flight), slots released as their
//     products complete.
//   - Above C = 224 (stage 3: 448) one warpgroup cannot hold the output
//     accumulator, so the warpgroups split the output channels (half of C
//     each, 112 registers a thread) and the work of each chunk of 128
//     features (fg padded to 32): warpgroup g computes features 64g ..
//     64g + 63 of the conv (n64 products), rounds them and writes them into
//     a chunk buffer in shared memory in core-matrix form (two buffers,
//     alternating); after one consumer barrier each projects the whole
//     chunk, as wgmma's shared A operand, onto its own output channels.  No
//     conv is computed twice.
//   - What bounds it (PERF.md §6): not the weight stream.  Without its
//     weight copies the kernel runs as fast; without its products it keeps
//     half its time at stage 3: the per-slot hand-offs (a barrier wait, a
//     fence, a commit, a wait a slot) and the per-chunk drain, GELU and
//     barrier.  Fewer, larger chunks and slots are what moved it.
//   - Epilogue: b2, one rounding; up to C = 224 the tile staged in shared
//     memory and written in 16-byte vectors along its positions, above
//     from registers (16 contiguous bytes a position for 4 lanes); dead
//     positions and columns past W store nothing.
// * f32 (evaluation: the eval command's default dtype), group_ffn_tf32_kernel
//   (notes at the kernel): the same producer / consumer walk on f32
//   operands, every product as three TF32 products on wgmma (3xTF32: a_hi
//   b_hi + a_hi b_lo + a_lo b_hi, about f32's accuracy; one TF32 product
//   keeps ~3 digits and misses the f32 tolerance).  Bound: 3 x 460.9 GFLOP
//   at 494.7 TFLOP/s, 2.795 ms at stage 0.  Tiles of two m64 sub-tiles, one
//   a consumer warpgroup, which holds all NW output channels of its
//   half; above C = 224 each tile runs once per output half (the conv
//   computed twice: the split fragments leave no registers for a shared
//   chunk).  The x slab is raw f32 by TMA (8-channel boxes); each thread
//   reads and splits its own A fragments, KB k8 steps a commit group; the
//   hidden goes from the accumulator through b1, the accurate GELU and the
//   split straight into the projection's register-A fragments.  The weight
//   stream holds every weight as its TF32 hi and its lo (pack_ffn_weights;
//   hi + lo is the weight exactly).  The scalar kernel this replaced (one
//   block per pixel tile, FMA in 16 x 16 register micro-tiles) ran at 0.18
//   of its f32 bound at stage 0 and lost to the plain version at every
//   path shape (PERF.md §6).
#include "common.cuh"
#include "wgmma.cuh"

#include <algorithm>

namespace vmg {

// ---- bf16: wgmma implicit GEMM on TMA slabs, hidden kept on chip --------

constexpr int kFC = 48;                    // hidden features per chunk
constexpr int kFCS = 128;                  // the same where the warpgroups split the outputs
constexpr int kMaxStages = 12;             // weight ring slots
constexpr int kRowPos = 66;                // slab row positions of a 64-column band
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kFfnThreads = kConsumers + 128;  // + the producer warpgroup

struct FfnArgs {
  const bf16* w;    // the weight stream (pack_ffn_weights), in walk order
  const bf16* b1;   // (G * fgp,)
  const bf16* b2;   // (C,)
  bf16* out;        // (N, H, W, C)
  int H, W, C, G, cg, Kp, fgp, act;
  int one;          // 1: the trip count of the tile body's loop (see the kernel)
  // geometry (group_conv.ffn_plan): nb column bands of Wc columns; a slab
  // row holds P = Wc + 2 positions (columns x0 - 1 .. x0 + Wc); a band's
  // positions f = y P + x are cut into tiles of `span`; a tile's m64
  // sub-tile s starts `step` positions after sub-tile s - 1 (step = P: one
  // band row each, step = 64: packed across rows); a slab is `rows` rows
  // (SP positions, a multiple of 8, per 8-channel box)
  int nb, Wc, P, step, span, rows, SP;
  int tiles, total;  // tiles per frame, in all
  int tps, nst, nslab;  // conv taps per stage, ring slots, slab buffers
  unsigned stage_bytes;
};

// m64 sub-tiles a tile: 2S (each warpgroup owns S), or one that both
// warpgroups share (SPLIT).
__host__ __device__ constexpr int ffn_subtiles(int S, bool split) { return split ? 1 : 2 * S; }
// slab positions a box of a 64-column band's MS + 2 rows (a 128-byte multiple)
__host__ __device__ constexpr int ffn_row_slab_pos(int MS) { return ((MS + 2) * kRowPos + 7) / 8 * 8; }
// shared memory: slabs, ring, hidden chunk buffers (SPLIT), barriers, the
// staged output tile (!SPLIT: SPLIT stores from registers)
__host__ __device__ inline size_t ffn_smem(int MS, int NO, int Kp, int SP, int nslab, int nst,
                                           unsigned stage_bytes, unsigned hidden_bytes,
                                           bool split) {
  return 128 + (size_t)nslab * (Kp / 8) * SP * 16 + (size_t)nst * stage_bytes +
         2 * (size_t)hidden_bytes + 256 + (split ? 0 : (size_t)MS * 64 * (2 * NO + 16));
}

// GELU in f32 of a value about to round to bf16 (2^-8 relative): the tanh
// form as v sigmoid(2u) = v / (1 + e^-2u), u = sqrt(2/pi) (v + 0.044715
// v^3), on the fast exponential and divide (errors ~1e-6 relative, far
// below the rounding; a third of tanhf's instructions); the erf form as
// common.cuh's.
__device__ __forceinline__ float gelu_to_bf16(float v, int act) {
  if (act == 0) return gelu(v, 0);
  const float u = 0.79788456080286535588f * (v + 0.044715f * v * v * v);
  return __fdividef(v, 1.f + __expf(-2.f * u));
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
// the conv of cw hidden features (64, 48, 32 or 16) into the first cw / 2
// registers of d
template <int R>
__device__ __forceinline__ void conv_mma(int cw, float (&d)[R], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (R >= 32) {
    if (cw == 64) {
      Wgmma<64>::mma(*reinterpret_cast<float(*)[32]>(&d[0]), da, db, scale_d);
      return;
    }
  }
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

// A tile: frame n, first band row y0 (the slab starts a row above), band
// columns from x0, its first position b0 in the slab's row 1 (0 where a
// sub-tile is one band row).
struct FfnTile {
  int n, y0, x0, b0;
};
template <bool PACKED, int MS, class Args>
__device__ __forceinline__ FfnTile ffn_tile(const Args& a, int tile) {
  const int n = tile / a.tiles, t = tile % a.tiles, x0 = (t % a.nb) * a.Wc;
  if (!PACKED) return {n, (t / a.nb) * MS, x0, 0};
  const int q0 = (t / a.nb) * a.span, y0 = q0 / a.P;
  return {n, y0, x0, q0 - y0 * a.P};
}

// The producer's next slab: into its buffer (shared address slab0 + i *
// slab_bytes) once the consumers released it, channels c0 .. c0 + 8 KC8 -
// 1 in 8-channel boxes of rows x P positions; full / empty: the shared
// addresses of the slab buffers' first barriers.
__device__ __forceinline__ void send_slab(const CUtensorMap* map, unsigned slab0,
                                          unsigned slab_bytes, unsigned box_bytes,
                                          unsigned full, unsigned empty, RingPos& sl, int nslab,
                                          int c0, const FfnTile& tl, int KC8, bool leader) {
  mbar_wait(empty + 8 * sl.i, sl.ph ^ 1);
  if (leader) {
    const unsigned dst = slab0 + sl.i * slab_bytes, bar = full + 8 * sl.i;
    mbar_expect(bar, KC8 * box_bytes);
    for (int c = 0; c < KC8; ++c)
      tma_load_4d(dst + c * (slab_bytes / KC8), map, c0 + 8 * c, tl.x0 - 1, tl.y0 - 1, tl.n, bar);
  }
  sl.next(nslab);
}

// One launch: out = fc2(GELU(gconv3x3(x) + b1)) + b2 for every tile of MS
// m64 sub-tiles.  Walk per tile: group b, hidden chunk c: the chunk's conv
// (9 taps, tps per weight stage) into f32 registers, bias + GELU + bf16,
// then hidden @ w2 rows, accumulated in f32 registers over every chunk and
// group.  Tap (dy, dx) of sub-tile s is the slab's descriptor at position
// b0 + s step + dy P + dx: a sub-tile packed across band rows reads the
// two pad columns of each row it crosses as two dead positions.
// * !SPLIT (C <= 224): warpgroup g owns sub-tiles g S .. g S + S - 1 and all
//   NO = NW output channels; the rounded hidden is the projection's
//   register-A operand.
// * SPLIT (C > 224): one sub-tile; warpgroup g computes features g FC/2 ..
//   (g + 1) FC/2 - 1 of each chunk's conv and writes them, rounded, into a
//   shared chunk buffer in the A operand's core-matrix form (two buffers,
//   alternating); after one consumer barrier both project the whole chunk,
//   warpgroup g onto output channels g NW .. g NW + NW - 1 from w2 stage g.
template <int S, int NW, bool SPLIT, bool PACKED>
__global__ void __launch_bounds__(kFfnThreads, 1)
group_ffn_wgmma_kernel(const __grid_constant__ CUtensorMap x_map, const FfnArgs a) {
  constexpr int MS = ffn_subtiles(S, SPLIT);
  constexpr int FC = SPLIT ? kFCS : kFC;   // hidden features per chunk
  constexpr int CW = SPLIT ? FC / 2 : FC;  // of which one warpgroup's conv computes
  constexpr int HALVES = SPLIT ? 2 : 1;    // w2 halves per chunk (one a warpgroup)
  constexpr int WP = SPLIT ? 2 : 1;        // ring slots a w2 half (by feature halves)
  // the geometry: compile-time for 64-column bands, else the plan's
  const int P = PACKED ? a.P : kRowPos, STEP = PACKED ? a.step : kRowPos;
  const int SP = PACKED ? a.SP : ffn_row_slab_pos(MS);
  constexpr int NO = HALVES * NW;          // output channels of a tile
  constexpr unsigned kHidBytes = SPLIT ? 64 * FC * 2 : 0;  // one hidden chunk buffer
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
    if (threadIdx.x < kConsumers + 32) {
      const bool leader = (threadIdx.x & 31) == 0;
      // with one slab buffer the next group's first weight stages go ahead
      // of its slab, so the ring does not drain while the slab is busy: as
      // many as the ring holds beside the previous chunk's w2 stages, which
      // the consumers release only once the next group's first conv runs
      const int lead = a.nslab == 1 ? a.nst - HALVES * WP : 0;
      const unsigned box_bytes = (unsigned)a.rows * P * 16;
      // shared addresses: the slabs, the ring, the barriers (slab full, slab
      // empty, weights full, weights empty at 0, 16, 32, 32 + 8 kMaxStages)
      const unsigned slab_s = su32(slabs), ring_s = su32(ring), bar_s = su32(bars);
      const unsigned wfull_s = bar_s + 32, wempty_s = bar_s + 32 + 8 * kMaxStages;
      RingPos q, sl;
      for (int tile = blockIdx.x; tile < a.total; tile += gridDim.x) {
        const FfnTile tl = ffn_tile<PACKED, MS>(a, tile);
        const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(a.w);
        for (int once = 0; once < a.one; ++once) {
          for (int b = 0; b < a.G; ++b) {
            int issued = 0;
            for (int c = 0; c < nchunks; ++c) {
              const int fcw = min(FC, a.fgp - c * FC);
              for (int i = 0; i < nconv + HALVES * WP; ++i, ++issued, q.next(a.nst)) {
                if (issued == lead)
                  send_slab(&x_map, slab_s, slab_bytes, box_bytes, bar_s, bar_s + 16, sl, a.nslab,
                            (a.cg * b) & ~7, tl, KC8, leader);
                const unsigned bytes = i < nconv ? (unsigned)(a.tps * a.Kp * fcw * 2)
                                                 : (unsigned)(fcw * NW * 2 / WP);
                mbar_wait(wempty_s + 8 * q.i, q.ph ^ 1);
                if (leader) {
                  mbar_expect(wfull_s + 8 * q.i, bytes);
                  bulk_load(ring_s + q.i * a.stage_bytes, wsrc, bytes, wfull_s + 8 * q.i);
                }
                wsrc += bytes;
              }
            }
            if (issued <= lead)  // fewer weight stages in the group than the lead
              send_slab(&x_map, slab_s, slab_bytes, box_bytes, bar_s, bar_s + 16, sl, a.nslab,
                        (a.cg * b) & ~7, tl, KC8, leader);
          }
        }
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int g = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const bool wg_leader = (threadIdx.x & 127) == 0;
    const unsigned ring_a = su32(ring), hidden_a = su32(hidden), wempty_a = su32(wempty);
    float hid[S][CW / 2];
    uint32_t afr[S][CW / 16][4];  // !SPLIT: the rounded hidden as register-A fragments
    float acc[S][NW / 2];
    RingPos q, sl;
    int pend = -1;   // the ring stage of the last committed products, not yet released
    unsigned hb = 0;  // SPLIT: the hidden buffer of the next chunk
    for (int tile = blockIdx.x; tile < a.total; tile += gridDim.x) {
      const FfnTile tl = ffn_tile<PACKED, MS>(a, tile);
      // The tile's work sits in a loop of one trip whose count the compiler
      // cannot see (a.one = 1), here and in the producer: ptxas then
      // schedules the main loop so that stage 0 runs ~6% faster than without
      // it (PERF.md); the loop does nothing else.
      for (int once = 0; once < a.one; ++once) {
        for (int b = 0; b < a.G; ++b, sl.next(a.nslab)) {
          const int sb = sl.i;
          mbar_wait(&slab_full[sb], sl.ph);
          const unsigned slab_a = su32(slabs + (size_t)sb * slab_bytes) + tl.b0 * 16;
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
                    const int pos = (SPLIT ? 0 : g * S + s) * STEP + dy * P + dx;
                    conv_mma(cw, hid[s],
                             mat_desc(slab_a + pos * 16 + kc * 2 * SP * 16, SP * 16, 128), db,
                             tap | kc);
                  }
                }
              }
              wg_commit();
#pragma unroll
              for (int s = 0; s < S; ++s) pin_regs(hid[s]);
              wg_wait<1>();  // the products committed before these are done
              if (pend >= 0 && wg_leader) mbar_arrive(wempty_a + 8 * pend);
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
              mbar_arrive(wempty_a + 8 * pend);
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
                      afr[s][kk][2 * jj + h] =
                          pack_bf16x2(gelu_to_bf16(hid[s][r] + bias[jj][0], a.act),
                                      gelu_to_bf16(hid[s][r + 1] + bias[jj][1], a.act));
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
                  *reinterpret_cast<uint32_t*>(hbuf + ((g * cw / 8 + j) * 64 + p) * 16 +
                                               4 * (lane & 3)) =
                      pack_bf16x2(gelu_to_bf16(hid[0][r] + bias0, a.act),
                                  gelu_to_bf16(hid[0][r + 1] + bias1, a.act));
                }
              }
              fence_async_shared();  // the writes, visible to wgmma
              ffn_consumers_sync();  // both halves of the chunk are in hbuf
              // acc += chunk @ w2 rows of this warpgroup's output channels,
              // in WP ring slots of nk / WP k16 steps each
              const unsigned ha = hidden_a + hb * kHidBytes;
              const int nkp = nk / WP;
              for (int h = 0; h < HALVES; ++h)
                for (int p = 0; p < WP; ++p, q.next(a.nst)) {
                  const int st = q.i;
                  mbar_wait(&wfull[st], q.ph);
                  if (h != g) {  // the other warpgroup's slot
                    if (wg_leader) mbar_arrive(wempty_a + 8 * st);
                    continue;
                  }
                  wg_fence();
                  pin_regs(acc[0]);
                  const unsigned b0 = ring_a + st * a.stage_bytes;
#pragma unroll
                  for (int kl = 0; kl < FC / 16 / WP; ++kl) {
                    if (kl >= nkp) break;
                    const int kk = p * nkp + kl;
                    Wgmma<NW>::mma(acc[0], mat_desc(ha + kk * 2 * 64 * 16, 64 * 16, 128),
                                   mat_desc(b0 + kl * 2 * NW * 16, NW * 16, 128),
                                   (b | c | kk) != 0);
                  }
                  wg_commit();
                  pin_regs(acc[0]);
                  if (p > 0) {  // the slot before is done once this one is in flight
                    wg_wait<1>();
                    pin_regs(acc[0]);
                    if (wg_leader) mbar_arrive(wempty_a + 8 * pend);
                  }
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
        if (pend >= 0 && wg_leader) mbar_arrive(wempty_a + 8 * pend);
        pend = -1;

        // epilogue: + b2, one rounding; position p of sub-tile s is band
        // position f = b0 + s step + p of the tile's rows, stored where it
        // is a live column of the image
        if constexpr (SPLIT) {
          // from registers: lanes 4i .. 4i + 3 write one position's 16
          // contiguous bytes an 8-channel column
          {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int f = tl.b0 + 16 * wq + lane / 4 + 8 * h, yy = f / P, col = f - yy * P;
              const int gy = tl.y0 + yy, gx = tl.x0 + col;
              if (col >= a.Wc || gx >= a.W || gy >= a.H) continue;
              bf16* orow = a.out + ((size_t)(tl.n * a.H + gy) * a.W + gx) * a.C;
#pragma unroll
              for (int j = 0; j < NW / 8; ++j) {
                const int ch = g * NW + 8 * j + 2 * (lane & 3);
                if (ch >= a.C) continue;
                *reinterpret_cast<uint32_t*>(orow + ch) =
                    pack_bf16x2(acc[0][4 * j + 2 * h] + __bfloat162float(a.b2[ch]),
                                acc[0][4 * j + 2 * h + 1] + __bfloat162float(a.b2[ch + 1]));
              }
            }
          }
        } else {
          // the tile staged in shared memory (position r = 64 s + p at r *
          // pitch), then 16-byte stores along the positions' channels
          const int pitch = 2 * NO + 16;
          ffn_consumers_sync();  // the previous tile's stores are done with otile
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned char* row =
                  otile + (size_t)(64 * (g * S + s) + 16 * wq + lane / 4 + 8 * h) * pitch;
#pragma unroll
              for (int j = 0; j < NW / 8; ++j) {
                const int ch = 8 * j + 2 * (lane & 3);
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
          for (int e = threadIdx.x; e < MS * 64 * cv; e += kConsumers) {
            const int r = e / cv, v = e % cv;
            const int f = tl.b0 + (r >> 6) * STEP + (r & 63), yy = f / P, col = f - yy * P;
            const int gy = tl.y0 + yy, gx = tl.x0 + col;
            if (col >= a.Wc || gx >= a.W || gy >= a.H) continue;
            *reinterpret_cast<uint4*>(a.out + ((size_t)(tl.n * a.H + gy) * a.W + gx) * a.C +
                                      8 * v) =
                *reinterpret_cast<const uint4*>(otile + (size_t)r * pitch + 16 * v);
          }
        }
      }
    }
  }
}

// The plan (group_conv.ffn_plan) checked against what this instantiation
// reads: the slab holds every live position's taps, the boxes and shared
// memory fit.
template <int S, int NW, bool SPLIT, bool PACKED>
int launch_ffn(const bf16* x, FfnArgs a, int N, cudaStream_t s) {
  constexpr int MS = ffn_subtiles(S, SPLIT), FC = SPLIT ? kFCS : kFC, NO = (SPLIT ? 2 : 1) * NW;
  constexpr unsigned hidden_bytes = SPLIT ? 64 * FC * 2 : 0;
  if (a.nb < 1 || a.Wc < 1 || a.nb * a.Wc < a.W || (a.nb - 1) * a.Wc >= a.W ||
      a.P != a.Wc + 2 || a.P > 256 || a.rows > 256 ||
      a.step != (PACKED ? 64 : kRowPos) || (!PACKED && a.Wc != 64) || a.span != MS * a.step)
    return (int)cudaErrorInvalidValue;
  const int b0max = a.step == 64 ? a.P - 1 : 0;
  if ((b0max + a.span - 1) / a.P + 3 > a.rows) return (int)cudaErrorInvalidValue;
  a.SP = (a.rows * a.P + 7) / 8 * 8;
  const long long tiles = (long long)a.nb * (((long long)(a.H - 1) * a.P + a.Wc + a.span - 1) / a.span);
  if ((long long)N * tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.total = N * a.tiles;
  a.one = 1;
  // one slab buffer: the ring holds at least a chunk's w2 slots, which go
  // ahead of the next group's slab (the producer's lead is not negative)
  if (!(a.tps == 1 || a.tps == 3 || a.tps == 9) || a.nslab < 1 || a.nslab > 2 || a.nst < 2 ||
      a.nst > kMaxStages || (a.nslab == 1 && a.nst < (SPLIT ? 4 : 1)))
    return (int)cudaErrorInvalidValue;
  a.stage_bytes = (unsigned)std::max(a.tps * a.Kp * FC * 2, FC * NW * 2 / (SPLIT ? 2 : 1));
  const size_t smem =
      ffn_smem(MS, NO, a.Kp, a.SP, a.nslab, a.nst, a.stage_bytes, hidden_bytes, SPLIT);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  int e = nhwc_box_map(&map, x, N, a.H, a.W, a.C, a.P, a.rows);
  if (e) return e;
  auto kern = group_ffn_wgmma_kernel<S, NW, SPLIT, PACKED>;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    e = set_smem(kern, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  const int sms = sm_count();
  kern<<<a.total < sms ? a.total : sms, kFfnThreads, smem, s>>>(map, a);
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

#define VMG_FFN_CASE(C, S, NW, SPLIT)                                              \
  case C:                                                                          \
    return a.step == 64 ? launch_ffn<S, NW, SPLIT, true>(x, a, N, s)               \
                        : launch_ffn<S, NW, SPLIT, false>(x, a, N, s);

inline int ffn_bf16(const bf16* x, FfnArgs a, int N, cudaStream_t s) {
  if (a.C > 224) {
    switch (ffn_out_width(a.C)) {
      VMG_FFN_CASE(128, 1, 128, true)
      VMG_FFN_CASE(144, 1, 144, true)
      VMG_FFN_CASE(160, 1, 160, true)
      VMG_FFN_CASE(176, 1, 176, true)
      VMG_FFN_CASE(192, 1, 192, true)
      VMG_FFN_CASE(208, 1, 208, true)
      VMG_FFN_CASE(224, 1, 224, true)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (a.C) {
    VMG_FFN_CASE(16, 2, 16, false)
    VMG_FFN_CASE(32, 2, 32, false)
    VMG_FFN_CASE(48, 2, 48, false)
    VMG_FFN_CASE(64, 2, 64, false)
    VMG_FFN_CASE(80, 2, 80, false)
    VMG_FFN_CASE(96, 2, 96, false)
    VMG_FFN_CASE(112, 2, 112, false)
    VMG_FFN_CASE(128, 1, 128, false)
    VMG_FFN_CASE(144, 1, 144, false)
    VMG_FFN_CASE(160, 1, 160, false)
    VMG_FFN_CASE(176, 1, 176, false)
    VMG_FFN_CASE(192, 1, 192, false)
    VMG_FFN_CASE(208, 1, 208, false)
    VMG_FFN_CASE(224, 1, 224, false)
    default: return (int)cudaErrorInvalidValue;
  }
}

#undef VMG_FFN_CASE

// ---- f32: 3xTF32 on wgmma, the bf16 kernel's walk ---------------------------

// Hidden features a chunk of the f32 kernel (group_conv.tf32_chunk): 48, and
// 32 where the output accumulator (NW / 2 registers a thread) is wider than
// 144 channels, so that it, the chunk's conv and its split fragments fit.
__host__ __device__ constexpr int tf32_chunk(int NW) { return NW <= 144 ? 48 : 32; }
// Conv k8 steps a commit group (group_conv.tf32_kgroup): 4 where the output
// accumulator leaves registers for two sets of four steps' fragments, else 2.
__host__ __device__ constexpr int tf32_kgroup(int NW) { return NW <= 112 ? 4 : 2; }

struct FfnTfArgs {
  const float* w;   // the weight stream (pack_ffn_weights), in walk order
  const float* b1;  // (G * fgp,)
  const float* b2;  // (C,)
  float* out;       // (N, H, W, C)
  int H, W, C, G, cg, Kp, fgp, act;
  // geometry (group_conv.ffn_tf32_plan): FfnArgs', always at run time, two
  // m64 sub-tiles a tile (one a consumer warpgroup)
  int nb, Wc, P, step, span, rows, SP;
  int halves;         // output halves: above C = 224 each tile runs once per half
  int tiles, total;   // tiles per frame; in all (N x tiles x halves)
  int kcs, kps;       // conv / projection k8 steps a ring slot
  int nslab, nst;     // slab buffers, ring slots
  unsigned stage_bytes;
};

// the conv of cw hidden features (8 .. 48) into the first cw / 2 registers of d
template <int R>
__device__ __forceinline__ void conv_tf32(int cw, float (&d)[R], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
#define VMG_CONV_TF32(N)                                                                \
  if constexpr (R >= N / 2) {                                                           \
    if (cw == N) {                                                                      \
      WgmmaTF32<N>::mma(*reinterpret_cast<float(*)[N / 2]>(&d[0]), a, db, scale_d);     \
      return;                                                                           \
    }                                                                                   \
  }
  VMG_CONV_TF32(48)
  VMG_CONV_TF32(40)
  VMG_CONV_TF32(32)
  VMG_CONV_TF32(24)
  VMG_CONV_TF32(16)
  VMG_CONV_TF32(8)
#undef VMG_CONV_TF32
}

// One launch, the bf16 kernel's producer / consumer walk on f32 operands,
// every product as three TF32 products (a_hi b_hi + a_hi b_lo + a_lo b_hi,
// wgmma.h: tf32_split).  Per tile of two m64 sub-tiles, warpgroup g owns
// sub-tile g and the NW output channels of the tile's half; per group b,
// hidden chunk c:
// * the conv, KB k8 steps a commit group (k8 step j: tap j / KS, slab box j
//   % KS of 8 channels): each thread reads its A fragments from the raw f32
//   slab (a float2 per row, channels 2 (lane % 4) and + 1 of the box: the
//   stream orders every k8 step's B rows 0, 2, 4, 6, 1, 3, 5, 7 to match),
//   splits them in registers, and issues each step's three products
//   against its hi and lo B images; the groups' fragments alternate between
//   two register sets, so one group's products run while the next group's
//   fragments are read;
// * b1 and GELU in f32 (common.cuh's accurate erf / tanh forms), the hidden
//   split into register-A fragments: accumulator registers (4 j + e, 4 j +
//   2 + e) are features 8 j + 2 (lane % 4) + e, which is k position
//   lane % 4 (+ 4 for e = 1) of the projection's k8 step j under the same
//   row order, so no shuffle;
// * the projection: three products a k8 step into the f32 accumulator.
// Ring slots hold kcs conv or kps projection k8 steps, each as its hi then
// its lo image; a slot is released once the products after it were issued
// and the ones reading it are done (wgmma.wait_group 1).  Every sum runs in
// one fixed order: two runs are bit-equal.
template <int NW>
__global__ void __launch_bounds__(kFfnThreads, 1)
group_ffn_tf32_kernel(const __grid_constant__ CUtensorMap x_map, const FfnTfArgs a) {
  constexpr int FC = tf32_chunk(NW), NK = FC / 8, KB = tf32_kgroup(NW);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const int KS = a.Kp / 8, nkc = 9 * KS;  // slab boxes; conv k8 steps a chunk
  const unsigned slab_bytes = (unsigned)KS * a.SP * 32;
  unsigned char* slabs = base;
  unsigned char* ring = slabs + (size_t)a.nslab * slab_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)a.nst * a.stage_bytes);
  uint64_t *slab_full = bars, *slab_empty = bars + 2, *wfull = bars + 4,
           *wempty = bars + 4 + kMaxStages;
  const int nchunks = (a.fgp + FC - 1) / FC;

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
    // ---- producer: as the bf16 kernel's; with one slab buffer the next
    // group's first stages go ahead of its slab, as many as the ring holds
    // beside a chunk's projection stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x < kConsumers + 32) {
      const bool leader = (threadIdx.x & 31) == 0;
      const int lead = a.nslab == 1 ? a.nst - (NK + a.kps - 1) / a.kps : 0;
      const unsigned box_bytes = (unsigned)a.rows * a.P * 32;
      const unsigned slab_s = su32(slabs), ring_s = su32(ring), bar_s = su32(bars);
      const unsigned wfull_s = bar_s + 32, wempty_s = bar_s + 32 + 8 * kMaxStages;
      RingPos q, sl;
      for (int tile = blockIdx.x; tile < a.total; tile += gridDim.x) {
        const FfnTile tl = ffn_tile<true, 2>(a, tile / a.halves);
        const int oh = tile % a.halves;
        const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(a.w);
        for (int b = 0; b < a.G; ++b) {
          int issued = 0;
          auto stage = [&](unsigned bytes) {
            if (issued == lead)
              send_slab(&x_map, slab_s, slab_bytes, box_bytes, bar_s, bar_s + 16, sl, a.nslab,
                        (a.cg * b) & ~3, tl, KS, leader);
            mbar_wait(wempty_s + 8 * q.i, q.ph ^ 1);
            if (leader) {
              mbar_expect(wfull_s + 8 * q.i, bytes);
              bulk_load(ring_s + q.i * a.stage_bytes, wsrc, bytes, wfull_s + 8 * q.i);
            }
            wsrc += bytes;
            ++issued;
            q.next(a.nst);
          };
          for (int c = 0; c < nchunks; ++c) {
            const int fcw = min(FC, a.fgp - c * FC), nk = fcw / 8;
            for (int j = 0; j < nkc; j += a.kcs) stage((unsigned)(min(a.kcs, nkc - j) * 64 * fcw));
            wsrc += (size_t)oh * nk * 64 * NW;  // the other half's projection rows
            for (int j = 0; j < nk; j += a.kps) stage((unsigned)(min(a.kps, nk - j) * 64 * NW));
            wsrc += (size_t)(a.halves - 1 - oh) * nk * 64 * NW;
          }
          if (issued <= lead)  // fewer weight stages in the group than the lead
            send_slab(&x_map, slab_s, slab_bytes, box_bytes, bar_s, bar_s + 16, sl, a.nslab,
                      (a.cg * b) & ~3, tl, KS, leader);
        }
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int g = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t4 = lane & 3, r = 16 * wq + (lane >> 2);  // fragment column pair, row
    const bool wg_leader = (threadIdx.x & 127) == 0;
    const unsigned ring_a = su32(ring), wempty_a = su32(wempty);
    float hid[FC / 2];
    uint32_t hA[NK][4], lA[NK][4];  // the chunk's hidden, split, as register-A fragments
    uint32_t xh0[KB][4], xl0[KB][4], xh1[KB][4], xl1[KB][4];  // the conv's A fragments, two sets
    float acc[NW / 2];
    RingPos q, sl;
    int pend = -1;  // the ring slot of the last issued products, not yet released
    // after products in `slot` were issued and all before them are done
    auto release = [&](int slot) {
      if (pend >= 0 && pend != slot && wg_leader) mbar_arrive(wempty_a + 8 * pend);
      pend = slot;
    };
    for (int tile = blockIdx.x; tile < a.total; tile += gridDim.x) {
      const FfnTile tl = ffn_tile<true, 2>(a, tile / a.halves);
      const int oh = tile % a.halves;
      for (int b = 0; b < a.G; ++b, sl.next(a.nslab)) {
        const int sb = sl.i;
        mbar_wait(&slab_full[sb], sl.ph);
        // this thread's row r of sub-tile g at tap (0, 0), its column pair
        const float* xs = reinterpret_cast<const float*>(slabs + (size_t)sb * slab_bytes) +
                          (size_t)(tl.b0 + g * a.step + r) * 8 + 2 * t4;
        for (int c = 0; c < nchunks; ++c) {
          const int fcw = min(FC, a.fgp - c * FC), nk = fcw / 8;
          // conv k8 steps j0 .. j0 + KB - 1 (those below nkc) into hid, their
          // fragments in (xh, xl); a slot holds a whole number of groups
          auto conv_group = [&](int j0, uint32_t(&xh)[KB][4], uint32_t(&xl)[KB][4]) {
            const int js = j0 % a.kcs;
            if (js == 0) {
              if (j0 > 0) q.next(a.nst);
              mbar_wait(&wfull[q.i], q.ph);
            }
#pragma unroll
            for (int u = 0; u < KB; ++u) {
              const int j = j0 + u;
              if (j >= nkc) break;
              const int tap = j / KS, kc = j - tap * KS, dy = tap / 3, dx = tap - 3 * dy;
              const float* src = xs + ((size_t)kc * a.SP + dy * a.P + dx) * 8;
              const float2 v0 = *reinterpret_cast<const float2*>(src);
              const float2 v1 = *reinterpret_cast<const float2*>(src + 64);  // row r + 8
              tf32_split(v0.x, xh[u][0], xl[u][0]);
              tf32_split(v1.x, xh[u][1], xl[u][1]);
              tf32_split(v0.y, xh[u][2], xl[u][2]);
              tf32_split(v1.y, xh[u][3], xl[u][3]);
            }
            wg_fence();
            pin_regs(hid);
#pragma unroll
            for (int u = 0; u < KB; ++u) {
              const int j = j0 + u;
              if (j >= nkc) break;
              const unsigned bh = ring_a + q.i * a.stage_bytes + (js + u) * 64 * fcw;
              const uint64_t dh = mat_desc(bh, fcw * 16, 128);
              const uint64_t dl = mat_desc(bh + 32 * fcw, fcw * 16, 128);
              conv_tf32(fcw, hid, xh[u], dh, j);
              conv_tf32(fcw, hid, xh[u], dl, 1);
              conv_tf32(fcw, hid, xl[u], dh, 1);
            }
            wg_commit();
            pin_regs(hid);
            wg_wait<1>();
            release(q.i);
          };
          for (int j = 0; j < nkc; j += 2 * KB) {
            conv_group(j, xh0, xl0);
            if (j + KB < nkc) conv_group(j + KB, xh1, xl1);
          }
          q.next(a.nst);
          wg_wait<0>();
          pin_regs(hid);
          pin_regs(acc);
          if (wg_leader) {
            mbar_arrive(wempty_a + 8 * pend);
            if (c == nchunks - 1) mbar_arrive(&slab_empty[sb]);  // the group's convs are done
          }
          pend = -1;
          // bias, GELU in f32, split: registers 4 kk + 2 h + e of hid are row
          // r + 8 h, feature 8 kk + 2 t4 + e of the chunk
          const float* b1c = a.b1 + (size_t)b * a.fgp + c * FC + 2 * t4;
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            if (kk >= nk) break;
            const float2 bias = *reinterpret_cast<const float2*>(b1c + 8 * kk);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              tf32_split(gelu(hid[4 * kk + 2 * h] + bias.x, a.act), hA[kk][h], lA[kk][h]);
              tf32_split(gelu(hid[4 * kk + 2 * h + 1] + bias.y, a.act), hA[kk][2 + h],
                         lA[kk][2 + h]);
            }
          }
          // acc += hidden @ w2 chunk rows of this half, kps k8 steps a slot
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            if (kk >= nk) break;
            const int ks = kk % a.kps;
            if (ks == 0) {
              if (kk > 0) {
                wg_commit();
                pin_regs(acc);
                wg_wait<1>();
                release(q.i);
                q.next(a.nst);
              }
              mbar_wait(&wfull[q.i], q.ph);
              wg_fence();
              pin_regs(acc);
            }
            const unsigned bh = ring_a + q.i * a.stage_bytes + ks * 64 * NW;
            const uint64_t dh = mat_desc(bh, NW * 16, 128);
            const uint64_t dl = mat_desc(bh + 32 * NW, NW * 16, 128);
            WgmmaTF32<NW>::mma(acc, hA[kk], dh, (b | c | kk) != 0);
            WgmmaTF32<NW>::mma(acc, hA[kk], dl, 1);
            WgmmaTF32<NW>::mma(acc, lA[kk], dh, 1);
          }
          wg_commit();
          pin_regs(acc);
          wg_wait<1>();
          release(q.i);
          q.next(a.nst);
        }
      }
      wg_wait<0>();
      pin_regs(acc);
      if (pend >= 0 && wg_leader) mbar_arrive(wempty_a + 8 * pend);
      pend = -1;

      // epilogue: + b2; position f of the band's rows, stored where it is a
      // live column of the image; lanes 4i .. 4i + 3 write 32 contiguous
      // bytes an 8-channel column
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = tl.b0 + g * a.step + r + 8 * h, yy = f / a.P, col = f - yy * a.P;
        const int gy = tl.y0 + yy, gx = tl.x0 + col;
        if (col >= a.Wc || gx >= a.W || gy >= a.H) continue;
        float* orow = a.out + ((size_t)(tl.n * a.H + gy) * a.W + gx) * a.C + oh * NW;
        const float* b2 = a.b2 + oh * NW;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int ch = 8 * j + 2 * t4;
          if (oh * NW + ch >= a.C) continue;
          const float2 bb = *reinterpret_cast<const float2*>(b2 + ch);
          *reinterpret_cast<float2*>(orow + ch) =
              make_float2(acc[4 * j + 2 * h] + bb.x, acc[4 * j + 2 * h + 1] + bb.y);
        }
      }
    }
  }
}

// The plan (group_conv.ffn_tf32_plan) checked against what the kernel reads.
template <int NW>
int launch_ffn_tf32(const float* x, FfnTfArgs a, int N, cudaStream_t s) {
  constexpr int FC = tf32_chunk(NW), NK = FC / 8, KB = tf32_kgroup(NW);
  if (a.nb < 1 || a.Wc < 1 || a.nb * a.Wc < a.W || (a.nb - 1) * a.Wc >= a.W ||
      a.P != a.Wc + 2 || a.P > 256 || a.rows > 256 || a.step != (a.Wc == 64 ? a.P : 64) ||
      a.span != 2 * a.step)
    return (int)cudaErrorInvalidValue;
  const int b0max = a.step == 64 ? a.P - 1 : 0;
  if ((b0max + a.span - 1) / a.P + 3 > a.rows) return (int)cudaErrorInvalidValue;
  a.SP = (a.rows * a.P + 7) / 8 * 8;
  const long long tiles = (long long)a.nb * (((long long)(a.H - 1) * a.P + a.Wc + a.span - 1) / a.span);
  if ((long long)N * tiles * a.halves > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.total = N * a.tiles * a.halves;
  // one slab buffer: the producer's lead is not negative
  if (a.kcs < KB || a.kcs % KB != 0 || a.kps < 1 || a.kps > NK || a.nslab < 1 || a.nslab > 2 || a.nst < 2 ||
      a.nst > kMaxStages || (a.nslab == 1 && a.nst < (NK + a.kps - 1) / a.kps))
    return (int)cudaErrorInvalidValue;
  a.stage_bytes = (unsigned)std::max(a.kcs * 64 * FC, a.kps * 64 * NW);
  const size_t smem = 128 + (size_t)a.nslab * (a.Kp / 8) * a.SP * 32 +
                      (size_t)a.nst * a.stage_bytes + 256;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  int e = nhwc_box_map(&map, x, N, a.H, a.W, a.C, a.P, a.rows, 8, true);
  if (e) return e;
  auto kern = group_ffn_tf32_kernel<NW>;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    e = set_smem(kern, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  const int sms = sm_count();
  kern<<<a.total < sms ? a.total : sms, kFfnThreads, smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

// K rows per tap in f32: group b's slab starts at channel (cg b) rounded
// down to 4 (16 bytes), its channels at offset (cg b) % 4; K covers the
// largest offset plus cg, rounded up to 8 (group_conv.slab_depth).
inline int ffn_slab_depth_f32(int cg, int G) {
  int off = 0;
  for (int b = 0; b < G; ++b) off = std::max(off, (cg * b) % 4);
  return (cg + off + 7) / 8 * 8;
}

inline int ffn_f32(const float* x, FfnTfArgs a, int N, cudaStream_t s) {
  switch (ffn_out_width(a.C)) {
    case 16: return launch_ffn_tf32<16>(x, a, N, s);
    case 32: return launch_ffn_tf32<32>(x, a, N, s);
    case 48: return launch_ffn_tf32<48>(x, a, N, s);
    case 64: return launch_ffn_tf32<64>(x, a, N, s);
    case 80: return launch_ffn_tf32<80>(x, a, N, s);
    case 96: return launch_ffn_tf32<96>(x, a, N, s);
    case 112: return launch_ffn_tf32<112>(x, a, N, s);
    case 128: return launch_ffn_tf32<128>(x, a, N, s);
    case 144: return launch_ffn_tf32<144>(x, a, N, s);
    case 160: return launch_ffn_tf32<160>(x, a, N, s);
    case 176: return launch_ffn_tf32<176>(x, a, N, s);
    case 192: return launch_ffn_tf32<192>(x, a, N, s);
    case 208: return launch_ffn_tf32<208>(x, a, N, s);
    case 224: return launch_ffn_tf32<224>(x, a, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace vmg

// x, out: (N, H, W, C); w: the weight stream of pack_ffn_weights in x's
// dtype (its layout follows ffn_out_width); b1 (G * fgp,), b2 (C,); fgp the
// hidden features per group (bf16: padded to a multiple of 16, 32 above C =
// 224; f32: 8).  plan: bf16 group_conv.ffn_plan_ints (nb, Wc, P, step, span,
// rows, tps, nslab, nst), f32 ffn_tf32_plan's (nb, Wc, P, step, span, rows,
// kcs, kps, nslab, nst; kcs a multiple of tf32_kgroup); the entry point
// checks it.
extern "C" int vmg_group_ffn(const void* x, const void* w, const void* b1, const void* b2,
                             void* out, int N, int H, int W, int C, int G, int fgp, int act,
                             const int* plan, int dtype, void* stream) {
  if (C % 16 != 0 || G < 1 || C % G != 0 || C > 448 || N < 1 || H < 1 || W < 1 || N > 65535 ||
      fgp < 1 || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (plan == nullptr || fgp % (C > 224 ? 32 : 16) != 0 || (uintptr_t)x % 16 ||
        (uintptr_t)w % 16 || (uintptr_t)out % 16)
      return (int)cudaErrorInvalidValue;
    vmg::FfnArgs a = {};
    a.w = (const vmg::bf16*)w, a.b1 = (const vmg::bf16*)b1, a.b2 = (const vmg::bf16*)b2;
    a.out = (vmg::bf16*)out;
    a.H = H, a.W = W, a.C = C, a.G = G, a.cg = C / G, a.Kp = vmg::ffn_slab_depth(C / G, G);
    a.fgp = fgp, a.act = act;
    a.nb = plan[0], a.Wc = plan[1], a.P = plan[2], a.step = plan[3], a.span = plan[4];
    a.rows = plan[5], a.tps = plan[6], a.nslab = plan[7], a.nst = plan[8];
    return vmg::ffn_bf16((const vmg::bf16*)x, a, N, s);
  }
  if (dtype != 0 || plan == nullptr || fgp % 8 != 0 || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)out % 8)
    return (int)cudaErrorInvalidValue;
  vmg::FfnTfArgs t = {};
  t.w = (const float*)w, t.b1 = (const float*)b1, t.b2 = (const float*)b2, t.out = (float*)out;
  t.H = H, t.W = W, t.C = C, t.G = G, t.cg = C / G, t.Kp = vmg::ffn_slab_depth_f32(C / G, G);
  t.fgp = fgp, t.act = act, t.halves = C > 224 ? 2 : 1;
  t.nb = plan[0], t.Wc = plan[1], t.P = plan[2], t.step = plan[3], t.span = plan[4];
  t.rows = plan[5], t.kcs = plan[6], t.kps = plan[7], t.nslab = plan[8], t.nst = plan[9];
  return vmg::ffn_f32((const float*)x, t, N, s);
}

extern "C" const char* vmg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
