// MorphFC-decay mixer kernels: the two axis branches with the reweight
// sums, the reweight reduction, and the combine pass.
//
// vmg_morphfc_axes replaces vmg_tpu/ops/morphfc_fused.py
// `fused_morphfc_axes` in its big form (`_axes_kernel`, chunk * C <= 1024):
// both decayed axis-FC branches, relu(acc + b) / C rounded once to the input
// dtype, and the f32 per-frame sums of h + w + c from the unrounded
// branch values.  Two run-time options of the TPU kernel reach every axes
// kernel here as they reach it (`non_linear`, `bh_raw=None`): relu == 0
// drops the epilogue's ReLU -- in the big form a template argument (RELU:
// both a branch and a floor parameter held one more register there and
// spilled 250 more bytes at C = 112), in the token forms max(acc + b,
// floor) with the floor a parameter, 0 or -inf (a NaN then ends as -inf, as
// the relu form's ends as 0) -- and null bias pointers (qkv_bias off) skip
// the bias loads from device memory: the big form zero-fills its shared
// bias rows instead, the token forms add no bias.  A token is channel segment q (S = C / chunk channels) of
// a chunk of `chunk` positions along the axis, its C features (p, s); each
// branch is then a (tokens x C) @ (C x C) matmul with the decayed weight
// -- the TPU kernel's block-diagonal big matrix without its zero blocks,
// which on the TPU bought a transpose-free layout.  Bound on H100: device
// memory at the stage-0 shape (x and c read, h and w written: 844.2 MB and
// 0.252 ms at 16 x 184 x 320 x 112, against 47 GFLOP, 0.048 ms on the
// tensor cores).
// * bf16 (serving), morphfc_axes_wgmma_kernel (notes at the kernel):
//   persistent warpgroups over contiguous runs of slabs, both decayed
//   weights resident as wgmma B images staged once per block (50 KB at C =
//   112), x and c slabs by TMA into a ring (three slots a warpgroup at the
//   stage-0 shape), x read once for both branches, the token matrices
//   formed straight into register-A fragments, the epilogue on the
//   accumulator staged back into the slot and stored by TMA; per-walker
//   per-frame partial sums.  The wmma kernel this replaced ran one block
//   per 8 x 8 slab (14,720 at stage 0) that staged both weights from L2
//   (739 MB of L2 -> SM traffic a call), scattered the slab into shared
//   memory two bytes at a time, round-tripped the f32 product through
//   shared memory, read x twice and overlapped nothing: 5.3x its bound.
// * f32 (evaluation), the same kernel (F32): f32 slabs, each product as
//   three TF32 products on wgmma (3xTF32), each weight staged as its hi
//   and lo B images (100 KB at C = 112: H and W run as two passes).  The
//   scalar kernel this replaced (one block per slab, the weight and
//   tokens staged in shared memory, scalar FMAs) ran at 0.10 of its f32
//   bound and lost to the 'hybrid' form.
// Each writes one f32 partial per (frame, walker) and channel, summed in
// a fixed order; morphfc_final_kernel adds the partials in a fixed order
// -- deterministic, no float atomics.
//
// vmg_morphfc_axes_token replaces the token form of the same call
// (`_axes_kernel_token`, chosen where chunk * C > 1024: stages 1/5 at C =
// 224, chunk 16, and stage 3 at C = 448, chunk 8): the same function and
// token maps.  What bounds it: shared memory first -- one C x C weight is
// 100 KB at C = 224 and 392 KB at 448, so the big form's two resident
// weights do not fit; then device memory (at stage 1 x and c in, h and w
// out: 422 MB against 47 GFLOP).
// * bf16 (serving), morphfc_axes_token_wgmma_kernel (notes at the kernel):
//   the big form's persistent design with the weight in column tiles --
//   units of 64 tokens of one branch by TMA, register-A token fragments,
//   wgmma against one weight's B image (resident up to C = 224, else
//   streamed in C x NT tiles by the first warpgroup's first warp, each
//   tile shared by both consumer warpgroups), the epilogue staged in place and
//   stored by TMA; one tile's accumulator a thread.  Three more launches: the B images (pack),
//   c's partial sums (the reduce's first pass) and the sums pass.  The
//   wmma kernel this replaced ran one 256-thread block per slab, gathered
//   the tokens two bytes at a time, re-staged the whole weight from L2 per
//   slab with cp.async and round-tripped the f32 product through shared
//   memory: 10x (stage 1) and 23x (stage 3) its bound.
// * f32 (evaluation), morphfc_axes_token_tf32_kernel (notes at the kernel):
//   the bf16 kernel's units and walk on f32 units, every product as three
//   TF32 products on wgmma against each weight's hi and lo B images (the
//   same pack launch, the same column order), streamed in stages of a few
//   k8 steps of a column tile and shared by both consumer warpgroups (each
//   with its own units up to C = 336; above, both on one unit, each with
//   half of its column tiles); token fragments formed from the raw f32
//   unit a k8 step at a time and split in registers; the output stored
//   from the accumulator.  Bound: the tensor cores at the 3xTF32 rate
//   (0.287 ms at stage 1/5, 0.072 ms at stage 3).  The scalar kernel this
//   replaced (one block per slab, tokens scattered into shared memory a
//   float at a time, the weight from L2 for every 32 token rows, scalar
//   FMAs on two shared loads) ran at 0.077 / 0.056 of its f32-FMA bound and
//   lost 2.3-4.5x to the 'hybrid' form.
//
// vmg_morphfc_reduce replaces `fused_morphfc_reduce` (`_reduce_kernel`):
// psum[n, c] = sum over the frame's pixels of (h + w + c) in f32.  Bound on
// H100: device-memory bandwidth (3 reads, no compute; 316.6 MB, 0.0945 ms
// at stage 1/5).  The TPU kernel carried the sum across its sequential
// grid; here blocks run in parallel, so pass 1 (morphfc_partial_kernel,
// notes at the kernel: 16-byte loads, every lane live, 12 loads in flight
// a thread, a grid of at least two blocks an SM) writes one f32 partial per
// (frame, pixel slice) and pass 2 adds the slices in a fixed order.
//
// vmg_morphfc_combine replaces `fused_morphfc_combine` (`_combine_body`,
// `_combine_kernel`, `_combine_res_kernel`): y = a0*h + a1*w + a2*c in the
// input dtype, p = round(y @ Pk + pb) to the input dtype, out = (x + p) *
// gate(p), optionally res + s * out.  A nullable residual pointer covers
// both TPU variants.  The gate, act: 0 tanh(p), 1 sigmoid(p) - 0.5, 2
// relu(p), a template argument; in bf16 it rounds where the TPU kernel's
// gate in the output dtype does (the sigmoid, then the subtraction).
// Bound on H100: device memory.  bf16 reads x, h, w, c, res and writes out,
// 12 bytes an element, against 2C FLOP on the tensor cores: 1.27 GB and
// 0.378 ms at stage 0 (16 x 184 x 320 x 112), where the product alone
// would take 0.024 ms.  So the design keeps every byte moving in 16-byte
// units and the weights off the device-memory path:
// * bf16 (serving), morphfc_combine_wgmma_kernel (notes at the kernel):
//   persistent blocks of 1-3 consumer warpgroups, each walking its own
//   64-pixel tiles through its own ring of shared-memory slots; y formed
//   once, with the plain version's roundings, straight into wgmma
//   register-A fragments;
//   the product on wgmma m64nNk16 against the Pk image (packed once per
//   parameter state, pack_combine_weight), resident in shared memory up to
//   C = 224 (25 KB at 112, 41 KB at 144, 98 KB at 224), streamed through
//   the ring in C x 64 column tiles above (448: 392 KB does not fit); the
//   tiles staged by TMA in 64-channel boxes; the epilogue on the
//   accumulator fragments, out by TMA store.
//   The wmma kernel this replaced read Pk from L2 for every 32
//   pixels (0.74 GB a stage-0 call beside 1.27 GB of activations), moved
//   2 bytes a thread with an integer divide per element, round-tripped the
//   f32 product through shared memory and overlapped nothing.
// * f32 (evaluation), morphfc_combine_tf32_kernel (notes at the kernel):
//   the bf16 kernel's walk on 32-channel f32 units, y formed a K chunk at a
//   time and split into hi and lo register-A fragments, every product as
//   three TF32 products on wgmma against Pk's hi and lo B images (resident
//   up to C = 128, streamed a k8 step a unit above); work items of (64
//   pixels, N-tile), two N-tiles above C = 224.  Bound: device memory, 6
//   f32 tensors (0.2104 ms at the eval tile's 16 x 128 x 128 x 112).
// ptxas report: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -Xptxas -v -c vmg_tpu_torch/csrc/morphfc.cu.  For the combine's wgmma
// instantiations C7519 ("warpgroup.arrive is injected") and C7517
// ("warpgroup.wait is injected") lines are expected; only the streamed one
// (C > 224) spills, 36-52 bytes at 255 registers.  The f32 combine's
// instantiations use 89-222 registers with no spill and carry one C7520
// line each (their wgmma serialized; the cause is not found, PERF.md §7).  The bf16 axes kernel
// (launch bounds 256 x 1) holds the accumulator (C / 2), the fragments (C /
// 4) and the position sums (C / 2) a thread: no spill up to C = 96 (186-254
// registers), 72 bytes of spill stores at C = 112 (the path) at 255, more
// from C = 128 on (248 bytes at 128, 3,412 at 240; off every path).  A
// spill at C <= 224 is a regression: the biases loaded ahead of the x
// unit's wait spilled 200-400 bytes at C = 224 and ran slower.  The token
// kernel spills nothing: 195 registers at C = 224 chunk 16 and 234 at C =
// 448 chunk 8 (the compile-time instantiations, no C7519 line), 195-234 in
// the generic ones (33 C7519 lines each: a fence a guarded k-step); a
// spill in either compile-time instantiation is a regression.  The f32
// token kernel (part 4: -DVMG_MORPHFC_PART=4 -Dvmg=vmg_part4): 243
// registers at C = 224 chunk 16 and 193 at C = 448 chunk 8, 119-182 in the
// generic ones, no spill and no C75xx line; a C7513 / C7514 / C7520 line,
// or a WARPGROUP.DEPBAR after every HGMMA in `cuobjdump -sass`, means its
// products run one at a time (notes at the kernel) and is a regression.
// The reduce's first pass: 32-79 registers (3 blocks an SM), no spill.  Traps:
// a box in the 128-byte swizzle must start 1024-byte aligned in shared
// memory (the kernel traps if the dynamic base is not); a 64-channel box
// past C loads zeros and its store writes nothing there, which covers C =
// 112, 144 and 224; asm "memory" clobbers (mbarrier waits, barriers) keep
// the compiler from hoisting loads across them, so the branch weights are
// loaded before a unit's wait by hand.
#include "common.cuh"
#include "wgmma.cuh"

#include <algorithm>
#include <cmath>
#include <cstring>

namespace vmg {

// the combine's symmetric gate of p (ACT: 0 tanh, 1 sigmoid - 0.5, 2 relu),
// rounded through T as the plain version's ops in T round; a template
// argument, so each kernel's epilogue holds only its own gate
template <typename T, int ACT>
__device__ __forceinline__ float symm_gate(float p) {
  if constexpr (ACT == 1)
    return rnd<T>(rnd<T>(1.f / (1.f + expf(-p))) - 0.5f);
  else if constexpr (ACT == 2)
    return fmaxf(p, 0.f);
  else
    return rnd<T>(tanhf(p));
}

// ---- the reduce, pass 1: one f32 partial per (frame, pixel slice) ----------
//
// Bound: device memory (3 reads of (N, P, C), no arithmetic to speak of).
// Threads are (pixel lane j, channel vector v) with nv = C / VEC vectors a
// pixel of VEC channels in one 16-byte load (bf16 8, f32 4; a narrower
// vector where C or a pointer is not a 16-byte multiple): every thread is
// live at every width the presets use (nv = 14, 18, 28, 56 at C = 112,
// 144, 224, 448).  A block is one contiguous pixel slice of one frame; its
// lanes walk it kRedUnroll pixels at a time, each thread with three
// tensors x kRedUnroll independent loads (__ldg) in flight.  The slice count
// S comes from the wrapper (morphfc_fused.reduce_plan): at least two blocks
// per SM, a function of the shape and the SM count only, so the sums --
// per thread in pixel order, then the lanes in lane order through shared
// memory -- repeat bit for bit.  Where a pixel has more than kRedThreads
// vectors (odd C above 256, or a view off a 16-byte boundary at C = 448)
// a block is one lane whose threads walk vectors v, v + kRedThreads, ...
// and write their sums straight into the partial.  NTENS = 1 sums one
// tensor (the token form's c).  The 64 x 4-thread kernel this replaced kept
// 8 channel slots a thread at a stride of 64 (2 of them live at C = 112)
// and loaded 2 bytes at a time.
constexpr int kRedThreads = 256;
constexpr int kRedUnroll = 4;

template <int B> struct RawVec;  // B bytes in one load
template <> struct RawVec<16> { typedef uint4 t; };
template <> struct RawVec<8> { typedef uint2 t; };
template <> struct RawVec<4> { typedef unsigned t; };
template <> struct RawVec<2> { typedef unsigned short t; };

template <typename T, int VEC>
__device__ __forceinline__ void add_vec(float (&acc)[VEC],
                                        const typename RawVec<VEC * sizeof(T)>::t& r) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] += to_f<T>(e[k]);
}

template <typename T, int VEC, int NTENS>
__global__ void __launch_bounds__(kRedThreads, 3)
morphfc_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                       const T* __restrict__ c, float* __restrict__ partial,
                       int P, int C, int per, int stot, int soff) {
  typedef typename RawVec<VEC * sizeof(T)>::t R;
  __shared__ float red[kRedThreads * VEC];  // lanes x C <= kRedThreads * VEC (lanes >= 2)
  const int nv = C / VEC, lanes = max(1, kRedThreads / nv);
  const int n = blockIdx.y, s = blockIdx.x;
  const int j = threadIdx.x / nv, v0 = threadIdx.x - j * nv;
  const int p0 = s * per, p1 = min(P, p0 + per);
  float* prow = partial + ((size_t)n * stot + soff + s) * C;
  // one vector a thread, except in a one-lane block of more than kRedThreads vectors
  for (int v = v0; j < lanes && v < nv; v += kRedThreads) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    const size_t base = (size_t)n * P * nv + v;  // vector v of the frame's pixel 0
    const R* hv = reinterpret_cast<const R*>(h) + base;
    const R* wv = reinterpret_cast<const R*>(w) + base;
    const R* cv = reinterpret_cast<const R*>(c) + base;
    int p = p0 + j;
    for (; p + (kRedUnroll - 1) * lanes < p1; p += kRedUnroll * lanes) {
      R a[kRedUnroll], b[kRedUnroll], d[kRedUnroll];
#pragma unroll
      for (int u = 0; u < kRedUnroll; ++u) {
        const size_t i = (size_t)(p + u * lanes) * nv;
        a[u] = __ldg(hv + i);
        if (NTENS == 3) b[u] = __ldg(wv + i), d[u] = __ldg(cv + i);
      }
#pragma unroll
      for (int u = 0; u < kRedUnroll; ++u) {
        add_vec<T, VEC>(acc, a[u]);
        if (NTENS == 3) add_vec<T, VEC>(acc, b[u]), add_vec<T, VEC>(acc, d[u]);
      }
    }
    for (; p < p1; p += lanes) {
      const size_t i = (size_t)p * nv;
      add_vec<T, VEC>(acc, __ldg(hv + i));
      if (NTENS == 3) add_vec<T, VEC>(acc, __ldg(wv + i)), add_vec<T, VEC>(acc, __ldg(cv + i));
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (lanes == 1)
        prow[v * VEC + k] = acc[k];
      else
        red[j * C + v * VEC + k] = acc[k];
    }
  }
  if (lanes == 1) return;  // the whole block alike
  __syncthreads();
  for (int ch = threadIdx.x; ch < C; ch += kRedThreads) {
    float t = 0.f;
    for (int r = 0; r < lanes; ++r) t += red[r * C + ch];
    prow[ch] = t;
  }
}

// Launch pass 1 over (N, S) blocks: slices of `per` pixels, partial rows
// soff .. soff + S - 1 of (N, stot, C).  vec: channels a load.
template <typename T, int NTENS>
int launch_partial(const T* h, const T* w, const T* c, float* partial, int N, int P, int C,
                   int S, int per, int vec, int stot, int soff, cudaStream_t st) {
  const dim3 grid(S, N);
#define VMG_PARTIAL(V)                                                                       \
  morphfc_partial_kernel<T, V, NTENS><<<grid, kRedThreads, 0, st>>>(h, w, c, partial, P, C, \
                                                                     per, stot, soff)
  if (vec * (int)sizeof(T) == 16) VMG_PARTIAL(16 / sizeof(T));
  else if (vec * (int)sizeof(T) == 8) VMG_PARTIAL(8 / sizeof(T));
  else if (vec * (int)sizeof(T) == 4) VMG_PARTIAL(4 / sizeof(T));
  else if (std::is_same<T, bf16>::value && vec == 1) VMG_PARTIAL(1);
  else return (int)cudaErrorInvalidValue;
#undef VMG_PARTIAL
  return (int)cudaGetLastError();
}

// a reduce plan the kernel can run: C in vectors of vec, pointers aligned
// to a vector, S slices of per pixels covering P with none empty
inline bool partial_plan_ok(const void* const* ptrs, int nptr, int N, int P, int C, int S,
                            int per, int vec, int elem) {
  if (vec < 1 || vec * elem > 16 || (vec * elem) & (vec * elem - 1) || C < 1 || C % vec != 0 ||
      N < 1 || N > 65535 || P < 1 || S < 1 || per < 1 ||
      (long long)S * per < P || (long long)(S - 1) * per >= P)
    return false;
  for (int i = 0; i < nptr; ++i)
    if ((uintptr_t)ptrs[i] % (uintptr_t)(vec * elem) != 0) return false;
  return true;
}

// Pass 2 of the per-frame sums (reduce, both axes forms): out[n, c] = the
// sum over s of partial[n, s, c], in a fixed order -- warp w of a block
// adds s = w, w + 8, ... (lane = channel, reads coalesced), then the 8 warps'
// sums are added in warp order.  A block per (frame, 32 channels).
__global__ void __launch_bounds__(256)
morphfc_final_kernel(const float* __restrict__ partial, float* __restrict__ out, int C, int S) {
  __shared__ float red[8][32];
  const int n = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ch = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (ch < C)
    for (int s = w; s < S; s += 8) v += partial[((size_t)n * S + s) * C + ch];
  red[w][lane] = v;
  __syncthreads();
  if (threadIdx.x < 32 && ch < C) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][lane];
    out[(size_t)n * C + ch] = t;
  }
}

inline int launch_final(const float* partial, float* out, int N, int C, int S, cudaStream_t st) {
  morphfc_final_kernel<<<dim3((C + 31) / 32, N), 256, 0, st>>>(partial, out, C, S);
  return (int)cudaGetLastError();
}

// ---- bf16 (serving): persistent warpgroups, a TMA ring, wgmma ------------
//
// A tile is kCM = 64 pixels of one frame (a = (N, 3, C) is per frame), one
// m64 wgmma tile.  Each consumer warpgroup walks its own tiles and streams
// them through its own ring of `ring` slots as units, in the order it
// consumes them: h, w, c (in K chunks of KW channels), then per N-tile of
// NT output channels [the Pk tile,] and per column chunk of XW of its
// channels x, res.  Whole tensors up to C = 160; above, units of two boxes
// (128 channels, 16 KB) keep several in flight beside C = 224's 98 KB Pk.
// One thread of the warpgroup
// issues each unit's copies: TMA boxes of 64 channels x 64 pixels of an
// (N, P, C) tensor (8 KB, 128-byte rows in the 128-byte swizzle: 16-byte
// chunk i of pixel row r at chunk i ^ (r % 8), so the fragment reads below
// hit 8 different bank groups; rows past the frame and channels past C
// read as zeros), or one bulk copy for a Pk tile, completing on the slot's
// mbarrier.  The TMA engine keeps whole lines in flight without a
// thread's request slots: 16-byte cp.async copies from every thread held
// the first version of this kernel far below its bound, however many
// warpgroups it ran.
//
// y never goes to shared memory: each thread forms its register-A fragments
// of y straight from h, w and c at the fragment's positions, one unit at a
// time (y = h a0; y = rnd(y + rnd(w a1)); y = rnd(y + rnd(c a2)), bf16x2
// ops that round once each, where the plain version rounds).  The product
// is wgmma m64nNk16 with B the Pk image (pack_combine_weight): resident in
// shared memory, loaded once per block, up to C = 224; above (C = 448: 401
// KB) streamed through the ring one C x 64 column tile at a time.  The
// epilogue works on the accumulator fragments: p = rnd(acc + pb), the gate,
// r = rnd(rnd(x + p) g), out = rnd(res + rnd(s r)); out overwrites res (or
// x) in its slot and leaves by TMA store (rows past the frame and channels
// past C are not written).
//
// Each step: barrier of the warpgroup (everyone is done with unit u - 1),
// the issuing thread starts unit u + ring - 1 in u - 1's slot (after its
// last store has read its slot), everyone waits on unit u's mbarrier and
// consumes it.  So ring - 1 units are in flight while one is consumed.  No
// proxy fence per step: the units are read in place, and the out tile's
// writes are fenced once, before their store.
constexpr int kCM = 64;                         // pixels per tile
constexpr int kCBox = 64;                       // channels per TMA box (128 bytes)
constexpr unsigned kCBoxBytes = kCM * kCBox * 2;  // 8 KB
constexpr int kCRingMax = 8;                    // unit slots per warpgroup

struct CombineMaps {
  CUtensorMap x, h, w, c, res, out;  // (N, P, C), 64 x 64 boxes, 128-byte swizzle
};

struct CombineArgs {
  const bf16 *a, *pk;
  const float* pb;
  float res_scale;
  int P, C;
  int KW, nK;     // channels per h / w / c unit, units per tensor
  int nN;         // N-tiles
  int XW, nX;     // channels per x / res unit, units per N-tile and tensor
  int stream;     // 1: Pk streamed per N-tile through the ring (C > 224)
  int ring, nwg;  // slots per consumer warpgroup, consumer warpgroups
  int has_res;
  int tiles_pf, tiles, units;  // tiles per frame, in all; units per tile
  unsigned slot_bytes, pk_bytes;
};

// Output channels per N-tile: all C up to 224 (Pk resident), else 64
// (morphfc_fused.combine_tile_n).
__host__ __device__ inline int combine_tile_n(int C) { return C <= 224 ? C : 64; }
// Channels per h / w / c unit and per x / res unit: all C up to 160, else
// two boxes.
__host__ __device__ inline int combine_k_width(int C) { return C <= 160 ? C : 128; }
__host__ __device__ inline int combine_x_width(int C) {
  return combine_tile_n(C) <= 160 ? combine_tile_n(C) : 128;
}
__host__ __device__ inline unsigned combine_slot_bytes(int C) {
  const unsigned act = (unsigned)((combine_k_width(C) + kCBox - 1) / kCBox) * kCBoxBytes;
  const unsigned pkt = C > 224 ? (unsigned)C * kCBox * 2 : 0;
  return act > pkt ? act : pkt;
}
__host__ __device__ inline size_t combine_smem(int C, int nwg, int ring) {
  // the rings (1024-byte aligned), the resident Pk image, the barriers
  return (size_t)nwg * ring * combine_slot_bytes(C) + (C <= 224 ? (size_t)C * C * 2 : 0) + 256;
}
// Consumer warpgroups a block may have: three while y's fragments, the
// accumulator and the epilogue's values fit 168 registers a thread (up to
// C = 128; ptxas spilled ~200 bytes at 144 and 160), else two.
__host__ __device__ constexpr int combine_max_wg(int KSM, int NT) {
  return KSM <= 8 && NT <= 128 ? 3 : 2;
}

__device__ __forceinline__ void wg_bar(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
}
__device__ __forceinline__ __nv_bfloat162 u2b(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t b2u(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// the gate of a bf16 pair, rounded as symm_gate<bf16, ACT> rounds
template <int ACT>
__device__ __forceinline__ __nv_bfloat162 combine_gate(__nv_bfloat162 p) {
  if constexpr (ACT == 2) {
    return __hmax2(p, __float2bfloat162_rn(0.f));
  } else {
    const float2 f = __bfloat1622float2(p);
    if constexpr (ACT == 1)
      return __hsub2(__floats2bfloat162_rn(1.f / (1.f + expf(-f.x)), 1.f / (1.f + expf(-f.y))),
                     __float2bfloat162_rn(0.5f));
    else
      return __floats2bfloat162_rn(tanhf(f.x), tanhf(f.y));
  }
}
// The bf16 pair of a unit slot at pixel row `row` (row % 8 == r8), 8-channel
// chunk k8 of the unit, byte q4 of the chunk: box k8 / 8, chunk k8 % 8
// swizzled with the row.
__device__ __forceinline__ __nv_bfloat162* slot_pair(unsigned char* slot, int row, int r8, int k8,
                                                     int q4) {
  return reinterpret_cast<__nv_bfloat162*>(slot + (k8 >> 3) * kCBoxBytes + row * 128 +
                                           (((k8 & 7) ^ r8) << 4) + q4);
}

// KSM: k-steps of y's fragments (C / 16; 28 where Pk streams); NT: output
// channels per N-tile (the accumulator: NT / 2 registers a thread).
template <int KSM, int NT, int ACT>
__global__ void __launch_bounds__(128 * combine_max_wg(KSM, NT), 1)
morphfc_combine_wgmma_kernel(const __grid_constant__ CombineMaps maps, const CombineArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw;  // the swizzled boxes need 1024-byte alignment
  if ((su32(base) & 1023) != 0) __trap();
  const int g = threadIdx.x >> 7, tid = threadIdx.x & 127, wq = tid >> 5, lane = tid & 31;
  const bool leader = tid == 0;  // issues the warpgroup's copies and stores
  unsigned char* ring = base + (size_t)g * a.ring * a.slot_bytes;
  unsigned char* pks = base + (size_t)a.nwg * a.ring * a.slot_bytes;  // resident Pk image
  uint64_t* pk_bar = reinterpret_cast<uint64_t*>(pks + a.pk_bytes);
  uint64_t* full = pk_bar + 1 + g * kCRingMax;  // this warpgroup's slots
  const int C = a.C;
  const int G = gridDim.x * a.nwg, gw = blockIdx.x * a.nwg + g;
  const int ntiles = gw < a.tiles ? (a.tiles - gw + G - 1) / G : 0;
  const int total = ntiles * a.units;
  const int XV = 1 + a.has_res, V = a.stream + a.nX * XV;  // units per x chunk, N-tile

  if (threadIdx.x == 0) {
    mbar_init(pk_bar, 1);
    for (int i = 0; i < a.nwg * kCRingMax; ++i) mbar_init(pk_bar + 1 + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && !a.stream) {
    mbar_expect(pk_bar, (unsigned)(C * C * 2));
    bulk_load(pks, a.pk, (unsigned)(C * C * 2), pk_bar);
  }

  auto slot_of = [&](int u) { return ring + (size_t)(u % a.ring) * a.slot_bytes; };
  // unit u's copies: h, w, c (kind 0-2) K chunk, x, res (3, 4) N-tile, or
  // (5) the N-tile's Pk columns
  auto issue = [&](int u) {
    if (u >= total) return;
    const int t = u / a.units;
    int k = u - t * a.units, kind, ch0, width;
    if (k < 3 * a.nK) {
      kind = k / a.nK;
      ch0 = (k - kind * a.nK) * a.KW;
      width = min(a.KW, C - ch0);
    } else {
      k -= 3 * a.nK;
      const int nt = k / V;
      int v = k - nt * V - a.stream;
      ch0 = nt * NT;
      width = NT;
      if (v < 0) {
        kind = 5;
      } else {
        const int cx = v / XV;
        kind = 3 + v - cx * XV;
        ch0 += cx * a.XW;
        width = min(a.XW, NT - cx * a.XW);
      }
    }
    unsigned char* slot = slot_of(u);
    uint64_t* bar = full + u % a.ring;
    if (kind == 5) {  // the image's N-tile ch0 / NT: C x NT contiguous
      const unsigned bytes = (unsigned)(C * NT * 2);
      mbar_expect(bar, bytes);
      bulk_load(slot, a.pk + (size_t)ch0 * C, bytes, bar);
      return;
    }
    const CUtensorMap* map = kind == 0 ? &maps.h : kind == 1 ? &maps.w : kind == 2 ? &maps.c
                             : kind == 3 ? &maps.x : &maps.res;
    const int tile = gw + t * G, n = tile / a.tiles_pf, r0 = (tile - n * a.tiles_pf) * kCM;
    const int nb = (width + kCBox - 1) / kCBox;
    mbar_expect(bar, nb * kCBoxBytes);
    for (int b = 0; b < nb; ++b) tma_load_3d(slot + b * kCBoxBytes, map, ch0 + b * kCBox, r0, n, bar);
  };
  if (leader)
    for (int u = 0; u < a.ring - 1; ++u) issue(u);

  const int r_lo = 16 * wq + (lane >> 2), r8 = lane >> 2, q4 = 4 * (lane & 3);
  int u = 0;
  // the next unit: its slot, once its copies are in
  auto step = [&]() {
    wg_bar(g);
    if (leader) {
      bulk_wait_read<0>();  // the last store has read its slot
      issue(u + a.ring - 1);
    }
    mbar_wait(full + u % a.ring, (u / a.ring) & 1);
    return slot_of(u++);
  };
  // the out columns ch0 .. ch0 + width - 1 of the tile, from a slot
  auto store = [&](const unsigned char* slot, int n, int r0, int ch0, int width) {
    fence_async_shared();
    wg_bar(g);
    if (leader) {
      for (int b = 0; b * kCBox < width; ++b)
        tma_store_3d(&maps.out, slot + b * kCBoxBytes, ch0 + b * kCBox, r0, n);
      bulk_commit();
    }
  };
  for (int t = 0; t < ntiles; ++t) {
    const int tile = gw + t * G, n = tile / a.tiles_pf, r0 = (tile - n * a.tiles_pf) * kCM;
    // y as register-A fragments: register q of k-step s holds row r_lo + 8
    // (q & 1), channels 16 s + 8 (q >> 1) + 2 (lane % 4) + {0, 1}
    uint32_t yf[KSM][4];
    for (int kind = 0; kind < 3; ++kind) {
      const unsigned* ak =
          reinterpret_cast<const unsigned*>(a.a + ((size_t)n * 3 + kind) * C + 2 * (lane & 3));
      for (int kc = 0; kc < a.nK; ++kc) {
        const int s0 = kc * a.KW / 16, s1 = min(C, (kc + 1) * a.KW) / 16;
        // the unit's branch weights, loaded before its wait (which the
        // compiler cannot move loads across)
        uint32_t aw[KSM][2];
#pragma unroll
        for (int s = 0; s < KSM; ++s)
          if (s >= s0 && s < s1) aw[s][0] = __ldg(ak + 8 * s), aw[s][1] = __ldg(ak + 8 * s + 4);
        unsigned char* slot = step();
#pragma unroll
        for (int s = 0; s < KSM; ++s) {
          if (s < s0 || s >= s1) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162 term =
                __hmul2(*slot_pair(slot, r_lo + 8 * (q & 1), r8, 2 * (s - s0) + (q >> 1), q4),
                        u2b(aw[s][q >> 1]));
            if (kind == 0)
              yf[s][q] = b2u(term);
            else
              yf[s][q] = b2u(__hadd2(u2b(yf[s][q]), term));
          }
        }
      }
    }
    for (int nt = 0; nt < a.nN; ++nt) {
      const int ch0 = nt * NT;
      // acc = y @ (the N-tile's columns of Pk): B k-step s at 2 s NT 16
      // bytes, its two 8-row halves NT 16 apart, 8-column groups 128 apart
      unsigned bsm;
      if (a.stream) {
        bsm = su32(step());
      } else {
        mbar_wait(pk_bar, 0);
        bsm = su32(pks);
      }
      float acc[NT / 2];
      wg_fence();
#pragma unroll
      for (int s = 0; s < KSM; ++s) {
        if (s >= C / 16) break;
        WgmmaRA<NT>::mma(acc, yf[s], mat_desc(bsm + s * 2 * NT * 16, NT * 16, 128), s != 0);
      }
      wg_commit();
      pin_regs(acc);
      wg_wait<0>();
      pin_regs(acc);
#pragma unroll
      for (int s = 0; s < KSM; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(yf[s][q])::"memory");
      // the epilogue on the accumulator's fragments, one column chunk of
      // XW channels at a time: register 4 j + 2 hh + e is row r_lo + 8 hh,
      // channel ch0 + 8 j + 2 (lane % 4) + e.  With a residual, r goes back
      // into the pair's first accumulator register until res is in.
      for (int cx = 0; cx < a.nX; ++cx) {
        const int j0 = cx * a.XW / 8, j1 = min(NT, (cx + 1) * a.XW) / 8;
        unsigned char* xs = step();
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          if (j < j0 || j >= j1) continue;
          const int ch = ch0 + 8 * j + 2 * (lane & 3);
          const float2 bj =
              ch < C ? __ldg(reinterpret_cast<const float2*>(a.pb + ch)) : make_float2(0.f, 0.f);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            __nv_bfloat162* px = slot_pair(xs, r_lo + 8 * hh, r8, j - j0, q4);
            const __nv_bfloat162 p = __floats2bfloat162_rn(acc[4 * j + 2 * hh] + bj.x,
                                                           acc[4 * j + 2 * hh + 1] + bj.y);
            const __nv_bfloat162 r = __hmul2(__hadd2(*px, p), combine_gate<ACT>(p));
            if (a.has_res)
              acc[4 * j + 2 * hh] = __uint_as_float(b2u(r));
            else
              *px = r;
          }
        }
        if (!a.has_res) {
          store(xs, n, r0, ch0 + 8 * j0, 8 * (j1 - j0));
          continue;
        }
        unsigned char* rs = step();  // out = rnd(res + rnd(s r))
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          if (j < j0 || j >= j1) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            __nv_bfloat162* px = slot_pair(rs, r_lo + 8 * hh, r8, j - j0, q4);
            const float2 r = __bfloat1622float2(u2b(__float_as_uint(acc[4 * j + 2 * hh])));
            *px = __hadd2(*px, __floats2bfloat162_rn(a.res_scale * r.x, a.res_scale * r.y));
          }
        }
        store(rs, n, r0, ch0 + 8 * j0, 8 * (j1 - j0));
      }
    }
  }
  if (leader) bulk_wait<0>();  // the stores are done before the block's shared memory goes
}

template <int KSM, int NT, int ACT>
int launch_combine_wgmma(const CombineMaps& maps, const CombineArgs& a, cudaStream_t s) {
  if (a.nwg < 1 || a.nwg > combine_max_wg(KSM, NT) || a.ring < 2 || a.ring > kCRingMax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = combine_smem(a.C, a.nwg, a.ring);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = morphfc_combine_wgmma_kernel<KSM, NT, ACT>;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    const int e = set_smem(kern, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  const int sms = sm_count(), want = (a.tiles + a.nwg - 1) / a.nwg;
  kern<<<want < sms ? want : sms, 128 * a.nwg, smem, s>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int ACT>
int combine_bf16(const CombineMaps& m, const CombineArgs& a, cudaStream_t s) {
  if (a.C > 224) return launch_combine_wgmma<28, 64, ACT>(m, a, s);
  switch (a.C) {
    case 16: return launch_combine_wgmma<1, 16, ACT>(m, a, s);
    case 32: return launch_combine_wgmma<2, 32, ACT>(m, a, s);
    case 48: return launch_combine_wgmma<3, 48, ACT>(m, a, s);
    case 64: return launch_combine_wgmma<4, 64, ACT>(m, a, s);
    case 80: return launch_combine_wgmma<5, 80, ACT>(m, a, s);
    case 96: return launch_combine_wgmma<6, 96, ACT>(m, a, s);
    case 112: return launch_combine_wgmma<7, 112, ACT>(m, a, s);
    case 128: return launch_combine_wgmma<8, 128, ACT>(m, a, s);
    case 144: return launch_combine_wgmma<9, 144, ACT>(m, a, s);
    case 160: return launch_combine_wgmma<10, 160, ACT>(m, a, s);
    case 176: return launch_combine_wgmma<11, 176, ACT>(m, a, s);
    case 192: return launch_combine_wgmma<12, 192, ACT>(m, a, s);
    case 208: return launch_combine_wgmma<13, 208, ACT>(m, a, s);
    case 224: return launch_combine_wgmma<14, 224, ACT>(m, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- f32 (evaluation): the bf16 kernel's walk in 3xTF32 -------------------
//
// The same persistent warpgroups, each walking its own work items through
// its own ring of TMA units, y formed in registers at the register-A
// fragment positions, the epilogue on the accumulator and a TMA store; every
// product as three TF32 products (a_hi b_hi + a_hi b_lo + a_lo b_hi,
// wgmma.cuh tf32_split).  What changes with f32:
// - Units are boxes of 32 channels x 64 pixels (8 KB, 128-byte rows in the
//   128-byte swizzle); y is formed a K chunk of 32 channels (four k8 steps)
//   at a time -- h, w, c units, y = h a0 + w a1 + c a2 in f32 as the plain
//   version computes it -- split into hi and lo fragments (two register
//   sets, alternating by chunk) and multiplied at once, so no y is held
//   across the K loop and the accumulator can be 224 wide.  A fragment
//   register pair of k8 step s is channels 8 s + 2 (lane % 4) and + 1, the
//   Pk image's B rows in the order 0, 2, 4, 6, 1, 3, 5, 7.
// - Pk is TF32 hi and lo B images (pack_combine_weight, 8 C^2 bytes): resident
//   in shared memory up to C = 128 (128 KB), streamed above as one unit per
//   k8 step (64 NT bytes: 14 KB at NT = 224) between the chunk's h, w, c units.
// - A work item is (64-pixel tile, N-tile): NT = C up to 224, else two
//   N-tiles of C / 2 rounded up to 32 (C = 448: 224), each recomputing y --
//   elementwise, cheap -- so the eval tile's stage 3 (64 tiles) gives 128
//   items for 132 SMs.  Walkers are numbered across blocks first, so few
//   items spread over all SMs.
// - What bounds a warpgroup is its serial work a unit, not the bytes in
//   flight (a ring twice as deep ran no faster), so a unit's path is kept
//   short: the leader issues the next copy from an incremental cursor (no
//   divisions), the branch weights of the item's frame and pb come from
//   shared memory (staged once an item / a block, not loaded from L2
//   before each unit), and every product is done before the next unit is
//   taken -- a slot is refilled one unit behind, as in the bf16 kernel.
// - Two consumer warpgroups a block, or one with a ring twice as deep where
//   there are no more work items than SMs (the eval tile's stage 3).
// The gates are the accurate tanhf / expf, chosen at run time.  The scalar kernel this
// replaced (one block per pixel tile, FMA in register micro-tiles, Pk read
// from global memory for every input channel) ran at 0.03-0.3 of its bound
// and lost to its plain version at every C >= 224 (PERF.md).
constexpr int kCFBox = 32;                       // f32 channels per TMA box (128 bytes)
constexpr unsigned kCFBoxBytes = kCM * kCFBox * 4;  // 8 KB
constexpr int kCFRingMax = 24;                  // unit slots per warpgroup
constexpr int kCFWgMax = 2;                      // consumer warpgroups

struct CombineF32Args {
  const float *a, *pk, *pb;
  float res_scale;
  int P, C, NT, nN, nK, nX, steps;  // steps: C / 8 k8 steps
  int stream;                       // 1: Pk streamed, one unit per k8 step
  int ring, nwg, act, has_res;      // slots per warpgroup, consumer warpgroups
  int tiles_pf, items;              // tiles per frame, work items
  unsigned slot_bytes, pk_bytes;
};

// Output channels per N-tile of the f32 kernel (morphfc_fused.combine_tile_n):
// all C up to 224, else half of C rounded up to 32 (whole x units).
__host__ __device__ inline int combine_f32_tile_n(int C) {
  return C <= 224 ? C : (C + 63) / 64 * 32;
}
__host__ __device__ inline unsigned combine_f32_slot_bytes(int C) {
  const unsigned pkt = C <= 128 ? 0u : 64u * combine_f32_tile_n(C);
  return pkt > kCFBoxBytes ? pkt : kCFBoxBytes;
}
constexpr unsigned kCFBarBytes = 8 * (1 + kCFWgMax * kCFRingMax);  // 392
// the rings (1024-byte aligned), the resident Pk image, the barriers, pb
// and each warpgroup's branch weights (morphfc_fused.combine_smem at float32)
__host__ __device__ inline size_t combine_f32_smem(int C, int nwg, int ring) {
  return (size_t)nwg * ring * combine_f32_slot_bytes(C) + (C <= 128 ? (size_t)8 * C * C : 0) +
         kCFBarBytes + (size_t)4 * C * (1 + 3 * nwg);
}

// The float2 of a 32-channel unit slot at pixel row `row` (row % 8 == r8),
// k8 step s of the box, columns 2 t4 and + 1: 16-byte chunk 2 s + t4 / 2
// swizzled with the row.
__device__ __forceinline__ float2* slot_f2(unsigned char* slot, int row, int r8, int s, int t4) {
  return reinterpret_cast<float2*>(slot + row * 128 + (((2 * s + (t4 >> 1)) ^ r8) << 4) +
                                   ((t4 & 1) << 3));
}
__device__ __forceinline__ float combine_gate_f32(float p, int act) {
  if (act == 1) return 1.f / (1.f + expf(-p)) - 0.5f;
  if (act == 2) return fmaxf(p, 0.f);
  return tanhf(p);
}

// NT: output channels per N-tile (the accumulator: NT / 2 registers a thread).
template <int NT>
__global__ void __launch_bounds__(128 * kCFWgMax, 1)
morphfc_combine_tf32_kernel(const __grid_constant__ CombineMaps maps, const CombineF32Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if ((su32(base) & 1023) != 0) __trap();
  const int g = threadIdx.x >> 7, tid = threadIdx.x & 127, wq = tid >> 5, lane = tid & 31;
  const bool leader = tid == 0;  // issues the warpgroup's copies and stores
  const int C = a.C;
  unsigned char* ring = base + (size_t)g * a.ring * a.slot_bytes;
  unsigned char* pks = base + (size_t)a.nwg * a.ring * a.slot_bytes;  // resident Pk image
  uint64_t* pk_bar = reinterpret_cast<uint64_t*>(pks + a.pk_bytes);
  uint64_t* full = pk_bar + 1 + g * kCFRingMax;  // this warpgroup's slots
  // pb, then each warpgroup's branch weights of its item's frame (3 C)
  float* pb_sm = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(pk_bar) +
                                          kCFBarBytes);
  float* a_sm = pb_sm + C + 3 * C * g;
  // walker gw: warpgroup g of block b is walker g gridDim.x + b
  const int G = gridDim.x * a.nwg, gw = g * gridDim.x + blockIdx.x;
  const int nitems = gw < a.items ? (a.items - gw + G - 1) / G : 0;
  const int XV = 1 + a.has_res;  // units per x chunk

  if (threadIdx.x == 0) {
    mbar_init(pk_bar, 1);
    for (int i = 0; i < a.nwg * kCFRingMax; ++i) mbar_init(pk_bar + 1 + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) pb_sm[i] = a.pb[i];
  __syncthreads();
  if (threadIdx.x == 0 && !a.stream) {
    mbar_expect(pk_bar, a.pk_bytes);
    bulk_load(pks, a.pk, a.pk_bytes, pk_bar);
  }

  // item t of this walker: its frame, first pixel row and N-tile
  auto item_at = [&](int t, int& n, int& r0, int& nt) {
    const int item = gw + t * G, tile = item / a.nN;
    nt = item - tile * a.nN, n = tile / a.tiles_pf, r0 = (tile - n * a.tiles_pf) * kCM;
  };
  // the leader's issue cursor: the next unit's item ct (frame cn, rows cr0,
  // N-tile cnt), K chunk ckc (nK: the x part), unit cr of its chunk, x chunk
  // ccx, ring slot cs -- advanced a unit at a time, no divisions
  int ct = 0, cn = 0, cr0 = 0, cnt = 0, ckc = 0, cr = 0, ccx = 0, cs = 0;
  if (nitems > 0) item_at(0, cn, cr0, cnt);
  // unit order of an item: per K chunk kc h, w, c (kinds 0-2) [then its Pk
  // steps]; then per x chunk x [, res] (3, 4)
  auto issue_next = [&]() {
    if (ct >= nitems) return;
    unsigned char* slot = ring + (size_t)cs * a.slot_bytes;
    uint64_t* bar = full + cs;
    if (++cs == a.ring) cs = 0;
    int kind, ch0;
    if (ckc < a.nK) {
      const int ns = a.stream ? min(4, a.steps - 4 * ckc) : 0;
      kind = cr, ch0 = ckc * kCFBox;
      if (++cr == 3 + ns) cr = 0, ++ckc;
      if (kind >= 3) {  // the N-tile's Pk rows of k8 step 4 kc + kind - 3, hi and lo
        const unsigned bytes = 64u * NT;
        mbar_expect(bar, bytes);
        bulk_load(slot, a.pk + ((size_t)cnt * a.steps + 4 * (ch0 / kCFBox) + kind - 3) * 16 * NT,
                  bytes, bar);
        return;
      }
    } else {
      kind = 3 + cr, ch0 = cnt * NT + ccx * kCFBox;
      const int n = cn, r0 = cr0;
      if (++cr == XV) {
        cr = 0;
        if (++ccx == a.nX) {
          ccx = 0, ckc = 0;
          if (++ct < nitems) item_at(ct, cn, cr0, cnt);
        }
      }
      mbar_expect(bar, kCFBoxBytes);
      tma_load_3d(slot, kind == 3 ? &maps.x : &maps.res, ch0, r0, n, bar);
      return;
    }
    const CUtensorMap* map = kind == 0 ? &maps.h : kind == 1 ? &maps.w : &maps.c;
    mbar_expect(bar, kCFBoxBytes);
    tma_load_3d(slot, map, ch0, cr0, cn, bar);
  };
  if (leader)
    for (int i = 0; i < a.ring - 1; ++i) issue_next();

  const int t4 = lane & 3, r_lo = 16 * wq + (lane >> 2), r8 = lane >> 2;
  RingPos q;  // the next unit to consume: its slot and phase
  // the next unit: its slot, once its copies are in; the slot consumed
  // before it is refilled (no products read a slot past its unit)
  auto step = [&]() {
    wg_bar(g);
    if (leader) {
      bulk_wait_read<0>();  // the last store has read its slot
      issue_next();
    }
    mbar_wait(full + q.i, q.ph);
    unsigned char* slot = ring + (size_t)q.i * a.slot_bytes;
    q.next(a.ring);
    return slot;
  };
  auto store = [&](const unsigned char* slot, int n, int r0, int ch0) {
    fence_async_shared();
    wg_bar(g);
    if (leader) {
      tma_store_3d(&maps.out, slot, ch0, r0, n);
      bulk_commit();
    }
  };
  if (!a.stream) mbar_wait(pk_bar, 0);
  const unsigned pk_sm = su32(pks);
  // y's hi and lo fragments of a chunk, two sets (alternating by chunk)
  uint32_t fh0[4][4], fl0[4][4], fh1[4][4], fl1[4][4];
  for (int t = 0; t < nitems; ++t) {
    int n, r0, nt;
    item_at(t, n, r0, nt);
    const int ch0 = nt * NT;
    // the frame's branch weights into shared memory (the previous item's
    // readers passed a barrier since: its x units' steps)
    for (int i = tid; i < 3 * C; i += 128) a_sm[i] = __ldg(a.a + (size_t)n * 3 * C + i);
    wg_bar(g);
    float acc[NT / 2];
    // K chunk kc: y from its h, w, c units, split into (fh, fl), products;
    // every product is done before the next unit is taken (no wgmma in
    // flight across the leader's branch: ptxas serializes all of them then)
    auto chunk = [&](int kc, uint32_t(&fh)[4][4], uint32_t(&fl)[4][4]) {
      const int ns = min(4, a.steps - 4 * kc);
      // register q of step s: row r_lo + 8 (q & 1), channel 32 kc + 8 s + 2 t4
      // + (q >> 1)
      float y[4][4] = {};
#pragma unroll
      for (int kind = 0; kind < 3; ++kind) {
        unsigned char* slot = step();
        const float* ak = a_sm + kind * C + 32 * kc + 2 * t4;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s >= ns) continue;
          const float2 aw = *reinterpret_cast<const float2*>(ak + 8 * s);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 v = *slot_f2(slot, r_lo + 8 * hh, r8, s, t4);
            const float t0 = __fmul_rn(v.x, aw.x), t1 = __fmul_rn(v.y, aw.y);
            y[s][hh] = kind == 0 ? t0 : __fadd_rn(y[s][hh], t0);
            y[s][2 + hh] = kind == 0 ? t1 : __fadd_rn(y[s][2 + hh], t1);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) tf32_split(y[s][q], fh[s][q], fl[s][q]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= ns) break;
        const unsigned bh = a.stream ? su32(step()) : pk_sm + (4 * kc + s) * 64 * NT;
        const uint64_t dh = mat_desc(bh, NT * 16, 128), dl = mat_desc(bh + 32 * NT, NT * 16, 128);
        wg_fence();
        pin_regs(acc);
        WgmmaTF32<NT>::mma(acc, fh[s], dh, (kc | s) != 0);
        WgmmaTF32<NT>::mma(acc, fh[s], dl, 1);
        WgmmaTF32<NT>::mma(acc, fl[s], dh, 1);
        wg_commit();
        pin_regs(acc);
        if (a.stream) {
          wg_wait<0>();
          pin_regs(acc);
        }
      }
      if (!a.stream) {
        wg_wait<0>();
        pin_regs(acc);
      }
    };
    for (int kc = 0; kc < a.nK; kc += 2) {
      chunk(kc, fh0, fl0);
      if (kc + 1 < a.nK) chunk(kc + 1, fh1, fl1);
    }
    // the epilogue, one x chunk of 32 channels at a time: register 4 j + 2
    // hh + e is row r_lo + 8 hh, channel ch0 + 8 j + 2 t4 + e.  With a
    // residual, r = (x + p) g(p) goes back into the accumulator until res is in.
    for (int cx = 0; cx < a.nX; ++cx) {
      unsigned char* xs = step();
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        if (j < 4 * cx || j >= 4 * cx + 4) continue;
        const int ch = ch0 + 8 * j + 2 * t4;
        const float2 bj =
            ch < C ? *reinterpret_cast<const float2*>(pb_sm + ch) : make_float2(0.f, 0.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* px = slot_f2(xs, r_lo + 8 * hh, r8, j - 4 * cx, t4);
          const float p0 = acc[4 * j + 2 * hh] + bj.x, p1 = acc[4 * j + 2 * hh + 1] + bj.y;
          const float2 xv = *px;
          const float o0 = (xv.x + p0) * combine_gate_f32(p0, a.act);
          const float o1 = (xv.y + p1) * combine_gate_f32(p1, a.act);
          if (a.has_res)
            acc[4 * j + 2 * hh] = o0, acc[4 * j + 2 * hh + 1] = o1;
          else
            *px = make_float2(o0, o1);
        }
      }
      if (!a.has_res) {
        store(xs, n, r0, ch0 + 32 * cx);
        continue;
      }
      unsigned char* rs = step();  // out = res + s r
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        if (j < 4 * cx || j >= 4 * cx + 4) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* px = slot_f2(rs, r_lo + 8 * hh, r8, j - 4 * cx, t4);
          const float2 rv = *px;
          *px = make_float2(rv.x + a.res_scale * acc[4 * j + 2 * hh],
                            rv.y + a.res_scale * acc[4 * j + 2 * hh + 1]);
        }
      }
      store(rs, n, r0, ch0 + 32 * cx);
    }
  }
  if (leader) bulk_wait<0>();  // the stores are done before the block's shared memory goes
}

template <int NT>
int launch_combine_tf32(const CombineMaps& maps, const CombineF32Args& a, cudaStream_t s) {
  if (a.nwg < 1 || a.nwg > kCFWgMax || a.ring < 4 || a.ring > kCFRingMax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = combine_f32_smem(a.C, a.nwg, a.ring);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = morphfc_combine_tf32_kernel<NT>;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    const int e = set_smem(kern, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  const int sms = sm_count();
  kern<<<a.items < sms ? a.items : sms, 128 * a.nwg, smem, s>>>(maps, a);
  return (int)cudaGetLastError();
}

#if !defined(VMG_MORPHFC_PART) || VMG_MORPHFC_PART == 2
// part 2's alone: a function that is no template instantiates its kernels
// in every part that sees it
inline int combine_f32(const CombineMaps& m, const CombineF32Args& a, cudaStream_t s) {
  switch (a.NT) {
    case 16: return launch_combine_tf32<16>(m, a, s);
    case 32: return launch_combine_tf32<32>(m, a, s);
    case 48: return launch_combine_tf32<48>(m, a, s);
    case 64: return launch_combine_tf32<64>(m, a, s);
    case 80: return launch_combine_tf32<80>(m, a, s);
    case 96: return launch_combine_tf32<96>(m, a, s);
    case 112: return launch_combine_tf32<112>(m, a, s);
    case 128: return launch_combine_tf32<128>(m, a, s);
    case 144: return launch_combine_tf32<144>(m, a, s);
    case 160: return launch_combine_tf32<160>(m, a, s);
    case 176: return launch_combine_tf32<176>(m, a, s);
    case 192: return launch_combine_tf32<192>(m, a, s);
    case 208: return launch_combine_tf32<208>(m, a, s);
    case 224: return launch_combine_tf32<224>(m, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // part 2

// ---- axes: both decayed axis branches + reweight partial sums --------------

constexpr int kVecBytes = 16;  // global loads and stores move 16 bytes

// ---- persistent warpgroups, resident weights, TMA slabs --------------------
//
// A tile is one slab of ch rows x WT columns of a frame (WT a multiple of
// cw, so the W chunks lie inside it; >= 64 positions,
// morphfc_fused.axes_slab_width).  Each branch's token matrix has its token
// groups (ch, resp. cw tokens: the channel segments q of one chunk) padded
// to a power of two cp of rows and its rows to whole m64 sub-tiles, so
// every sub-tile holds whole groups and row m is segment q = m % cp
// (padding rows are zero tokens that write and sum nothing).  Both branches of a tile
// read one x slab, brought in once by one TMA box (C x WT x ch; rows past H
// and columns past W read as zeros) with the c slab, into a ring of slots
// per consumer warpgroup; each warpgroup walks a contiguous run of tiles
// (a fixed assignment), its leader thread issuing the next slot's boxes.
//
// Per sub-tile: the token matrix is formed straight into wgmma register-A
// fragments from the slab -- A[(w, q)][(P, s)] = x[P][w][q S + s] (H),
// A[(r, G, q)][(p, s)] = x[r][G cw + p][q S + s] (W); with S = C / chunk
// even, a fragment register's k pair is two neighbouring channels, one
// 4-byte shared read (odd S: two 2-byte reads) -- then m64nCk16 against the
// branch's decayed weight, a B image staged once per block from the plain
// (C_in, C_out) matrix.  The epilogue works on the accumulator: relu(acc +
// b) / C, rounded once, lands at position P, channel q S + Z of the output
// slab, which is the (token, feature)'s own x element: so h overwrites x in
// its slot sub-tile by sub-tile (each reads and writes only its own token
// columns), and w goes where c was (summed first).  Both leave by TMA store.
//
// Sums: each thread keeps the unrounded values of its accumulator
// positions (row m % 64, column f) summed over its tiles, in tile order --
// the (segment, feature) of a position is the same in every sub-tile, and
// so is the channel q S + Z -- beside its c lanes' sums.  At each change of
// frame (a walker's run crosses one or two) the warpgroup writes them to
// its global scratch and each channel's thread adds its positions in a
// fixed order into the walker's per-frame partial; morphfc_final_kernel
// adds the walkers' partials.  Deterministic, no atomics.
//
// F32: the same walk on f32 slabs, every product as three TF32 products
// (a_hi b_hi + a_hi b_lo + a_lo b_hi; wgmma.cuh tf32_split): each weight
// staged as its hi and lo B images (8 C^2 bytes: 100 KB at C = 112, so the
// branches run in two passes, H then W), k8 steps whose B rows are in the
// order 0, 2, 4, 6, 1, 3, 5, 7, so that a fragment register pair is the
// bf16 kernel's channel pair; the token fragments split in registers a k8
// step at a time, in two alternating sets (one step's products run while
// the next step's fragments are read).
constexpr int kAxRingMax = 4;  // slots per warpgroup

struct AxesMaps {
  CUtensorMap x, c, h, w;  // (N, H, W, C): boxes of C x WT x ch, no swizzle
};

struct AxesArgs {
  const bf16 *kh, *kw;  // the plain (C_in, C_out) weights (f32 ones for F32)
  const float *bh, *bw;  // both null: no bias
  float *partial, *scratch;
  int N, H, W, C, ch, cw, WT, kg;
  int lchp, lcwp;                      // log2 of the padded group sizes
  int tiles_w, tiles_pf, tiles;        // slabs per slab row, per frame; all
  int nwg, ring, npass, walkers;
  unsigned slab_bytes, box_bytes;      // a slab's slot half (128-aligned); one box
};

// one slab: ch * WT positions of C elements of esz bytes, 128-byte aligned
__host__ __device__ inline unsigned axes_slab_bytes(int positions, int C, int esz = 2) {
  return ((unsigned)positions * C * esz + 127) / 128 * 128;
}
// the rings (x and c slabs per slot), the weights (both where npass == 1;
// wbytes an element: bf16 2, f32 hi and lo 8), the biases, the barriers
// (morphfc_fused.axes_smem)
__host__ __device__ inline size_t axes_smem(int C, unsigned slab, int nwg, int ring, int npass,
                                            int wbytes = 2) {
  return (size_t)nwg * ring * 2 * slab + (size_t)(npass == 1 ? 2 : 1) * C * C * wbytes +
         (size_t)2 * C * 4 + (size_t)nwg * kAxRingMax * 8;
}

template <int KS, bool F32, bool RELU = true>
__global__ void __launch_bounds__(256, 1)
morphfc_axes_wgmma_kernel(const __grid_constant__ AxesMaps maps, const AxesArgs a) {
  constexpr int C = 16 * KS, NJ = C / 8;  // accumulator column groups
  typedef std::conditional_t<F32, float, bf16> T;
  constexpr size_t WIMG = F32 ? (size_t)2 * C * C : (size_t)C * C;  // a weight's image, in T
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if ((su32(base) & 127) != 0) __trap();
  const int g = threadIdx.x >> 7, tid = threadIdx.x & 127, wq = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, l4 = lane & 3;
  const bool leader = tid == 0;  // issues the warpgroup's copies and stores
  const unsigned slot_bytes = 2 * a.slab_bytes;
  unsigned char* ring = base + (size_t)g * a.ring * slot_bytes;
  T* wsm = reinterpret_cast<T*>(base + (size_t)a.nwg * a.ring * slot_bytes);
  float* bias = reinterpret_cast<float*>(wsm + (a.npass == 1 ? 2 : 1) * WIMG);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias + 2 * C);
  uint64_t* full = bars + g * kAxRingMax;
  const int G = a.walkers, gw = blockIdx.x * a.nwg + g;
  const int t0 = (int)((long long)gw * a.tiles / G);
  const int nt = (int)((long long)(gw + 1) * a.tiles / G) - t0, total = a.npass * nt;
  const float inv_c = 1.f / C;

  // a weight's B image: element (k, n) at ((k / 8) C + n) 8 + k % 8 (K-major
  // 8 x 16-byte core matrices), from the plain (C_in, C_out) matrix; f32:
  // per k8 step j its hi then its lo image, k position 4 kb + e of column n
  // at (kb C + n) 4 + e, holding row k = 8 j + 2 e + kb
  auto stage = [&](T* dst, const T* __restrict__ K) {
    if constexpr (F32) {
      for (int it = threadIdx.x; it < C / 4 * C; it += blockDim.x) {
        const int jk = it / C, nn = it - jk * C, j = jk >> 1, kb = jk & 1;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(K[(size_t)(8 * j + 2 * e + kb) * C + nn], hi[e], lo[e]);
        float* o = dst + (size_t)j * 16 * C + (size_t)(kb * C + nn) * 4;
        *reinterpret_cast<uint4*>(o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(o + 8 * C) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    } else {
      for (int it = threadIdx.x; it < C / 8 * C; it += blockDim.x) {
        const int kg8 = it / C, nn = it - kg8 * C;
        alignas(16) bf16 v[8];
#pragma unroll
        for (int ki = 0; ki < 8; ++ki) v[ki] = K[(size_t)(8 * kg8 + ki) * C + nn];
        *reinterpret_cast<uint4*>(dst + (size_t)it * 8) = *reinterpret_cast<const uint4*>(v);
      }
    }
    fence_async_shared();  // the image, visible to wgmma
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nwg * kAxRingMax; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x)  // no bias: zero rows, no load
    bias[i] = a.bh != nullptr ? a.bh[i] : 0.f, bias[C + i] = a.bw != nullptr ? a.bw[i] : 0.f;
  stage(wsm, reinterpret_cast<const T*>(a.kh));
  if (a.npass == 1) stage(wsm + WIMG, reinterpret_cast<const T*>(a.kw));
  __syncthreads();

  auto tile_at = [&](int t, int& n, int& r0, int& w0) {
    n = t / a.tiles_pf;
    const int rem = t - n * a.tiles_pf, ty = rem / a.tiles_w;
    r0 = ty * a.ch, w0 = (rem - ty * a.tiles_w) * a.WT;
  };
  auto slot_of = [&](int u) { return ring + (size_t)(u % a.ring) * slot_bytes; };
  // unit u = pass * nt + i: tile t0 + i's x slab (and its c slab, in the
  // pass that runs the W branch)
  auto issue = [&](int u) {
    if (u >= total) return;
    const int pass = u / nt, i = u - pass * nt;
    int n, r0, w0;
    tile_at(t0 + i, n, r0, w0);
    const bool with_c = a.npass == 1 || pass == 1;
    unsigned char* slot = slot_of(u);
    uint64_t* bar = full + u % a.ring;
    mbar_expect(bar, (with_c ? 2 : 1) * a.box_bytes);
    tma_load_4d(slot, &maps.x, 0, w0, r0, n, bar);
    if (with_c) tma_load_4d(slot + a.slab_bytes, &maps.c, 0, w0, r0, n, bar);
  };
  if (leader)
    for (int u = 0; u < a.ring - 1; ++u) issue(u);

  // per-thread sums: accumulator position (row half hh, column 8 j + 2 l4
  // + e) over the walker's tiles; the c lanes' 8 channels
  float ss[2][NJ][2], cs[8];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ss[hh][j][0] = ss[hh][j][1] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) cs[k] = 0.f;
  const int nv = C / 8, Rc = 128 / nv, jc = tid / nv, vc = tid - jc * nv;  // c lanes
  float* sc = a.scratch + (size_t)gw * (C / 2 + 8) * 128;

  // the walker's sums of frame n into its partial, in a fixed order: per
  // channel (q, Z), rows m = q, q + cp, ... < 64, then features P S + Z, P
  // < chunk, then the c lanes
  auto flush = [&](int n, int pass, int chunk, int lcp, int S) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[((hh * NJ + j) * 2 + e) * 128 + tid] = ss[hh][j][e];
          ss[hh][j][e] = 0.f;
        }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sc[(C / 2 + k) * 128 + tid] = cs[k];
      cs[k] = 0.f;
    }
    wg_bar(g);
    for (int cc = tid; cc < C; cc += 128) {
      const int q = cc / S, Z = cc - q * S;
      float acc = 0.f;
      for (int m = q; m < 64; m += 1 << lcp) {
        const float* row = sc + (m >> 4) * 32 + (m & 7) * 4;
        const int hh = (m >> 3) & 1;
        for (int P = 0; P < chunk; ++P) {
          const int f = P * S + Z;
          acc += row[((hh * NJ + (f >> 3)) * 2 + (f & 1)) * 128 + ((f & 7) >> 1)];
        }
      }
      for (int j2 = 0; j2 < Rc; ++j2) acc += sc[(C / 2 + (cc & 7)) * 128 + j2 * nv + (cc >> 3)];
      a.partial[((size_t)n * a.npass * G + (size_t)pass * G + gw) * C + cc] = acc;
    }
    wg_bar(g);
  };

  int u = 0;
  for (int pass = 0; pass < a.npass; ++pass) {
    if (pass == 1) {  // two passes: kw replaces kh
      __syncthreads();
      stage(wsm, reinterpret_cast<const T*>(a.kw));
      __syncthreads();
    }
    const bool doH = a.npass == 1 || pass == 0, doW = a.npass == 1 || pass == 1;
    // the pass's branch geometry (both branches alike where npass == 1)
    const int chunk = doH ? a.ch : a.cw, lcp = doH ? a.lchp : a.lcwp, S = C / chunk;
    const bool even = (S & 1) == 0;
    // column 8 j + 2 l4 (+ 1) of the token matrices is feature (P, Z): its
    // start and its step over j
    const int P0 = 2 * l4 / S, Z0 = 2 * l4 - P0 * S, dP = 8 / S, dZ = 8 - dP * S;
    int cur = -1, first = -1, last = -1;
    for (int i = 0; i <= nt; ++i, ++u) {
      int n = -1, r0 = 0, w0 = 0;
      if (i < nt) tile_at(t0 + i, n, r0, w0);
      if (n != cur) {  // the run enters a frame, or ends (one call site: flush inlines)
        if (cur >= 0) flush(cur, pass, chunk, lcp, S);
        if (first < 0) first = n;
        last = cur;
        cur = n;
      }
      if (i == nt) break;
      if (leader) {
        bulk_wait_read<0>();  // the last stores have read their slot
        issue(u + a.ring - 1);
      }
      mbar_wait(full + u % a.ring, (u / a.ring) & 1);
      unsigned char* slot = slot_of(u);
      T* xs = reinterpret_cast<T*>(slot);
      T* cslab = reinterpret_cast<T*>(slot + a.slab_bytes);
      if (doW && jc < Rc) {  // c over the slab (zeros past the frame)
        for (int pos = jc; pos < a.ch * a.WT; pos += Rc) {
          if constexpr (F32) {
            const float4* v = reinterpret_cast<const float4*>(cslab + (size_t)pos * C + vc * 8);
            const float4 u0 = v[0], u1 = v[1];
            cs[0] += u0.x, cs[1] += u0.y, cs[2] += u0.z, cs[3] += u0.w;
            cs[4] += u1.x, cs[5] += u1.y, cs[6] += u1.z, cs[7] += u1.w;
          } else {
            const uint4 v = *reinterpret_cast<const uint4*>(cslab + (size_t)pos * C + vc * 8);
            const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f2 = __bfloat1622float2(b2[k]);
              cs[2 * k] += f2.x, cs[2 * k + 1] += f2.y;
            }
          }
        }
      }
      // one branch: its sub-tiles' fragments, product, epilogue into dst
      auto branch = [&](auto is_h) {
        constexpr bool IH = decltype(is_h)::value;
        // token groups: WT (H) or ch kg (W), cp rows each, in whole m64 sub-tiles
        const int cp = 1 << (IH ? a.lchp : a.lcwp), ngroups = IH ? a.WT : a.ch * a.kg;
        const int rows = ((ngroups << (IH ? a.lchp : a.lcwp)) + 63) / 64 * 64;
        const int cstride = IH ? a.WT * C : C;
        T* dst = IH ? xs : cslab;
        const float* bs = bias + (IH ? 0 : C);
        const unsigned bsm = su32(wsm + (a.npass == 1 && !IH ? WIMG : 0));
        for (int m0 = 0; m0 < rows; m0 += 64) {
          int rowpart[2];
          bool real[2], rvalid[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = m0 + 16 * wq + 8 * hh + gr, grp = m >> (IH ? a.lchp : a.lcwp);
            const int q = m & (cp - 1);
            real[hh] = q < chunk && grp < ngroups;
            if (IH) {
              rowpart[hh] = grp * C + q * S;
              rvalid[hh] = real[hh] && w0 + grp < a.W;
            } else {
              const int rr = grp / a.kg, G2 = grp - rr * a.kg;
              rowpart[hh] = (rr * a.WT + G2 * a.cw) * C + q * S;
              rvalid[hh] = real[hh] && r0 + rr < a.H && w0 + G2 * a.cw < a.W;
            }
          }
          float acc[C / 2];
          int P = P0, Z = Z0;
          if constexpr (F32) {
            // k8 step j: the fragment pair (row hh, columns c0 and c1) is k
            // positions l4 and l4 + 4 of the step, split, against the step's
            // hi and lo images
            uint32_t xh[2][4], xl[2][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              int P1 = P, Z1 = Z + 1;
              if (Z1 == S) Z1 = 0, P1 = P + 1;
              const int c0 = P * cstride + Z, c1 = P1 * cstride + Z1;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float v0 = 0.f, v1 = 0.f;
                if (real[hh]) {
                  const float* src = xs + rowpart[hh];
                  if (even) {
                    const float2 v = *reinterpret_cast<const float2*>(src + c0);
                    v0 = v.x, v1 = v.y;
                  } else {
                    v0 = src[c0], v1 = src[c1];
                  }
                }
                tf32_split(v0, xh[j & 1][hh], xl[j & 1][hh]);
                tf32_split(v1, xh[j & 1][2 + hh], xl[j & 1][2 + hh]);
              }
              wg_fence();
              pin_regs(acc);
              const uint64_t dh = mat_desc(bsm + j * 64 * C, C * 16, 128);
              const uint64_t dl = mat_desc(bsm + j * 64 * C + 32 * C, C * 16, 128);
              WgmmaTF32<C>::mma(acc, xh[j & 1], dh, j != 0);
              WgmmaTF32<C>::mma(acc, xh[j & 1], dl, 1);
              WgmmaTF32<C>::mma(acc, xl[j & 1], dh, 1);
              wg_commit();
              pin_regs(acc);
              if (j + 1 < NJ) wg_wait<1>();  // the other set is free again
              P += dP, Z += dZ;
              if (Z >= S) Z -= S, ++P;
            }
            wg_bar(g);  // every fragment read of the slab's sub-tile (and, for W, the c sums) is done
            wg_wait<0>();
            pin_regs(acc);
          } else {
            uint32_t fr[KS][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              int P1 = P, Z1 = Z + 1;
              if (Z1 == S) Z1 = 0, P1 = P + 1;
              const int c0 = P * cstride + Z, c1 = P1 * cstride + Z1;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                uint32_t v = 0;
                if (real[hh]) {
                  const bf16* src = xs + rowpart[hh];
                  if (even) {
                    v = *reinterpret_cast<const uint32_t*>(src + c0);
                  } else {
                    const unsigned short lo = *reinterpret_cast<const unsigned short*>(src + c0);
                    const unsigned short hi = *reinterpret_cast<const unsigned short*>(src + c1);
                    v = (uint32_t)lo | ((uint32_t)hi << 16);
                  }
                }
                fr[j >> 1][(j & 1) * 2 + hh] = v;
              }
              P += dP, Z += dZ;
              if (Z >= S) Z -= S, ++P;
            }
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              WgmmaRA<C>::mma(acc, fr[ks], mat_desc(bsm + ks * 2 * C * 16, C * 16, 128), ks != 0);
            wg_commit();
            pin_regs(acc);
            wg_bar(g);  // every fragment read of the slab's sub-tile (and, for W, the c sums) is done
            wg_wait<0>();
            pin_regs(acc);
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
#pragma unroll
              for (int qq = 0; qq < 4; ++qq) asm volatile("" : "+r"(fr[ks][qq])::"memory");
          }
          // epilogue: register 4 j + 2 hh + e is row hh, column 8 j + 2 l4 + e
          P = P0, Z = Z0;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            int P1 = P, Z1 = Z + 1;
            if (Z1 == S) Z1 = 0, P1 = P + 1;
            const int c0 = P * cstride + Z, c1 = P1 * cstride + Z1;
            const float2 bj = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * l4);
            // H: the feature's position is the slab row P (or P1)
            const bool cv0 = !IH || r0 + P < a.H, cv1 = !IH || r0 + P1 < a.H;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float y0 = (RELU ? fmaxf(acc[4 * j + 2 * hh] + bj.x, 0.f)
                                     : acc[4 * j + 2 * hh] + bj.x) * inv_c;
              const float y1 = (RELU ? fmaxf(acc[4 * j + 2 * hh + 1] + bj.y, 0.f)
                                     : acc[4 * j + 2 * hh + 1] + bj.y) * inv_c;
              if (rvalid[hh]) {
                ss[hh][j][0] += cv0 ? y0 : 0.f;
                ss[hh][j][1] += cv1 ? y1 : 0.f;
              }
              if (real[hh]) {
                T* o = dst + rowpart[hh];
                if constexpr (F32) {
                  if (even) {
                    *reinterpret_cast<float2*>(o + c0) = make_float2(y0, y1);
                  } else {
                    o[c0] = y0;
                    o[c1] = y1;
                  }
                } else if (even) {
                  *reinterpret_cast<__nv_bfloat162*>(o + c0) = __floats2bfloat162_rn(y0, y1);
                } else {
                  o[c0] = __float2bfloat16_rn(y0);
                  o[c1] = __float2bfloat16_rn(y1);
                }
              }
            }
            P += dP, Z += dZ;
            if (Z >= S) Z -= S, ++P;
          }
        }
      };
      if (doW) branch(std::false_type());  // x is read, w goes where c was
      if (doH) branch(std::true_type());   // h overwrites x, sub-tile by sub-tile
      fence_async_shared();  // the staged outputs, visible to the TMA stores
      wg_bar(g);
      if (leader) {
        if (doH) tma_store_4d(&maps.h, xs, 0, w0, r0, n);
        if (doW) tma_store_4d(&maps.w, cslab, 0, w0, r0, n);
        bulk_commit();
      }
    }
    // frames of no tile of this walker's run: zero partials
    for (int n = 0; n < a.N; ++n) {
      if (last >= 0 && n >= first && n <= last) continue;
      for (int cc = tid; cc < C; cc += 128)
        a.partial[((size_t)n * a.npass * G + (size_t)pass * G + gw) * C + cc] = 0.f;
    }
  }
  if (leader) bulk_wait<0>();  // the stores are done before the block's shared memory goes
}

template <int KS, bool F32, bool RELU>
int launch_axes_wgmma(const AxesMaps& m, const AxesArgs& a, int grid, cudaStream_t st) {
  const size_t smem = axes_smem(a.C, a.slab_bytes, a.nwg, a.ring, a.npass, F32 ? 8 : 2);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = morphfc_axes_wgmma_kernel<KS, F32, RELU>;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    const int e = set_smem(kern, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  kern<<<grid, 128 * a.nwg, smem, st>>>(m, a);
  return (int)cudaGetLastError();
}

template <bool F32, bool RELU>
int axes_wgmma(const AxesMaps& m, const AxesArgs& a, int grid, cudaStream_t st) {
  switch (a.C / 16) {
    case 1: return launch_axes_wgmma<1, F32, RELU>(m, a, grid, st);
    case 2: return launch_axes_wgmma<2, F32, RELU>(m, a, grid, st);
    case 3: return launch_axes_wgmma<3, F32, RELU>(m, a, grid, st);
    case 4: return launch_axes_wgmma<4, F32, RELU>(m, a, grid, st);
    case 5: return launch_axes_wgmma<5, F32, RELU>(m, a, grid, st);
    case 6: return launch_axes_wgmma<6, F32, RELU>(m, a, grid, st);
    case 7: return launch_axes_wgmma<7, F32, RELU>(m, a, grid, st);
    case 8: return launch_axes_wgmma<8, F32, RELU>(m, a, grid, st);
    case 9: return launch_axes_wgmma<9, F32, RELU>(m, a, grid, st);
    case 10: return launch_axes_wgmma<10, F32, RELU>(m, a, grid, st);
    case 11: return launch_axes_wgmma<11, F32, RELU>(m, a, grid, st);
    case 12: return launch_axes_wgmma<12, F32, RELU>(m, a, grid, st);
    case 13: return launch_axes_wgmma<13, F32, RELU>(m, a, grid, st);
    case 14: return launch_axes_wgmma<14, F32, RELU>(m, a, grid, st);
    case 15: return launch_axes_wgmma<15, F32, RELU>(m, a, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- axes, token form: the same function where the weights do not fit ---
//
// bf16 (the serving dtype): morphfc_axes_token_wgmma_kernel (notes at the
// kernel), after a pack launch (the weights as wgmma B images) and a
// reduce launch (c's per-frame partials, morphfc_partial_kernel).
//
// f32 (the evaluation dtype): morphfc_axes_token_tf32_kernel (notes at the
// kernel, below the bf16 one): the bf16 kernel's units, walkers, image
// column order and sums on 3xTF32 wgmma, the images' hi and lo halves
// streamed in k8-step stages of a column tile, the token fragments formed
// from the raw f32 unit a k8 step at a time, the output stored from
// registers; the same three launches around it.

// ---- bf16: persistent warpgroups, weight column tiles, TMA units ----------
//
// Bound: device memory.  At stage 1/5 (16 x 92 x 160 x 224, chunk 16) each
// branch is a (tokens x 224) @ (224 x 224) product, 47 GFLOP for both (0.048
// ms on the tensor cores) against 422 MB of x, c in and h, w out (0.126
// ms); at stage 3 (16 x 23 x 40 x 448, chunk 8) 12.3 GFLOP (0.012 ms)
// against 52.8 MB (0.016 ms).  The big form's kernel above holds both C x
// C weights in shared memory; here one is 100 KB (C = 224) or 392 KB (448).
//
// Units.  A unit is 64 tokens of one branch: 64 / cp = Gu groups of a
// chunk's L tokens (cp = L rounded up to a power of two; segments q >= L
// are zero tokens that write and sum nothing), one m64 wgmma row tile; a
// warp's 16 rows hold 16 / Gu whole segments (so one channel array a
// warpgroup takes the sums), laid out so a store's lanes hit several.
// Branch H: Gu columns x one L-row chunk; branch W: Gu rows x one L-column
// chunk.  Its x comes by one TMA
// box of all C channels (a 5-D map, C in pieces of <= 256) into a ring
// slot: 28 KB at stage 1, 56 KB at stage 3.  Rows and columns past the
// frame read as zeros; the store clips them.  Each block runs one branch
// (the grid is split between them in proportion to their units), so it
// needs one weight; x is read once per branch (527 MB at stage 1: a bound
// of 0.157 ms, not 0.126).
//
// Weights.  A pack launch writes each weight as a wgmma B image in column
// tiles of NT = 8 G (C x NT each, K-major core matrices; G = 16 at stage
// 1/5, 8 at stage 3: a tile a whole block of 8 channels).  Its output
// columns come in blocks of 8 channels: tile t holds channels 8 zb .. 8 zb
// + 7 (zb = t / tpz) at G chunk positions P from (t % tpz) G, column 8 (P -
// P0) + i being channel 8 zb + i -- so accumulator lane l4 holds channels
// 8 zb + 2 l4 + {0, 1} of every position: 4-byte output stores to 8
// different channels a quad (a channel-major order put the quad's lanes 4
// positions apart, one bank), and a thread's sums stay per channel over
// the tile.  Columns past S (padded to 8) or past the chunk are zero.
// Resident (where the image fits beside two slots a warpgroup: C <= 224):
// one bulk copy per block.  Streamed (C = 448: 56 KB tiles, two slots):
// the first warpgroup's first warp streams the tiles through a ring, each tile
// shared by both warpgroups (an empty barrier of 8 warp arrivals), which
// walk their units in step (one with fewer units takes the last step's
// tiles without one).
//
// Per unit: the token matrix is formed straight into register-A fragments
// from the slot (as in the big form's kernel: k pairs of neighbouring
// channels, one 4-byte read for even S); per column tile, m64nNTk16
// against the tile; the epilogue relu(acc + b) / C, rounded once, lands at
// its (token, feature)'s own x element, so the output is staged in place
// and leaves by TMA store.
// The accumulator is one tile's (NT / 2 registers), not C / 2.
//
// Sums, without atomics, in one fixed order: (1) each thread adds its
// positions per channel, its two rows where they share a segment q; (2)
// shuffles add the lanes of the segment (2 at stage 1, 4 at stage 3) and
// one lane writes the (q, channel) total; (3) morphfc_final_kernel adds
// the walkers' and c's partials.  At the compile-time path shapes a tile
// is a whole 8-channel block, so (1) runs in registers over all the
// walker's units of a frame and (2) once a frame, straight into the
// walker's partial row (no channel array: the shared memory that frees
// holds stage 3's 56 KB tiles); elsewhere (2) runs at each tile's end into
// a channel array a warpgroup, which goes into the partial at a change of
// frame.  Walkers are frame-aligned (wpf walkers share
// a frame's units, or one walker takes fpw whole frames), so the partial
// holds N x (a few) rows: stage 3 writes 0.9 MB, not a row per walker and
// frame.  Why the 8-channel blocks: with the columns in channel-major
// order a fold (shuffles, a shared-memory read-modify-write) came every 8
// or 16 columns and a quad's 2-byte stores hit one bank; the two made the
// epilogue the kernel's largest cost.
constexpr int kTokWg = 2;       // consumer warpgroups a block
constexpr int kTokRingMax = 2;  // x slots a warpgroup
constexpr int kTokWMax = 8;     // weight tiles resident, or ring slots

// The plan as the wrapper computes it (morphfc_fused.token_plan, its fields
// in the order of TOKEN_PLAN_FIELDS and TOKEN_BRANCH_FIELDS there): every
// decision -- the tile width, the compile-time shapes, residence, rings,
// the grid's split -- and each branch's geometry are made there once;
// vmg_morphfc_axes_token only checks that the kernel can run the plan.
struct TokPlanBranch {
  int L, S, lgu, tpz, ucols, upf, ntiles, blocks, wpf, fpw;
};
struct TokPlan {
  int nt, exact, resident, ring, wring, nws, sc, per_c, stot;
  TokPlanBranch br[2];
};

struct TokMaps {
  CUtensorMap x[2], out[2];  // per branch (0: H, 1: W): x, and h / w; 5-D, one unit a box
};

struct TokBranch {
  const bf16* img;            // B image: ntiles x (C / 8) x NT x 8
  const float* bias;          // its bias, ntiles x NT; null: no bias
  int L, S, lgu, tpz;         // chunk, C / L, log2 of groups a unit (64 / cp), tiles a zb
  int ucols, upf, ntiles;     // units a unit row, a frame; column tiles
  unsigned box_bytes;         // a unit's x box (Gu x L positions of C channels)
  int blocks, block0;         // the branch's blocks, its first
  int wpf, fpw, slot0;        // walkers a frame (fpw == 0) or frames a walker; first partial row
};

struct TokArgs {
  TokBranch br[2];
  float* partial;
  int N, H, W, C, KS, stot;
  float floor;  // the epilogue's relu floor: 0, or -inf (non_linear off)
  int ring, resident, wring, nws;
  unsigned slot_bytes, tile_bytes;
  unsigned off_w, off_sum, off_bar;
};

// The shared memory of the bf16 kernel (morphfc_fused.token_smem): the
// rings, the weights (resident: all tiles; else wtiles ring slots), nws
// channel arrays a warpgroup, the barriers.
struct TokLayout {
  unsigned slot, off_w, off_sum, off_bar, total;
  __host__ __device__ TokLayout(int C, int NT, int ring, int wtiles, int nws) {
    slot = ((unsigned)64 * C * 2 + 127) / 128 * 128;
    off_w = kTokWg * ring * slot;
    off_sum = off_w + (unsigned)wtiles * C * NT * 2;
    off_bar = off_sum + kTokWg * nws * C * 4;
    total = off_bar + (kTokWg * kTokRingMax + 2 * kTokWMax) * 8;
  }
};

// the pack launch: each branch's B image and bias image (none without a bias)
struct TokPack {
  const bf16* k[2];
  const float* b[2];  // null: no bias
  bf16* img[2];
  float* bimg[2];
  int L[2], S[2], tpz[2];
  int C, NT, chunks0, chunks;  // 16-byte chunks of branch 0's image, of both
};

// image column n of tile t: channel Z = 8 (t / tpz) + n % 8 at chunk
// position P = (t % tpz) NT / 8 + n / 8, plain column P S + Z (zero past S
// or the chunk)
__global__ void __launch_bounds__(256)
morphfc_axes_token_pack_kernel(const TokPack p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.chunks) return;
  const int br = i < p.chunks0 ? 0 : 1, e = br ? i - p.chunks0 : i;
  const int C = p.C, NT = p.NT, KG = C / 8;
  const int nn = e % NT, rest = e / NT, kg = rest % KG, t = rest / KG;
  const int Z = 8 * (t / p.tpz[br]) + nn % 8, P = (t % p.tpz[br]) * (NT / 8) + nn / 8;
  const bool real = Z < p.S[br] && P < p.L[br];
  const int f = P * p.S[br] + Z;
  alignas(16) bf16 v[8];
#pragma unroll
  for (int ki = 0; ki < 8; ++ki)
    v[ki] = real ? p.k[br][(size_t)(8 * kg + ki) * C + f] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(p.img[br] + (size_t)e * 8) = *reinterpret_cast<const uint4*>(v);
  if (kg == 0 && p.b[br] != nullptr) p.bimg[br][t * NT + nn] = real ? p.b[br][f] : 0.f;
}

// KSMAX: k-steps of the fragments (an upper bound of the run-time C / 16);
// NT: columns a tile (8 G); LX > 0: the shape is compile-time, C = 16 KSMAX
// and both chunks LX (the path shapes: C = 224, chunk 16; C = 448, chunk
// 8), so the index arithmetic folds to constants, the epilogue has no
// run-time branch and the k-steps no guard (a guarded wgmma gets a
// warpgroup fence of its own, C7519)
template <int KSMAX, int NT, int LX>
__global__ void __launch_bounds__(kTokWg * 128, 1)
morphfc_axes_token_wgmma_kernel(const __grid_constant__ TokMaps maps,
                                const __grid_constant__ TokArgs a) {
  constexpr bool EXACT = LX > 0;
  constexpr int NG = NT / 8;  // chunk positions a tile
  // a compile-time shape whose tiles each hold a whole 8-channel block
  // keeps its sums in registers: rsum[zb][e] is channel 8 zb + 2 l4 + e of
  // the thread's segment, over all its units of the frame
  constexpr bool REG = EXACT && NG >= LX;
  constexpr int NZB = EXACT ? (16 * KSMAX / (LX > 0 ? LX : 1) + 7) / 8 : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if ((su32(base) & 127) != 0) __trap();
  const int b = blockIdx.x < a.br[0].blocks ? 0 : 1;
  const TokBranch& B = a.br[b];
  const int C = EXACT ? 16 * KSMAX : a.C, KS = EXACT ? KSMAX : a.KS;
  unsigned char* wts = base + a.off_w;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(base + a.off_bar);
  uint64_t* wfull = xfull + kTokWg * kTokRingMax;
  uint64_t* wempty = wfull + kTokWMax;
  const int g = threadIdx.x >> 7, tid = threadIdx.x & 127, wq = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, l4 = lane & 3;
  const bool leader = tid == 0;  // issues the warpgroup's copies and stores
  // the warpgroup's channel arrays: one, or (Gu >= 32: a segment's rows
  // span warps) one a warp
  float* ws = reinterpret_cast<float*>(base + a.off_sum) + (size_t)g * a.nws * C;
  float* wsw = ws + (size_t)(a.nws == 1 ? 0 : wq) * C;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTokWg * kTokRingMax; ++i) mbar_init(xfull + i, 1);
    for (int i = 0; i < kTokWMax; ++i) mbar_init(wfull + i, 1), mbar_init(wempty + i, 4 * kTokWg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kTokWg * a.nws * C; i += blockDim.x)
    reinterpret_cast<float*>(base + a.off_sum)[i] = 0.f;
  __syncthreads();

  // walker k of the branch: units [u0, u1) of the branch's list, its
  // partial row within a frame
  auto range = [&](int k, int& u0, int& u1, int& slot) {
    slot = 0;
    if (B.fpw == 0) {
      if (k >= a.N * B.wpf) {
        u0 = u1 = 0;
        return;
      }
      const int f = k / B.wpf, sub = k - f * B.wpf;
      u0 = f * B.upf + (int)((long long)sub * B.upf / B.wpf);
      u1 = f * B.upf + (int)((long long)(sub + 1) * B.upf / B.wpf);
      slot = sub;
    } else {
      const int f0 = min(a.N, k * B.fpw), f1 = min(a.N, f0 + B.fpw);
      u0 = f0 * B.upf, u1 = f1 * B.upf;
    }
  };
  const int kb = blockIdx.x - B.block0;
  int u0 = 0, u1 = 0, myslot = 0, steps = 0;
#pragma unroll
  for (int w = 0; w < kTokWg; ++w) {
    int v0, v1, sv;
    range(kTokWg * kb + w, v0, v1, sv);
    steps = max(steps, v1 - v0);
    if (w == g) u0 = v0, u1 = v1, myslot = sv;
  }
  const int nmine = u1 - u0;
  // weight tiles: resident, the whole image once; streamed, tile seq of
  // the block's walk (steps x ntiles) into slot seq % wring, issued by the
  // first warp of the first warpgroup once both warpgroups are done with
  // tile seq - wring.  The whole warp waits for that and its lane 0
  // issues: were lane 0 alone to wait on the other warpgroup, its warp's
  // other lanes could run on into the .aligned wgmma instructions without
  // it
  const int wtotal = steps * B.ntiles;
  auto issue_w = [&](int seq) {
    if (seq >= wtotal) return;
    const int s = seq % a.wring;
    if (seq >= a.wring) mbar_wait(wempty + s, (seq / a.wring - 1) & 1);
    if (lane == 0) {
      mbar_expect(wfull + s, a.tile_bytes);
      bulk_load(wts + (size_t)s * a.tile_bytes,
                B.img + (size_t)(seq % B.ntiles) * (a.tile_bytes / 2), a.tile_bytes, wfull + s);
    }
    __syncwarp();
  };
  const bool wwarp = g == 0 && wq == 0 && !a.resident;  // warp-uniform
  if (threadIdx.x == 0 && a.resident && steps > 0) {
    mbar_expect(wfull, B.ntiles * a.tile_bytes);
    bulk_load(wts, B.img, B.ntiles * a.tile_bytes, wfull);
  }
  if (wwarp)
    for (int seq = 0; seq < a.wring - 1; ++seq) issue_w(seq);

  unsigned char* ring = base + (size_t)g * a.ring * a.slot_bytes;
  uint64_t* full = xfull + g * kTokRingMax;
  const int L = EXACT ? LX : B.L, S = EXACT ? 16 * KSMAX / LX : B.S;
  const int lgu = EXACT ? 6 - (LX > 8 ? (LX > 16 ? (LX > 32 ? 6 : 5) : 4) : LX > 4 ? 3 : 2) : B.lgu;
  const int gu = 1 << lgu, tpz = EXACT && NG >= LX ? 1 : B.tpz;
  const float inv_c = 1.f / C;
  // unit u of the branch's list: frame n, first row y0, first column x0
  auto unit_at = [&](int u, int& n, int& y0, int& x0) {
    n = u / B.upf;
    const int r = u - n * B.upf, ur = r / B.ucols, uc = r - ur * B.ucols;
    y0 = ur * (b == 0 ? L : gu);
    x0 = uc * (b == 0 ? gu : L);
  };
  auto issue = [&](int i) {  // the warpgroup's i-th unit into slot i % ring
    if (i >= nmine) return;
    int n, y0, x0;
    unit_at(u0 + i, n, y0, x0);
    mbar_expect(full + i % a.ring, B.box_bytes);
    tma_load_5d(ring + (size_t)(i % a.ring) * a.slot_bytes, &maps.x[b], 0, 0, x0, y0, n,
                full + i % a.ring);
  };
  if (leader)
    for (int i = 0; i < a.ring - 1; ++i) issue(i);

  // the thread's two accumulator rows (gr, gr + 8 of its warp): tokens
  // (group grp, segment q).  A warp holds QW = 16 / Gu segments (Gu <= 16)
  // of all Gu groups: lane row gr is segment gr % QW of group gr / QW (+ 8 /
  // QW for the second row), so the lanes of one store hit QW segments and
  // both rows share one; a segment's 16 x Gu / 16 rows lie in one warp (for
  // Gu >= 32 it spans Gu / 16 warps, with a channel array each)
  const int lqw = max(0, 4 - lgu);
  int rowpart[2], q[2], grp[2];
  bool real[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (lgu >= 5) {
      const int m = 16 * wq + gr + 8 * hh;
      q[hh] = m >> lgu, grp[hh] = m & (gu - 1);
    } else if (lqw == 4) {
      q[hh] = 16 * wq + gr + 8 * hh, grp[hh] = 0;
    } else {
      q[hh] = (wq << lqw) + (gr & ((1 << lqw) - 1));
      grp[hh] = (gr >> lqw) + (hh << (3 - lqw));
    }
    real[hh] = q[hh] < L;
    rowpart[hh] = (b == 0 ? grp[hh] * C : grp[hh] * L * C) + q[hh] * S;
  }
  const int cstride = b == 0 ? gu * C : C;
  const bool even = EXACT ? (16 * KSMAX / LX) % 2 == 0 : (S & 1) == 0;
  // fragment column 8 j + 2 l4 (+ 1) is feature (P, Z): its start and its step over j
  const int P0 = 2 * l4 / S, Z0 = 2 * l4 - P0 * S, dP = 8 / S, dZ = 8 - dP * S;
  // the rows share q except where a warp holds 16 segments; the lanes of a
  // segment differ in gr's bits from lsh on
  const bool hshare = lqw < 4;
  const int lsh = min(lqw, 3);
  const bool owner = (gr >> lsh) == 0;

  // (2) a tile's per-thread sums rs[hh][e] of channels zc + e into the
  // channel array: the rows sharing q, then the lanes sharing it
  auto fold = [&](int zc, float (&rs)[2][2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v0 = rs[0][e], v1 = rs[1][e];
      if (hshare) v0 += v1;
      for (int bb = lsh; bb < 3; ++bb) v0 += __shfl_xor_sync(0xffffffffu, v0, 4 << bb);
      const int Z = zc + e;
      if (owner && Z < S) {
        if (real[0]) wsw[q[0] * S + Z] += v0;
        if (!hshare && real[1]) wsw[q[1] * S + Z] += v1;
      }
    }
  };
  float rsum[NZB][2];
#pragma unroll
  for (int zb = 0; zb < NZB; ++zb) rsum[zb][0] = rsum[zb][1] = 0.f;
  // (3) the warpgroup's sums of frame n into the walker's partial row:
  // registers (the lanes of a segment added by shuffles, one lane a
  // segment writes its channels) or the channel arrays
  auto flush = [&](int n) {
    float* row = a.partial + ((size_t)n * a.stot + B.slot0 + myslot) * C;
    if constexpr (REG) {
#pragma unroll
      for (int zb = 0; zb < NZB; ++zb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = rsum[zb][e];
          rsum[zb][e] = 0.f;
          for (int bb = lsh; bb < 3; ++bb) v += __shfl_xor_sync(0xffffffffu, v, 4 << bb);
          const int Zc = 8 * zb + 2 * l4 + e;
          if (owner && real[0] && Zc < S) row[q[0] * S + Zc] = v;
        }
      return;
    }
    wg_bar(g);
    for (int ch = tid; ch < C; ch += 128) {
      float t = 0.f;
      for (int w = 0; w < a.nws; ++w) t += ws[(size_t)w * C + ch], ws[(size_t)w * C + ch] = 0.f;
      row[ch] = t;
    }
    wg_bar(g);
  };

  int cur = -1;
  for (int i = 0; i < steps; ++i) {
    if (i >= nmine) {  // no unit: keep step with the other warpgroup's tiles
      if (!a.resident)
        for (int t = 0; t < B.ntiles; ++t) {
          const int seq = i * B.ntiles + t, s = seq % a.wring;
          if (wwarp) issue_w(seq + a.wring - 1);
          mbar_wait(wfull + s, (seq / a.wring) & 1);
          if (lane == 0) mbar_arrive(wempty + s);
        }
      continue;
    }
    int n, y0, x0;
    unit_at(u0 + i, n, y0, x0);
    if (n != cur) {  // one call site: flush inlines
      if (cur >= 0) flush(cur);
      cur = n;
    }
    if (leader) {
      bulk_wait_read<0>();  // the last store has read its slot
      issue(i + a.ring - 1);
    }
    mbar_wait(full + i % a.ring, (i / a.ring) & 1);
    bf16* xs = reinterpret_cast<bf16*>(ring + (size_t)(i % a.ring) * a.slot_bytes);
    // positions in the frame, for the sums: the rows' groups, and (H) the
    // chunk positions P < prow
    bool sv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      sv[hh] = real[hh] && (b == 0 ? x0 + grp[hh] < a.W : y0 + grp[hh] < a.H);
    const int prow = b == 0 ? min(L, a.H - y0) : L;
    uint32_t fr[KSMAX][4];
    {
      int P = P0, Z = Z0;
#pragma unroll
      for (int j = 0; j < 2 * KSMAX; ++j) {
        if (EXACT || j < 2 * KS) {
          int P1 = P, Z1 = Z + 1;
          if (Z1 == S) Z1 = 0, P1 = P + 1;
          const int c0 = P * cstride + Z, c1 = P1 * cstride + Z1;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t v = 0;
            if (real[hh]) {
              const bf16* src = xs + rowpart[hh];
              if (even) {
                v = *reinterpret_cast<const uint32_t*>(src + c0);
              } else {
                const unsigned short lo = *reinterpret_cast<const unsigned short*>(src + c0);
                const unsigned short hi = *reinterpret_cast<const unsigned short*>(src + c1);
                v = (uint32_t)lo | ((uint32_t)hi << 16);
              }
            }
            fr[j >> 1][(j & 1) * 2 + hh] = v;
          }
          P += dP, Z += dZ;
          if (Z >= S) Z -= S, ++P;
        } else {
          fr[j >> 1][(j & 1) * 2] = fr[j >> 1][(j & 1) * 2 + 1] = 0;
        }
      }
    }
    auto tile = [&](const int t) {
      const int seq = i * B.ntiles + t, s = seq % a.wring;
      unsigned bsm;
      if (a.resident) {
        if (i == 0 && t == 0) mbar_wait(wfull, 0);
        bsm = su32(wts) + t * a.tile_bytes;
      } else {
        if (wwarp) issue_w(seq + a.wring - 1);
        mbar_wait(wfull + s, (seq / a.wring) & 1);
        bsm = su32(wts) + s * a.tile_bytes;
      }
      // the warp converged for the .aligned wgmma; ahead of the bias loads,
      // which a __syncwarp after them would wait for (stage 1/5 ran 14%
      // slower so)
      __syncwarp();
      // the tile's bias (its columns 8 j + 2 l4 + {0, 1}), in flight during the product
      const int zc = 8 * (t / tpz), pb = (t - (t / tpz) * tpz) * NG, Z = zc + 2 * l4;
      float2 bj[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j)
        bj[j] = B.bias != nullptr
                    ? __ldg(reinterpret_cast<const float2*>(B.bias + t * NT + 8 * j + 2 * l4))
                    : make_float2(0.f, 0.f);
      float acc[NT / 2];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KSMAX; ++ks)
        if (EXACT || ks < KS)
          WgmmaRA<NT>::mma(acc, fr[ks], mat_desc(bsm + ks * 2 * NT * 16, NT * 16, 128), ks != 0);
      wg_commit();
      pin_regs(acc);
      wg_wait<0>();
      pin_regs(acc);
#pragma unroll
      for (int ks = 0; ks < KSMAX; ++ks)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) asm volatile("" : "+r"(fr[ks][qq])::"memory");
      if (!a.resident && lane == 0) mbar_arrive(wempty + s);  // this warp is done with the tile
      // epilogue: register 4 j + 2 hh + e is row hh, channel zc + 2 l4 + e
      // at chunk position pb + j; stored where the row is a token and the
      // channel real, summed where the position lies in the frame
      const bool zok = Z < S;
      bool st[2];
      bf16* ob[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        st[hh] = zok && real[hh];
        ob[hh] = xs + rowpart[hh] + pb * cstride + Z;
      }
      float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      // one copy of the loop a parity of S: even, a 4-byte store a pair
      auto epilogue = [&](auto is_even) {
        constexpr bool EV = decltype(is_even)::value;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int P = pb + j;
          if (!(EXACT && NG == LX) && P >= L) break;  // warp-uniform
          const bool in = P < prow;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float y0v = fmaxf(acc[4 * j + 2 * hh] + bj[j].x, a.floor) * inv_c;
            const float y1v = fmaxf(acc[4 * j + 2 * hh + 1] + bj[j].y, a.floor) * inv_c;
            bf16* o = ob[hh] + j * cstride;
            if (EV) {
              if (st[hh]) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0v, y1v);
            } else {
              if (st[hh]) o[0] = __float2bfloat16_rn(y0v);
              if (st[hh] && Z + 1 < S) o[1] = __float2bfloat16_rn(y1v);
            }
            const bool sum = in && sv[hh];
            if constexpr (REG) {  // the rows share q (hshare at both path shapes)
              rsum[t][0] += sum ? y0v : 0.f;
              rsum[t][1] += sum ? y1v : 0.f;
            } else {
              rs[hh][0] += sum ? y0v : 0.f;
              rs[hh][1] += sum ? y1v : 0.f;
            }
          }
        }
      };
      if (even)
        epilogue(std::true_type());
      else
        epilogue(std::false_type());
      if constexpr (!REG) fold(zc + 2 * l4, rs);
    };
    if constexpr (REG) {
#pragma unroll
      for (int t = 0; t < NZB; ++t) tile(t);
    } else {
      for (int t = 0; t < B.ntiles; ++t) tile(t);
    }
    fence_async_shared();  // the staged output, visible to the TMA store
    __syncwarp();
    wg_bar(g);
    if (leader) {
      tma_store_5d(&maps.out[b], xs, 0, 0, x0, y0, n);
      bulk_commit();
    }
  }
  if (cur >= 0) flush(cur);
  if (leader) bulk_wait<0>();  // the stores are done before the block's shared memory goes
}

template <int KSMAX, int NT, int LX>
int launch_axes_token_wgmma(const TokMaps& m, const TokArgs& a, unsigned smem, cudaStream_t st) {
  auto kern = morphfc_axes_token_wgmma_kernel<KSMAX, NT, LX>;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    const int e = set_smem(kern, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  kern<<<a.br[0].blocks + a.br[1].blocks, kTokWg * 128, smem, st>>>(m, a);
  return (int)cudaGetLastError();
}

#if !defined(VMG_MORPHFC_PART) || VMG_MORPHFC_PART == 4
// ---- f32: the same walk on 3xTF32 wgmma, the weight streamed in stages -----
//
// Bound: the tensor cores at the 3xTF32 rate (every product three TF32
// products): at stage 1/5 (16 x 92 x 160 x 224, chunk 16) 3 x 47.27 GFLOP,
// 0.287 ms, against 844.2 MB of x, c in and h, w out (0.252 ms); at stage
// 3 (16 x 23 x 40 x 448, chunk 8) 0.072 ms against 0.032 ms.  The bf16
// kernel's units (64 tokens of one branch by one 5-D TMA box), walkers,
// token rows, image column order (8-channel blocks) and sums, with what
// f32 changes:
// - Shared memory: a unit is 57 KB at C = 224 and 115 KB at 448, and one
//   C x NT tile's hi and lo images 229 KB at NT = 128, so neither the image
//   nor two units a warpgroup fit.  The images stream in stages of kcs k8
//   steps of one column tile (32 KB where three fit, else 16 KB) through a
//   ring.  Where two units fit beside the ring (C <= 336: "solo") each
//   warpgroup walks its own units, one slot each (two where they fit), and
//   both read every stage: 128 tokens a pass over the weight (~1.8 GB of
//   L2 -> SM traffic at stage 1/5).  Above ("shared": stage 3) both
//   warpgroups work on one unit in one slot, each on half of its column
//   tiles, each with its own ring.  No warp waits for another to free a
//   slot: each counts itself done with a stage or a unit, and the last
//   issues the slot's next load.
// - Operands: the bf16 kernel holds a unit's fragments for the whole K (C /
//   2 registers); split into hi and lo they would be 2 C.  So each column
//   tile forms them again from the raw f32 slot, a commit group of two k8
//   steps at a time, split in registers (wgmma.cuh tf32_split), two sets
//   alternating: one group's fragments are read while the last group's
//   products run.  B: the tile's hi and lo images (the pack launch), rows
//   in the FFN stream's order 0, 2, 4, 6, 1, 3, 5, 7, so a register pair is
//   two neighbouring features (one 8-byte read where S is even).  Each
//   group's six products go into a fresh register tile, added into the
//   tile's sum with f32 adds: one long chain into one tile drifts toward
//   zero (the tensor cores truncate as they accumulate; the conv chain's
//   and the FFN's f32 kernels met it).
// - ptxas serializes a kernel's wgmmas (a wait after each, C7513 / C7514 /
//   C7520) when a branch or loop lies between a group's wait and its
//   products, or when it recomputes the fragments into one register quad
//   just before each product.  So that span is straight-line code (the
//   waits and arrivals go before it or after the commit), and a running
//   xor reads each fragment set before its products and after they are
//   done, which keeps the sets in registers of their own (ptxas sees no
//   empty asm statement, so pinning them that way does nothing).
// - Epilogue: the slot holds x until the unit's last tile has read it, so
//   the output is not staged there: max(acc + b, floor) / C goes from the
//   accumulator to h or w (8-byte stores where S is even: a quad's lanes
//   write 32 contiguous bytes of one position).
// - Sums: as the bf16 kernel's (registers at the compile-time path shapes,
//   channel arrays elsewhere), one partial row a warpgroup; c's partials
//   from morphfc_partial_kernel, the final pass as before.
// The scalar kernel this replaced (one block per ch x WT slab, the tokens
// scattered into shared memory a float at a time, C x 32 weight tiles from
// L2 for every 32 token rows, two shared loads an FMA, the product through
// shared memory) ran at 0.077 (stage 1/5) and 0.056 (stage 3) of its
// f32-FMA bound and lost 2.3-4.5x to the 'hybrid' form (PERF.md).
constexpr int kTfStMax = 8;  // weight ring stages a stream
constexpr int kTfKB = 2;     // k8 steps a commit group

// The plan as the wrapper computes it (morphfc_fused.token_f32_plan, its
// fields in the order of TOKEN_F32_PLAN_FIELDS, then TOKEN_BRANCH_FIELDS
// a branch); the walkers are warpgroups (solo) or blocks (shared).
struct TokF32Plan {
  int nt, exact, shared, ring, kcs, nst, nws, sc, per_c, stot;
  TokPlanBranch br[2];
};

struct TokF32Branch {
  const float* img;       // hi and lo images: ntiles x (C / 8) x 2 x 2 x NT x 4
  const float* bias;      // ntiles x NT; null: no bias
  float* out;             // h or w, (N, H, W, C)
  int L, S, lgu, tpz;     // as TokBranch's
  int ucols, upf, ntiles;
  unsigned box_bytes;     // a unit's x box
  int blocks, block0, wpf, fpw, slot0;
};

struct TokF32Args {
  TokF32Branch br[2];
  float* partial;
  int N, H, W, C, stot;
  float floor;  // 0, or -inf (non_linear off)
  int shared, ring, kcs, nst, nws;
  unsigned slot_bytes, off_w, off_sum, off_bar;
};

// The shared memory (morphfc_fused.token_f32_smem): the x slots (a ring a
// warpgroup, or one a block where shared), the weight rings (one, or one a
// warpgroup), nws channel arrays a warpgroup, the barriers.
struct TokF32Layout {
  unsigned slot, off_w, off_sum, off_bar, total;
  __host__ __device__ TokF32Layout(int C, int NT, int shared, int ring, int kcs, int nst,
                                   int nws) {
    slot = ((unsigned)64 * C * 4 + 127) / 128 * 128;
    off_w = (shared ? 1 : kTokWg) * ring * slot;
    off_sum = off_w + (shared ? kTokWg : 1) * nst * (unsigned)kcs * 64 * NT;
    off_bar = off_sum + kTokWg * nws * C * 4;
    total = off_bar + (kTokWg * kTokRingMax + kTokRingMax + 4 * kTfStMax) * 8;
  }
};

// the pack launch: each branch's hi and lo images, and bias image (none
// without a bias)
struct TokPackF32 {
  const float* k[2];
  const float* b[2];  // null: no bias
  float* img[2];
  float* bimg[2];
  int L[2], S[2], tpz[2];
  int C, NT, items0, items;  // (tile, k8 step, kb, column) items of branch 0's images, of both
};

// item (t, s, kb, n): k positions 4 kb + e (rows 8 s + 2 e + kb) of image
// column n of tile t -- channel Z = 8 (t / tpz) + n % 8 at chunk position P
// = (t % tpz) NT / 8 + n / 8, plain column P S + Z (zero past S or the
// chunk), as the bf16 image's -- its hi at ((t C / 8 + s) 16 NT + (kb NT +
// n) 4), its lo 8 NT further
__global__ void __launch_bounds__(256)
morphfc_axes_token_pack_tf32_kernel(const TokPackF32 p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.items) return;
  const int br = i < p.items0 ? 0 : 1, e = br ? i - p.items0 : i;
  const int C = p.C, NT = p.NT, KS8 = C / 8;
  const int nn = e % NT, rest = e / NT, kb = rest & 1, s = (rest >> 1) % KS8,
            t = (rest >> 1) / KS8;
  const int Z = 8 * (t / p.tpz[br]) + nn % 8, P = (t % p.tpz[br]) * (NT / 8) + nn / 8;
  const bool real = Z < p.S[br] && P < p.L[br];
  const int f = P * p.S[br] + Z;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    tf32_split(real ? p.k[br][(size_t)(8 * s + 2 * q + kb) * C + f] : 0.f, hi[q], lo[q]);
  float* o = p.img[br] + ((size_t)t * KS8 + s) * 16 * NT + (size_t)(kb * NT + nn) * 4;
  *reinterpret_cast<uint4*>(o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(o + 8 * NT) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  if (s == 0 && kb == 0 && p.b[br] != nullptr) p.bimg[br][t * NT + nn] = real ? p.b[br][f] : 0.f;
}

// NT: columns a tile (8 G); CX > 0: the shape is compile-time, C = CX and
// both chunks LX (the path shapes: C = 224, chunk 16, NT = 128; C = 448,
// chunk 8, NT = 64), so the index arithmetic folds and the sums stay in
// registers
template <int NT, int CX, int LX>
__global__ void __launch_bounds__(kTokWg * 128, 1)
morphfc_axes_token_tf32_kernel(const __grid_constant__ TokMaps maps,
                               const __grid_constant__ TokF32Args a) {
  constexpr bool EXACT = CX > 0;
  constexpr int NG = NT / 8;  // chunk positions a tile
  // the compile-time shapes keep their sums in registers: rsum[zb][e] is
  // channel 8 zb + 2 l4 + e of the thread's segment, over its units of the frame
  constexpr int LXD = LX > 0 ? LX : 1;
  constexpr int NZB = EXACT ? (CX / LXD + 7) / 8 : 1;
  constexpr int KB = kTfKB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if ((su32(base) & 127) != 0) __trap();
  const int b = blockIdx.x < a.br[0].blocks ? 0 : 1;
  const TokF32Branch& B = a.br[b];
  const int C = EXACT ? CX : a.C, KS8 = C / 8;
  const bool shared = a.shared != 0;
  const int g = threadIdx.x >> 7, tid = threadIdx.x & 127, wq = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, l4 = lane & 3;
  // the barriers of the x slots and the weight stages, and counters of the
  // warps done with each (the last to finish issues the slot's next load:
  // no warp waits for another to release)
  uint64_t* xfull = reinterpret_cast<uint64_t*>(base + a.off_bar);
  unsigned* xrel = reinterpret_cast<unsigned*>(xfull + kTokWg * kTokRingMax);
  uint64_t* wfull = xfull + kTokWg * kTokRingMax + kTokRingMax;  // a stream's kTfStMax each
  unsigned* wrel = reinterpret_cast<unsigned*>(wfull + 2 * kTfStMax);
  // the warpgroup's channel arrays: one, or (Gu >= 32) one a warp
  float* ws = reinterpret_cast<float*>(base + a.off_sum) + (size_t)g * a.nws * C;
  float* wsw = ws + (size_t)(a.nws == 1 ? 0 : wq) * C;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTokWg * kTokRingMax; ++i) mbar_init(xfull + i, 1), xrel[i] = 0;
    for (int i = 0; i < 2 * kTfStMax; ++i) mbar_init(wfull + i, 1), wrel[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kTokWg * a.nws * C; i += blockDim.x)
    reinterpret_cast<float*>(base + a.off_sum)[i] = 0.f;
  __syncthreads();

  // walker k of the branch: units [u0, u1) of the branch's list, its
  // partial row within a frame
  auto range = [&](int k, int& u0, int& u1, int& slot) {
    slot = 0;
    if (B.fpw == 0) {
      if (k >= a.N * B.wpf) {
        u0 = u1 = 0;
        return;
      }
      const int f = k / B.wpf, sub = k - f * B.wpf;
      u0 = f * B.upf + (int)((long long)sub * B.upf / B.wpf);
      u1 = f * B.upf + (int)((long long)(sub + 1) * B.upf / B.wpf);
      slot = sub;
    } else {
      const int f0 = min(a.N, k * B.fpw), f1 = min(a.N, f0 + B.fpw);
      u0 = f0 * B.upf, u1 = f1 * B.upf;
    }
  };
  const int blk = blockIdx.x - B.block0;
  int u0 = 0, u1 = 0, myslot = 0, steps = 0;
  if (shared) {  // the block is the walker; a row a warpgroup
    range(blk, u0, u1, myslot);
    steps = u1 - u0, myslot = 2 * myslot + g;
  } else {
#pragma unroll
    for (int w = 0; w < kTokWg; ++w) {
      int v0, v1, sv;
      range(kTokWg * blk + w, v0, v1, sv);
      steps = max(steps, v1 - v0);
      if (w == g) u0 = v0, u1 = v1, myslot = sv;
    }
  }
  const int nmine = u1 - u0;

  // The weight stream: solo, one for the block, every column tile of every
  // step; shared, one a warpgroup, its tiles t = g, g + 2, ...  Stage seq
  // of a stream holds kcs k8 steps (fewer at a tile's end) of one tile,
  // into ring slot seq % nst, issued by the last of its slot's readers to be
  // done with stage seq - nst (a warp counts itself done after the products
  // reading it; 8 warps solo, the warpgroup's 4 shared).  No warp waits for
  // another: a producer that waited at each stage for the other
  // warpgroup's release held the two in step.
  const int t0 = shared ? g : 0, tstep = shared ? 2 : 1;
  const int ntl = (B.ntiles - t0 + tstep - 1) / tstep;
  const int nkc = (KS8 + a.kcs - 1) / a.kcs, per_step = ntl * nkc, wtotal = steps * per_step;
  const unsigned stage_bytes = (unsigned)a.kcs * 64 * NT;
  const int st = shared ? g : 0;
  unsigned char* wring = base + a.off_w + (size_t)st * a.nst * stage_bytes;
  uint64_t* sfull = wfull + st * kTfStMax;
  unsigned* srel = wrel + st * kTfStMax;
  auto issue_w = [&](int seq) {  // one thread
    if (seq >= wtotal) return;
    const int s = seq % a.nst, r = seq % per_step, lt = r / nkc, kc = r - lt * nkc;
    const unsigned bytes = (unsigned)min(a.kcs, KS8 - kc * a.kcs) * 64 * NT;
    mbar_expect(sfull + s, bytes);
    bulk_load(wring + (size_t)s * stage_bytes,
              B.img + ((size_t)(t0 + lt * tstep) * KS8 + (size_t)kc * a.kcs) * 16 * NT, bytes,
              sfull + s);
  };
  // the warp is done with stage seq (whole warp)
  auto release_w = [&](int seq) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(srel + seq % a.nst, 1u) == (shared ? 3u : 4u * kTokWg - 1)) {
        atomicExch(srel + seq % a.nst, 0u);
        issue_w(seq + a.nst);
      }
    }
    __syncwarp();
  };
  if (tid == 0 && (shared || g == 0))
    for (int seq = 0; seq < a.nst; ++seq) issue_w(seq);

  // x: unit i of the walker into slot i % ring, issued by the first warp's
  // lane 0 (of each warpgroup, or of the first where shared) and then by
  // the last of the slot's readers to be done with unit i - ring
  unsigned char* xring = base + (shared ? 0 : (size_t)g * a.ring * a.slot_bytes);
  uint64_t* full = xfull + (shared ? 0 : g * kTokRingMax);
  const int L = EXACT ? LX : B.L, S = EXACT ? CX / LXD : B.S;
  const int lgu = EXACT ? 6 - (LX > 8 ? (LX > 16 ? (LX > 32 ? 6 : 5) : 4) : LX > 4 ? 3 : 2) : B.lgu;
  const int gu = 1 << lgu, tpz = EXACT ? 1 : B.tpz;
  const float inv_c = 1.f / C;
  // unit u of the branch's list: frame n, first row y0, first column x0
  auto unit_at = [&](int u, int& n, int& y0, int& x0) {
    n = u / B.upf;
    const int r = u - n * B.upf, ur = r / B.ucols, uc = r - ur * B.ucols;
    y0 = ur * (b == 0 ? L : gu);
    x0 = uc * (b == 0 ? gu : L);
  };
  auto issue_x = [&](int i) {  // one thread
    if (i >= nmine) return;
    int n, y0, x0;
    unit_at(u0 + i, n, y0, x0);
    mbar_expect(full + i % a.ring, B.box_bytes);
    tma_load_5d(xring + (size_t)(i % a.ring) * a.slot_bytes, &maps.x[b], 0, 0, x0, y0, n,
                full + i % a.ring);
  };
  if (tid == 0 && (!shared || g == 0))
    for (int i = 0; i < a.ring; ++i) issue_x(i);
  // the warp is done with unit i's slot (whole warp)
  auto release_x = [&](int i) {
    __syncwarp();
    if (lane == 0) {
      unsigned* c = xrel + (shared ? 0 : g * kTokRingMax) + i % a.ring;
      __threadfence_block();
      if (atomicAdd(c, 1u) == (shared ? 4u * kTokWg - 1 : 3u)) {
        atomicExch(c, 0u);
        issue_x(i + a.ring);
      }
    }
    __syncwarp();
  };

  // the thread's two accumulator rows, as the bf16 kernel's: tokens
  // (group grp, segment q), a segment's rows in one warp for Gu <= 16
  const int lqw = max(0, 4 - lgu);
  int rowpart[2], q[2], grp[2];
  bool real[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (lgu >= 5) {
      const int m = 16 * wq + gr + 8 * hh;
      q[hh] = m >> lgu, grp[hh] = m & (gu - 1);
    } else if (lqw == 4) {
      q[hh] = 16 * wq + gr + 8 * hh, grp[hh] = 0;
    } else {
      q[hh] = (wq << lqw) + (gr & ((1 << lqw) - 1));
      grp[hh] = (gr >> lqw) + (hh << (3 - lqw));
    }
    real[hh] = q[hh] < L;
    rowpart[hh] = (b == 0 ? grp[hh] * C : grp[hh] * L * C) + q[hh] * S;
  }
  const int cstride = b == 0 ? gu * C : C;
  const bool even = EXACT ? (CX / LXD) % 2 == 0 : (S & 1) == 0;
  // fragment column 8 j + 2 l4 (+ 1) is feature (P, Z): its start and its step over j
  const int P0 = 2 * l4 / S, Z0 = 2 * l4 - P0 * S, dP = 8 / S, dZ = 8 - dP * S;
  const bool hshare = lqw < 4;
  const int lsh = min(lqw, 3);
  const bool owner = (gr >> lsh) == 0;
  // a position's step in h / w: a row of the frame (H) or a column (W)
  const size_t pstride = b == 0 ? (size_t)a.W * C : (size_t)C;

  // a tile's per-thread sums rs[hh][e] of channels zc + e into the channel
  // array: the rows sharing q, then the lanes sharing it
  auto fold = [&](int zc, float (&rs)[2][2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v0 = rs[0][e], v1 = rs[1][e];
      if (hshare) v0 += v1;
      for (int bb = lsh; bb < 3; ++bb) v0 += __shfl_xor_sync(0xffffffffu, v0, 4 << bb);
      const int Z = zc + e;
      if (owner && Z < S) {
        if (real[0]) wsw[q[0] * S + Z] += v0;
        if (!hshare && real[1]) wsw[q[1] * S + Z] += v1;
      }
    }
  };
  float rsum[NZB][2];
#pragma unroll
  for (int zb = 0; zb < NZB; ++zb) rsum[zb][0] = rsum[zb][1] = 0.f;
  // the warpgroup's sums of frame n into its partial row
  auto flush = [&](int n) {
    float* row = a.partial + ((size_t)n * a.stot + B.slot0 + myslot) * C;
    if constexpr (EXACT) {
#pragma unroll
      for (int zb = 0; zb < NZB; ++zb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = rsum[zb][e];
          rsum[zb][e] = 0.f;
          for (int bb = lsh; bb < 3; ++bb) v += __shfl_xor_sync(0xffffffffu, v, 4 << bb);
          const int Zc = 8 * zb + 2 * l4 + e;
          if (owner && real[0] && Zc < S) row[q[0] * S + Zc] = v;
        }
      return;
    }
    wg_bar(g);
    for (int ch = tid; ch < C; ch += 128) {
      float t = 0.f;
      for (int w = 0; w < a.nws; ++w) t += ws[(size_t)w * C + ch], ws[(size_t)w * C + ch] = 0.f;
      row[ch] = t;
    }
    wg_bar(g);
  };

  int seq = 0, cur = -1;  // the stream's next stage; the frame of the sums
  // a running xor of the token fragments: read right before a group's
  // products and again after they are done, so that ptxas computes them
  // ahead of the products and keeps their registers until then (else it
  // recomputes each into one register quad just before its product, which
  // it must then serialize: a wait after every wgmma)
  uint32_t sink = 0;
  for (int i = 0; i < steps; ++i) {
    if (i >= nmine) {  // solo, no unit: keep step with the other warpgroup's stages
      for (int r = 0; r < per_step; ++r, ++seq) {
        mbar_wait(sfull + seq % a.nst, (seq / a.nst) & 1);
        release_w(seq);
      }
      continue;
    }
    int n, y0, x0;
    unit_at(u0 + i, n, y0, x0);
    if (n != cur) {  // one call site: flush inlines
      if (cur >= 0) flush(cur);
      cur = n;
    }
    mbar_wait(full + i % a.ring, (i / a.ring) & 1);
    const float* xs = reinterpret_cast<const float*>(xring + (size_t)(i % a.ring) * a.slot_bytes);
    // the rows' tokens in the frame (stores and sums), their first
    // element in h / w, and (H) the chunk positions P < prow
    bool sv[2];
    size_t ob[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int yy = b == 0 ? y0 : y0 + grp[hh], xx = b == 0 ? x0 + grp[hh] : x0;
      sv[hh] = real[hh] && yy < a.H && xx < a.W;
      ob[hh] = sv[hh] ? (((size_t)n * a.H + yy) * a.W + xx) * C + q[hh] * S : 0;
    }
    const int prow = b == 0 ? min(L, a.H - y0) : L;

    for (int lt = 0; lt < ntl; ++lt) {
      const int t = t0 + lt * tstep;
      const int zb = t / tpz, pb = (t - zb * tpz) * NG, Z = 8 * zb + 2 * l4;
      float acc[NT / 2], part[NT / 2];  // the tile's sum (f32 adds); a group's products
#pragma unroll
      for (int k = 0; k < NT / 2; ++k) acc[k] = part[k] = 0.f;
      uint32_t xh0[KB][4], xl0[KB][4], xh1[KB][4], xl1[KB][4];
      int P = P0, Zf = Z0;       // the next fragment column's feature
      int js = 0, held = -1;     // the k8 step in the stage; the stage's ring slot
      int hseq = -1;             // the stage (its index in the stream)
      const bool last = lt == ntl - 1;  // the unit's last tile: its reads free the slot
      auto drain = [&]() {
        wg_wait<0>();
        pin_regs(part);
#pragma unroll
        for (int k = 0; k < NT / 2; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
        pin_regs(acc);
      };
      // k8 steps j0, j0 + 1.  ptxas serializes every wgmma of the kernel (a
      // wait after each) if a branch or loop lies between a group's wait and
      // its products (C7513 / C7514 / C7520), so that span -- the
      // fragments, the last group's products added (the first group of a
      // tile adds part's zeros), the descriptors, the products -- is
      // straight-line code, and the waits and barrier arrivals of the
      // stages and the slot go before it (the last group's products still
      // running) or after the commit
      auto group = [&](uint32_t(&xh)[KB][4], uint32_t(&xl)[KB][4],
                       uint32_t(&ph)[KB][4], uint32_t(&pl)[KB][4]) {
        const bool fresh = js == 0;  // the group opens a stage
        const int prev = hseq;
        if (fresh) {
          hseq = seq;
          held = seq % a.nst;
          mbar_wait(sfull + held, (seq / a.nst) & 1);
          ++seq;
        }
        __syncwarp();  // the warp converged for the .aligned wgmma
        const unsigned bsm = su32(wring) + (unsigned)held * stage_bytes + (unsigned)js * 64 * NT;
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          int P1 = P, Z1 = Zf + 1;
          Z1 = Z1 == S ? 0 : Z1;
          P1 = Z1 == 0 ? P + 1 : P1;
          const int c0 = P * cstride + Zf, c1 = P1 * cstride + Z1;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* src = xs + rowpart[hh];
            float v0, v1;
            if (EXACT) {  // S even: one 8-byte read
              const float2 v = *reinterpret_cast<const float2*>(src + c0);
              v0 = v.x, v1 = v.y;
            } else {
              v0 = src[c0], v1 = src[c1];
            }
            tf32_split(real[hh] ? v0 : 0.f, xh[u][hh], xl[u][hh]);
            tf32_split(real[hh] ? v1 : 0.f, xh[u][2 + hh], xl[u][2 + hh]);
          }
          P += dP, Zf += dZ;
          P = Zf >= S ? P + 1 : P;
          Zf = Zf >= S ? Zf - S : Zf;
        }
        drain();
#pragma unroll
        for (int u = 0; u < KB; ++u)
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) sink ^= ph[u][qq] ^ pl[u][qq] ^ xh[u][qq] ^ xl[u][qq];
        uint64_t dh[KB], dl[KB];  // the steps' hi and lo B descriptors
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          dh[u] = mat_desc(bsm + u * 64 * NT, NT * 16, 128);
          dl[u] = mat_desc(bsm + u * 64 * NT + 32 * NT, NT * 16, 128);
        }
        wg_fence();
        pin_regs(part);
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          WgmmaTF32<NT>::mma(part, xh[u], dh[u], u != 0);
          WgmmaTF32<NT>::mma(part, xh[u], dl[u], 1);
          WgmmaTF32<NT>::mma(part, xl[u], dh[u], 1);
        }
        wg_commit();
        pin_regs(part);
        js += KB;
        js = js >= a.kcs ? 0 : js;
        // the last stage's products were done at this group's drain (a
        // tile's last stage is released at the tile's end)
        if (fresh && prev >= 0) release_w(prev);
      };
      for (int j = 0; j < KS8; j += 2 * KB) {
        group(xh0, xl0, xh1, xl1);
        if (j + KB < KS8) group(xh1, xl1, xh0, xl0);
      }
      if (last) release_x(i);  // the unit's last read of its slot
      // the tile's bias (its columns 8 j + 2 l4 + {0, 1}), in flight during
      // the last products
      float2 bj[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j)
        bj[j] = B.bias != nullptr
                    ? __ldg(reinterpret_cast<const float2*>(B.bias + t * NT + 8 * j + 2 * l4))
                    : make_float2(0.f, 0.f);
      drain();
#pragma unroll
      for (int u = 0; u < KB; ++u)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) sink ^= xh0[u][qq] ^ xl0[u][qq] ^ xh1[u][qq] ^ xl1[u][qq];
      release_w(hseq);  // this warp is done with the tile's stages
      // epilogue: register 4 j + 2 hh + e is row hh, channel Z + e at chunk
      // position pb + j; stored and summed where the row's token and the
      // position lie in the frame and the channel is real
      const bool zok = Z < S;
      float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int Pj = pb + j;
        if (!(EXACT && NG == LX) && Pj >= L) break;  // warp-uniform
        const bool in = Pj < prow;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float y0v = fmaxf(acc[4 * j + 2 * hh] + bj[j].x, a.floor) * inv_c;
          const float y1v = fmaxf(acc[4 * j + 2 * hh + 1] + bj[j].y, a.floor) * inv_c;
          const bool sum = in && sv[hh];
          if (sum && zok) {
            float* o = B.out + ob[hh] + Pj * pstride + Z;
            if (even) {
              *reinterpret_cast<float2*>(o) = make_float2(y0v, y1v);
            } else {
              o[0] = y0v;
              if (Z + 1 < S) o[1] = y1v;
            }
          }
          rs[hh][0] += sum ? y0v : 0.f;
          rs[hh][1] += sum ? y1v : 0.f;
        }
      }
      if constexpr (EXACT) {  // the rows share q (hshare at both path shapes)
#pragma unroll
        for (int z = 0; z < NZB; ++z)
          if (z == zb) {
            rsum[z][0] += rs[0][0] + rs[1][0];
            rsum[z][1] += rs[0][1] + rs[1][1];
          }
      } else {
        fold(8 * zb + 2 * l4, rs);
      }
    }
  }
  if (cur >= 0) flush(cur);
  if (a.N < 0) a.partial[tid] = __uint_as_float(sink);  // never (N >= 1): keeps the xor
}

template <int NT, int CX, int LX>
int launch_axes_token_tf32(const TokMaps& m, const TokF32Args& a, int grid, unsigned smem,
                           cudaStream_t st) {
  auto kern = morphfc_axes_token_tf32_kernel<NT, CX, LX>;
  static bool smem_set = false;  // the largest size, once per instantiation
  if (!smem_set) {
    const int e = set_smem(kern, kMaxSmem);
    if (e) return e;
    smem_set = true;
  }
  kern<<<grid, kTokWg * 128, smem, st>>>(m, a);
  return (int)cudaGetLastError();
}
#endif  // part 4

}  // namespace vmg

// The build compiles this file four times (vmg_tpu_torch/_build.py), once
// per part, so that its kernels' instantiations compile in parallel: part 1
// defines the axes entry points (the bf16 big form, the token form), part
// 3 the f32 big form they call through vmg_morphfc_axes_f32_big, part 4 the
// f32 token form they call through vmg_morphfc_axes_token_f32, part 2 the
// reduce and combine entry points.  The build renames parts 2-4's
// namespace, so the objects share no symbol but the C ones.  Undefined:
// all four parts.
extern "C" int vmg_morphfc_axes_f32_big(const void* maps, const void* args, int grid, int relu,
                                        void* stream);
extern "C" int vmg_morphfc_axes_token_f32(const void* x, const void* c, const void* kh,
                                          const float* bh, const void* kw, const float* bw,
                                          void* h, void* w, void* img, float* bimg,
                                          float* partial, float* psum, const void* plan, int N,
                                          int H, int W, int C, int ch, int cw, int relu,
                                          void* stream);

#if !defined(VMG_MORPHFC_PART) || VMG_MORPHFC_PART == 3
// the f32 big form's launch (maps, args: the caller's AxesMaps, AxesArgs)
extern "C" int vmg_morphfc_axes_f32_big(const void* maps, const void* args, int grid, int relu,
                                        void* stream) {
  const vmg::AxesMaps& m = *static_cast<const vmg::AxesMaps*>(maps);
  const vmg::AxesArgs& a = *static_cast<const vmg::AxesArgs*>(args);
  cudaStream_t st = (cudaStream_t)stream;
  return relu ? vmg::axes_wgmma<true, true>(m, a, grid, st)
              : vmg::axes_wgmma<true, false>(m, a, grid, st);
}
#endif  // part 3

#if !defined(VMG_MORPHFC_PART) || VMG_MORPHFC_PART == 4
// The f32 token form (vmg_morphfc_axes_token's float32 half): x, c, kh, bh,
// kw, bw, h, w, psum as there; plan: morphfc_fused.token_f32_plan's
// (TokF32Plan); img: both branches' hi and lo images (ntiles x C / 8 x 16 x
// NT f32 each), bimg: their biases (ntiles x NT f32 each); partial: (N,
// stot, C).  The launches: the pack, c's partials, the kernel, the sums pass.
extern "C" int vmg_morphfc_axes_token_f32(const void* x, const void* c, const void* kh,
                                          const float* bh, const void* kw, const float* bw,
                                          void* h, void* w, void* img, float* bimg,
                                          float* partial, float* psum, const void* plan, int N,
                                          int H, int W, int C, int ch, int cw, int relu,
                                          void* stream) {
  if (plan == nullptr || img == nullptr || (uintptr_t)img % 16 != 0 ||
      (bh != nullptr && (bimg == nullptr || (uintptr_t)bimg % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const vmg::TokF32Plan& p = *static_cast<const vmg::TokF32Plan*>(plan);
  cudaStream_t st = (cudaStream_t)stream;
  const int NT = p.nt;
  const bool exact = p.exact != 0, shared = p.shared != 0;
  // the instantiations: the path shapes at their tile widths, else NT =
  // 16, 32 or 64
  if (exact ? !((C == 224 && ch == 16 && cw == 16 && NT == 128) ||
                (C == 448 && ch == 8 && cw == 8 && NT == 64)) || p.nws != 0
            : (NT != 16 && NT != 32 && NT != 64) || (p.nws != 1 && p.nws != 4))
    return (int)cudaErrorInvalidValue;
  if ((p.shared != 0 && p.shared != 1) || (p.ring != 1 && p.ring != 2) || p.nst < 2 ||
      p.nst > vmg::kTfStMax || p.kcs < vmg::kTfKB || p.kcs % vmg::kTfKB != 0 || p.kcs > C / 8)
    return (int)cudaErrorInvalidValue;
  vmg::TokF32Args a = {};
  vmg::TokPackF32 pk = {};
  const int Ls[2] = {ch, cw};
  const void* ks[2] = {kh, kw};
  const float* bs[2] = {bh, bw};
  void* outs[2] = {h, w};
  const int wpb = shared ? 1 : vmg::kTokWg;  // walkers a block
  int slots = 0;
  for (int br = 0; br < 2; ++br) {
    const vmg::TokPlanBranch& q = p.br[br];
    vmg::TokF32Branch& B = a.br[br];
    // as the bf16 entry's checks; where shared, each warpgroup has a tile
    const int L = Ls[br], gu = q.lgu >= 0 && q.lgu <= 6 ? 1 << q.lgu : 0;
    const int bw_ = br == 0 ? gu : L, bh_ = br == 0 ? L : gu;
    int cp = 1;
    while (cp < L) cp *= 2;
    const int Gw = wpb * q.blocks;
    if (q.L != L || q.S != C / L || gu * cp != 64 || (gu >= 32 && !exact && p.nws != 4) ||
        q.tpz < 1 || q.tpz * (NT / 8) < L || (exact && q.tpz != 1) ||
        q.ntiles != (q.S + 7) / 8 * q.tpz || (shared && q.ntiles < 2) || q.ucols < 1 ||
        (long long)q.ucols * bw_ < W || q.upf < q.ucols || q.upf % q.ucols != 0 ||
        (long long)(q.upf / q.ucols) * bh_ < H || (long long)N * q.upf > 0x7fffffff ||
        q.blocks < 1 ||
        (q.fpw == 0 ? (q.wpf < 1 || q.wpf > q.upf || (long long)N * q.wpf > Gw)
                    : (q.wpf != 1 || (long long)q.fpw * Gw < N)))
      return (int)cudaErrorInvalidValue;
    B.L = L, B.S = q.S, B.lgu = q.lgu, B.tpz = q.tpz;
    B.ucols = q.ucols, B.upf = q.upf, B.ntiles = q.ntiles;
    B.box_bytes = (unsigned)gu * L * C * 4;
    B.blocks = q.blocks, B.block0 = br == 0 ? 0 : p.br[0].blocks;
    B.wpf = q.wpf, B.fpw = q.fpw, B.slot0 = slots;
    slots += (B.fpw == 0 ? B.wpf : 1) * (shared ? 2 : 1);
    pk.k[br] = (const float*)ks[br], pk.b[br] = bs[br];
    pk.img[br] = (float*)img + (br == 0 ? 0 : (size_t)a.br[0].ntiles * C * 2 * NT);
    pk.bimg[br] = bs[br] == nullptr ? nullptr : bimg + (br == 0 ? 0 : a.br[0].ntiles * NT);
    pk.L[br] = L, pk.S[br] = B.S, pk.tpz[br] = B.tpz;
    B.img = pk.img[br], B.bias = pk.bimg[br], B.out = (float*)outs[br];
  }
  if (p.stot != slots + p.sc) return (int)cudaErrorInvalidValue;
  const vmg::TokF32Layout lay(C, NT, p.shared, p.ring, p.kcs, p.nst, p.nws);
  if (lay.total > vmg::kMaxSmem) return (int)cudaErrorInvalidValue;
  a.partial = partial;
  a.N = N, a.H = H, a.W = W, a.C = C, a.stot = p.stot;
  a.floor = relu ? 0.f : -INFINITY;
  a.shared = p.shared, a.ring = p.ring, a.kcs = p.kcs, a.nst = p.nst, a.nws = p.nws;
  a.slot_bytes = lay.slot, a.off_w = lay.off_w, a.off_sum = lay.off_sum, a.off_bar = lay.off_bar;
  // both weights as hi and lo images
  pk.C = C, pk.NT = NT;
  pk.items0 = a.br[0].ntiles * (C / 8) * 2 * NT;
  pk.items = pk.items0 + a.br[1].ntiles * (C / 8) * 2 * NT;
  vmg::morphfc_axes_token_pack_tf32_kernel<<<(pk.items + 255) / 256, 256, 0, st>>>(pk);
  int e = (int)cudaGetLastError();
  if (e) return e;
  // c's per-frame partials: rows slots .. stot - 1
  const void* cptr[1] = {c};
  if (!vmg::partial_plan_ok(cptr, 1, N, H * W, C, p.sc, p.per_c, 4, 4))
    return (int)cudaErrorInvalidValue;
  e = vmg::launch_partial<float, 1>((const float*)c, (const float*)c, (const float*)c, partial, N,
                                    H * W, C, p.sc, p.per_c, 4, p.stot, slots, st);
  if (e) return e;
  vmg::TokMaps maps;
  memset(&maps, 0, sizeof(maps));
  int nsp = (C + 255) / 256;
  while (C % nsp != 0 || (C / nsp) % 8 != 0) ++nsp;
  for (int br = 0; br < 2; ++br) {  // a box a unit
    const int gu = 1 << a.br[br].lgu;
    e = vmg::nhwc_split_map(&maps.x[br], x, N, H, W, C, nsp, br == 0 ? gu : cw, br == 0 ? ch : gu,
                            true);
    if (e) return e;
  }
  const int grid = p.br[0].blocks + p.br[1].blocks;
  if (exact)
    e = C == 224 ? vmg::launch_axes_token_tf32<128, 224, 16>(maps, a, grid, lay.total, st)
                 : vmg::launch_axes_token_tf32<64, 448, 8>(maps, a, grid, lay.total, st);
  else if (NT == 16)
    e = vmg::launch_axes_token_tf32<16, 0, 0>(maps, a, grid, lay.total, st);
  else if (NT == 32)
    e = vmg::launch_axes_token_tf32<32, 0, 0>(maps, a, grid, lay.total, st);
  else
    e = vmg::launch_axes_token_tf32<64, 0, 0>(maps, a, grid, lay.total, st);
  if (e) return e;
  return vmg::launch_final(partial, psum, N, C, p.stot, st);
}
#endif  // part 4

#if !defined(VMG_MORPHFC_PART) || VMG_MORPHFC_PART == 1
// x, c, h, w: (N, H, W, C); kh, kw: (C_in, C_out) decayed axis weights;
// bh, bw: (C,) f32, both null for no bias; relu: the epilogue's ReLU (0:
// none); psum: (N, C) f32.  C % 16 == C % ch == C % cw == W % cw == 0, WT %
// cw == 0.  f32: one block per slab of ch x WT; partial: (N,
// ceil(H/ch) * ceil(W/WT), C) f32; scratch, nwg, ring, npass and grid
// unused.  bf16: the persistent kernel with the plan of
// morphfc_fused.axes_plan (WT, npass, nwg, ring) on grid blocks; partial:
// (N, npass * grid * nwg, C) f32; scratch: grid * nwg * (C / 2 + 8) * 128 f32.
extern "C" int vmg_morphfc_axes(const void* x, const void* c, const void* kh,
                                const float* bh, const void* kw, const float* bw,
                                void* h, void* w, float* partial, float* psum, float* scratch,
                                int N, int H, int W, int C, int ch, int cw, int WT, int nwg,
                                int ring, int npass, int grid, int relu, int dtype,
                                void* stream) {
  if (ch < 1 || cw < 1 || C % ch != 0 || C % cw != 0 || W % cw != 0 || WT % cw != 0 ||
      N > 65535 || (H + ch - 1) / ch > 65535 || (bh == nullptr) != (bw == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, c, kh, kw, (const void*)h, (const void*)w})
    if ((uintptr_t)p % vmg::kVecBytes != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool f32 = dtype == 0;
  auto lg2 = [](int v) {  // log2 of the least power of two >= v
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
  };
  vmg::AxesArgs a = {};
  a.kh = (const vmg::bf16*)kh, a.kw = (const vmg::bf16*)kw, a.bh = bh, a.bw = bw;
  a.partial = partial, a.scratch = scratch;
  a.N = N, a.H = H, a.W = W, a.C = C, a.ch = ch, a.cw = cw, a.WT = WT, a.kg = WT / cw;
  a.lchp = lg2(ch), a.lcwp = lg2(cw);
  a.nwg = nwg, a.ring = ring, a.npass = npass, a.walkers = grid * nwg;
  // the box within TMA's limits, token groups of at most 64 rows
  if (C > 240 || WT > 256 || ch > 64 || cw > 64 || nwg < 1 || nwg > 2 || ring < 1 ||
      ring > vmg::kAxRingMax || npass < 1 || npass > 2 || (npass == 1 && ch != cw) ||
      grid < 1 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  a.tiles_w = (W + WT - 1) / WT;
  a.tiles_pf = a.tiles_w * ((H + ch - 1) / ch);
  if ((long long)N * a.tiles_pf > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.tiles = N * a.tiles_pf;
  a.box_bytes = (unsigned)(ch * WT * C * (f32 ? 4 : 2));
  a.slab_bytes = vmg::axes_slab_bytes(ch * WT, C, f32 ? 4 : 2);
  vmg::AxesMaps maps;
  memset(&maps, 0, sizeof(maps));
  const void* ts[4] = {x, c, h, w};
  CUtensorMap* ms[4] = {&maps.x, &maps.c, &maps.h, &maps.w};
  for (int i = 0; i < 4; ++i) {
    const int e = vmg::nhwc_box_map(ms[i], ts[i], N, H, W, C, WT, ch, C, f32);
    if (e) return e;
  }
  int e = f32 ? vmg_morphfc_axes_f32_big(&maps, &a, grid, relu, st)
              : (relu ? vmg::axes_wgmma<false, true>(maps, a, grid, st)
                      : vmg::axes_wgmma<false, false>(maps, a, grid, st));
  if (e) return e;
  return vmg::launch_final(partial, psum, N, C, npass * a.walkers, st);
}

// The token form: x, c, kh, bh, kw, bw, h, w, psum as vmg_morphfc_axes; C %
// 16 == 0, C <= 512; WT unused.  bf16: plan is morphfc_fused.token_plan's
// (TokPlan); img: both B images (ntiles x C x NT bf16 each), bimg: their
// biases (ntiles x NT f32 each); partial: (N, stot, C).  f32:
// vmg_morphfc_axes_token_f32 (part 4), plan morphfc_fused.token_f32_plan's.
extern "C" int vmg_morphfc_axes_token(const void* x, const void* c, const void* kh,
                                      const float* bh, const void* kw, const float* bw,
                                      void* h, void* w, void* img, float* bimg, float* partial,
                                      float* psum, const vmg::TokPlan* plan, int N, int H, int W,
                                      int C, int ch, int cw, int WT, int relu, int dtype,
                                      void* stream) {
  if (ch < 1 || cw < 1 || C % ch != 0 || C % cw != 0 || W % cw != 0 || WT % cw != 0 ||
      C % 16 != 0 || C > 512 || N < 1 || H < 1 || (bh == nullptr) != (bw == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, c, kh, kw, (const void*)h, (const void*)w})
    if ((uintptr_t)p % vmg::kVecBytes != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return vmg_morphfc_axes_token_f32(x, c, kh, bh, kw, bw, h, w, img, bimg, partial, psum, plan,
                                      N, H, W, C, ch, cw, relu, stream);
  if (dtype != 1 || plan == nullptr || img == nullptr ||
      (bh != nullptr && (bimg == nullptr || (uintptr_t)bimg % 16 != 0)) ||
      (uintptr_t)img % 16 != 0)
    return (int)cudaErrorInvalidValue;
  using vmg::bf16;
  const vmg::TokPlan& p = *plan;
  const int NT = p.nt;
  // the instantiations: the path shapes (stages 1/5 and 3) at their tile
  // widths, else NT = 16, 32 or 64
  const bool exact = p.exact != 0;
  if (exact ? !((C == 224 && ch == 16 && cw == 16 && NT == 128) ||
                (C == 448 && ch == 8 && cw == 8 && NT == 64)) || p.nws != 0
            : (NT != 16 && NT != 32 && NT != 64) || (p.nws != 1 && p.nws != 4))
    return (int)cudaErrorInvalidValue;
  if ((p.ring != 1 && p.ring != 2) || p.wring < 2 || p.wring > vmg::kTokWMax ||
      (p.resident != 0 && p.resident != 1))
    return (int)cudaErrorInvalidValue;
  vmg::TokArgs a = {};
  vmg::TokPack pk = {};
  const int Ls[2] = {ch, cw};
  const void* ks[2] = {kh, kw};
  const float* bs[2] = {bh, bw};
  int slots = 0, ntmax = 0;
  for (int br = 0; br < 2; ++br) {
    const vmg::TokPlanBranch& q = p.br[br];
    vmg::TokBranch& B = a.br[br];
    // the units tile the frame (H: gu columns x L rows; W: L columns x gu
    // rows), the tiles cover the chunk's positions and every 8-channel
    // block of S, a segment's token rows are a power of two with gu of
    // them in 64 (from 32 a warp's channel array each), the walkers
    // cover the frames
    const int L = Ls[br], gu = q.lgu >= 0 && q.lgu <= 6 ? 1 << q.lgu : 0;
    const int bw_ = br == 0 ? gu : L, bh_ = br == 0 ? L : gu;
    int cp = 1;
    while (cp < L) cp *= 2;
    const int Gw = vmg::kTokWg * q.blocks;
    if (q.L != L || q.S != C / L || gu * cp != 64 || (gu >= 32 && !exact && p.nws != 4) ||
        q.tpz < 1 || q.tpz * (NT / 8) < L || (exact && q.tpz != 1) ||
        q.ntiles != (q.S + 7) / 8 * q.tpz || q.ucols < 1 || (long long)q.ucols * bw_ < W ||
        q.upf < q.ucols || q.upf % q.ucols != 0 || (long long)(q.upf / q.ucols) * bh_ < H ||
        (long long)N * q.upf > 0x7fffffff || q.blocks < 1 ||
        (q.fpw == 0 ? (q.wpf < 1 || q.wpf > q.upf || (long long)N * q.wpf > Gw)
                    : (q.wpf != 1 || (long long)q.fpw * Gw < N)))
      return (int)cudaErrorInvalidValue;
    B.L = L, B.S = q.S, B.lgu = q.lgu, B.tpz = q.tpz;
    B.ucols = q.ucols, B.upf = q.upf, B.ntiles = q.ntiles;
    B.box_bytes = (unsigned)gu * L * C * 2;
    B.blocks = q.blocks, B.block0 = br == 0 ? 0 : p.br[0].blocks;
    B.wpf = q.wpf, B.fpw = q.fpw, B.slot0 = slots;
    slots += B.fpw == 0 ? B.wpf : 1;
    ntmax = std::max(ntmax, B.ntiles);
    pk.k[br] = (const bf16*)ks[br], pk.b[br] = bs[br];
    pk.img[br] = (bf16*)img + (br == 0 ? 0 : (size_t)a.br[0].ntiles * C * NT);
    pk.bimg[br] = bs[br] == nullptr ? nullptr : bimg + (br == 0 ? 0 : a.br[0].ntiles * NT);
    pk.L[br] = L, pk.S[br] = B.S, pk.tpz[br] = B.tpz;
    B.img = pk.img[br], B.bias = pk.bimg[br];
  }
  if (p.stot != slots + p.sc || (p.resident && ntmax > vmg::kTokWMax))
    return (int)cudaErrorInvalidValue;
  const vmg::TokLayout lay(C, NT, p.ring, p.resident ? ntmax : p.wring, p.nws);
  if (lay.total > vmg::kMaxSmem) return (int)cudaErrorInvalidValue;
  a.partial = partial;
  a.N = N, a.H = H, a.W = W, a.C = C, a.KS = C / 16, a.stot = p.stot;
  a.floor = relu ? 0.f : -INFINITY;
  a.ring = p.ring, a.resident = p.resident, a.wring = p.wring, a.nws = p.nws;
  a.slot_bytes = lay.slot, a.tile_bytes = (unsigned)C * NT * 2;
  a.off_w = lay.off_w, a.off_sum = lay.off_sum, a.off_bar = lay.off_bar;
  // both weights as B images
  pk.C = C, pk.NT = NT;
  pk.chunks0 = a.br[0].ntiles * (C / 8) * NT;
  pk.chunks = pk.chunks0 + a.br[1].ntiles * (C / 8) * NT;
  vmg::morphfc_axes_token_pack_kernel<<<(pk.chunks + 255) / 256, 256, 0, st>>>(pk);
  int e = (int)cudaGetLastError();
  if (e) return e;
  // c's per-frame partials: rows slots .. stot - 1
  const void* cptr[1] = {c};
  if (!vmg::partial_plan_ok(cptr, 1, N, H * W, C, p.sc, p.per_c, 8, 2))
    return (int)cudaErrorInvalidValue;
  e = vmg::launch_partial<bf16, 1>((const bf16*)c, (const bf16*)c, (const bf16*)c, partial, N,
                                   H * W, C, p.sc, p.per_c, 8, p.stot, slots, st);
  if (e) return e;
  vmg::TokMaps maps;
  memset(&maps, 0, sizeof(maps));
  int nsp = (C + 255) / 256;
  while (C % nsp != 0 || (C / nsp) % 8 != 0) ++nsp;
  const void* outs[2] = {h, w};
  for (int br = 0; br < 2; ++br) {
    const int gu = 1 << a.br[br].lgu;
    const int bw_ = br == 0 ? gu : cw, bh_ = br == 0 ? ch : gu;
    e = vmg::nhwc_split_map(&maps.x[br], x, N, H, W, C, nsp, bw_, bh_);
    if (!e) e = vmg::nhwc_split_map(&maps.out[br], outs[br], N, H, W, C, nsp, bw_, bh_);
    if (e) return e;
  }
  if (exact)
    e = C == 224 ? vmg::launch_axes_token_wgmma<14, 128, 16>(maps, a, lay.total, st)
                 : vmg::launch_axes_token_wgmma<28, 64, 8>(maps, a, lay.total, st);
  else if (NT == 16)
    e = vmg::launch_axes_token_wgmma<32, 16, 0>(maps, a, lay.total, st);
  else if (NT == 32)
    e = vmg::launch_axes_token_wgmma<32, 32, 0>(maps, a, lay.total, st);
  else
    e = vmg::launch_axes_token_wgmma<32, 64, 0>(maps, a, lay.total, st);
  if (e) return e;
  return vmg::launch_final(partial, psum, N, C, p.stot, st);
}

#endif  // part 1

#if !defined(VMG_MORPHFC_PART) || VMG_MORPHFC_PART == 2
// h, w, c: (N, P, C) with P = H*W pixels per frame; partial: (N, S, C) f32
// scratch; out: (N, C) f32.  The plan of morphfc_fused.reduce_plan: S
// slices of per pixels, vec channels a load.
extern "C" int vmg_morphfc_reduce(const void* h, const void* w, const void* c,
                                  float* partial, float* out, int N, int P, int C, int S,
                                  int per, int vec, int dtype, void* stream) {
  const void* ptrs[3] = {h, w, c};
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    if (!vmg::partial_plan_ok(ptrs, 3, N, P, C, S, per, vec, (int)sizeof(T)))
      return (int)cudaErrorInvalidValue;
    const int e = vmg::launch_partial<T, 3>((const T*)h, (const T*)w, (const T*)c, partial, N,
                                            P, C, S, per, vec, S, 0, st);
    if (e) return e;
  });
  return vmg::launch_final(partial, out, N, C, S, st);
}

// x, h, w, c, res, out: (N, P, C); a: (N, 3, C); pb: (C,) f32; res may be
// null; act: the gate (0 tanh, 1 sigmoid - 0.5, 2 relu).  pk: the image of
// pack_combine_weight: bf16 (C / NT, C / 8, NT, 8), f32 (C / NT, C / 8, 2, 2,
// NT, 4) (each k8 step's hi and lo B images), NT =
// morphfc_fused.combine_tile_n(C, dtype).  nwg, ring: the kernel's consumer
// warpgroups and ring slots (morphfc_fused.combine_plan; f32: nwg 2).
extern "C" int vmg_morphfc_combine(const void* x, const void* h, const void* w,
                                   const void* c, const void* a, const void* pk,
                                   const float* pb, const void* res, void* out,
                                   int N, int P, int C, float res_scale, int act,
                                   int nwg, int ring, int dtype, void* stream) {
  if (C % 16 != 0 || C > 448 || N < 1 || P < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    for (const void* p : {x, h, w, c, res, pk, (const void*)out})
      if ((uintptr_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
    if ((uintptr_t)a % 4 != 0 || (uintptr_t)pb % 8 != 0) return (int)cudaErrorMisalignedAddress;
    vmg::CombineArgs ca = {};
    ca.a = (const vmg::bf16*)a, ca.pk = (const vmg::bf16*)pk, ca.pb = pb;
    ca.res_scale = res_scale, ca.P = P, ca.C = C;
    ca.KW = vmg::combine_k_width(C), ca.nK = (C + ca.KW - 1) / ca.KW;
    const int NT = vmg::combine_tile_n(C);
    ca.nN = (C + NT - 1) / NT, ca.stream = C > 224, ca.has_res = res != nullptr;
    ca.XW = vmg::combine_x_width(C), ca.nX = (NT + ca.XW - 1) / ca.XW;
    ca.ring = ring, ca.nwg = nwg;
    ca.tiles_pf = (P + vmg::kCM - 1) / vmg::kCM;
    if ((long long)N * ca.tiles_pf > 0x7fffffff) return (int)cudaErrorInvalidValue;
    ca.tiles = N * ca.tiles_pf;
    ca.units = 3 * ca.nK + ca.nN * (ca.stream + ca.nX * (1 + ca.has_res));
    ca.slot_bytes = vmg::combine_slot_bytes(C);
    ca.pk_bytes = ca.stream ? 0 : (unsigned)(C * C * 2);
    vmg::CombineMaps maps;
    memset(&maps, 0, sizeof(maps));
    const void* ts[6] = {x, h, w, c, res, out};
    CUtensorMap* ms[6] = {&maps.x, &maps.h, &maps.w, &maps.c, &maps.res, &maps.out};
    for (int i = 0; i < 6; ++i) {
      if (ts[i] == nullptr) continue;
      const int e = vmg::bf16_box_map3(ms[i], ts[i], C, P, N, vmg::kCBox, vmg::kCM, true);
      if (e) return e;
    }
    auto launch = act == 0 ? vmg::combine_bf16<0> : act == 1 ? vmg::combine_bf16<1>
                                                             : vmg::combine_bf16<2>;
    return launch(maps, ca, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, h, w, c, res, pk, (const void*)out})
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if ((uintptr_t)a % 8 != 0 || (uintptr_t)pb % 8 != 0) return (int)cudaErrorMisalignedAddress;
  vmg::CombineF32Args fa = {};
  fa.a = (const float*)a, fa.pk = (const float*)pk, fa.pb = pb;
  fa.res_scale = res_scale, fa.P = P, fa.C = C, fa.act = act, fa.has_res = res != nullptr;
  fa.NT = vmg::combine_f32_tile_n(C), fa.nN = (C + fa.NT - 1) / fa.NT;
  fa.nK = (C + vmg::kCFBox - 1) / vmg::kCFBox, fa.nX = (fa.NT + vmg::kCFBox - 1) / vmg::kCFBox;
  fa.steps = C / 8, fa.stream = C > 128, fa.ring = ring;
  fa.tiles_pf = (P + vmg::kCM - 1) / vmg::kCM;
  fa.nwg = nwg;
  if ((long long)N * fa.tiles_pf * fa.nN > 0x7fffffff) return (int)cudaErrorInvalidValue;
  fa.items = N * fa.tiles_pf * fa.nN;
  fa.slot_bytes = vmg::combine_f32_slot_bytes(C);
  fa.pk_bytes = fa.stream ? 0 : (unsigned)(8 * C * C);
  vmg::CombineMaps maps;
  memset(&maps, 0, sizeof(maps));
  const void* ts[6] = {x, h, w, c, res, out};
  CUtensorMap* ms[6] = {&maps.x, &maps.h, &maps.w, &maps.c, &maps.res, &maps.out};
  for (int i = 0; i < 6; ++i) {
    if (ts[i] == nullptr) continue;
    const int e = vmg::bf16_box_map3(ms[i], ts[i], C, P, N, vmg::kCFBox, vmg::kCM, true, true);
    if (e) return e;
  }
  return vmg::combine_f32(maps, fa, st);
}
#endif  // part 2
