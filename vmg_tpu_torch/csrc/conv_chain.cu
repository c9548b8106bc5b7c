// Chained 3x3 convolutions: out = conv2(act(conv1(x) + b1)) + b2,
// optionally x + s * out, optionally with f32 per-frame sums of out; and
// the identity copy that stands in for the TPU's layout pin.
//
// Replaces the Pallas kernels vmg_tpu/ops/conv_chain.py `fused_conv_chain`
// (`_chain_kernel`) and `layout_pin` (`_identity_kernel`).
//
// Bound on H100: operations.  At C = 112 each pixel costs 2 x 9 C^2 MACs
// (two convs) against ~4 C bytes of bf16 traffic: 26.6 GFLOP for one
// 184x320 frame, 0.027 ms on the bf16 tensor cores against 0.008 ms of
// HBM traffic.  The intermediate (C per pixel) is what the fusion keeps
// out of device memory.
//
// Numerics of the TPU kernel: conv1 accumulates in f32, adds the bias and
// applies the activation in f32 and rounds once to the dtype; conv1 values
// outside the image are ZEROS (conv2's SAME padding), not conv1 evaluated
// over the padding; conv2 accumulates in f32, adds its bias, rounds once;
// the residual is x + round(s * y) in the dtype's arithmetic; the sums are
// f32 sums of the rounded output over the real (H, W) extent.
//
// * bf16 (serving): one block per (frame, 6-row x 28-column output tile),
//   8 warps.  The block stages an 10 x 32 position slab of x (the
//   two-level halo; 16-byte loads, zeros outside the image and in the
//   channel padding) in shared memory, rows 32 positions apart.  Both
//   convs are implicit GEMMs on that flat layout: the output at flat
//   position f reads input position f + dy * 32 + dx for tap (dy, dx), so
//   a 16-position M-tile of every tap is one contiguous, 32-byte aligned
//   wmma operand (16x16x16 bf16 fragments, f32 accumulation); the 4
//   columns of each row past the tile are computed and discarded.  conv1
//   covers 8 x 32 positions: 16 M-tiles, one pair per warp, so the whole
//   conv is one round and its output (masked, biased, activated, rounded)
//   overwrites the slab after a barrier; conv2 covers 6 x 32 positions,
//   6 warps one pair each.  Each warp holds 2 M-tiles x up to 8 N-tiles
//   of accumulators.  The packed (9, K, N) taps pass through shared memory
//   one tap at a time, double-buffered (cp.async: tap t + 1 copies while
//   tap t multiplies), so the warps share one copy of each weight
//   fragment; epilogues go through a per-warp 16x16 f32 stage.
//   Sums: each block writes one f32 partial per channel, summed in a
//   fixed order (lanes, then warps), and a second pass adds the blocks'
//   partials in a fixed tree order -- deterministic, no atomics (the TPU
//   kernel carried the sum across its sequential row grid instead).  Channels
//   pad to a multiple of 16 (the packed weights carry zeros there), at
//   most 128.
// * f32 (parity runs): scalar FMA, one block per 8 x 8 output tile, the
//   12 x 12 slab and the 10 x 10 intermediate in shared memory, 16 x 16
//   register micro-tiles; unpadded weights.
#include "common.cuh"

namespace vmg {

constexpr int kCR = 6;                           // output rows per tile
constexpr int kCTW = 28;                         // output columns per tile
constexpr int kCWs = kCTW + 4;                   // slab row stride, positions
constexpr int kCM1 = (kCR + 2) * kCWs / 16;      // conv1 M-tiles
constexpr int kCM2 = kCR * kCWs / 16;            // conv2 M-tiles
constexpr int kSlabPos = (kCR + 4) * kCWs + 2;   // + the last taps' overrun
static_assert(kCM1 == 2 * kWarps, "conv1 must be one round of M-tile pairs");
static_assert(2 * kWarps >= kCM2, "conv2 must be one round of M-tile pairs");
constexpr int kMaxNT = 8;                        // channels <= 128

// Shared row stride (elements) for cp channels: a multiple of 16, so every
// position starts 32-byte aligned (wmma's operand alignment), and an odd
// number of 32-byte units where that costs nothing, so 8 consecutive rows
// spread over the banks.
__host__ __device__ inline int chain_ld(int cp) { return (cp / 16) % 2 ? cp : cp + 16; }

// Elements of one staged tap buffer: the larger of the two convs' (Kp, Np + pad).
__host__ __device__ inline int chain_wbuf(int Cinp, int Cmp, int Coutp) {
  const int a = Cinp * (Cmp + kPadH), b = Cmp * (Coutp + kPadH);
  return a > b ? a : b;
}

__host__ __device__ inline size_t chain_smem_bf16(int ld, int wbuf) {
  return (size_t)kSlabPos * ld * 2 + (size_t)2 * wbuf * 2 + (size_t)kWarps * 256 * 4 +
         (size_t)kWarps * 128 * 4;
}

__device__ __forceinline__ float chain_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v >= 0.f ? v : 0.1f * v;
  return v;
}

// Start copying tap `tap` of w (9, Kp, Np) into wsm, rows Np + kPadH apart
// (every thread issues its share of 16-byte copies, then commits).
__device__ __forceinline__ void stage_tap(bf16* wsm, const bf16* __restrict__ w, int tap,
                                          int Kp, int Np) {
  const int cv = Np / 8, ldb = Np + kPadH;
  const bf16* src = w + (size_t)tap * Kp * Np;
  for (int e = threadIdx.x; e < Kp * cv; e += kThreads) {
    const int k = e / cv, q = e % cv;
    cp_async16(wsm + k * ldb + q * 8, src + (size_t)k * Np + q * 8);
  }
  cp_async_commit();
}

// Block-wide conv over flat positions: warps with `active` accumulate
// acc[i][j] = sum over taps and k of src[(m0 + i) * 16 + tap offset] @ w[tap]
// (K = Kp, N-tile j; src rows ld apart; w (9, Kp, Np) row-major).  The taps'
// weight matrices pass through two shared buffers of wbuf elements each
// (tap t + 1 loads while tap t multiplies), so the warps share one copy;
// every warp joins the copies and the barriers.
__device__ __forceinline__ void conv_block(const bf16* src, int ld,
                                           const bf16* __restrict__ w, int Kp, int Np,
                                           bf16* wsm, int wbuf, bool active, int m0,
                                           FragC (&acc)[2][kMaxNT]) {
  const int NT = Np / 16, KC = Kp / 16, ldb = Np + kPadH;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) wm::fill_fragment(acc[i][j], 0.f);
  stage_tap(wsm, w, 0, Kp, Np);
  for (int tap = 0; tap < 9; ++tap) {
    const bf16* cur = wsm + (tap & 1) * wbuf;
    if (tap + 1 < 9) {
      stage_tap(wsm + ((tap + 1) & 1) * wbuf, w, tap + 1, Kp, Np);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tap's weights are in
    if (active) {
      const int off = (tap / 3) * kCWs + tap % 3;
      const bf16* a0 = src + (size_t)(m0 * 16 + off) * ld;
      const bf16* a1 = a0 + (size_t)16 * ld;
      for (int kc = 0; kc < KC; ++kc) {
        FragA fa0, fa1;
        wm::load_matrix_sync(fa0, a0 + kc * 16, ld);
        wm::load_matrix_sync(fa1, a1 + kc * 16, ld);
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          if (j < NT) {
            FragB fb;
            wm::load_matrix_sync(fb, cur + kc * 16 * ldb + j * 16, ldb);
            wm::mma_sync(acc[0][j], fa0, fb, acc[0][j]);
            wm::mma_sync(acc[1][j], fa1, fb, acc[1][j]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }
}

// Cinp, Cmp, Coutp: padded channels (multiples of 16, <= 128); Cin, Cout:
// the tensors' channels.  partial: (N, tiles, Cout) f32 or null.
__global__ void __launch_bounds__(kThreads, 1)
conv_chain_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ out,
                       float* __restrict__ partial, int H, int W, int Cin, int Cinp,
                       int Cmp, int Cout, int Coutp, int ld, int act, int has_res,
                       float res_scale, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // the slab, then conv1's output
  const int wbuf = chain_wbuf(Cinp, Cmp, Coutp);
  bf16* wsm = buf + (size_t)kSlabPos * ld;         // two staged tap matrices
  float* stage = reinterpret_cast<float*>(wsm + (size_t)2 * wbuf);
  float* wps = stage + kWarps * 256;               // per-warp channel sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / tiles_w) * kCR, x0 = (tile % tiles_w) * kCTW;
  float* st = stage + warp * 256;

  // slab: position s = r * kCWs + c holds x at (y0 + r - 2, x0 + c - 2)
  const int cv = Cinp / 8;  // 16-byte chunks per position
  const bool vec = Cin % 8 == 0;
  for (int e = threadIdx.x; e < kSlabPos * cv; e += kThreads) {
    const int s = e / cv, q = e % cv;
    const int r = s / kCWs, c = s % kCWs;
    const int gy = y0 + r - 2, gx = x0 + c - 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < kCR + 4 && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const bf16* src = x + ((size_t)(n * H + gy) * W + gx) * Cin + q * 8;
      if (vec && q * 8 < Cin) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (q * 8 + i < Cin) h[i] = src[i];
      }
    }
    *reinterpret_cast<uint4*>(buf + (size_t)s * ld + q * 8) = v;
  }
  __syncthreads();

  // conv1 over flat positions f = r * kCWs + c, image (y0 + r - 1, x0 + c - 1)
  FragC acc[2][kMaxNT];
  conv_block(buf, ld, w1, Cinp, Cmp, wsm, wbuf, true, 2 * warp, acc);
  // (conv_block ends on a barrier: every warp is done with the slab, and
  // conv1's output replaces it)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j < Cmp / 16) {
        wm::store_matrix_sync(st, acc[i][j], 16, wm::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int f = (2 * warp + i) * 16 + e / 16, ch = j * 16 + e % 16;
          const int gy = y0 + f / kCWs - 1, gx = x0 + f % kCWs - 1;
          const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const float v = chain_act(st[e] + b1[ch], act);
          buf[(size_t)f * ld + ch] = __float2bfloat16_rn(ok ? v : 0.f);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // conv2 over flat positions o = r * kCWs + c, image (y0 + r, x0 + c)
  float ps[kMaxNT];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) ps[j] = 0.f;
  conv_block(buf, ld, w2, Cmp, Coutp, wsm, wbuf, 2 * warp < kCM2, 2 * warp, acc);
  if (2 * warp < kCM2) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j < Coutp / 16) {
          wm::store_matrix_sync(st, acc[i][j], 16, wm::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int row = lane / 16 + 2 * t, co = j * 16 + lane % 16;
            const int o = (2 * warp + i) * 16 + row;
            const int c = o % kCWs, gy = y0 + o / kCWs, gx = x0 + c;
            if (c < kCTW && gy < H && gx < W && co < Cout) {
              float v = rnd<bf16>(st[row * 16 + lane % 16] + b2[co]);
              const size_t idx = ((size_t)(n * H + gy) * W + gx) * Cout + co;
              if (has_res) v = rnd<bf16>(__bfloat162float(x[idx]) + rnd<bf16>(res_scale * v));
              out[idx] = __float2bfloat16_rn(v);
              ps[j] += v;
            }
          }
          __syncwarp();
        }
      }
    }
  }
  if (partial != nullptr) {
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) ps[j] += __shfl_down_sync(0xffffffffu, ps[j], 16);
    if (lane < 16)
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) wps[warp * 128 + j * 16 + lane] = ps[j];
    __syncthreads();
    for (int co = threadIdx.x; co < Cout; co += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += wps[w * 128 + co];
      partial[((size_t)n * gridDim.x + tile) * Cout + co] = s;
    }
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
  const int R = dtype == 1 ? kCR : kFR, TW = dtype == 1 ? kCTW : kFTW;
  *tiles_w = (W + TW - 1) / TW;
  return ((H + R - 1) / R) * *tiles_w;
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// ---- layout pin: identity copy ---------------------------------------------

__global__ void copy16_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                              long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
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

// x: (N, H, W, Cin); w1: (9, Cinp, Cm), b1: (Cm,) f32; w2: (9, Cm, Coutp),
// b2: (Coutp,) f32; out: (N, H, W, Cout).  bf16: Cinp, Cm, Coutp are the
// multiples of 16 above Cin, the intermediate and Cout (<= 128), zeros in
// the padding; f32: Cinp == Cin, Coutp == Cout.  act: 0 none, 1 relu,
// 2 lrelu(0.1).  has_res: out = x + res_scale * y (Cout == Cin).  partial
// (N, vmg_conv_chain_tiles(H, W, dtype), Cout) f32 scratch and psum
// (N, Cout) f32: both null, or both set for the per-frame sums.
extern "C" int vmg_conv_chain(const void* x, const void* w1, const float* b1,
                              const void* w2, const float* b2, void* out,
                              float* partial, float* psum, int N, int H, int W,
                              int Cin, int Cinp, int Cm, int Cout, int Coutp, int act,
                              int has_res, float res_scale, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535 || act < 0 || act > 2 ||
      (has_res && Cout != Cin) || Cout > Coutp || (partial == nullptr) != (psum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int tiles_w;
  const int S = vmg::chain_tiles(H, W, dtype, &tiles_w);
  const dim3 grid(S, N);
  if (dtype == 1) {
    if (Cinp % 16 || Cm % 16 || Coutp % 16 || Cinp < Cin || Cinp > 128 || Cm > 128 ||
        Coutp > 128 || (uintptr_t)x % 16)
      return (int)cudaErrorInvalidValue;
    const int ld = vmg::chain_ld(Cinp > Cm ? Cinp : Cm);
    const size_t smem = vmg::chain_smem_bf16(ld, vmg::chain_wbuf(Cinp, Cm, Coutp));
    int e = vmg::set_smem(vmg::conv_chain_bf16_kernel, smem);
    if (e) return e;
    vmg::conv_chain_bf16_kernel<<<grid, vmg::kThreads, smem, s>>>(
        (const vmg::bf16*)x, (const vmg::bf16*)w1, b1, (const vmg::bf16*)w2, b2,
        (vmg::bf16*)out, partial, H, W, Cin, Cinp, Cm, Cout, Coutp, ld, act, has_res,
        res_scale, tiles_w);
  } else if (dtype == 0) {
    if (Cinp != Cin || Coutp != Cout || Cin > 128 || Cm > 128 || Cout > 128)
      return (int)cudaErrorInvalidValue;
    const size_t smem = vmg::chain_smem_f32(Cin, Cm, Cout);
    int e = vmg::set_smem(vmg::conv_chain_f32_kernel, smem);
    if (e) return e;
    vmg::conv_chain_f32_kernel<<<grid, vmg::kThreads, smem, s>>>(
        (const float*)x, (const float*)w1, b1, (const float*)w2, b2, (float*)out,
        partial, H, W, Cin, Cm, Cout, act, has_res, res_scale, tiles_w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int e = (int)cudaGetLastError();
  if (e || partial == nullptr) return e;
  vmg::chain_psum_kernel<<<dim3((Cout + 31) / 32, N), 32 * vmg::kPsumWarps, 0, s>>>(
      partial, psum, Cout, S);
  return (int)cudaGetLastError();
}

// out = a fresh copy of the nbytes at x (16-byte vectors where both are
// aligned and nbytes allows).
extern "C" int vmg_layout_pin(const void* x, void* out, long long nbytes, void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 && nbytes % 16 == 0) {
    const long long n = nbytes / 16;
    vmg::copy16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        (const uint4*)x, (uint4*)out, n);
  } else {
    vmg::copy1_kernel<<<(unsigned)((nbytes + 255) / 256), 256, 0, s>>>(
        (const unsigned char*)x, (unsigned char*)out, nbytes);
  }
  return (int)cudaGetLastError();
}
