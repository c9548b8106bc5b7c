// LTAM 2x2-window trajectory attention, forward and backward.
//
// Replaces vmg_tpu/ops/ltam_attention.py `ltam_attention_2x2`: the forward
// (`_fwd_call`, `_kernel`) and the backward of its custom VJP
// (`_bwd_call`, `_bwd_kernel`).  Per pixel (r, c) and head e, the query
// attends over K keyframe slots x the 4 taps of its own 2x2 window,
// source (2*(r//2) + ki, 2*(c//2) + kj):
//
//   logit = q . key_tap          (q L2-normalized * scale, f32)
//   e     = exp(logit) * pe[k, tap, pos(r, c), e]
//   out   = sum(e * val_tap) / max(sum(e), 1e-30)
//
// with no running max: |q . key| <= scale and the pe factors are
// exp(decay * rpe) with |decay * rpe| small, the bound the TPU kernel
// documents.  H and W are even, so every tap lies inside the image (the
// TPU kernel's parity masks and shifts compute the same selection).
//
// Layout (the port's choice): q (N,H,W,C) f32; kv (N,H,W,K*2*C) in the
// feature dtype, per slot C value channels then C normalized-key
// channels, no lane padding; pe (K,4,4,heads) f32; out (N,H,W,C) f32;
// den (N,H,W,heads) f32, written only when the caller asks (training).
//
// Bound on H100: device-memory traffic.  A forward step reads the 4 taps
// of K * 2C channels for every pixel (K = 5 at stage 0: 2.2 KB per pixel
// in bf16) and does ~4 FLOPs per element read.  Design: one group of L
// lanes per (pixel, head) holding its d = C/heads query and numerator
// values in registers, at most 32 a lane (L = 1 up to d = 32, 2 up to 64,
// ..., 32 up to d = 1024: every head width of the repo's presets; the
// few-levels preset's d = 36 runs with L = 2); the 4 pixels of a window
// read the same taps, back to back in the same warp, so the re-reads hit
// L1.
//
// Backward, from the saved q, kv, pe, den, out and the cotangent g, with
// p = exp(logit) * pe / den and s = (g . out) per head:
//
//   dlogit = p * ((g . val) - s)         dq   = sum_i dlogit_i * key_i
//   dval   = sum over queries of p * g   dkey = sum over queries of dlogit * q
//   dpe[k, tap, pos, e] = sum over pixels at pos of exp(logit) ((g . val) - s) / den
//
// The TPU kernel ran the adjoint of tap selection as a 2x2 window sum
// inside one tile and carried dpe across its sequential grid.  Here:
//   1. a query pass (one group per (pixel, head), as the forward) writes
//      dq and, per (pixel, slot, tap, head), p, dlogit and the dpe term to
//      a float scratch (N*H*W*K*4*heads each);
//   2. a source pass (one group per (source pixel, slot, head)): a
//      source at in-window position t is read, for tap t, by exactly the
//      4 queries of its own window, so dval and dkey are 4-term sums in a
//      fixed order -- no atomics;
//   3. dpe: per-block partial sums over pixel slices, then one block sums
//      the partials in slice order (the reduce kernel's scheme,
//      morphfc.cu): deterministic, no float atomics.
// Bound: device-memory traffic, as the forward (the backward reads q, g,
// out and the kv taps and writes dq and an f32 dkv).
#include "common.cuh"

namespace vmg {

// Head widths: each (pixel, head) is a group of L lanes (L = 1, 2, ..., 32,
// the least power of two with L * kLtamR >= d), lane j holding elements
// j, j + L, j + 2L, ... of the head in registers, so neighbouring lanes read
// neighbouring channels.  Dot products are summed per lane in element
// order, then across the group by a butterfly of __shfl_xor_sync, after
// which every lane holds the same bits (each level adds the same two
// values).  L = 1 (d <= 32) is one thread per (pixel, head), no shuffle.
constexpr int kLtamR = 32;                  // head elements per lane
constexpr int kLtamMaxD = kLtamR * 32;      // 1024

__host__ __device__ inline int ltam_lanes(int d) {
  int L = 1;
  while (L * kLtamR < d) L *= 2;
  return L;
}

// LF = 1: one lane per (pixel, head) (d <= 32), everything a compile-time
// constant, the code of a plain per-thread loop; LF = 0: L lanes, L given
// at run time.
template <int LF>
struct LtamLane {
  int L, j;       // group size, this lane's index in its group
  unsigned mask;  // the group's lanes of the warp
  __device__ LtamLane(int lanes)
      : L(LF == 1 ? 1 : lanes), j(LF == 1 ? 0 : threadIdx.x & (lanes - 1)) {
    mask = LF == 1 || lanes == 32
               ? 0xffffffffu
               : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  }
  __device__ __forceinline__ float sum(float v) const {
    if constexpr (LF != 1)
      for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
    return v;
  }
  __device__ __forceinline__ int at(int i) const {
    if constexpr (LF == 1)
      return i;
    else
      return i * L + j;
  }
  __device__ __forceinline__ bool has(int i, int d) const { return at(i) < d; }
};

// One group per (pixel, head): idx = group index (pix * heads + e).
template <typename T, int LF>
__global__ void __launch_bounds__(256)
ltam_fwd_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                const float* __restrict__ pe, float* __restrict__ out,
                float* __restrict__ den_out, long long total, int H, int W,
                int C, int K, int heads, int lanes) {
  const long long gidx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int shift = LF == 1 ? 0 : __ffs(lanes) - 1;  // lanes is a power of two
  if (gidx >= (total << shift)) return;  // whole groups: total * lanes threads
  const LtamLane<LF> ln(lanes);
  const long long idx = gidx >> shift;
  const int e = (int)(idx % heads);
  const long long pix = idx / heads;
  const int col = (int)(pix % W);
  const long long t = pix / W;
  const int row = (int)(t % H);
  const long long n = t / H;
  const int d = C / heads;
  const int pos = (row & 1) * 2 + (col & 1);

  float qv[kLtamR], num[kLtamR];
  const float* qp = q + pix * C + e * d;
#pragma unroll
  for (int i = 0; i < kLtamR; ++i) {
    qv[i] = ln.has(i, d) ? qp[ln.at(i)] : 0.f;
    num[i] = 0.f;
  }
  float den = 0.f;
  const size_t slot_stride = 2 * (size_t)C;
  for (int k = 0; k < K; ++k) {
    for (int tap = 0; tap < 4; ++tap) {
      const int sr = (row & ~1) + (tap >> 1), sc = (col & ~1) + (tap & 1);
      const T* base = kv + ((size_t)(n * H + sr) * W + sc) * (K * slot_stride) +
                      k * slot_stride + e * d;
      const T* val = base;
      const T* key = base + C;
      float logit = 0.f;
#pragma unroll
      for (int i = 0; i < kLtamR; ++i)
        if (ln.has(i, d)) logit = fmaf(qv[i], to_f<T>(key[ln.at(i)]), logit);
      logit = ln.sum(logit);
      const float ex = expf(logit) * pe[((k * 4 + tap) * 4 + pos) * heads + e];
      den += ex;
#pragma unroll
      for (int i = 0; i < kLtamR; ++i)
        if (ln.has(i, d)) num[i] = fmaf(ex, to_f<T>(val[ln.at(i)]), num[i]);
    }
  }
  if (den_out != nullptr && ln.j == 0) den_out[idx] = den;
  const float dd = fmaxf(den, 1e-30f);
  float* op = out + pix * C + e * d;
#pragma unroll
  for (int i = 0; i < kLtamR; ++i)
    if (ln.has(i, d)) op[ln.at(i)] = num[i] / dd;
}

// Pass 1 of the backward: one group per (pixel, head).  Scratch index of
// (pixel, slot k, tap, head): ((pix * K + k) * 4 + tap) * heads + e.
template <typename T, int LF>
__global__ void __launch_bounds__(256)
ltam_bwd_query_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                      const float* __restrict__ pe, const float* __restrict__ den_in,
                      const float* __restrict__ out, const float* __restrict__ g,
                      float* __restrict__ dq, float* __restrict__ sp,
                      float* __restrict__ sdl, float* __restrict__ sdpe,
                      long long total, int H, int W, int C, int K, int heads, int lanes) {
  const long long gidx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int shift = LF == 1 ? 0 : __ffs(lanes) - 1;
  if (gidx >= (total << shift)) return;
  const LtamLane<LF> ln(lanes);
  const long long idx = gidx >> shift;
  const int e = (int)(idx % heads);
  const long long pix = idx / heads;
  const int col = (int)(pix % W);
  const long long t = pix / W;
  const int row = (int)(t % H);
  const long long n = t / H;
  const int d = C / heads;
  const int pos = (row & 1) * 2 + (col & 1);

  float qv[kLtamR], gv[kLtamR], dqv[kLtamR];
  const float* qp = q + pix * C + e * d;
  const float* gp = g + pix * C + e * d;
  const float* op = out + pix * C + e * d;
  float s = 0.f;  // (g . out) over the head
#pragma unroll
  for (int i = 0; i < kLtamR; ++i) {
    const bool ok = ln.has(i, d);
    qv[i] = ok ? qp[ln.at(i)] : 0.f;
    gv[i] = ok ? gp[ln.at(i)] : 0.f;
    dqv[i] = 0.f;
    if (ok) s = fmaf(gv[i], op[ln.at(i)], s);
  }
  s = ln.sum(s);
  const float den = fmaxf(den_in[idx], 1e-30f);
  const size_t slot_stride = 2 * (size_t)C;
  for (int k = 0; k < K; ++k) {
    for (int tap = 0; tap < 4; ++tap) {
      const int sr = (row & ~1) + (tap >> 1), sc = (col & ~1) + (tap & 1);
      const T* base = kv + ((size_t)(n * H + sr) * W + sc) * (K * slot_stride) +
                      k * slot_stride + e * d;
      const T* val = base;
      const T* key = base + C;
      float logit = 0.f, gval = 0.f;
#pragma unroll
      for (int i = 0; i < kLtamR; ++i)
        if (ln.has(i, d)) {
          logit = fmaf(qv[i], to_f<T>(key[ln.at(i)]), logit);
          gval = fmaf(gv[i], to_f<T>(val[ln.at(i)]), gval);
        }
      logit = ln.sum(logit);
      gval = ln.sum(gval);
      const float el = expf(logit);
      const float p = el * pe[((k * 4 + tap) * 4 + pos) * heads + e] / den;
      const float dl = p * (gval - s);
#pragma unroll
      for (int i = 0; i < kLtamR; ++i)
        if (ln.has(i, d)) dqv[i] = fmaf(dl, to_f<T>(key[ln.at(i)]), dqv[i]);
      if (ln.j == 0) {
        const long long si = ((pix * K + k) * 4 + tap) * heads + e;
        sp[si] = p;
        sdl[si] = dl;
        sdpe[si] = el * (gval - s) / den;
      }
    }
  }
  float* dqp = dq + pix * C + e * d;
#pragma unroll
  for (int i = 0; i < kLtamR; ++i)
    if (ln.has(i, d)) dqp[ln.at(i)] = dqv[i];
}

// Pass 2: one group per (source pixel, slot, head), each lane its slice of
// the head (no reduction); its window's 4 queries in position order.
template <int LF>
__global__ void __launch_bounds__(256)
ltam_bwd_source_kernel(const float* __restrict__ q, const float* __restrict__ g,
                       const float* __restrict__ sp, const float* __restrict__ sdl,
                       float* __restrict__ dkv, long long total, int H, int W,
                       int C, int K, int heads, int lanes) {
  const long long gidx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int shift = LF == 1 ? 0 : __ffs(lanes) - 1;
  if (gidx >= (total << shift)) return;
  const LtamLane<LF> ln(lanes);
  const long long idx = gidx >> shift;
  const int e = (int)(idx % heads);
  const int k = (int)((idx / heads) % K);
  const long long spix = idx / ((long long)heads * K);
  const int sc = (int)(spix % W);
  const long long t = spix / W;
  const int sr = (int)(t % H);
  const long long n = t / H;
  const int d = C / heads;
  const int tap = (sr & 1) * 2 + (sc & 1);

  float dval[kLtamR], dkey[kLtamR];
#pragma unroll
  for (int i = 0; i < kLtamR; ++i) dval[i] = dkey[i] = 0.f;
  for (int qpos = 0; qpos < 4; ++qpos) {
    const int qr = (sr & ~1) + (qpos >> 1), qc = (sc & ~1) + (qpos & 1);
    const long long qpix = (n * H + qr) * W + qc;
    const long long si = ((qpix * K + k) * 4 + tap) * heads + e;
    const float p = sp[si], dl = sdl[si];
    const float* gp = g + qpix * C + e * d;
    const float* qp = q + qpix * C + e * d;
#pragma unroll
    for (int i = 0; i < kLtamR; ++i)
      if (ln.has(i, d)) {
        dval[i] = fmaf(p, gp[ln.at(i)], dval[i]);
        dkey[i] = fmaf(dl, qp[ln.at(i)], dkey[i]);
      }
  }
  float* vp = dkv + (size_t)spix * K * 2 * C + (size_t)k * 2 * C + e * d;
#pragma unroll
  for (int i = 0; i < kLtamR; ++i)
    if (ln.has(i, d)) {
      vp[ln.at(i)] = dval[i];
      vp[C + ln.at(i)] = dkey[i];
    }
}

// Pass 3a: block s sums the dpe terms of pixels [s*chunk, (s+1)*chunk) per
// bin (k, tap, pos, e), bin index ((k*4 + tap)*4 + pos)*heads + e.
__global__ void __launch_bounds__(256)
ltam_bwd_dpe_partial_kernel(const float* __restrict__ sdpe, float* __restrict__ partial,
                            long long P, long long chunk, int H, int W, int K,
                            int heads) {
  const int bins = K * 16 * heads;
  const long long p0 = (long long)blockIdx.x * chunk;
  const long long p1 = p0 + chunk < P ? p0 + chunk : P;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    const int e = b % heads;
    const int pos = (b / heads) % 4;
    const int kt = b / (4 * heads);  // k * 4 + tap
    float acc = 0.f;
    for (long long pix = p0; pix < p1; ++pix) {
      const int col = (int)(pix % W), row = (int)((pix / W) % H);
      if ((row & 1) * 2 + (col & 1) == pos)
        acc += sdpe[(pix * K * 4 + kt) * heads + e];
    }
    partial[(size_t)blockIdx.x * bins + b] = acc;
  }
}

// Pass 3b: one block, partials summed in slice order.
__global__ void __launch_bounds__(256)
ltam_bwd_dpe_final_kernel(const float* __restrict__ partial, float* __restrict__ dpe,
                          int S, int bins) {
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += partial[(size_t)s * bins + b];
    dpe[b] = acc;
  }
}

}  // namespace vmg

static bool ltam_shape_ok(int C, int heads, int H, int W) {
  return heads >= 1 && C % heads == 0 && C / heads <= vmg::kLtamMaxD && H % 2 == 0 &&
         W % 2 == 0;
}

extern "C" int vmg_ltam_fwd(const float* q, const void* kv, const float* pe,
                            float* out, float* den, int N, int H, int W, int C,
                            int K, int heads, int dtype, void* stream) {
  if (!ltam_shape_ok(C, heads, H, W)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * H * W * heads;
  const int threads = 256, L = vmg::ltam_lanes(C / heads);
  const long long blocks = (total * L + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    auto kern = L == 1 ? vmg::ltam_fwd_kernel<T, 1> : vmg::ltam_fwd_kernel<T, 0>;
    kern<<<(unsigned)blocks, threads, 0, st>>>(q, (const T*)kv, pe, out, den, total, H, W, C, K,
                                               heads, L);
  });
  return (int)cudaGetLastError();
}

// scratch: 3 * N*H*W*K*4*heads floats (p, dlogit, dpe term); partial:
// S * K*16*heads floats.  dkv is float32 whatever kv's dtype.
extern "C" int vmg_ltam_bwd(const float* q, const void* kv, const float* pe,
                            const float* den, const float* out, const float* g,
                            float* dq, float* dkv, float* dpe, float* scratch,
                            float* partial, int N, int H, int W, int C, int K,
                            int heads, int S, int dtype, void* stream) {
  if (!ltam_shape_ok(C, heads, H, W) || K < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)N * H * W;
  const long long terms = P * K * 4 * heads;
  float* sp = scratch;
  float* sdl = scratch + terms;
  float* sdpe = scratch + 2 * terms;
  const int threads = 256, L = vmg::ltam_lanes(C / heads);
  cudaStream_t st = (cudaStream_t)stream;
  const long long qtotal = P * heads;
  VMG_DISPATCH_DTYPE(dtype, T, {
    auto kern = L == 1 ? vmg::ltam_bwd_query_kernel<T, 1> : vmg::ltam_bwd_query_kernel<T, 0>;
    kern<<<(unsigned)((qtotal * L + threads - 1) / threads), threads, 0, st>>>(
        q, (const T*)kv, pe, den, out, g, dq, sp, sdl, sdpe, qtotal, H, W, C, K, heads, L);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long stotal = P * K * heads;
  auto src_kern = L == 1 ? vmg::ltam_bwd_source_kernel<1> : vmg::ltam_bwd_source_kernel<0>;
  src_kern<<<(unsigned)((stotal * L + threads - 1) / threads), threads, 0, st>>>(
      q, g, sp, sdl, dkv, stotal, H, W, C, K, heads, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long chunk = (P + S - 1) / S;
  vmg::ltam_bwd_dpe_partial_kernel<<<S, threads, 0, st>>>(sdpe, partial, P, chunk, H,
                                                         W, K, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vmg::ltam_bwd_dpe_final_kernel<<<1, threads, 0, st>>>(partial, dpe, S, K * 16 * heads);
  return (int)cudaGetLastError();
}
