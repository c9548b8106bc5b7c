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
// Bound on H100: device-memory traffic.  A forward step reads q, writes
// out and reads every pixel's kv once (each kv pixel is a tap of exactly
// the 4 queries of its own window): K = 5 at stage 0 is 2.2 KB of bf16 kv
// per pixel, 184.6 MB and 0.055 ms a call, at ~4 FLOPs per element read.
// Design (ltam_fwd_kernel, notes there): one block per (frame, window row,
// column span, head group) stages each slot's kv for its own windows
// through shared memory, four slots in flight, with one bulk copy per
// pixel's contiguous 2C channels, and q and out through the same buffer as
// contiguous rows; so every tap crosses L2 -> SM once and all global
// traffic moves whole lines.  The four taps' logits are four interleaved
// FMA chains: one 28-long chain at a time left the warps waiting on FMA
// latency.  Thread groups of L lanes per (pixel,
// head) (L = 1 up to d = 32, 2 up to 64, ..., 32 up to d = 1024: every
// head width of the repo's presets; the few-levels preset's d = 36 runs
// with L = 2) keep q and the numerator in registers and read the taps from
// shared memory 4, 2 or 1 elements at a time, as far as d's alignment
// allows: a head does not start on 16 bytes at d = 28 or 36.  The scalar
// kernel this replaced (one group per (pixel, head) reading d 2-byte taps
// straight from device memory, 8 pixels of a warp 2,240 bytes apart; the
// window's second row in another block) was bound by load instructions
// and L1 transactions, at a fifth of the bound.
//
// ptxas report: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -Xptxas -v -c vmg_tpu_torch/csrc/ltam.cu.  The bf16 forward (launch
// bounds 128 x 4: 128 registers) spills nothing but at head widths that
// are not even (one element at a time, several lanes: 12-16 bytes); the f32
// forward (parity runs) spills 8-272 bytes.  The backward: see
// ltam_bwd_kernel.  Traps: a TMA box holds at most 256 elements a dimension, so
// a slot's 2C = 288 channels at C = 144 are not one box -- bulk copies
// have no such limit and need only 16-byte multiples; at d = 28 and 36 a
// head starts 8 bytes off a 16-byte boundary, so taps are read 4 elements
// (8 bytes) at a time.
//
// Backward, from the saved q, kv, pe, den, out and the cotangent g, with
// p = exp(logit) * pe / den and s = (g . out) per head:
//
//   dlogit = p * ((g . val) - s)         dq   = sum_i dlogit_i * key_i
//   dval   = sum over queries of p * g   dkey = sum over queries of dlogit * q
//   dpe[k, tap, pos, e] = sum over pixels at pos of exp(logit) ((g . val) - s) / den
//
// The TPU kernel ran the adjoint of tap selection as a 2x2 window sum
// inside one tile and carried dpe across its sequential grid.  Here
// (ltam_bwd_kernel, notes there) one block per (frame, window row, column
// span, head group) -- the forward's tiling -- holds every query that reads
// its source pixels, so each pixel's lane group computes its query terms
// (p, dlogit, dq) and, after one exchange through shared memory, its
// source's dval and dkey as 4-term sums in query-position order, rounded
// once to kv's dtype.  dpe: one partial per block and bin, summed in block
// order by ltam_bwd_dpe_kernel (two launches; deterministic, no float
// atomics, no scratch of per-(pixel, slot, tap) terms).
// Bound: device-memory traffic, as the forward: q, g and out read in f32,
// kv read and dkv written in kv's dtype, dq written in f32 -- 25.8 MB and
// 0.0077 ms at the training shape (1x64x64x112, K = 5, bf16), against
// ~92 MFLOP.  The four-pass kernel this replaced (a query pass of one
// thread per (pixel, head) reading taps straight from device memory, 16,384
// threads at that shape; a source pass over a 3 x P K 4 heads f32 scratch;
// a single-block dpe sum; dkv in f32, then a cast pass) ran at 29x that.
#include "common.cuh"
#include "wgmma.cuh"

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

// the least power of two L with L * R >= d
__host__ __device__ inline int ltam_lanes_for(int d, int R) {
  int L = 1;
  while (L * R < d) L *= 2;
  return L;
}
__host__ __device__ inline int ltam_lanes(int d) { return ltam_lanes_for(d, kLtamR); }

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

// ---- forward: a block per (frame, window row, column span, head group) ----
//
// The block's queries are rows 2 rp, 2 rp + 1 and columns c0 .. c0 + Wt -
// 1 of one frame, for HB heads: exactly the pixels whose 2x2 windows are
// the block's own, so each kv tap is needed by this block alone.  kv is
// staged one slot k at a time in nbuf = min(K, 4) buffers (slots k + 1 ..
// k + nbuf - 1 copy while k is used): per pixel the HB heads' value
// channels, then their key channels -- one bulk copy where every run is a
// 16-byte multiple (a pixel's slot is 2C contiguous elements), else cp.async
// at the widest width the runs allow -- at a pixel stride padded so that
// the two windows a warp reads fall on other banks.  Blocks of at most 128
// threads, three or more an SM.
// q comes in the same way, as one contiguous run of Wt C f32 per row when
// HB = heads, and out leaves through the same buffer.  A thread group of L
// lanes per (pixel, head) (LtamLane) keeps q and the numerator in
// registers and reads the taps from shared memory VU elements at a time
// (VU = 4, 2 or 1, as the head width's alignment allows); the 4 queries of
// a window sit in neighbouring groups of one warp, so their reads of a tap
// are broadcasts.
struct LtamFwdArgs {
  int H, W, C, K, heads, d, L;
  int Wt, HB, spans, hgroups;  // column span, heads per block; spans per row, head groups
  int pst;                     // kv pixel stride in shared memory (elements)
  int vkv, vq;                 // copy widths (bytes) of kv and of q / out
  int bulk;                    // 1: every run a 16-byte multiple: bulk copies
  int nbuf;                    // kv slot buffers: min(K, kLtamBufs)
  unsigned q_bytes;            // the q / out buffer
};

constexpr int kLtamBufs = 4;  // kv slots in flight (buffers) per block

// The kv pixel stride: the 2 HB d staged channels, padded (in 16-byte
// steps, where the run is a 16-byte multiple) so that 2 strides are 16
// banks apart.
__host__ __device__ inline int ltam_pixel_stride(int seg2, int es) {
  const int words = seg2 * es / 4;
  if ((seg2 * es) % 16 != 0) return seg2;
  return seg2 + ((8 - words % 16 + 16) % 16) * 4 / es;
}
__host__ __device__ inline size_t ltam_fwd_smem(int Wt, int HB, int d, int es, int nbuf) {
  const size_t q = ((size_t)2 * Wt * HB * d * 4 + 15) / 16 * 16;
  const size_t kv = (size_t)nbuf * 2 * Wt * ltam_pixel_stride(2 * HB * d, es) * es;
  return q + (kv + 7) / 8 * 8 + (1 + nbuf) * 8;  // + the mbarriers of q and of the buffers
}

// cp.async of 16, 8 or 4 bytes; 2: a plain copy of one bf16 (a run with no
// 4-byte alignment)
__device__ __forceinline__ void copy_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = su32(smem);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    *reinterpret_cast<unsigned short*>(smem) = *reinterpret_cast<const unsigned short*>(gmem);
}

// VU consecutive elements of T from shared memory, as floats
template <typename T, int VU>
__device__ __forceinline__ void lds_vec(const T* p, float (&v)[VU]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VU == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else if constexpr (VU == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      v[0] = t.x, v[1] = t.y;
    } else {
      v[0] = *p;
    }
  } else {
    if constexpr (VU == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
      v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    } else if constexpr (VU == 2) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      v[0] = t.x, v[1] = t.y;
    } else {
      v[0] = __bfloat162float(*p);
    }
  }
}

// Threads: 2 Wt HB groups of L lanes.  Group gi: window column cw = gi /
// (4 HB), then pixel pw of the window (row pw / 2, column pw % 2), then
// head el; lane j holds the head's elements (i L + j) VU + t, i < 32 / VU.
// Copies: where every run is a multiple of 16 bytes (a.bulk), warp 0 issues
// bulk copies -- one per staged pixel and slot (its value and key runs are
// one run when HB = heads), one per row of q (likewise) -- completing on the
// buffer's mbarrier, and out leaves by bulk stores; else every thread
// copies with cp.async at the widest width the runs allow.
template <typename T, int LF, int VU>
__global__ void __launch_bounds__(128, 4)
ltam_fwd_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                const float* __restrict__ pe, float* __restrict__ out,
                float* __restrict__ den_out, const LtamFwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int es = sizeof(T), NU = kLtamR / VU;
  const int d = a.d, seg = a.HB * d, C = a.C;
  float* qs = reinterpret_cast<float*>(smem);  // [2][Wt][seg] f32: q, then out
  T* kvs = reinterpret_cast<T*>(smem + a.q_bytes);  // [nbuf][2 rows][Wt][pst]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(kvs + (size_t)a.nbuf * 2 * a.Wt * a.pst) + 7) & ~(uintptr_t)7);
  int b = blockIdx.x;
  const int hg = b % a.hgroups;
  b /= a.hgroups;
  const int cs = b % a.spans;
  b /= a.spans;
  const int rp = b % (a.H / 2), n = b / (a.H / 2);
  const int r0 = 2 * rp, c0 = cs * a.Wt, Wv = min(a.Wt, a.W - c0), ch0 = hg * seg;
  const size_t pix0 = ((size_t)n * a.H + r0) * a.W + c0;  // the block's first pixel
  const size_t kstride = (size_t)a.K * 2 * C;               // kv elements per pixel
  const bool whole = a.HB == a.heads;  // a pixel's staged channels are one run
  const int lane = threadIdx.x & 31;
  const bool issuer = threadIdx.x < 32;

  if (a.bulk) {
    if (threadIdx.x == 0) {
      for (int i = 0; i <= a.nbuf; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // q: per staged pixel (row r, column p) seg f32 from channel ch0
  if (a.bulk) {
    if (issuer) {
      const int runs = whole ? 2 : 2 * Wv;
      const unsigned bytes = (unsigned)((whole ? Wv : 1) * seg * 4);
      if (lane == 0) mbar_expect(bars, runs * bytes);
      __syncwarp();
      for (int i = lane; i < runs; i += 32) {
        const int r = whole ? i : i / Wv, p = whole ? 0 : i - r * Wv;
        bulk_load(qs + (r * a.Wt + p) * seg, q + (pix0 + (size_t)r * a.W + p) * C + ch0, bytes,
                  bars);
      }
    }
  } else {
    const int nv = seg * 4 / a.vq, fv = a.vq / 4;
    for (int e = threadIdx.x; e < 2 * Wv * nv; e += blockDim.x) {
      const int pix = e / nv, v = e - pix * nv, r = pix / Wv, p = pix - r * Wv;
      copy_async(qs + (r * a.Wt + p) * seg + v * fv,
                 q + (pix0 + (size_t)r * a.W + p) * C + ch0 + v * fv, a.vq);
    }
  }
  auto copy_slot = [&](int k, int buf) {
    T* dst0 = kvs + (size_t)buf * 2 * a.Wt * a.pst;
    const T* src0 = kv + pix0 * kstride + (size_t)k * 2 * C + ch0;
    if (a.bulk) {
      if (!issuer) return;
      const int parts = whole ? 1 : 2, runs = 2 * Wv * parts;
      const unsigned bytes = (unsigned)((whole ? 2 : 1) * seg * es);
      if (lane == 0) mbar_expect(bars + 1 + buf, runs * bytes);
      __syncwarp();
      for (int i = lane; i < runs; i += 32) {
        const int pix = i / parts, part = i - pix * parts, r = pix / Wv, p = pix - r * Wv;
        bulk_load(dst0 + (r * a.Wt + p) * a.pst + part * seg,
                  src0 + ((size_t)r * a.W + p) * kstride + part * C, bytes, bars + 1 + buf);
      }
      return;
    }
    const int nv = seg * es / a.vkv, fv = a.vkv / es;
    for (int e = threadIdx.x; e < 2 * Wv * 2 * nv; e += blockDim.x) {
      const int pix = e / (2 * nv), rem = e - pix * 2 * nv, part = rem / nv, v = rem - part * nv;
      const int r = pix / Wv, p = pix - r * Wv;
      copy_async(dst0 + (r * a.Wt + p) * a.pst + part * seg + v * fv,
                 src0 + ((size_t)r * a.W + p) * kstride + part * C + v * fv, a.vkv);
    }
    cp_async_commit();
  };
  for (int k = 0; k < a.nbuf; ++k) copy_slot(k, k);  // slot 0 with q

  const LtamLane<LF> ln(a.L);
  const int gi = threadIdx.x / (LF == 1 ? 1 : a.L);
  const int cw = gi / (4 * a.HB), rem = gi - cw * 4 * a.HB, pw = rem / a.HB, el = rem - pw * a.HB;
  const int r = pw >> 1, cc = pw & 1, px = 2 * cw + cc, e = hg * a.HB + el;
  const bool valid = px < Wv;  // Wv is even: whole windows
  const int pos = 2 * r + cc;  // r0 and c0 are even
  float qv[kLtamR], num[kLtamR], den = 0.f;
  auto has = [&](int i) { return (ln.at(i) * VU) < d; };
  float* qp = qs + (r * a.Wt + px) * seg + el * d;
  for (int k = 0; k < a.K; ++k) {
    const int bi = k % a.nbuf;
    float pk4[4];  // the slot's position factors, loaded before the wait
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) pk4[tap] = __ldg(pe + ((k * 4 + tap) * 4 + pos) * a.heads + e);
    if (a.bulk) {
      if (k == 0) mbar_wait(bars, 0);
      mbar_wait(bars + 1 + bi, (k / a.nbuf) & 1);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // slot k (and q) in for every thread
    }
    if (valid) {
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          float v[VU];
          if (has(i)) lds_vec<float, VU>(qp + ln.at(i) * VU, v);
#pragma unroll
          for (int t = 0; t < VU; ++t) {
            qv[i * VU + t] = has(i) ? v[t] : 0.f;
            num[i * VU + t] = 0.f;
          }
        }
      }
      // the 4 taps' logits as 4 interleaved chains (each summed in element
      // order), then their weights, then the numerator in tap order
      const T* vp = kvs + (size_t)bi * 2 * a.Wt * a.pst + 2 * cw * a.pst + el * d;
      auto tap_at = [&](int tap) { return vp + ((tap >> 1) * a.Wt + (tap & 1)) * a.pst; };
      float logit[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (has(i)) {
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            float kf[VU];
            lds_vec<T, VU>(tap_at(tap) + seg + ln.at(i) * VU, kf);
#pragma unroll
            for (int t = 0; t < VU; ++t) logit[tap] = fmaf(qv[i * VU + t], kf[t], logit[tap]);
          }
        }
      float ex[4];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        ex[tap] = expf(ln.sum(logit[tap])) * pk4[tap];
        den += ex[tap];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (has(i)) {
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            float vf[VU];
            lds_vec<T, VU>(tap_at(tap) + ln.at(i) * VU, vf);
#pragma unroll
            for (int t = 0; t < VU; ++t) num[i * VU + t] = fmaf(ex[tap], vf[t], num[i * VU + t]);
          }
        }
    }
    __syncthreads();  // the buffer is free for slot k + nbuf
    if (k + a.nbuf < a.K) copy_slot(k + a.nbuf, bi);
  }
  if (valid) {
    const size_t pix = pix0 + (size_t)r * a.W + px;
    if (den_out != nullptr && ln.j == 0) den_out[pix * a.heads + e] = den;
    const float dd = fmaxf(den, 1e-30f);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (has(i))
#pragma unroll
        for (int t = 0; t < VU; ++t) qp[ln.at(i) * VU + t] = num[i * VU + t] / dd;
  }
  if (a.bulk) {
    fence_async_shared();  // out's writes, visible to the bulk stores
    __syncthreads();
    if (issuer) {
      const int runs = whole ? 2 : 2 * Wv;
      const unsigned bytes = (unsigned)((whole ? Wv : 1) * seg * 4);
      for (int i = lane; i < runs; i += 32) {
        const int rr = whole ? i : i / Wv, p = whole ? 0 : i - rr * Wv;
        bulk_store(out + (pix0 + (size_t)rr * a.W + p) * C + ch0, qs + (rr * a.Wt + p) * seg,
                   bytes);
      }
      bulk_commit();
      bulk_wait<0>();
    }
    return;
  }
  __syncthreads();
  const int fv = a.vq / 4, nv = seg / fv;
  for (int e2 = threadIdx.x; e2 < 2 * Wv * nv; e2 += blockDim.x) {
    const int pix = e2 / nv, v = e2 - pix * nv, rr = pix / Wv, p = pix - rr * Wv;
    const float* src = qs + (rr * a.Wt + p) * seg + v * fv;
    float* dst = out + (pix0 + (size_t)rr * a.W + p) * C + ch0 + v * fv;
    if (fv == 4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else if (fv == 2)
      *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
    else
      *dst = *src;
  }
}

// ---- backward: the forward's block, each lane group a query and a source ----
//
// A block covers the forward's (frame, window row, column span Wt, head
// group HB) and holds both rows of its windows, so the 4 queries that read
// a source pixel (the 4 pixels of its own window) are all in it.  Thread
// group (window cw, in-window position pw, head el) of L lanes plays two
// roles for its pixel, slot by slot:
//   * query: the 4 taps' logits and (g . val), then p, dlogit and the dpe
//     term per tap (to shared memory), dq += dlogit key_tap (registers);
//   * source (its pixel is tap pw of its window): dval = sum over the
//     window's queries qp = 0..3 of p[qp, pw] g[qp], dkey likewise with
//     dlogit and q -- 4-term sums in query-position order from shared
//     memory, rounded once to kv's dtype and stored.
// q and g come in once per block as f32 runs (bulk copies, or cp.async
// where a run is not a 16-byte multiple), kv slot by slot into min(K, 4)
// buffers as in the forward; s = (g . out) is formed once per (pixel,
// head).  More lanes per (pixel, head) than the forward (ltam_bwd_lanes: 8
// or 12 head elements a lane up to d = 256), so the work spreads over 4x the
// threads of one group per (pixel, head): at the training crop (1x64x64,
// d = 28, K = 5; and d = 36, K = 3) 4 lanes, 256 blocks of 256 threads
// (8 columns x 4 heads), 65,536 threads; at <= 128 registers two blocks,
// 16 warps, fit an SM, so the grid is one wave on 132 SMs.  dpe: per slot each block sums its
// windows' terms in column order into one partial per (slot, tap,
// position, head) -- ltam_bwd_dpe_kernel then adds a bin's partials in
// block order, one warp a bin.  Deterministic; no scratch of the P x K x 4 x
// heads terms, no float atomics; dkv leaves in kv's dtype.
// ptxas (launch bounds 256 x 2: 128 registers): the bf16 d = 28 kernel
// (VU = 4, R = 8) uses 128 registers and spills nothing; R = 12 (d = 36)
// spills 64 bytes; odd or 2-aligned head widths (VU = 1, 2) 36-352 bytes;
// R = 32 (d > 256, launch bounds 256 x 1) runs at 252-255 registers.
constexpr int kLtamBwdThreads = 256;

// head elements per lane of the backward: 8, or 12 where that halves the
// lanes (d = 36: 4 lanes, not 8 -- one wave of blocks at the training
// crop, not two), up to d = 256; 32 above
__host__ __device__ inline int ltam_bwd_reg(int d) {
  if (d > 8 * 32) return kLtamR;
  return ltam_lanes_for(d, 12) < ltam_lanes_for(d, 8) ? 12 : 8;
}
__host__ __device__ inline int ltam_bwd_lanes(int d) { return ltam_lanes_for(d, ltam_bwd_reg(d)); }
// q and g (f32), the p / dlogit / dpe exchange, nbuf kv slot buffers, the
// mbarriers (ltam_attention.bwd_smem)
__host__ __device__ inline size_t ltam_bwd_smem(int Wt, int HB, int d, int es, int nbuf) {
  const size_t q = ((size_t)2 * Wt * HB * d * 4 + 15) / 16 * 16;
  const size_t pd = ((size_t)2 * Wt * HB * 4 * 3 * 4 + 15) / 16 * 16;
  const size_t kv = (size_t)nbuf * 2 * Wt * ltam_pixel_stride(2 * HB * d, es) * es;
  return 2 * q + pd + (kv + 7) / 8 * 8 + (1 + nbuf) * 8;
}

struct LtamBwdArgs {
  int H, W, C, K, heads, d, L;
  int Wt, HB, spans, hgroups;
  int pst, vkv, vq, bulk, nbuf;
  unsigned q_bytes, pd_bytes;
  int nblk;  // blocks of a head group: the length of a dpe bin's partials
};

// VU elements of T to global memory from floats (rounded once to T)
template <typename T, int VU>
__device__ __forceinline__ void stg_vec(T* p, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VU == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else if constexpr (VU == 2)
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    else
      *p = v[0];
  } else {
    if constexpr (VU == 4) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<unsigned*>(&lo);
      u.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(p) = u;
    } else if constexpr (VU == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
      *p = __float2bfloat16_rn(v[0]);
    }
  }
}

// Threads: 2 Wt HB groups of L lanes, laid out as the forward's (group gi:
// window column cw, pixel pw of the window, head el); lane j holds the
// head's elements (i L + j) VU + t, i < R / VU.  partial: (K * 16 * heads)
// bins x nblk blocks, bin ((k * 4 + tap) * 4 + pos) * heads + e.
template <typename T, int VU, int R>
__global__ void __launch_bounds__(kLtamBwdThreads, R == kLtamR ? 1 : 2)
ltam_bwd_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                const float* __restrict__ pe, const float* __restrict__ den_in,
                const float* __restrict__ out, const float* __restrict__ g,
                float* __restrict__ dq, T* __restrict__ dkv, float* __restrict__ partial,
                const LtamBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NU = R / VU;
  const int d = a.d, seg = a.HB * d, C = a.C;
  float* qs = reinterpret_cast<float*>(smem);                // [2][Wt][seg] f32
  float* gs = reinterpret_cast<float*>(smem + a.q_bytes);    // [2][Wt][seg] f32
  float* pd = reinterpret_cast<float*>(smem + 2 * a.q_bytes);  // [group][tap][p, dl, dpe]
  T* kvs = reinterpret_cast<T*>(smem + 2 * a.q_bytes + a.pd_bytes);  // [nbuf][2][Wt][pst]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(kvs + (size_t)a.nbuf * 2 * a.Wt * a.pst) + 7) & ~(uintptr_t)7);
  const int hg = blockIdx.x % a.hgroups, blk = blockIdx.x / a.hgroups;
  const int cs = blk % a.spans, rp = (blk / a.spans) % (a.H / 2), n = blk / a.spans / (a.H / 2);
  const int r0 = 2 * rp, c0 = cs * a.Wt, Wv = min(a.Wt, a.W - c0), ch0 = hg * seg;
  const size_t pix0 = ((size_t)n * a.H + r0) * a.W + c0;  // the block's first pixel
  const size_t kstride = (size_t)a.K * 2 * C;               // kv elements per pixel
  const bool whole = a.HB == a.heads;
  const int lane = threadIdx.x & 31;
  const bool issuer = threadIdx.x < 32;

  if (a.bulk) {
    if (threadIdx.x == 0) {
      for (int i = 0; i <= a.nbuf; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // q and g: per staged pixel seg f32 from channel ch0, both on bars[0]
  if (a.bulk) {
    if (issuer) {
      const int runs = whole ? 2 : 2 * Wv;
      const unsigned bytes = (unsigned)((whole ? Wv : 1) * seg * 4);
      if (lane == 0) mbar_expect(bars, 2 * runs * bytes);
      __syncwarp();
      for (int i = lane; i < 2 * runs; i += 32) {
        const int which = i / runs, ii = i - which * runs;
        const int r = whole ? ii : ii / Wv, p = whole ? 0 : ii - r * Wv;
        bulk_load((which ? gs : qs) + (r * a.Wt + p) * seg,
                  (which ? g : q) + (pix0 + (size_t)r * a.W + p) * C + ch0, bytes, bars);
      }
    }
  } else {
    const int nv = seg * 4 / a.vq, fv = a.vq / 4, per = 2 * Wv * nv;
    for (int e = threadIdx.x; e < 2 * per; e += blockDim.x) {
      const int which = e / per, e2 = e - which * per;
      const int pix = e2 / nv, v = e2 - pix * nv, r = pix / Wv, p = pix - r * Wv;
      copy_async((which ? gs : qs) + (r * a.Wt + p) * seg + v * fv,
                 (which ? g : q) + (pix0 + (size_t)r * a.W + p) * C + ch0 + v * fv, a.vq);
    }
  }
  auto copy_slot = [&](int k, int buf) {
    T* dst0 = kvs + (size_t)buf * 2 * a.Wt * a.pst;
    const T* src0 = kv + pix0 * kstride + (size_t)k * 2 * C + ch0;
    if (a.bulk) {
      if (!issuer) return;
      const int parts = whole ? 1 : 2, runs = 2 * Wv * parts;
      const unsigned bytes = (unsigned)((whole ? 2 : 1) * seg * sizeof(T));
      if (lane == 0) mbar_expect(bars + 1 + buf, runs * bytes);
      __syncwarp();
      for (int i = lane; i < runs; i += 32) {
        const int pix = i / parts, part = i - pix * parts, r = pix / Wv, p = pix - r * Wv;
        bulk_load(dst0 + (r * a.Wt + p) * a.pst + part * seg,
                  src0 + ((size_t)r * a.W + p) * kstride + part * C, bytes, bars + 1 + buf);
      }
      return;
    }
    const int nv = seg * (int)sizeof(T) / a.vkv, fv = a.vkv / (int)sizeof(T);
    for (int e = threadIdx.x; e < 2 * Wv * 2 * nv; e += blockDim.x) {
      const int pix = e / (2 * nv), rem = e - pix * 2 * nv, part = rem / nv, v = rem - part * nv;
      const int r = pix / Wv, p = pix - r * Wv;
      copy_async(dst0 + (r * a.Wt + p) * a.pst + part * seg + v * fv,
                 src0 + ((size_t)r * a.W + p) * kstride + part * C + v * fv, a.vkv);
    }
    cp_async_commit();
  };
  for (int k = 0; k < a.nbuf; ++k) copy_slot(k, k);  // slot 0 with q and g

  const LtamLane<0> ln(a.L);
  const int gi = threadIdx.x / a.L;
  const int cw = gi / (4 * a.HB), rem = gi - cw * 4 * a.HB, pw = rem / a.HB, el = rem - pw * a.HB;
  const int r = pw >> 1, px = 2 * cw + (pw & 1), e = hg * a.HB + el;
  const bool valid = px < Wv;  // Wv is even: whole windows
  // r0 and c0 are even: pw is the pixel's query position and its tap index
  // as a source of its own window
  const size_t pix = pix0 + (size_t)r * a.W + px;
  auto has = [&](int i) { return ln.at(i) * VU < d; };
  if (a.bulk) {
    mbar_wait(bars, 0);
  } else {
    cp_async_wait<0>();
    __syncthreads();
  }
  // this pixel's q and g in registers, s = (g . out) and the denominator
  float qv[R], gv[R], dqv[R], s = 0.f, den = 1.f;
  if (valid) {
    const float* qp = qs + (r * a.Wt + px) * seg + el * d;
    const float* gp = gs + (r * a.Wt + px) * seg + el * d;
    const float* op = out + pix * C + e * d;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float vq[VU], vg[VU], vo[VU];
      if (has(i)) {
        lds_vec<float, VU>(qp + ln.at(i) * VU, vq);
        lds_vec<float, VU>(gp + ln.at(i) * VU, vg);
        lds_vec<float, VU>(op + ln.at(i) * VU, vo);
      }
#pragma unroll
      for (int t = 0; t < VU; ++t) {
        qv[i * VU + t] = has(i) ? vq[t] : 0.f;
        gv[i * VU + t] = has(i) ? vg[t] : 0.f;
        dqv[i * VU + t] = 0.f;
        if (has(i)) s = fmaf(vg[t], vo[t], s);
      }
    }
    s = ln.sum(s);
    den = fmaxf(den_in[pix * a.heads + e], 1e-30f);
  }
  for (int k = 0; k < a.K; ++k) {
    const int bi = k % a.nbuf;
    float pk4[4];  // the slot's position factors, loaded before the wait
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) pk4[tap] = __ldg(pe + ((k * 4 + tap) * 4 + pw) * a.heads + e);
    if (a.bulk) {
      mbar_wait(bars + 1 + bi, (k / a.nbuf) & 1);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // slot k in for every thread
    }
    const T* vp = kvs + (size_t)bi * 2 * a.Wt * a.pst + 2 * cw * a.pst + el * d;
    auto tap_at = [&](int tap) { return vp + ((tap >> 1) * a.Wt + (tap & 1)) * a.pst; };
    if (valid) {
      // query: the 4 taps' logits and (g . val) as 8 interleaved chains
      float lg[4] = {0.f, 0.f, 0.f, 0.f}, gval[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (has(i)) {
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            float kf[VU], vf[VU];
            lds_vec<T, VU>(tap_at(tap) + seg + ln.at(i) * VU, kf);
            lds_vec<T, VU>(tap_at(tap) + ln.at(i) * VU, vf);
#pragma unroll
            for (int t = 0; t < VU; ++t) {
              lg[tap] = fmaf(qv[i * VU + t], kf[t], lg[tap]);
              gval[tap] = fmaf(gv[i * VU + t], vf[t], gval[tap]);
            }
          }
        }
      float dl[4];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const float ex = expf(ln.sum(lg[tap])), gs_ = ln.sum(gval[tap]) - s;
        const float p = ex * pk4[tap] / den;
        dl[tap] = p * gs_;
        if (ln.j == 0) {
          float* o = pd + (gi * 4 + tap) * 3;
          o[0] = p, o[1] = dl[tap], o[2] = ex * gs_ / den;
        }
      }
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (has(i)) {
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            float kf[VU];
            lds_vec<T, VU>(tap_at(tap) + seg + ln.at(i) * VU, kf);
#pragma unroll
            for (int t = 0; t < VU; ++t) dqv[i * VU + t] = fmaf(dl[tap], kf[t], dqv[i * VU + t]);
          }
        }
    }
    __syncthreads();  // every query's p, dlogit and dpe term are in pd
    if (valid) {
      // source: this pixel as tap pw of slot k, its window's 4 queries in
      // position order
      float pq[4], dlq[4];
#pragma unroll
      for (int qp = 0; qp < 4; ++qp) {
        const float* o = pd + (((cw * 4 + qp) * a.HB + el) * 4 + pw) * 3;
        pq[qp] = o[0], dlq[qp] = o[1];
      }
      T* dst = dkv + pix * kstride + (size_t)k * 2 * C + e * d;
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (has(i)) {
          float dv[VU], dk[VU];
#pragma unroll
          for (int t = 0; t < VU; ++t) dv[t] = dk[t] = 0.f;
#pragma unroll
          for (int qp = 0; qp < 4; ++qp) {
            const int off = ((qp >> 1) * a.Wt + 2 * cw + (qp & 1)) * seg + el * d + ln.at(i) * VU;
            float gq[VU], qq[VU];
            lds_vec<float, VU>(gs + off, gq);
            lds_vec<float, VU>(qs + off, qq);
#pragma unroll
            for (int t = 0; t < VU; ++t) {
              dv[t] = fmaf(pq[qp], gq[t], dv[t]);
              dk[t] = fmaf(dlq[qp], qq[t], dk[t]);
            }
          }
          stg_vec<T, VU>(dst + ln.at(i) * VU, dv);
          stg_vec<T, VU>(dst + C + ln.at(i) * VU, dk);
        }
    }
    // dpe: the block's windows in column order, one partial per bin
    for (int x = threadIdx.x; x < 16 * a.HB; x += blockDim.x) {
      const int tap = x / (4 * a.HB), qpos = (x / a.HB) % 4, eh = x % a.HB;
      float acc = 0.f;
      for (int w2 = 0; w2 < Wv / 2; ++w2) acc += pd[(((w2 * 4 + qpos) * a.HB + eh) * 4 + tap) * 3 + 2];
      partial[(size_t)(((k * 4 + tap) * 4 + qpos) * a.heads + hg * a.HB + eh) * a.nblk + blk] = acc;
    }
    __syncthreads();  // the buffer and pd are free
    if (k + a.nbuf < a.K) copy_slot(k + a.nbuf, bi);
  }
  if (valid) {
    float* dst = dq + pix * C + e * d;
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (has(i)) stg_vec<float, VU>(dst + ln.at(i) * VU, dqv + i * VU);
  }
}

// dpe: one warp a bin, lane l adding the bin's partials l, l + 32, ... in
// order, then a fixed butterfly across the warp.
__global__ void __launch_bounds__(256)
ltam_bwd_dpe_kernel(const float* __restrict__ partial, float* __restrict__ dpe, int bins,
                    int nblk) {
  const int bin = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (bin >= bins) return;
  const float* p = partial + (size_t)bin * nblk;
  float acc = 0.f;
  for (int i = lane; i < nblk; i += 32) acc += p[i];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) dpe[bin] = acc;
}

}  // namespace vmg

static bool ltam_shape_ok(int C, int heads, int H, int W) {
  return heads >= 1 && C % heads == 0 && C / heads <= vmg::kLtamMaxD && H % 2 == 0 &&
         W % 2 == 0;
}

// Wt, HB: the block's column span and heads (ltam_attention.fwd_plan):
// Wt even, HB dividing heads, 2 Wt HB lanes(d) <= 128 threads.
extern "C" int vmg_ltam_fwd(const float* q, const void* kv, const float* pe,
                            float* out, float* den, int N, int H, int W, int C,
                            int K, int heads, int Wt, int HB, int dtype, void* stream) {
  if (!ltam_shape_ok(C, heads, H, W) || N < 1 || K < 1 || Wt < 2 || Wt % 2 != 0 || HB < 1 ||
      heads % HB != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  vmg::LtamFwdArgs a = {};
  a.H = H, a.W = W, a.C = C, a.K = K, a.heads = heads, a.d = C / heads;
  a.L = vmg::ltam_lanes(a.d), a.Wt = Wt, a.HB = HB;
  a.spans = (W + Wt - 1) / Wt, a.hgroups = heads / HB;
  const int threads = 2 * Wt * HB * a.L, es = dtype == 1 ? 2 : 4, seg = HB * a.d;
  if (threads > 128) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)N * (H / 2) * a.spans * a.hgroups;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.pst = vmg::ltam_pixel_stride(2 * seg, es);
  // the widest copies the runs' lengths, offsets and the pointers allow
  auto width = [](int run_bytes, int stride_bytes, std::initializer_list<const void*> ptrs) {
    for (int v : {16, 8, 4}) {
      bool ok = run_bytes % v == 0 && stride_bytes % v == 0;
      for (const void* p : ptrs) ok = ok && (uintptr_t)p % v == 0;
      if (ok) return v;
    }
    return 2;
  };
  a.vkv = width(seg * es, C * es, {kv});
  a.vq = width(seg * 4, C * 4, {q, out});
  if (a.vq < 4 || (dtype == 0 && a.vkv < 4)) return (int)cudaErrorMisalignedAddress;
  a.bulk = a.vkv == 16 && a.vq == 16 && (a.pst * es) % 16 == 0;
  a.q_bytes = (unsigned)(((size_t)2 * Wt * seg * 4 + 15) / 16 * 16);
  a.nbuf = K < vmg::kLtamBufs ? K : vmg::kLtamBufs;
  const size_t smem = vmg::ltam_fwd_smem(Wt, HB, a.d, es, a.nbuf);
  if (smem > vmg::kMaxSmem) return (int)cudaErrorInvalidValue;
  const int vu = a.d % 4 == 0 ? 4 : a.d % 2 == 0 ? 2 : 1;
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    auto pick = [&](auto lf) {
      constexpr int LF = decltype(lf)::value;
      return vu == 4 ? vmg::ltam_fwd_kernel<T, LF, 4>
                     : vu == 2 ? vmg::ltam_fwd_kernel<T, LF, 2> : vmg::ltam_fwd_kernel<T, LF, 1>;
    };
    auto kern = a.L == 1 ? pick(std::integral_constant<int, 1>())
                         : pick(std::integral_constant<int, 0>());
    const int e = vmg::set_smem(kern, smem);
    if (e) return e;
    kern<<<(unsigned)blocks, threads, smem, st>>>(q, (const T*)kv, pe, out, den, a);
  });
  return (int)cudaGetLastError();
}

// Wt, HB, nbuf: the block's column span and heads and its kv buffers
// (ltam_attention.bwd_plan): Wt even, HB dividing heads, 2 Wt HB
// ltam_bwd_lanes(d) <= 256 threads, 1 <= nbuf <= min(K, 4).  partial:
// K*16*heads x N*(H/2)*ceil(W/Wt) floats; dkv in kv's dtype.
extern "C" int vmg_ltam_bwd(const float* q, const void* kv, const float* pe,
                            const float* den, const float* out, const float* g,
                            float* dq, void* dkv, float* dpe, float* partial, int N, int H,
                            int W, int C, int K, int heads, int Wt, int HB, int nbuf,
                            int dtype, void* stream) {
  if (!ltam_shape_ok(C, heads, H, W) || N < 1 || K < 1 || Wt < 2 || Wt % 2 != 0 || HB < 1 ||
      heads % HB != 0 || nbuf < 1 || nbuf > K || nbuf > vmg::kLtamBufs ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  vmg::LtamBwdArgs a = {};
  a.H = H, a.W = W, a.C = C, a.K = K, a.heads = heads, a.d = C / heads;
  a.L = vmg::ltam_bwd_lanes(a.d), a.Wt = Wt, a.HB = HB;
  a.spans = (W + Wt - 1) / Wt, a.hgroups = heads / HB;
  const int threads = 2 * Wt * HB * a.L, es = dtype == 1 ? 2 : 4, seg = HB * a.d;
  if (threads > vmg::kLtamBwdThreads) return (int)cudaErrorInvalidValue;
  const long long nblk = (long long)N * (H / 2) * a.spans;
  if (nblk * a.hgroups > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.nblk = (int)nblk;
  a.pst = vmg::ltam_pixel_stride(2 * seg, es);
  auto width = [](int run_bytes, int stride_bytes, std::initializer_list<const void*> ptrs) {
    for (int v : {16, 8, 4}) {
      bool ok = run_bytes % v == 0 && stride_bytes % v == 0;
      for (const void* p : ptrs) ok = ok && (uintptr_t)p % v == 0;
      if (ok) return v;
    }
    return 2;
  };
  a.vkv = width(seg * es, C * es, {kv});
  a.vq = width(seg * 4, C * 4, {q, g});
  if (a.vq < 4 || (dtype == 0 && a.vkv < 4)) return (int)cudaErrorMisalignedAddress;
  a.bulk = a.vkv == 16 && a.vq == 16 && (a.pst * es) % 16 == 0;
  a.q_bytes = (unsigned)(((size_t)2 * Wt * seg * 4 + 15) / 16 * 16);
  a.pd_bytes = (unsigned)(((size_t)2 * Wt * HB * 4 * 3 * 4 + 15) / 16 * 16);
  a.nbuf = nbuf;
  const size_t smem = vmg::ltam_bwd_smem(Wt, HB, a.d, es, nbuf);
  if (smem > vmg::kMaxSmem) return (int)cudaErrorInvalidValue;
  const int vu = a.d % 4 == 0 ? 4 : a.d % 2 == 0 ? 2 : 1;
  const int reg = vmg::ltam_bwd_reg(a.d);
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    auto pick = [&](auto rr) {
      constexpr int R = decltype(rr)::value;
      return vu == 4 ? vmg::ltam_bwd_kernel<T, 4, R>
                     : vu == 2 ? vmg::ltam_bwd_kernel<T, 2, R> : vmg::ltam_bwd_kernel<T, 1, R>;
    };
    auto kern = reg == vmg::kLtamR ? pick(std::integral_constant<int, vmg::kLtamR>())
                : reg == 12 ? pick(std::integral_constant<int, 12>())
                            : pick(std::integral_constant<int, 8>());
    const int e = vmg::set_smem(kern, smem);
    if (e) return e;
    kern<<<(unsigned)(nblk * a.hgroups), threads, smem, st>>>(q, (const T*)kv, pe, den, out, g, dq,
                                                              (T*)dkv, partial, a);
  });
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bins = K * 16 * heads;
  vmg::ltam_bwd_dpe_kernel<<<(bins + 7) / 8, 256, 0, st>>>(partial, dpe, bins, a.nblk);
  return (int)cudaGetLastError();
}
