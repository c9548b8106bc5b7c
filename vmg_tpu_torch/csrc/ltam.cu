// LTAM 2x2-window trajectory attention, forward.
//
// Replaces vmg_tpu/ops/ltam_attention.py `ltam_attention_2x2` forward
// (`_fwd_call`, `_kernel`).  Per pixel (r, c) and head e, the query
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
// channels, no lane padding; pe (K,4,4,heads) f32; out (N,H,W,C) f32.
//
// Bound on H100: device-memory traffic.  A step reads the 4 taps of
// K * 2C channels for every pixel (K = 5 at stage 0: 2.2 KB per pixel in
// bf16) and does ~4 FLOPs per element read.  Design: one thread per
// (pixel, head) holding its d = C/heads query and numerator values in
// registers; the 4 pixels of a window read the same taps, back to back
// in the same warp, so the re-reads hit L1.  The denominator, which
// only a backward pass needs, is not written.
#include "common.cuh"

namespace vmg {

constexpr int kLtamD = 32;  // largest head width held in registers

template <typename T>
__global__ void __launch_bounds__(256)
ltam_fwd_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                const float* __restrict__ pe, float* __restrict__ out,
                long long total, int H, int W, int C, int K, int heads) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int e = (int)(idx % heads);
  const long long pix = idx / heads;
  const int col = (int)(pix % W);
  const long long t = pix / W;
  const int row = (int)(t % H);
  const long long n = t / H;
  const int d = C / heads;
  const int pos = (row & 1) * 2 + (col & 1);

  float qv[kLtamD], num[kLtamD];
  const float* qp = q + pix * C + e * d;
#pragma unroll
  for (int i = 0; i < kLtamD; ++i) {
    qv[i] = i < d ? qp[i] : 0.f;
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
      for (int i = 0; i < kLtamD; ++i)
        if (i < d) logit = fmaf(qv[i], to_f<T>(key[i]), logit);
      const float ex = expf(logit) * pe[((k * 4 + tap) * 4 + pos) * heads + e];
      den += ex;
#pragma unroll
      for (int i = 0; i < kLtamD; ++i)
        if (i < d) num[i] = fmaf(ex, to_f<T>(val[i]), num[i]);
    }
  }
  const float dd = fmaxf(den, 1e-30f);
  float* op = out + pix * C + e * d;
#pragma unroll
  for (int i = 0; i < kLtamD; ++i)
    if (i < d) op[i] = num[i] / dd;
}

}  // namespace vmg

extern "C" int vmg_ltam_fwd(const float* q, const void* kv, const float* pe,
                            float* out, int N, int H, int W, int C, int K,
                            int heads, int dtype, void* stream) {
  if (heads < 1 || C % heads != 0 || C / heads > vmg::kLtamD || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * H * W * heads;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    vmg::ltam_fwd_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
        q, (const T*)kv, pe, out, total, H, W, C, K, heads);
  });
  return (int)cudaGetLastError();
}
