// Grouped-conv FFN: out = fc2(GELU(grouped_conv3x3(x) + b1)) + b2.
//
// Replaces the Pallas kernel vmg_tpu/ops/group_conv.py `_fused_group_ffn`
// (`_kernel`): C -> 6C -> C with groups = 4, the 6C hidden never written
// to device memory.
//
// Bound on H100: arithmetic.  Per pixel the FFN does 19.5 C^2 MACs against
// 4 C bytes of bf16 traffic (x in, out back), thousands of FLOPs per byte,
// far right of the ridge; the hidden (6C per pixel, 6x the input) is what
// would make it memory-bound if it went through HBM.
//
// Both versions: one block per (frame, tile of output pixels), 256
// threads.  Per group b the block walks the group's hidden features in
// chunks of 64: phase 1 computes the chunk's conv from the group's input
// taps, adds the bias, applies GELU in f32 and rounds the hidden to the
// input dtype (as the TPU kernel does before its projection), parking it
// in shared memory; phase 2 accumulates hidden_chunk @ w2[b] into the f32
// output tile.  The hidden lives only in that chunk buffer.  Ragged tile
// edges are masked at the store.
//
// * bf16 (serving): tensor cores through nvcuda::wmma 16x16x16 fragments
//   with f32 accumulation.  The block stages the group's im2col patch
//   (kTP pixels x 9 taps x cg channels, channels zero-padded to a multiple
//   of 16) in shared memory; w1/w2 fragments load from L2; the output
//   tile accumulates in shared memory.  Operands come padded: w1
//   (G, 9*cgp, fgp), b1 (G*fgp), w2 (G, fgp, C) with cgp, fgp the
//   multiples of 16 above cg, fg, zeros in the padding.
// * f32 (parity runs): scalar FMA, 16 x 16 register micro-tiles, the
//   halo'd input tile in shared memory; operands unpadded: w1
//   (G, 9*cg, fg), b1 (G*fg), w2 (G, fg, C).
// Rows of w1 are in (dy, dx, ci) order.
#include "common.cuh"

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

// ---- bf16: tensor cores (wmma) ------------------------------------------

constexpr int kTW = 8;   // tile width in pixels
constexpr int kTP = 32;  // pixels per tile, kTP / kTW rows: at C = 112
                         // 4 blocks fit an SM (64 pixels: 2, and 19% slower)

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory: patch kTP x K1 bf16 | stage kTP x kFCH f32 | hidden
// kTP x kFCH bf16 | output accumulator kTP x C f32, rows padded (common.cuh).
__host__ __device__ inline size_t wmma_smem(int C, int G) {
  const int K1 = 9 * round16(C / G);
  return (size_t)kTP * ((K1 + kPadH) * 2 + (kFCH + kPadF) * 4 +
                       (kFCH + kPadH) * 2 + (C + kPadF) * 4);
}

__global__ void __launch_bounds__(kThreads)
group_ffn_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ b2, bf16* __restrict__ out,
                      int H, int W, int C, int G, int fgp, int act,
                      int tiles_w) {
  constexpr int MT = kTP / 16;  // 16-pixel row tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int cg = C / G, cgp = round16(cg), K1 = 9 * cgp;
  // row strides (elements) of the four buffers
  const int ldp = K1 + kPadH, lda = C + kPadF;
  constexpr int lds = kFCH + kPadF, ldh = kFCH + kPadH;
  bf16* patch = reinterpret_cast<bf16*>(smem_raw);
  float* stage = reinterpret_cast<float*>(patch + (size_t)kTP * ldp);
  bf16* hid = reinterpret_cast<bf16*>(stage + kTP * lds);
  float* acc = reinterpret_cast<float*>(hid + kTP * ldh);
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_w) * (kTP / kTW), x0 = (blockIdx.x % tiles_w) * kTW;

  for (int e = threadIdx.x; e < kTP * lda; e += kThreads) acc[e] = 0.f;
  for (int b = 0; b < G; ++b) {
    __syncthreads();  // previous group's readers are done with the patch
    for (int e = threadIdx.x; e < kTP * K1; e += kThreads) {
      const int p = e / K1, k = e % K1, tap = k / cgp, ci = k % cgp;
      const int gy = y0 + p / kTW + tap / 3 - 1, gx = x0 + p % kTW + tap % 3 - 1;
      bf16 v = __float2bfloat16_rn(0.f);
      if (ci < cg && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = x[((size_t)(n * H + gy) * W + gx) * C + b * cg + ci];
      patch[p * ldp + k] = v;
    }
    __syncthreads();
    const bf16* w1b = w1 + (size_t)b * K1 * fgp;
    const bf16* w2b = w2 + (size_t)b * fgp * C;

    for (int f0 = 0; f0 < fgp; f0 += kFCH) {
      const int fc = min(kFCH, fgp - f0);  // a multiple of 16
      // phase 1: stage = patch @ w1b[:, f0:f0+fc]
      for (int t = warp; t < MT * (fc / 16); t += kWarps) {
        const int mi = t % MT, ni = t / MT;
        FragC cf;
        wm::fill_fragment(cf, 0.f);
        for (int k0 = 0; k0 < K1; k0 += 16) {
          FragA af;
          FragB bfr;
          wm::load_matrix_sync(af, patch + mi * 16 * ldp + k0, ldp);
          wm::load_matrix_sync(bfr, w1b + (size_t)k0 * fgp + f0 + ni * 16, fgp);
          wm::mma_sync(cf, af, bfr, cf);
        }
        wm::store_matrix_sync(stage + mi * 16 * lds + ni * 16, cf, lds,
                              wm::mem_row_major);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kTP * fc; e += kThreads) {
        const int p = e / fc, f = e % fc;
        const float v = stage[p * lds + f] + __bfloat162float(b1[b * fgp + f0 + f]);
        hid[p * ldh + f] = __float2bfloat16_rn(gelu(v, act));
      }
      __syncthreads();
      // phase 2: acc += hidden @ w2b[f0:f0+fc, :]
      for (int t = warp; t < MT * (C / 16); t += kWarps) {
        const int mi = t % MT, ni = t / MT;
        float* ap = acc + mi * 16 * lda + ni * 16;
        FragC cf;
        wm::load_matrix_sync(cf, ap, lda, wm::mem_row_major);
        for (int k0 = 0; k0 < fc; k0 += 16) {
          FragA af;
          FragB bfr;
          wm::load_matrix_sync(af, hid + mi * 16 * ldh + k0, ldh);
          wm::load_matrix_sync(bfr, w2b + (size_t)(f0 + k0) * C + ni * 16, C);
          wm::mma_sync(cf, af, bfr, cf);
        }
        wm::store_matrix_sync(ap, cf, lda, wm::mem_row_major);
      }
      __syncthreads();  // stage and hidden are rewritten by the next chunk
    }
  }

  for (int e = threadIdx.x; e < kTP * C; e += kThreads) {
    const int p = e / C, o = e % C;
    const int gy = y0 + p / kTW, gx = x0 + p % kTW;
    if (gy < H && gx < W)
      out[((size_t)(n * H + gy) * W + gx) * C + o] =
          __float2bfloat16_rn(acc[p * lda + o] + __bfloat162float(b2[o]));
  }
}

int launch_bf16(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                const bf16* b2, bf16* out, int N, int H, int W, int C, int G,
                int fgp, int act, cudaStream_t stream) {
  const int TH = kTP / kTW;
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + TH - 1) / TH;
  const size_t smem = wmma_smem(C, G);
  auto kern = group_ffn_bf16_kernel;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(tiles_h * tiles_w, N), kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, out, H, W, C, G, fgp, act, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace vmg

// fg: hidden features per group as packed (bf16: padded to a multiple of 16).
extern "C" int vmg_group_ffn(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int N,
                             int H, int W, int C, int G, int fg, int act,
                             int dtype, void* stream) {
  if (C % 16 != 0 || C % G != 0 || C > 448 || N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef vmg::bf16 T;
    if (fg % 16 != 0) return (int)cudaErrorInvalidValue;
    return vmg::launch_bf16((const T*)x, (const T*)w1, (const T*)b1, (const T*)w2,
                            (const T*)b2, (T*)out, N, H, W, C, G, fg, act, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x, *w1f = (const float*)w1, *b1f = (const float*)b1;
  const float *w2f = (const float*)w2, *b2f = (const float*)b2;
  float* of = (float*)out;
  const int OR = C / 16;
  if (OR <= 7) return vmg::launch_f32<4, 7>(xf, w1f, b1f, w2f, b2f, of, N, H, W, C, G, fg, act, s);
  if (OR <= 14) return vmg::launch_f32<2, 14>(xf, w1f, b1f, w2f, b2f, of, N, H, W, C, G, fg, act, s);
  return vmg::launch_f32<1, 28>(xf, w1f, b1f, w2f, b2f, of, N, H, W, C, G, fg, act, s);
}

extern "C" const char* vmg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
