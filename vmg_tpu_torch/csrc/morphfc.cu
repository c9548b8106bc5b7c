// MorphFC-decay mixer kernels: the two axis branches with the reweight
// sums, the reweight reduction, and the combine pass.
//
// vmg_morphfc_axes replaces vmg_tpu/ops/morphfc_fused.py
// `fused_morphfc_axes` in its big form (`_axes_kernel`, chunk * C <= 1024):
// both decayed axis-FC branches, relu(acc + b) / C rounded once to the input
// dtype, and the f32 per-frame sums of h + w + c from the unrounded
// branch values.  A token is channel segment q (S = C / chunk channels) of
// a chunk of `chunk` positions along the axis, its C features (p, s); each
// branch is then a (tokens x C) @ (C x C) matmul with the decayed weight
// -- the TPU kernel's block-diagonal big matrix without its zero blocks,
// which on the TPU bought a transpose-free layout.  Bound on H100: device
// memory at the stage-0 shape (x and c read, h and w written: ~4 bf16
// tensors against C MACs per element and branch on the tensor cores).
// Design: one block per (frame, chunk_h rows, WT columns) slab, WT a
// multiple of chunk_w so the W chunks lie inside it, >= 64 tokens.  The
// block stages the branch's C x C weight in shared memory, gathers the
// slab's H tokens there too (rows past H read as zeros), projects them
// (bf16: wmma with f32 accumulation; f32: scalar FMAs), adds bias, relu and
// 1/C in the epilogue, writes h and sums it; then the same for the W tokens
// of the same slab (x again, from L2), adding the slab's c to the sums.
// Global loads and stores move 16 bytes (one position's channel vector).
// Each block writes one f32 partial per channel, summed in a fixed order
// over its positions; the reduce's second pass adds the partials in a
// fixed order -- deterministic, no float atomics.
//
// vmg_morphfc_axes_token replaces the token form of the same call
// (`_axes_kernel_token`, chosen where chunk * C > 1024: stages 1/5 at C =
// 224, chunk 16, and stage 3 at C = 448, chunk 8): the same function, the
// same slab grid and token maps.  What bounds it: shared memory first --
// the whole C x C weight, the M x C tokens and their M x C f32 projection
// (100 + 115 + 229 KB at stage 1, M = 256) do not fit in a block's 227 KB,
// so the kernel above cannot launch there; then device memory, as above
// (at stage 1 x and c in, h and w out: 422 MB against 47 GFLOP).  Design:
// the slab's tokens pass through shared memory in M-tiles of whole token
// groups (at most 64 rows in bf16, 32 in f32), and the weight in C x nt
// column tiles (nt = 64 bf16, 32 f32), staged with cp.async and
// double-buffered (tile j + 1 copies while tile j multiplies); each
// (M-tile, column tile) product goes to an f32 tile whose epilogue (bias,
// relu, 1/C, one rounding, the store) runs before the next tile.  Stage 1
// bf16 takes 111 KB (two blocks per SM), stage 3 200 KB.  Sums: thread i
// owns channels i and i + 256 and adds their values in a fixed order
// (tiles, token groups, positions), then the slab's c, summed by position
// lanes with 16-byte loads and added lane by lane; one f32 partial per
// block and channel, added in a fixed order by the second pass --
// deterministic, no atomics.
//
// vmg_morphfc_reduce replaces `fused_morphfc_reduce` (`_reduce_kernel`):
// psum[n, c] = sum over the frame's pixels of (h + w + c) in f32.  Bound on
// H100: device-memory bandwidth (3 reads, no compute).  The TPU kernel
// carried the sum across its sequential grid; here blocks run in parallel,
// so pass 1 writes one f32 partial per (frame, pixel slice) and pass 2 adds
// the slices in a fixed order.  Neighbouring threads read neighbouring
// channels of a pixel, so loads coalesce.
//
// vmg_morphfc_combine replaces `fused_morphfc_combine` (`_combine_body`,
// `_combine_kernel`, `_combine_res_kernel`): y = a0*h + a1*w + a2*c in the
// input dtype, p = round(y @ Pk + pb) to the input dtype, out = (x + p) *
// tanh(p), optionally res + s * out.  Bound on H100: the C x C projection
// is C MACs per element (112..448) against ~12 bytes of bf16 traffic per
// element, compute-bound as scalar FMAs, memory-bound on the tensor
// cores.  Design: one block per (frame, pixel tile); the weighted sum is
// formed once per element into shared memory and projected from there
// (Pk read from L1/L2, it is at most 400 KB); the gate and residual are
// applied in the epilogue, so x, h, w, c, res are each read once and out
// written once.  bf16 (serving) projects on the tensor cores (wmma, f32
// accumulation); f32 (parity runs) with scalar FMAs in the FFN kernel's
// 16 x 16 register micro-tiles.  A nullable residual pointer covers both
// TPU variants.  The gate, act: 0 tanh(p), 1 sigmoid(p) - 0.5, 2 relu(p);
// in bf16 it rounds where the TPU kernel's gate in the output dtype does
// (the sigmoid, then the subtraction).
#include "common.cuh"

#include <algorithm>

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

constexpr int kRedX = 64;  // channel lanes of the reduce block
constexpr int kRedY = 4;   // pixel lanes of the reduce block
constexpr int kRedC = 8;   // channels per thread: C <= kRedX * kRedC

template <typename T>
__global__ void __launch_bounds__(kRedX * kRedY)
morphfc_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                       const T* __restrict__ c, float* __restrict__ partial,
                       int P, int C, int S) {
  __shared__ float red[kRedY][kRedX * kRedC];
  const int n = blockIdx.y, s = blockIdx.x;
  const int cx = threadIdx.x, pyl = threadIdx.y;
  const int per = (P + S - 1) / S;
  const int p0 = s * per, p1 = min(P, p0 + per);
  float acc[kRedC];
#pragma unroll
  for (int k = 0; k < kRedC; ++k) acc[k] = 0.f;
  for (int p = p0 + pyl; p < p1; p += kRedY) {
    const size_t base = ((size_t)n * P + p) * C;
#pragma unroll
    for (int k = 0; k < kRedC; ++k) {
      const int ch = cx + kRedX * k;
      if (ch < C)
        acc[k] += to_f<T>(h[base + ch]) + to_f<T>(w[base + ch]) + to_f<T>(c[base + ch]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRedC; ++k) red[pyl][cx + kRedX * k] = acc[k];
  __syncthreads();
  const int tid = pyl * kRedX + cx;
  for (int ch = tid; ch < C; ch += kRedX * kRedY) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kRedY; ++r) v += red[r][ch];
    partial[((size_t)n * S + s) * C + ch] = v;
  }
}

__global__ void morphfc_final_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int N, int C,
                                     int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * C) return;
  const int n = i / C, ch = i % C;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += partial[((size_t)n * S + s) * C + ch];
  out[i] = v;
}

// f32 (parity runs): the projection as scalar FMAs in 16 x 16 register
// micro-tiles, the weighted sums staged in shared memory.
template <int PR, int ORMAX, int ACT>
__global__ void __launch_bounds__(kThreads)
morphfc_combine_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                           const float* __restrict__ w, const float* __restrict__ c,
                           const float* __restrict__ a, const float* __restrict__ pk,
                           const float* __restrict__ pb, const float* __restrict__ res,
                           float* __restrict__ out, int P, int C, float res_scale) {
  extern __shared__ float ys[];  // (16 * PR) x C weighted branch sums
  const int TP = 16 * PR;
  const int OR = C / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n = blockIdx.y, p0 = blockIdx.x * TP;
  const float* an = a + (size_t)n * 3 * C;

  for (int e = threadIdx.x; e < TP * C; e += kThreads) {
    const int p = e / C, ch = e % C;
    float v = 0.f;
    if (p0 + p < P) {
      const size_t idx = ((size_t)n * P + p0 + p) * C + ch;
      v = h[idx] * an[ch] + w[idx] * an[C + ch] + c[idx] * an[2 * C + ch];
    }
    ys[e] = v;
  }
  __syncthreads();

  float acc[PR][ORMAX];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < ORMAX; ++j) acc[i][j] = 0.f;
  for (int ci = 0; ci < C; ++ci) {
    const float* pr = pk + (size_t)ci * C + tx;
    float yv[PR];
#pragma unroll
    for (int i = 0; i < PR; ++i) yv[i] = ys[(ty + 16 * i) * C + ci];
#pragma unroll
    for (int j = 0; j < ORMAX; ++j) {
      if (j < OR) {
        const float wv = pr[16 * j];
#pragma unroll
        for (int i = 0; i < PR; ++i) acc[i][j] = fmaf(yv[i], wv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= P) continue;
    const size_t base = ((size_t)n * P + p) * C + tx;
#pragma unroll
    for (int j = 0; j < ORMAX; ++j) {
      if (j >= OR) continue;
      const float pv = acc[i][j] + pb[tx + 16 * j];
      float o = (x[base + 16 * j] + pv) * symm_gate<float, ACT>(pv);
      if (res != nullptr) o = res[base + 16 * j] + res_scale * o;
      out[base + 16 * j] = o;
    }
  }
}

template <int PR, int ORMAX, int ACT>
int launch_combine_f32(const float* x, const float* h, const float* w,
                       const float* c, const float* a, const float* pk,
                       const float* pb, const float* res, float* out, int N,
                       int P, int C, float res_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 16 * PR * C;
  auto kern = morphfc_combine_f32_kernel<PR, ORMAX, ACT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((P + 16 * PR - 1) / (16 * PR), N);
  kern<<<grid, kThreads, smem, stream>>>(x, h, w, c, a, pk, pb, res, out, P, C,
                                         res_scale);
  return (int)cudaGetLastError();
}

// bf16 (serving): the weighted sums go to shared memory as bf16 (rounded
// where the plain version rounds), the projection runs on the tensor cores
// into an f32 tile, and the epilogue rounds p, gates and adds the residual.
constexpr int kCP = 32;  // pixels per block

__host__ __device__ inline size_t combine_bf16_smem(int C) {
  return (size_t)kCP * ((C + kPadH) * 2 + (C + kPadF) * 4);
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
morphfc_combine_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                            const bf16* __restrict__ w, const bf16* __restrict__ c,
                            const bf16* __restrict__ a, const bf16* __restrict__ pk,
                            const float* __restrict__ pb, const bf16* __restrict__ res,
                            bf16* __restrict__ out, int P, int C, float res_scale) {
  constexpr int MT = kCP / 16;  // 16-pixel row tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldy = C + kPadH, lda = C + kPadF;
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);           // kCP x ldy
  float* acc = reinterpret_cast<float*>(ys + kCP * ldy);  // kCP x lda
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y, p0 = blockIdx.x * kCP;
  const bf16* an = a + (size_t)n * 3 * C;

  for (int e = threadIdx.x; e < kCP * C; e += kThreads) {
    const int p = e / C, ch = e % C;
    float v = 0.f;
    if (p0 + p < P) {
      const size_t idx = ((size_t)n * P + p0 + p) * C + ch;
      const float th = rnd<bf16>(to_f<bf16>(h[idx]) * to_f<bf16>(an[ch]));
      const float tw = rnd<bf16>(to_f<bf16>(w[idx]) * to_f<bf16>(an[C + ch]));
      const float tc = rnd<bf16>(to_f<bf16>(c[idx]) * to_f<bf16>(an[2 * C + ch]));
      v = rnd<bf16>(th + tw) + tc;
    }
    ys[p * ldy + ch] = from_f<bf16>(v);
  }
  __syncthreads();

  for (int t = warp; t < MT * (C / 16); t += kWarps) {
    const int mi = t % MT, ni = t / MT;
    FragC cf;
    wm::fill_fragment(cf, 0.f);
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragA af;
      FragB bfr;
      wm::load_matrix_sync(af, ys + mi * 16 * ldy + k0, ldy);
      wm::load_matrix_sync(bfr, pk + (size_t)k0 * C + ni * 16, C);
      wm::mma_sync(cf, af, bfr, cf);
    }
    wm::store_matrix_sync(acc + mi * 16 * lda + ni * 16, cf, lda, wm::mem_row_major);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kCP * C; e += kThreads) {
    const int p = e / C, o = e % C;
    if (p0 + p >= P) continue;
    const size_t idx = ((size_t)n * P + p0 + p) * C + o;
    const float pv = rnd<bf16>(acc[p * lda + o] + pb[o]);
    float r = rnd<bf16>(rnd<bf16>(to_f<bf16>(x[idx]) + pv) * symm_gate<bf16, ACT>(pv));
    if (res != nullptr)
      r = rnd<bf16>(to_f<bf16>(res[idx]) + rnd<bf16>(res_scale * r));
    out[idx] = from_f<bf16>(r);
  }
}

template <int ACT>
int launch_combine_bf16(const bf16* x, const bf16* h, const bf16* w,
                        const bf16* c, const bf16* a, const bf16* pk,
                        const float* pb, const bf16* res, bf16* out, int N,
                        int P, int C, float res_scale, cudaStream_t stream) {
  const size_t smem = combine_bf16_smem(C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(morphfc_combine_bf16_kernel<ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((P + kCP - 1) / kCP, N);
  morphfc_combine_bf16_kernel<ACT><<<grid, kThreads, smem, stream>>>(
      x, h, w, c, a, pk, pb, res, out, P, C, res_scale);
  return (int)cudaGetLastError();
}

// the f32 kernel for C's register micro-tile
template <int ACT>
int launch_combine_f32_any(const float* x, const float* h, const float* w, const float* c,
                           const float* a, const float* pk, const float* pb, const float* res,
                           float* out, int N, int P, int C, float res_scale, cudaStream_t st) {
  const int OR = C / 16;
  if (OR <= 7)
    return launch_combine_f32<4, 7, ACT>(x, h, w, c, a, pk, pb, res, out, N, P, C, res_scale, st);
  if (OR <= 14)
    return launch_combine_f32<2, 14, ACT>(x, h, w, c, a, pk, pb, res, out, N, P, C, res_scale, st);
  return launch_combine_f32<1, 28, ACT>(x, h, w, c, a, pk, pb, res, out, N, P, C, res_scale, st);
}

// ---- axes: both decayed axis branches + reweight partial sums --------------

constexpr int kVecBytes = 16;  // global loads and stores move 16 bytes

// Shared memory of the axes kernel: the C x C weight of the branch being
// projected, the M x C token matrix in T (bf16 rows padded for the fragment
// loads; at the end it holds the R x C f32 partial sums), and the M x C f32
// projection.  R = kThreads / (C / VEC) position lanes per channel vector.
template <typename T>
struct AxesSmem {
  static constexpr bool kTC = std::is_same<T, bf16>::value;
  static constexpr int VEC = kVecBytes / sizeof(T);
  int ld, ldo, R;
  size_t k_bytes, a_bytes, total;
  __host__ __device__ AxesSmem(int M, int C) {
    ld = kTC ? C + kPadH : C;  // rows of the weight and of the tokens
    ldo = kTC ? C + kPadF : C;
    R = kThreads / (C / VEC);
    k_bytes = ((size_t)C * ld * sizeof(T) + 127) / 128 * 128;
    const size_t tok = (size_t)M * ld * sizeof(T), red = (size_t)R * C * sizeof(float);
    a_bytes = ((tok > red ? tok : red) + 127) / 128 * 128;
    total = k_bytes + a_bytes + (size_t)M * ldo * sizeof(float);
  }
};

// Ks (C x C, row stride ld) <- K (C x C, global), 16 bytes per load.
template <typename T>
__device__ __forceinline__ void axes_stage_weight(T* Ks, int ld, const T* __restrict__ K,
                                                  int C) {
  constexpr int VEC = AxesSmem<T>::VEC;
  const int nv = C / VEC;
#pragma unroll 4
  for (int e = threadIdx.x; e < C * nv; e += kThreads) {
    const int row = e / nv, v = e % nv;
    *reinterpret_cast<uint4*>(Ks + row * ld + v * VEC) =
        *reinterpret_cast<const uint4*>(K + (size_t)row * C + v * VEC);
  }
}

// O (M x C, f32) = A (M x C) @ Ks (C x C), both in shared memory.
template <typename T>
__device__ __forceinline__ void axes_project(const T* A, const T* Ks, int ld, float* O,
                                             int ldo, int M, int C) {
  if constexpr (AxesSmem<T>::kTC) {
    const int MT = M / 16;
    for (int t = threadIdx.x >> 5; t < MT * (C / 16); t += kWarps) {
      const int mi = t % MT, ni = t / MT;
      FragC cf;
      wm::fill_fragment(cf, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA af;
        FragB bfr;
        wm::load_matrix_sync(af, A + mi * 16 * ld + k0, ld);
        wm::load_matrix_sync(bfr, Ks + k0 * ld + ni * 16, ld);
        wm::mma_sync(cf, af, bfr, cf);
      }
      wm::store_matrix_sync(O + mi * 16 * ldo + ni * 16, cf, ldo, wm::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < M * C; e += kThreads) {
      const int t = e / C, f = e % C;
      const T* a = A + t * ld;
      float acc = 0.f;
      for (int k = 0; k < C; ++k) acc = fmaf(to_f<T>(a[k]), to_f<T>(Ks[k * ld + f]), acc);
      O[t * ldo + f] = acc;
    }
  }
}

// Grid (ceil(W / WT), ceil(H / ch), N).  Branch H: token (w, q) is row
// w * ch + q, feature (p, s) column p * Sh + s, p the slab row.  Branch W:
// token (r, G, q) is row (r * kg + G) * cw + q, feature (p, s) column
// p * Sw + s, p the column inside W chunk G.  The output feature (P, Z) of
// a token lands at position P of its chunk, channel q * S + Z.  Slab
// positions are (r, w), r < ch, w < WT; global traffic moves VEC channels
// of one position per 16-byte access.  In the epilogues thread (j, v) owns
// channel vector v at positions j, j + R, ... and keeps its f32 sums of
// h + w + c in registers to the end, so every sum has one fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
morphfc_axes_kernel(const T* __restrict__ x, const T* __restrict__ c,
                    const T* __restrict__ kh, const float* __restrict__ bh,
                    const T* __restrict__ kw, const float* __restrict__ bw,
                    T* __restrict__ h_out, T* __restrict__ w_out,
                    float* __restrict__ partial, int H, int W, int C, int ch,
                    int cw, int WT) {
  constexpr int VEC = AxesSmem<T>::VEC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int M = ch * WT, nv = C / VEC;
  const AxesSmem<T> sm(M, C);
  const int ld = sm.ld, ldo = sm.ldo, R = sm.R;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* A = reinterpret_cast<T*>(smem_raw + sm.k_bytes);
  float* red = reinterpret_cast<float*>(A);  // after the last projection
  float* O = reinterpret_cast<float*>(smem_raw + sm.k_bytes + sm.a_bytes);
  const int n = blockIdx.z, r0 = blockIdx.y * ch, w0 = blockIdx.x * WT;
  const int Sh = C / ch, Sw = C / cw, kg = WT / cw;
  const float inv_c = 1.f / C;
  const size_t frame = (size_t)n * H * W * C;
  auto at = [&](int r, int w) { return frame + ((size_t)(r0 + r) * W + w0 + w) * C; };
  auto valid = [&](int r, int w) { return r0 + r < H && w0 + w < W; };
  auto load = [&](const T* src, int r, int w, int v, T* dst) {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (valid(r, w)) u = *reinterpret_cast<const uint4*>(src + at(r, w) + v * VEC);
    *reinterpret_cast<uint4*>(dst) = u;
  };
  // slab (r, w, channel vector v) -> token matrix; row(r, w, q), col(r, w, s)
  auto fill = [&](auto row, auto col, int S) {
#pragma unroll 2
    for (int e = threadIdx.x; e < M * nv; e += kThreads) {
      const int v = e % nv, rw = e / nv, r = rw / WT, w = rw % WT;
      alignas(16) T vals[VEC];
      load(x, r, w, v, vals);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int cc = v * VEC + k;
        A[row(r, w, cc / S) * ld + col(r, w, cc % S)] = vals[k];
      }
    }
  };
  const int j = threadIdx.x / nv, v = threadIdx.x % nv;  // epilogue lanes
  float sums[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sums[k] = 0.f;
  // token matrix outputs -> relu(o + b) / C -> out, summed; trow(r, w, q),
  // feature f(r, w, Z) = P * S + Z
  auto epilogue = [&](T* out, const float* bias, auto trow, auto feat, int S, bool add_c) {
    if (j >= R) return;
    for (int pos = j; pos < M; pos += R) {
      const int r = pos / WT, w = pos % WT;
      if (!valid(r, w)) continue;
      alignas(16) T vals[VEC];
      alignas(16) T cv[VEC];
      if (add_c) load(c, r, w, v, cv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int cc = v * VEC + k, f = feat(r, w, cc % S);
        const float y = fmaxf(O[trow(r, w, cc / S) * ldo + f] + bias[f], 0.f) * inv_c;
        vals[k] = from_f<T>(y);
        sums[k] += add_c ? y + to_f<T>(cv[k]) : y;
      }
      *reinterpret_cast<uint4*>(out + at(r, w) + v * VEC) = *reinterpret_cast<uint4*>(vals);
    }
  };
  auto h_row = [&](int, int w, int q) { return w * ch + q; };
  auto h_col = [&](int r, int, int s) { return r * Sh + s; };
  auto w_row = [&](int r, int w, int q) { return (r * kg + w / cw) * cw + q; };
  auto w_col = [&](int, int w, int s) { return (w % cw) * Sw + s; };

  axes_stage_weight<T>(Ks, ld, kh, C);
  fill(h_row, h_col, Sh);
  __syncthreads();
  axes_project<T>(A, Ks, ld, O, ldo, M, C);
  __syncthreads();
  epilogue(h_out, bh, h_row, h_col, Sh, false);  // h(r, w): feature P = r
  axes_stage_weight<T>(Ks, ld, kw, C);
  fill(w_row, w_col, Sw);
  __syncthreads();
  axes_project<T>(A, Ks, ld, O, ldo, M, C);
  __syncthreads();
  epilogue(w_out, bw, w_row, w_col, Sw, true);
  if (j < R) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[j * C + v * VEC + k] = sums[k];
  }
  __syncthreads();
  const size_t blk = (size_t)n * gridDim.y * gridDim.x + blockIdx.y * gridDim.x + blockIdx.x;
  for (int cc = threadIdx.x; cc < C; cc += kThreads) {
    float s = 0.f;
    for (int jj = 0; jj < R; ++jj) s += red[jj * C + cc];
    partial[blk * C + cc] = s;
  }
}

template <typename T>
int launch_axes(const T* x, const T* c, const T* kh, const float* bh,
                const T* kw, const float* bw, T* h, T* w, float* partial,
                float* psum, int N, int H, int W, int C, int ch, int cw, int WT,
                cudaStream_t stream) {
  const int M = ch * WT;
  if (C % 16 != 0 || C / AxesSmem<T>::VEC > kThreads || (AxesSmem<T>::kTC && M % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = AxesSmem<T>(M, C).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;  // the token form's domain
  auto kern = morphfc_axes_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + WT - 1) / WT, (H + ch - 1) / ch, N);
  kern<<<grid, kThreads, smem, stream>>>(x, c, kh, bh, kw, bw, h, w, partial, H, W, C,
                                         ch, cw, WT);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int S = grid.x * grid.y;
  morphfc_final_kernel<<<(N * C + 255) / 256, 256, 0, stream>>>(partial, psum, N, C, S);
  return (int)cudaGetLastError();
}

// ---- axes, token form: the same function where the weight does not fit ----

// Rows of one M-tile: kTokMT<T> token rows at most (bf16 rows pad to 16 for
// the fragments), whole groups of L tokens, at least one group.  64 bf16
// rows keep stage 1 at 111 KB, two blocks per SM.
template <typename T>
constexpr int kTokMT = std::is_same<T, bf16>::value ? 64 : 32;

template <typename T>
__host__ __device__ inline int tok_groups(int L, int G) {
  const int g = kTokMT<T> / L > 1 ? kTokMT<T> / L : 1;
  return g < G ? g : G;
}

template <typename T>
__host__ __device__ inline int tok_rows(int L, int G) {
  const int r = tok_groups<T>(L, G) * L;
  return std::is_same<T, bf16>::value ? (r + 15) / 16 * 16 : r;
}

// Shared memory: the M-tile of tokens (mt x C), two C x nt weight tiles,
// the mt x nt f32 product.
template <typename T>
struct TokSmem {
  static constexpr bool kTC = std::is_same<T, bf16>::value;
  int lda, ldw, ldo;
  size_t a_bytes, w_bytes, total;
  __host__ __device__ TokSmem(int mt, int C, int nt) {
    lda = kTC ? C + kPadH : C;
    ldw = kTC ? nt + kPadH : nt;
    ldo = kTC ? nt + kPadF : nt;
    a_bytes = ((size_t)mt * lda * sizeof(T) + 127) / 128 * 128;
    w_bytes = ((size_t)C * ldw * sizeof(T) + 127) / 128 * 128;
    total = a_bytes + 2 * w_bytes + (size_t)mt * ldo * sizeof(float);
  }
};

// Start copying columns f0 .. f0 + nw of K (C x C) into Ws (rows ldw apart).
template <typename T>
__device__ __forceinline__ void tok_stage_weight(T* Ws, int ldw, const T* __restrict__ K,
                                                 int C, int f0, int nw) {
  constexpr int VEC = kVecBytes / sizeof(T);
  const int cv = nw / VEC;
  for (int e = threadIdx.x; e < C * cv; e += kThreads) {
    const int k = e / cv, q = e % cv;
    cp_async16(Ws + k * ldw + q * VEC, K + (size_t)k * C + f0 + q * VEC);
  }
  cp_async_commit();
}

// Grid (ceil(W / WT), ceil(H / ch), N), the big form's slabs.  A branch's
// tokens come in groups of L (= its chunk): group t holds tokens t * L + q,
// q < L, whose feature (P, Z) (column P * S + Z, S = C / L) is channel
// q * S + Z of position pos(t, P).  Branch H: L = ch, groups t < WT,
// pos = (P, t).  Branch W: L = cw, groups t < ch * kg, pos = (t / kg,
// (t % kg) * cw + P).
template <typename T>
__global__ void __launch_bounds__(kThreads)
morphfc_axes_token_kernel(const T* __restrict__ x, const T* __restrict__ c,
                          const T* __restrict__ kh, const float* __restrict__ bh,
                          const T* __restrict__ kw, const float* __restrict__ bw,
                          T* __restrict__ h_out, T* __restrict__ w_out,
                          float* __restrict__ partial, int H, int W, int C, int ch,
                          int cw, int WT, int mt, int nt) {
  constexpr bool kTC = TokSmem<T>::kTC;
  constexpr int VEC = kVecBytes / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TokSmem<T> sm(mt, C, nt);
  const int lda = sm.lda, ldw = sm.ldw, ldo = sm.ldo, nv = C / VEC;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* Wbuf[2] = {reinterpret_cast<T*>(smem_raw + sm.a_bytes),
                reinterpret_cast<T*>(smem_raw + sm.a_bytes + sm.w_bytes)};
  float* O = reinterpret_cast<float*>(smem_raw + sm.a_bytes + 2 * sm.w_bytes);
  const int n = blockIdx.z, r0 = blockIdx.y * ch, w0 = blockIdx.x * WT, kg = WT / cw;
  const float inv_c = 1.f / C;
  const size_t frame = (size_t)n * H * W * C;
  auto at = [&](int r, int w) { return frame + ((size_t)(r0 + r) * W + w0 + w) * C; };
  auto valid = [&](int r, int w) { return r0 + r < H && w0 + w < W; };
  float sums[2] = {0.f, 0.f};  // channels threadIdx.x and threadIdx.x + kThreads

  auto branch = [&](const T* __restrict__ K, const float* __restrict__ bias,
                    T* __restrict__ out, int L, int G, auto pos) {
    const int S = C / L, GT = tok_groups<T>(L, G);
    for (int g0 = 0; g0 < G; g0 += GT) {
      const int ng = min(GT, G - g0), rows = ng * L;
      const int rows_c = kTC ? (rows + 15) / 16 * 16 : rows;
      // gather the tile: position (t, P), channel vector v -> token rows
      for (int e = threadIdx.x; e < rows * nv; e += kThreads) {
        const int v = e % nv, tp = e / nv, t = g0 + tp / L, P = tp % L;
        int r, w;
        pos(t, P, r, w);
        alignas(16) T vals[VEC];
        uint4 u = make_uint4(0, 0, 0, 0);
        if (valid(r, w)) u = *reinterpret_cast<const uint4*>(x + at(r, w) + v * VEC);
        *reinterpret_cast<uint4*>(vals) = u;
        int q = v * VEC / S, z = v * VEC % S;  // channel v * VEC + k = (q, z)
        T* row = A + ((t - g0) * L) * lda + P * S;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          row[q * lda + z] = vals[k];
          if (++z == S) z = 0, ++q;
        }
      }
      for (int e = rows * C + threadIdx.x; e < rows_c * C; e += kThreads)
        A[(e / C) * lda + e % C] = from_f<T>(0.f);  // fragment padding rows
      tok_stage_weight<T>(Wbuf[0], ldw, K, C, 0, min(nt, C));
      for (int f0 = 0, it = 0; f0 < C; f0 += nt, ++it) {
        const int nw = min(nt, C - f0);
        if (f0 + nt < C) {
          tok_stage_weight<T>(Wbuf[(it + 1) & 1], ldw, K, C, f0 + nt, min(nt, C - f0 - nt));
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // tokens and weight tile in; the last epilogue is done with O
        const T* Ws = Wbuf[it & 1];
        if constexpr (kTC) {
          const int MT = rows_c / 16, NT = nw / 16;
          for (int tt = threadIdx.x >> 5; tt < MT * NT; tt += kWarps) {
            const int mi = tt % MT, ni = tt / MT;
            FragC cf;
            wm::fill_fragment(cf, 0.f);
            for (int k0 = 0; k0 < C; k0 += 16) {
              FragA af;
              FragB bfr;
              wm::load_matrix_sync(af, A + mi * 16 * lda + k0, lda);
              wm::load_matrix_sync(bfr, Ws + k0 * ldw + ni * 16, ldw);
              wm::mma_sync(cf, af, bfr, cf);
            }
            wm::store_matrix_sync(O + mi * 16 * ldo + ni * 16, cf, ldo, wm::mem_row_major);
          }
        } else {
          for (int e = threadIdx.x; e < rows * nw; e += kThreads) {
            const int row = e / nw, col = e % nw;
            const T* a = A + row * lda;
            float acc = 0.f;
            for (int k = 0; k < C; ++k) acc = fmaf(to_f<T>(a[k]), to_f<T>(Ws[k * ldw + col]), acc);
            O[row * ldo + col] = acc;
          }
        }
        __syncthreads();  // the product tile is in O; the weight buffer is free
        // epilogue: channel cc = (q, Z) takes features P * S + Z of this tile
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int cc = threadIdx.x + k * kThreads;
          if (cc >= C) continue;
          const int q = cc / S, Z = cc % S;
          if (Z > f0 + nw - 1) continue;  // no feature of this channel in the tile
          const int p_lo = f0 > Z ? (f0 - Z + S - 1) / S : 0;
          const int p_hi = min(L - 1, (f0 + nw - 1 - Z) / S);
          for (int t = g0; t < g0 + ng; ++t) {
            const int orow = ((t - g0) * L + q) * ldo + Z - f0;  // + P * S >= 0
            for (int P = p_lo; P <= p_hi; ++P) {
              int r, w;
              pos(t, P, r, w);
              if (!valid(r, w)) continue;
              const float y = fmaxf(O[orow + P * S] + bias[P * S + Z], 0.f) * inv_c;
              out[at(r, w) + cc] = from_f<T>(y);
              sums[k] += y;
            }
          }
        }
      }
    }
  };

  branch(kh, bh, h_out, ch, WT, [&](int t, int P, int& r, int& w) { r = P; w = t; });
  branch(kw, bw, w_out, cw, ch * kg,
         [&](int t, int P, int& r, int& w) { r = t / kg; w = (t % kg) * cw + P; });
  // c over the slab: thread (j, v) adds channel vector v at positions j,
  // j + R, ... (16-byte loads); then each channel's owner adds the R lane
  // sums in order.  The tokens' space is free after the last product.
  const int R = kThreads / nv, j = threadIdx.x / nv, v = threadIdx.x % nv;
  float* red = reinterpret_cast<float*>(smem_raw);  // R x C
  if (j < R) {
    float cs[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) cs[k] = 0.f;
#pragma unroll 4
    for (int pos = j; pos < ch * WT; pos += R) {
      const int r = pos / WT, w = pos % WT;
      if (!valid(r, w)) continue;
      alignas(16) T cv[VEC];
      *reinterpret_cast<uint4*>(cv) = *reinterpret_cast<const uint4*>(c + at(r, w) + v * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) cs[k] += to_f<T>(cv[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[j * C + v * VEC + k] = cs[k];
  }
  __syncthreads();
  const size_t blk = (size_t)n * gridDim.y * gridDim.x + blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int cc = threadIdx.x + k * kThreads;
    if (cc >= C) continue;
    for (int jj = 0; jj < R; ++jj) sums[k] += red[jj * C + cc];
    partial[blk * C + cc] = sums[k];
  }
}

template <typename T>
int launch_axes_token(const T* x, const T* c, const T* kh, const float* bh,
                      const T* kw, const float* bw, T* h, T* w, float* partial,
                      float* psum, int N, int H, int W, int C, int ch, int cw, int WT,
                      cudaStream_t stream) {
  if (C % 16 != 0 || C > 2 * kThreads || C / (kVecBytes / (int)sizeof(T)) > kThreads)
    return (int)cudaErrorInvalidValue;
  const int kg = WT / cw;
  const int mh = tok_rows<T>(ch, WT), mw = tok_rows<T>(cw, ch * kg);
  const int mt = mh > mw ? mh : mw;
  int nt = TokSmem<T>::kTC ? 64 : 32;
  while (nt > 16 && TokSmem<T>(mt, C, nt).total > kMaxSmem) nt /= 2;
  const int nv = C / (kVecBytes / (int)sizeof(T));
  const size_t red = (size_t)(kThreads / nv) * C * sizeof(float);  // the c sums' lanes
  const size_t smem = std::max(TokSmem<T>(mt, C, nt).total, red);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = morphfc_axes_token_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + WT - 1) / WT, (H + ch - 1) / ch, N);
  kern<<<grid, kThreads, smem, stream>>>(x, c, kh, bh, kw, bw, h, w, partial, H, W, C,
                                         ch, cw, WT, mt, nt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int S = grid.x * grid.y;
  morphfc_final_kernel<<<(N * C + 255) / 256, 256, 0, stream>>>(partial, psum, N, C, S);
  return (int)cudaGetLastError();
}

}  // namespace vmg

// x, c, h, w: (N, H, W, C); kh, kw: (C_in, C_out) decayed axis weights;
// bh, bw: (C,) f32; partial: (N, ceil(H/ch) * ceil(W/WT), C) f32 scratch;
// psum: (N, C) f32.  C % 16 == C % ch == C % cw == W % cw == 0, WT % cw
// == 0; bf16: ch * WT % 16 == 0.
extern "C" int vmg_morphfc_axes(const void* x, const void* c, const void* kh,
                                const float* bh, const void* kw, const float* bw,
                                void* h, void* w, float* partial, float* psum,
                                int N, int H, int W, int C, int ch, int cw,
                                int WT, int dtype, void* stream) {
  if (ch < 1 || cw < 1 || C % ch != 0 || C % cw != 0 || W % cw != 0 || WT % cw != 0 ||
      N > 65535 || (H + ch - 1) / ch > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, c, kh, kw, (const void*)h, (const void*)w})
    if ((uintptr_t)p % vmg::kVecBytes != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    return vmg::launch_axes<T>((const T*)x, (const T*)c, (const T*)kh, bh,
                               (const T*)kw, bw, (T*)h, (T*)w, partial, psum, N, H,
                               W, C, ch, cw, WT, st);
  });
  return (int)cudaErrorInvalidValue;  // not reached: the dispatch returns
}

// The token form: arguments as vmg_morphfc_axes; C % 16 == 0, C <= 512.
extern "C" int vmg_morphfc_axes_token(const void* x, const void* c, const void* kh,
                                      const float* bh, const void* kw, const float* bw,
                                      void* h, void* w, float* partial, float* psum,
                                      int N, int H, int W, int C, int ch, int cw,
                                      int WT, int dtype, void* stream) {
  if (ch < 1 || cw < 1 || C % ch != 0 || C % cw != 0 || W % cw != 0 || WT % cw != 0 ||
      N > 65535 || (H + ch - 1) / ch > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, c, kh, kw, (const void*)h, (const void*)w})
    if ((uintptr_t)p % vmg::kVecBytes != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    return vmg::launch_axes_token<T>((const T*)x, (const T*)c, (const T*)kh, bh,
                                     (const T*)kw, bw, (T*)h, (T*)w, partial, psum, N, H,
                                     W, C, ch, cw, WT, st);
  });
  return (int)cudaErrorInvalidValue;  // not reached: the dispatch returns
}

// h, w, c: (N, P, C) with P = H*W pixels per frame; partial: (N, S, C) f32
// scratch; out: (N, C) f32.
extern "C" int vmg_morphfc_reduce(const void* h, const void* w, const void* c,
                                  float* partial, float* out, int N, int P,
                                  int C, int S, int dtype, void* stream) {
  if (C > vmg::kRedX * vmg::kRedC || N > 65535 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  VMG_DISPATCH_DTYPE(dtype, T, {
    vmg::morphfc_partial_kernel<T><<<dim3(S, N), dim3(vmg::kRedX, vmg::kRedY), 0, st>>>(
        (const T*)h, (const T*)w, (const T*)c, partial, P, C, S);
  });
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  vmg::morphfc_final_kernel<<<(N * C + 255) / 256, 256, 0, st>>>(partial, out, N, C, S);
  return (int)cudaGetLastError();
}

// x, h, w, c, res, out: (N, P, C); a: (N, 3, C); pk: (C_in, C_out); pb: (C,)
// f32; res may be null; act: the gate (0 tanh, 1 sigmoid - 0.5, 2 relu).
extern "C" int vmg_morphfc_combine(const void* x, const void* h, const void* w,
                                   const void* c, const void* a, const void* pk,
                                   const float* pb, const void* res, void* out,
                                   int N, int P, int C, float res_scale, int act,
                                   int dtype, void* stream) {
  if (C % 16 != 0 || C > 448 || N > 65535 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef vmg::bf16 T;
    auto launch = act == 0 ? vmg::launch_combine_bf16<0>
                           : act == 1 ? vmg::launch_combine_bf16<1> : vmg::launch_combine_bf16<2>;
    return launch((const T*)x, (const T*)h, (const T*)w, (const T*)c, (const T*)a, (const T*)pk,
                  pb, (const T*)res, (T*)out, N, P, C, res_scale, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  auto launch = act == 0 ? vmg::launch_combine_f32_any<0>
                         : act == 1 ? vmg::launch_combine_f32_any<1> : vmg::launch_combine_f32_any<2>;
  return launch((const float*)x, (const float*)h, (const float*)w, (const float*)c,
                (const float*)a, (const float*)pk, pb, (const float*)res, (float*)out, N, P, C,
                res_scale, st);
}
