// Hopper probes: the counterparts of the Mosaic probes the JAX package used
// to settle its grouped-conv kernel design (tools/exp_mosaic_probe.py,
// tools/exp_mosaic_probe2.py), as three kernels over bf16 tensors.
//
// vmg_probe_slab_copy replaces `dma_probe` (a pltpu.make_async_copy of a
// halo'd (R, Wp, C) row slab into VMEM, waited on with its DMA semaphore,
// then rows 1 .. R-2 stored): the counterpart is the bulk asynchronous
// copy (cp.async.bulk, the TMA's one-dimensional form) completing on an
// mbarrier.  Bound: device memory (the output, read and written once).  A
// 6-row slab of 328 x 112 bf16 is 440 KB, over a block's 227 KB, so the
// slab is split along W into pieces of at most 64 KB, one block each; each
// row of a piece is one bulk copy.  Bulk copies move multiples of 16 bytes
// between 16-byte aligned addresses: the wrapper refuses a shape whose row
// pieces break that rule instead of copying another way.
//
// vmg_probe_relayout replaces the layout probes (`vmem_subshift`,
// `vmem_lane_store`, `vmem_lane_read`, `roll_lane`, `subdim_store`,
// `lane_store`, `lane_concat`): a template over the index map.  A block
// stages the input rows one 8-row output tile needs in shared memory
// (16-byte loads where the rows allow), then writes the tile in the
// probe's layout, neighbouring threads on neighbouring output elements
// (two per 4-byte store).
// Bound: device memory.  Maps: a slice (row and channel offsets), taps
// (out[b, t * C + k] = in[b + t, k]), a roll along channels, and a tiling
// of the rows.
//
// vmg_probe_tile_gemm replaces `mm_time` and the stage-0 conv-tile probes
// (`tile_assembled`, `tile_accum`, `tile_3dot`): out = round(sum over taps
// of A_t @ B_t) with f32 accumulation, bf16 wmma (16x16x16).  Bound:
// operations at these shapes' arithmetic intensity (0.2-0.6 GFLOP against
// ~1 MB).  One block of 8 warps per 128 output rows, each warp 16 rows x
// all N columns (<= 192) of accumulators; per tap, the A operand is
// gathered into shared memory in 8-byte units in the probe's form --
// row-major, column-major (the TPU tool's contraction of dim 1), a 3x3
// conv tap of an (R + 2, Wx, Cx) slab, or all nine taps assembled as one
// im2col operand at a channel stride (zeros in the gaps) -- and B_t is
// staged beside it, K padded to 16 with zeros, N to 16.  A `reps` grid
// dimension runs the same tile on every SM at once.
#include "common.cuh"

namespace vmg {

// ---- slab copy ---------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// out[i, r, w, :] = x[0, i * (R - 2) + 1 + r, w, :], r < R - 2; grid
// (pieces, slabs), piece p covering columns p * wpiece .. + wpiece.
__global__ void __launch_bounds__(kThreads)
slab_copy_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int Wp, int C, int R,
                 int wpiece) {
  extern __shared__ __align__(128) unsigned char slab[];
  __shared__ __align__(8) unsigned long long bar;
  const int i = blockIdx.y, w0 = blockIdx.x * wpiece;
  const int ncols = min(wpiece, Wp - w0);
  const unsigned row_bytes = (unsigned)ncols * C * 2;
  const unsigned b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(row_bytes * R)
                 : "memory");
    for (int r = 0; r < R; ++r) {
      const bf16* src = x + ((size_t)(i * (R - 2) + r) * Wp + w0) * C;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slab + (size_t)r * row_bytes)),
          "l"(src), "r"(row_bytes), "r"(b)
          : "memory");
    }
  }
  unsigned done = 0;
  while (!done) {  // wait for phase 0 to complete: every byte has landed
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
  const int nv = row_bytes / 16;
  for (int r = 1; r < R - 1; ++r) {
    const uint4* s = reinterpret_cast<const uint4*>(slab + (size_t)r * row_bytes);
    uint4* d = reinterpret_cast<uint4*>(out + (((size_t)i * (R - 2) + r - 1) * Wp + w0) * C);
    for (int e = threadIdx.x; e < nv; e += kThreads) d[e] = s[e];
  }
}

// ---- relayout ----------------------------------------------------------------

constexpr int kRelayRows = 8;  // output rows per block

// Each map names, for output (b, c) of an A x Bout x Cout tensor, the input
// row and channel it copies, and the input rows an output row tile needs.
struct SliceMap {  // out[b, c] = in[b + boff, c + coff]
  int boff, coff;
  __device__ int lo(int b0, int) const { return b0 + boff; }
  __device__ int hi(int b1, int) const { return b1 + boff; }
  __device__ void src(int b, int c, int, int& rb, int& rc) const { rb = b + boff; rc = c + coff; }
};
struct TapsMap {  // out[b, t * Cin + k] = in[b + t, k], t < taps
  int taps;
  __device__ int lo(int b0, int) const { return b0; }
  __device__ int hi(int b1, int) const { return b1 + taps - 1; }
  __device__ void src(int b, int c, int Cin, int& rb, int& rc) const {
    rb = b + c / Cin;
    rc = c % Cin;
  }
};
struct RollMap {  // out[b, c] = in[b, (c - shift) mod Cin]
  int shift;
  __device__ int lo(int b0, int) const { return b0; }
  __device__ int hi(int b1, int) const { return b1; }
  __device__ void src(int b, int c, int Cin, int& rb, int& rc) const {
    rb = b;
    rc = ((c - shift) % Cin + Cin) % Cin;
  }
};
struct TileMap {  // out[b, c] = in[b mod Bin, c]
  __device__ int lo(int, int) const { return 0; }
  __device__ int hi(int, int Bin) const { return Bin; }
  __device__ void src(int b, int c, int Bin, int& rb, int& rc) const {
    rb = b % Bin;
    rc = c;
  }
};

template <typename Map>
__global__ void __launch_bounds__(kThreads)
relayout_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, int Bin, int Cin,
                int Bout, int Cout, Map map) {
  extern __shared__ __align__(128) unsigned char raw[];
  bf16* tile = reinterpret_cast<bf16*>(raw);
  const int a = blockIdx.y, b0 = blockIdx.x * kRelayRows;
  const int b1 = min(Bout, b0 + kRelayRows);
  const int lo = map.lo(b0, Bin), hi = min(Bin, map.hi(b1, Bin));
  const bf16* src = in + ((size_t)a * Bin + lo) * Cin;
  const int n = (hi - lo) * Cin;
  if ((uintptr_t)src % 16 == 0 && n % 8 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(tile);
    for (int e = threadIdx.x; e < n / 8; e += kThreads) d[e] = s[e];
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) tile[e] = src[e];
  }
  __syncthreads();
  const int Bm = std::is_same<Map, TileMap>::value ? Bin : Cin;  // the map's modulus
  auto at = [&](int b, int c) {
    int rb, rc;
    map.src(b, c, Bm, rb, rc);
    return tile[(rb - lo) * Cin + rc];
  };
  if (Cout % 2 == 0) {  // two elements (4 bytes) per store
    for (int e = threadIdx.x; e < (b1 - b0) * Cout / 2; e += kThreads) {
      const int b = b0 + 2 * e / Cout, c = 2 * e % Cout;
      __nv_bfloat162 v;
      v.x = at(b, c);
      v.y = at(b, c + 1);
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)a * Bout + b) * Cout + c) = v;
    }
  } else {
    for (int e = threadIdx.x; e < (b1 - b0) * Cout; e += kThreads) {
      const int b = b0 + e / Cout, c = e % Cout;
      out[((size_t)a * Bout + b) * Cout + c] = at(b, c);
    }
  }
}

// ---- tile GEMM ---------------------------------------------------------------

constexpr int kGemmMT = 128;  // output rows per block: 8 warps x 16
constexpr int kGemmNT = 12;   // N <= 192

// The A operand's forms (tap t, batch item bi, row m, column k < K).
struct GemmForm {
  int kind;       // 0 rows, 1 cols, 2 conv taps, 3 assembled
  int lda;        // rows / cols: the row (column) stride
  int tap_stride; // rows: elements between taps
  int batch_stride;
  int Wo, Wx, Cx, cg, stride;  // conv forms: output width, slab width and channels
};

// Row-wise forms: where columns k .. k + 3 of row m start in a, or null
// where they are zeros (the gaps of a stride wider than the group).
__device__ __forceinline__ const bf16* gemm_a4(const bf16* __restrict__ a, const GemmForm& f,
                                               int t, int m, int k) {
  if (f.kind == 0) return a + (size_t)t * f.tap_stride + (size_t)m * f.lda + k;
  if (f.kind == 3) {
    t = k / f.stride;
    k %= f.stride;
    if (k >= f.cg) return nullptr;
  }
  const int r = m / f.Wo, w = m % f.Wo;
  return a + ((size_t)(t / 3 + r) * f.Wx + t % 3 + w) * f.Cx + k;
}

__host__ __device__ inline size_t gemm_smem(int Kp, int Np) {
  const size_t ab = (size_t)kGemmMT * (Kp + kPadH) * 2 + (size_t)Kp * (Np + kPadH) * 2;
  const size_t o = (size_t)kGemmMT * (Np + kPadF) * 4;
  return ab > o ? ab : o;
}

// out (reps, batch, M, N) = round(sum_t A_t (M x K) @ b[t] (K x N)); grid
// (ceil(M / 128), batch, reps).
__global__ void __launch_bounds__(kThreads)
tile_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bm, bf16* __restrict__ out,
                 int M, int N, int K, int taps, GemmForm f) {
  extern __shared__ __align__(128) unsigned char raw[];
  const int Kp = (K + 15) / 16 * 16, Np = (N + 15) / 16 * 16;
  const int lda = Kp + kPadH, ldb = Np + kPadH, ldo = Np + kPadF;
  bf16* As = reinterpret_cast<bf16*>(raw);
  bf16* Bs = As + kGemmMT * lda;
  float* Os = reinterpret_cast<float*>(raw);  // after the last tap
  const int m0 = blockIdx.x * kGemmMT, bi = blockIdx.y, warp = threadIdx.x >> 5;
  const int NT = Np / 16;
  FragC acc[kGemmNT];
#pragma unroll
  for (int j = 0; j < kGemmNT; ++j) wm::fill_fragment(acc[j], 0.f);
  const bf16* ab = a + (size_t)bi * f.batch_stride;
  for (int t = 0; t < taps; ++t) {
    // A in 8-byte units: 4 columns of one row, or (column-major source) 4
    // rows of one column, neighbouring threads on neighbouring units
    if (f.kind == 1) {
      constexpr int MU = kGemmMT / 4;
      for (int u = threadIdx.x; u < MU * Kp; u += kThreads) {
        const int m = (u % MU) * 4, k = u / MU;
        uint2 v = make_uint2(0, 0);
        if (m0 + m < M && k < K)
          v = *reinterpret_cast<const uint2*>(ab + (size_t)k * f.lda + m0 + m);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) As[(m + i) * lda + k] = e[i];
      }
    } else {
      const int KU = Kp / 4;
      for (int u = threadIdx.x; u < kGemmMT * KU; u += kThreads) {
        const int m = u / KU, k = (u % KU) * 4;
        uint2 v = make_uint2(0, 0);
        if (m0 + m < M && k < K) {
          const bf16* p = gemm_a4(ab, f, t, m0 + m, k);
          if (p != nullptr) v = *reinterpret_cast<const uint2*>(p);
        }
        *reinterpret_cast<uint2*>(As + m * lda + k) = v;
      }
    }
    const bf16* bt = bm + (size_t)t * K * N;
    const int nv = Np / 8;
    for (int e = threadIdx.x; e < Kp * nv; e += kThreads) {
      const int k = e / nv, v = e % nv;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (k < K && v * 8 < N) u = *reinterpret_cast<const uint4*>(bt + (size_t)k * N + v * 8);
      *reinterpret_cast<uint4*>(Bs + k * ldb + v * 8) = u;
    }
    __syncthreads();
    for (int k0 = 0; k0 < Kp; k0 += 16) {
      FragA af;
      wm::load_matrix_sync(af, As + warp * 16 * lda + k0, lda);
#pragma unroll
      for (int j = 0; j < kGemmNT; ++j) {
        if (j < NT) {
          FragB bfr;
          wm::load_matrix_sync(bfr, Bs + k0 * ldb + j * 16, ldb);
          wm::mma_sync(acc[j], af, bfr, acc[j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kGemmNT; ++j)
    if (j < NT)
      wm::store_matrix_sync(Os + warp * 16 * ldo + j * 16, acc[j], ldo, wm::mem_row_major);
  __syncthreads();
  bf16* o = out + ((size_t)blockIdx.z * gridDim.y + bi) * M * N;
  for (int e = threadIdx.x; e < kGemmMT * N; e += kThreads) {
    const int m = e / N, n = e % N;
    if (m0 + m < M) o[(size_t)(m0 + m) * N + n] = from_f<bf16>(Os[m * ldo + n]);
  }
}

}  // namespace vmg

// x: (slabs' frame, H2, Wp, C) bf16, out: (slabs, R - 2, Wp, C); the caller
// checks the 16-byte rule (Wp * C * 2 and wpiece * C * 2 multiples of 16).
extern "C" int vmg_probe_slab_copy(const void* x, void* out, int Wp, int C, int R,
                                   int slabs, int wpiece, void* stream) {
  if (R < 3 || wpiece < 1 || ((size_t)wpiece * C * 2) % 16 || ((size_t)Wp * C * 2) % 16 ||
      (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * wpiece * C * 2;
  if (smem > vmg::kMaxSmem - 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(vmg::slab_copy_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Wp + wpiece - 1) / wpiece, slabs);
  vmg::slab_copy_kernel<<<grid, vmg::kThreads, smem, (cudaStream_t)stream>>>(
      (const vmg::bf16*)x, (vmg::bf16*)out, Wp, C, R, wpiece);
  return (int)cudaGetLastError();
}

// in: (A, Bin, Cin), out: (A, Bout, Cout) bf16.  kind 0 slice (p0 row
// offset, p1 channel offset), 1 taps (p0 taps), 2 roll (p0 shift), 3 tile.
extern "C" int vmg_probe_relayout(const void* in, void* out, int A, int Bin, int Cin,
                                  int Bout, int Cout, int kind, int p0, int p1,
                                  void* stream) {
  using namespace vmg;
  const int halo = kind == 1 ? p0 - 1 : 0;
  const int rows = kind == 3 ? Bin : kRelayRows + halo;
  const size_t smem = (size_t)rows * Cin * 2;
  if (A > 65535 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((Bout + kRelayRows - 1) / kRelayRows, A);
  const bf16* i = (const bf16*)in;
  bf16* o = (bf16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      relayout_kernel<<<grid, kThreads, smem, st>>>(i, o, Bin, Cin, Bout, Cout, SliceMap{p0, p1});
      break;
    case 1:
      relayout_kernel<<<grid, kThreads, smem, st>>>(i, o, Bin, Cin, Bout, Cout, TapsMap{p0});
      break;
    case 2:
      relayout_kernel<<<grid, kThreads, smem, st>>>(i, o, Bin, Cin, Bout, Cout, RollMap{p0});
      break;
    case 3:
      relayout_kernel<<<grid, kThreads, smem, st>>>(i, o, Bin, Cin, Bout, Cout, TileMap{});
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a: the A source in the form's layout; b: (taps, K, N); out: (reps, batch,
// M, N), all bf16.  N % 8 == 0, N <= 192; K, the strides and the
// channel counts multiples of 4 (8-byte A units; M for kind 1).
extern "C" int vmg_probe_tile_gemm(const void* a, const void* b, void* out, int M, int N,
                                   int K, int taps, int batch, int reps, int kind, int lda,
                                   int tap_stride, int batch_stride, int Wo, int Wx, int Cx,
                                   int cg, int stride, void* stream) {
  using namespace vmg;
  if (N % 8 || N > 16 * kGemmNT || K < 1 || taps < 1 || kind < 0 || kind > 3 ||
      batch > 65535 || reps > 65535 || (uintptr_t)b % 16 || (uintptr_t)a % 8 ||
      K % 4 || lda % 4 || tap_stride % 4 || batch_stride % 4 || Cx % 4 || cg % 4 ||
      stride % 4 || (kind == 1 && M % 4) || ((kind == 2 || kind == 3) && Wo < 1) ||
      (kind == 3 && (stride < cg || K != 9 * stride)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem((K + 15) / 16 * 16, (N + 15) / 16 * 16);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(tile_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const GemmForm f{kind, lda, tap_stride, batch_stride, Wo, Wx, Cx, cg, stride};
  const dim3 grid((M + kGemmMT - 1) / kGemmMT, batch, reps);
  tile_gemm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)b, (bf16*)out, M, N, K, taps, f);
  return (int)cudaGetLastError();
}
