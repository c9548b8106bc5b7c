// Hopper probes: the counterparts of the Mosaic probes the JAX package used
// to settle its grouped-conv kernel design (tools/exp_mosaic_probe.py,
// tools/exp_mosaic_probe2.py), as three kernels over bf16 tensors.
//
// vmg_probe_slab_copy replaces `dma_probe` (a pltpu.make_async_copy of a
// halo'd (R, Wp, C) row slab into VMEM, waited on with its DMA semaphore,
// then rows 1 .. R-2 stored): the counterpart is the bulk asynchronous
// copy (cp.async.bulk, the TMA's one-dimensional form) completing on an
// mbarrier.  Bound: device memory (the output, read and written once); at
// the probes' 0.6 MB it is launch and memory latency.  So the slab is cut
// along W into pieces small enough that the grid covers the card
// (`slab_piece`: about SMs / slabs pieces a slab, each row piece a whole
// number of 16-byte units); a block is one warp whose lane r issues row r
// of its piece as one bulk copy on the row's own mbarrier and, as soon as
// that row has landed, stores it back by one bulk copy
// (cp.async.bulk.global.shared::cta).  A block's set-up before its first
// copy (the barriers) weighs as much as the copies at this size, so the
// kernel is launched with programmatic dependent launch (`launch_pdl`):
// that part of a launch overlaps the end of the grid before it.  Bulk copies
// move multiples of 16 bytes between 16-byte aligned addresses: the
// wrapper refuses a shape whose row pieces break that rule instead of
// copying another way.
//
// vmg_probe_relayout replaces the layout probes (`vmem_subshift`,
// `vmem_lane_store`, `vmem_lane_read`, `roll_lane`, `subdim_store`,
// `lane_store`, `lane_concat`): a copy of an (A, B, C) tensor into a slice
// (row and channel offsets), taps (out[b, t * C + k] = in[b + t, k]), a roll
// along channels or a tiling of the rows.  Bound: device memory, and at the
// probes' 0.1-6 MB launch and memory latency.  Every map is a copy of
// contiguous runs: an output row is one run of input (slice, taps, tile)
// or two (roll).  So the index map leaves the inner loop:
//   - a block (`probes.relayout_plan`: a row tile of `rows` output rows,
//     a whole number of 16-byte units where the row width allows; at most
//     two blocks an SM, at most 768 output vectors a block, two a thread)
//     stages the input span its rows read -- one contiguous range, whole
//     rows for a channel slice -- by one bulk asynchronous copy
//     (cp.async.bulk) from the 16-byte unit below its first element,
//     completing on an mbarrier (a tail past the input's last whole unit,
//     element by element);
//   - while the copy is in flight, each output row's runs (byte offsets into
//     the stage, the first run's length) are worked out once, into a table;
//   - threads then assemble the block's output as 16-byte vectors,
//     neighbouring threads on neighbouring vectors: a vector inside one run
//     from the two aligned 16-byte words that hold it, shifted by selects and
//     a byte permute (runs start anywhere on 2 bytes: taps of 56-byte rows,
//     the channel slice, the roll's 2-byte run), stored as one 16-byte store;
//     a vector across a run or row boundary element by element, walking
//     the rows from its first (one divide a vector, none an element);
//   - launched with programmatic dependent launch, as the slab copy.
// Bulk copies read 16-byte aligned addresses: the wrapper refuses an input
// that is not 16-byte aligned, and a shape whose staged span does not fit a
// block's shared memory.
//
// vmg_probe_tile_gemm replaces `mm_time` and the stage-0 conv-tile probes
// (`tile_assembled`, `tile_accum`, `tile_3dot`): out = round(sum over taps
// of A_t @ B_t) with f32 accumulation.  Bound: operations at these shapes'
// arithmetic intensity (0.2-0.6 GFLOP against ~1 MB), so the tile has to
// reach the tensor cores the way a conv kernel on this card would.  What
// limits a block here is the number of copies it asks of its SM's TMA unit
// (a fixed cost a box, then one a 64- or 128-byte row) or of its threads
// (cp.async), not the bytes or the products, so the design is about feeding:
//   - wgmma m64nNTk16 on 64-row tiles, N cut into `splits` column tiles of
//     NT = 64, 128 or 192 (whole 128-byte swizzle atoms) where one tile per
//     64 rows would leave SMs idle (`probes.gemm_plan`: 40 row tiles x 3
//     column tiles of 64 at the stage-0 tile's 2560 x 168).  A block owns
//     one column tile and walks (output, row tile) units, so B stays.
//   - B, every tap of the block's columns, is loaded once: one TMA box of
//     64 columns x Kp rows x taps per atom from a 3-D map over (taps, K,
//     N), the 128-byte swizzle, read MN-major by the descriptors; rows K ..
//     Kp (K padded to 32 or 64) arrive as zeros (out of bounds).
//   - A streams through a ring of stages by TMA where its rows are 16-byte
//     aligned: K-major boxes of 64 rows x kw columns (kw = 32, the 64-byte
//     swizzle, where a tap's K fits 32; else 64, the 128-byte), "cols" (the
//     TPU tool's contraction of dim 1, A = a[bi]^T) as MN-major 64 x 64
//     boxes.  The conv forms load one box a K chunk: the three tap rows dy
//     of 72 pixels (64 output columns and the halo), and tap (dy, dx) is
//     that box's tap row dy from pixel row dx on (the wgmma unit swizzles by
//     absolute address, as TMA does, so such a start needs no base offset):
//     one box for nine taps.  The assembled form is those nine taps of cg
//     channels, each tap's channels past cg out of bounds in A's and B's
//     maps (zeros: exact), so its gaps are never read.  Where a row is not
//     16-byte aligned (a 252-column "rows" A), the producer warpgroup's 128
//     threads copy the same layouts with cp.async (16 bytes, or two 8-byte
//     halves; zeros past M and K), signalling a stage once the one behind
//     it has landed.
//   - The consumer warpgroup runs each stage's wgmma chain and hands a
//     stage back on its empty mbarrier once the chain three after it is in
//     flight: copies overlap the products.
//   - Epilogue: the accumulator fragments as bf16 pairs into a staged tile
//     (64 rows of 128 bytes an atom, swizzled: no bank conflicts), out by
//     TMA stores, rows past the image row and columns past N clipped by the
//     map.  (Storing the pairs straight from registers, each warp store
//     spread over 8 rows, was slower for a 192-column tile.)
//   - Programmatic dependent launch, as the slab copy.
// The `reps` dimension runs the same product that many times at once (one
// output each), the conv tile on every SM.
#include "common.cuh"
#include "wgmma.cuh"

namespace vmg {

// ---- slab copy ---------------------------------------------------------------


// Programmatic dependent launch: a grid launched with the stream
// serialization attribute (launch_pdl) starts while the grid before it in
// the stream finishes; it lets the next grid start likewise
// (pdl_launch_dependents), and waits until the grid before it has completed
// and its memory is visible (pdl_wait) before it touches device memory.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, void* stream,
               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// out[i, r - 1, w, :] = x[0, i * (R - 2) + r, w, :], 1 <= r <= R - 2; grid
// (pieces, slabs), piece p covering columns p * wpiece .. + wpiece; one
// warp, lane r issuing row r (and r + 32, ..) on the row's own mbarrier.
// Shared memory: R row pieces wpiece * C * 2 bytes apart, then R mbarriers.
__global__ void __launch_bounds__(32)
slab_copy_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int Wp, int C, int R,
                 int wpiece) {
  extern __shared__ __align__(128) unsigned char slab[];
  pdl_launch_dependents();
  const int lane = threadIdx.x, i = blockIdx.y, w0 = blockIdx.x * wpiece;
  const unsigned row_bytes = (unsigned)(min(wpiece, Wp - w0) * C * 2);
  const size_t pitch = (size_t)wpiece * C * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(slab + (size_t)R * pitch);
  for (int r = lane; r < R; r += 32) mbar_init(&bar[r], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  pdl_wait();
  for (int r = lane; r < R; r += 32) {  // every row of the halo'd piece
    mbar_expect(&bar[r], row_bytes);
    bulk_load(slab + r * pitch, x + ((size_t)(i * (R - 2) + r) * Wp + w0) * C, row_bytes,
              &bar[r]);
  }
  for (int r = lane; r < R; r += 32) {  // an inner row out as soon as it has landed
    mbar_wait(&bar[r], 0);  // (the halo rows too, before the block's shared memory goes)
    if (r == 0 || r == R - 1) continue;
    bulk_store(out + ((size_t)(i * (R - 2) + r - 1) * Wp + w0) * C, slab + r * pitch, row_bytes);
    bulk_commit();
  }
  bulk_wait_read<0>();  // and the stores have read it
}

// ---- relayout ----------------------------------------------------------------

constexpr int kRelayMaxThreads = 256;

// The relayout's operands: in (A, Bin, Cin) -> out (A, Bout, Cout), bf16;
// kind 0 slice (p0 row, p1 channel offset), 1 taps (p0 taps), 2 roll (p0
// shift, 0 <= p0 < Cin), 3 tile; `rows` output rows a block.
struct RelayArgs {
  const bf16* in;
  bf16* out;
  int Bin, Cin, Bout, Cout, kind, p0, p1, rows;
  long long in_elems;
};

// Flat input elements [lo, hi) that output rows [b0, b1) of frame a read
// (probes.relayout_span).
__device__ __forceinline__ void relay_span(const RelayArgs& g, int a, int b0, int b1,
                                           long long& lo, long long& hi) {
  const long long f = (long long)a * g.Bin;
  if (g.kind == 0) {
    lo = (f + b0 + g.p0) * g.Cin + g.p1;
    hi = (f + b1 - 1 + g.p0) * g.Cin + g.p1 + g.Cout;
  } else if (g.kind == 1) {
    lo = (f + b0) * g.Cin;
    hi = (f + b1 - 1 + g.p0) * g.Cin;
  } else if (g.kind == 2) {
    lo = (f + b0) * g.Cin;
    hi = (f + b1) * g.Cin;
  } else {  // rows b mod Bin: the whole frame where the block wraps
    int r0 = b0 % g.Bin, n = b1 - b0;
    if (r0 + n > g.Bin) r0 = 0, n = g.Bin;
    lo = (f + r0) * g.Cin;
    hi = (f + r0 + n) * g.Cin;
  }
}

// Output row b of frame a as at most two runs of input (probes.relayout_row):
// element c < len0 is flat input element src0 + c, the rest src1 + c - len0.
__device__ __forceinline__ void relay_row(const RelayArgs& g, int a, int b, long long& src0,
                                          int& len0, long long& src1) {
  const long long f = (long long)a * g.Bin;
  len0 = g.Cout;
  src1 = 0;
  if (g.kind == 0) {
    src0 = (f + b + g.p0) * g.Cin + g.p1;
  } else if (g.kind == 1) {
    src0 = (f + b) * g.Cin;
  } else if (g.kind == 2) {  // out[c] = in[(c - shift) mod Cin]: the last `shift`, then the rest
    src1 = (f + b) * g.Cin;
    src0 = src1 + g.Cin - g.p0;
    len0 = g.p0;
  } else {
    src0 = (f + b % g.Bin) * g.Cin;
  }
}

// The 16 bytes at stage + s (s even): the two aligned 16-byte words that
// hold them, shifted down by s % 16 bytes -- whole words by selects, the
// 2-byte remainder by a byte permute.
__device__ __forceinline__ uint4 relay_vec(const unsigned char* stage, int s) {
  const uint4 w0 = *reinterpret_cast<const uint4*>(stage + (s & ~15));
  const uint4 w1 = *reinterpret_cast<const uint4*>(stage + (s & ~15) + 16);
  uint32_t u0 = w0.x, u1 = w0.y, u2 = w0.z, u3 = w0.w, u4 = w1.x, u5 = w1.y;
  const uint32_t u6 = w1.z, u7 = w1.w;
  if (s & 8) u0 = u2, u1 = u3, u2 = u4, u3 = u5, u4 = u6, u5 = u7;
  if (s & 4) u0 = u1, u1 = u2, u2 = u3, u3 = u4, u4 = u5;
  const unsigned sel = (s & 2) ? 0x5432 : 0x3210;
  return make_uint4(__byte_perm(u0, u1, sel), __byte_perm(u1, u2, sel),
                    __byte_perm(u2, u3, sel), __byte_perm(u3, u4, sel));
}

// Walks the block's output element by element from row r, column c: the
// row's runs in registers, the next row's read from the table only where
// the walk crosses into it.
struct RelayCursor {
  const unsigned char* stage;
  const int* table;
  int Cout, r, c, off0, len0, off1;
  __device__ __forceinline__ RelayCursor(const unsigned char* s, const int* t, int cout, int row,
                                         int col)
      : stage(s), table(t), Cout(cout), r(row), c(col) {
    load();
  }
  __device__ __forceinline__ void load() {
    off0 = table[3 * r];
    len0 = table[3 * r + 1];
    off1 = table[3 * r + 2];
  }
  __device__ __forceinline__ unsigned short next() {
    if (c == Cout) ++r, c = 0, load();
    const int off = c < len0 ? off0 + 2 * c : off1 + 2 * (c - len0);
    ++c;
    return *reinterpret_cast<const unsigned short*>(stage + off);
  }
};

// grid (row tiles, A): block (x, a) writes output rows [x rows, + rows) of
// frame a.  Shared memory: the staged input span (stage_bytes, from 16
// bytes below its first element, with room for relay_vec's second word),
// the rows' run table (byte offsets into the stage), the mbarrier.
__global__ void __launch_bounds__(kRelayMaxThreads)
relayout_kernel(RelayArgs g, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char relay_smem[];
  unsigned char* stage = relay_smem;
  int* table = reinterpret_cast<int*>(relay_smem + stage_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(relay_smem + stage_bytes +
                                              (12 * g.rows + 7) / 8 * 8);
  pdl_launch_dependents();
  const int a = blockIdx.y, b0 = blockIdx.x * g.rows, b1 = min(g.Bout, b0 + g.rows);
  long long lo, hi;
  relay_span(g, a, b0, b1, lo, hi);
  // one bulk copy of the span's whole 16-byte units; a tail past the input's
  // last whole unit element by element
  const long long S0 = (2 * lo) & ~15LL;
  const long long S1 = min((2 * hi + 15) & ~15LL, (2 * g.in_elems) & ~15LL);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  pdl_wait();
  const unsigned char* in = reinterpret_cast<const unsigned char*>(g.in);
  if (threadIdx.x == 0) {
    mbar_expect(bar, (unsigned)(S1 - S0));
    if (S1 > S0) bulk_load(stage, in + S0, (unsigned)(S1 - S0), bar);
  }
  for (long long e = S1 + 2 * threadIdx.x; e < 2 * hi; e += 2 * blockDim.x)
    *reinterpret_cast<unsigned short*>(stage + (e - S0)) =
        *reinterpret_cast<const unsigned short*>(in + e);
  // each row's runs, once, while the copy is in flight
  for (int r = threadIdx.x; r < b1 - b0; r += blockDim.x) {
    long long s0, s1;
    int l0;
    relay_row(g, a, b0 + r, s0, l0, s1);
    table[3 * r] = (int)(2 * s0 - S0);
    table[3 * r + 1] = l0;
    table[3 * r + 2] = (int)(2 * s1 - S0);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  // the block's output span as 16-byte vectors, neighbouring threads on
  // neighbouring vectors: a vector inside one run from relay_vec, one across
  // a run or row boundary element by element; a vector the span shares with
  // the next block's (a row tile whose bytes are not a multiple of 16) is
  // written element by element, its own elements only
  const long long e0 = ((long long)a * g.Bout + b0) * g.Cout;
  const long long e1 = ((long long)a * g.Bout + b1) * g.Cout;
  unsigned short* out = reinterpret_cast<unsigned short*>(g.out);
  for (long long k = e0 / 8 + threadIdx.x; 8 * k < e1; k += blockDim.x) {
    const long long v0 = 8 * k;
    if (v0 >= e0 && v0 + 8 <= e1) {
      const int rel = (int)(v0 - e0), r = rel / g.Cout, c = rel - r * g.Cout;
      const int off0 = table[3 * r], len0 = table[3 * r + 1], off1 = table[3 * r + 2];
      uint4 v;
      if (c + 8 <= len0) {
        v = relay_vec(stage, off0 + 2 * c);
      } else if (c >= len0 && c + 8 <= g.Cout) {
        v = relay_vec(stage, off1 + 2 * (c - len0));
      } else {
        RelayCursor cur(stage, table, g.Cout, r, c);
        uint32_t h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = cur.next();
        v = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                       h[6] | h[7] << 16);
      }
      *reinterpret_cast<uint4*>(out + v0) = v;
    } else {
      const long long first = max(v0, e0);
      const int rel = (int)(first - e0), r = rel / g.Cout;
      RelayCursor cur(stage, table, g.Cout, r, rel - r * g.Cout);
      for (long long e = first; e < min(v0 + 8, e1); ++e) out[e] = cur.next();
    }
  }
}

// ---- tile GEMM ---------------------------------------------------------------

constexpr int kGemmMT = 64;        // output rows per tile: one m64 wgmma row block
constexpr int kGemmThreads = 256;  // the consumer warpgroup, then the producer warpgroup
constexpr int kGemmMaxRing = 16;
constexpr int kAtom = 64 * 128;    // a 64-row x 128-byte swizzle atom block
constexpr int kConvRows = 72;      // a conv stage's pixel rows: 64 output columns, the halo, to 8

// The A operand's forms (tap t, batch item bi, row m, column k < K); the
// assembled form arrives as nine conv taps of cg columns each.
struct GemmForm {
  int kind;        // 0 rows, 1 cols, 2 conv taps
  int lda;         // rows / cols: the row (column) stride
  int tap_stride;  // rows: elements between taps
  int batch_stride;
  int Wx, Cx;      // conv taps: slab width and channels
};

// The launch: the problem and `probes.gemm_plan`'s choices.  Row tiles are
// R image rows x wtiles 64-wide pieces of Wo (rows / cols: R = 1, Wo = M);
// a unit is (output, row tile, column tile).
struct GemmArgs {
  const bf16* a;
  int M, N, K, taps, batch, units, R, Wo, wtiles;
  int Kp, kw, nk, kbox, ring, splits, tma;  // a tap's K padded to nk chunks of kw (32 or 64)
  GemmForm f;
};
struct GemmMaps {
  CUtensorMap a, b, out;
};

// 16 or 8 bytes global -> shared, or zeros where src is null (source size 0)
__device__ __forceinline__ void cp_async_16z(unsigned dst, const void* src, const void* any) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src ? src : any), "r"(src ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_8z(unsigned dst, const void* src, const void* any) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src ? src : any), "r"(src ? 8 : 0)
               : "memory");
}
// One 16-byte chunk: one copy where both halves are contiguous and aligned.
__device__ __forceinline__ void cp_async_chunk(unsigned dst, const bf16* p0, const bf16* p1,
                                               const void* any) {
  if (p0 != nullptr && p1 == p0 + 4 && (reinterpret_cast<uintptr_t>(p0) & 15) == 0) {
    cp_async_16z(dst, p0, any);
  } else {
    cp_async_8z(dst, p0, any);
    cp_async_8z(dst + 8, p1, any);
  }
}

__host__ __device__ inline size_t gemm_b_bytes(int taps, int Kp, int NT) {
  return (size_t)(NT / 64) * taps * Kp * 128;
}
// A stage: 64 rows of kw columns, or for conv taps the (taps + 2) / 3 tap
// rows dy of 72 pixels each (one box; each a whole number of swizzle
// periods, 512 or 1024 bytes); its bytes, and its slot (1024-byte aligned)
__host__ __device__ inline size_t gemm_stage_bytes(int kw, int taps, int conv) {
  return conv ? (size_t)(taps + 2) / 3 * kConvRows * kw * 2 : (size_t)kGemmMT * kw * 2;
}
__host__ __device__ inline size_t gemm_slot_bytes(int kw, int taps, int conv) {
  return (gemm_stage_bytes(kw, taps, conv) + 1023) / 1024 * 1024;
}
// B image, A ring, output tile, barriers (1 + 2 kGemmMaxRing), alignment slack
__host__ __device__ inline size_t gemm_smem(int taps, int Kp, int NT, int kw, int ring, int conv) {
  return gemm_b_bytes(taps, Kp, NT) + ring * gemm_slot_bytes(kw, taps, conv) +
         (size_t)(NT / 64) * kAtom + (1 + 2 * kGemmMaxRing) * 8 + 1024;
}

// An A stage by the producer's 128 threads with cp.async, in the layout
// the TMA path's boxes land in: K-major rows of kw * 2 bytes (64 rows of
// a; conv: tap row dy's 72 pixels of image row r + dy from column w0, the
// tap rows one after another), 16-byte chunk i of row m at i ^ (m % 8) (kw
// = 64, the 128-byte swizzle) or i ^ (m / 2 % 4) (kw = 32, the 64-byte);
// "cols" MN-major, 64 k rows of 64 m, chunk i of row k at i ^ (k % 8).
// Neighbouring threads on neighbouring chunks of a row; zeros past K, past
// M and past the slab's columns.
__device__ __forceinline__ void gemm_stage_copy(const GemmArgs& g, unsigned dst, int p, int bi,
                                                int t, int r, int w0, int k0) {
  const bf16* ab = g.a + (size_t)bi * g.f.batch_stride;
  if (g.f.kind == 1) {  // a[bi][k][m]: 8 rows of one column a chunk
    for (int e = p; e < 64 * 8; e += 128) {
      const int k = e >> 3, i = e & 7, gk = k0 + k, gm = w0 + 8 * i;
      const bf16* row = ab + (size_t)gk * g.f.lda;
      cp_async_chunk(dst + k * 128 + ((i ^ (k & 7)) << 4),
                     gk < g.K && gm < g.M ? row + gm : nullptr,
                     gk < g.K && gm + 4 < g.M ? row + gm + 4 : nullptr, g.a);
    }
    return;
  }
  const int cpr = g.kw / 8, conv = g.f.kind == 2;  // chunks a row
  const int rows = conv ? (g.taps + 2) / 3 * kConvRows : kGemmMT;
  for (int e = p; e < rows * cpr; e += 128) {
    const int m = e / cpr, i = e % cpr, k = k0 + 8 * i;
    const int sw = g.kw == 64 ? (m & 7) : ((m >> 1) & 3);
    const int w = w0 + (conv ? m % kConvRows : m), wend = conv ? g.f.Wx : g.Wo;
    const bf16* src = conv ? ab + ((size_t)(m / kConvRows + r) * g.f.Wx + w) * g.f.Cx
                           : ab + (size_t)t * g.f.tap_stride + (size_t)w * g.f.lda;
    cp_async_chunk(dst + m * g.kw * 2 + ((i ^ sw) << 4),
                   w < wend && k < g.K ? src + k : nullptr,
                   w < wend && k + 4 < g.K ? src + k + 4 : nullptr, g.a);
  }
}

// The A box of stage (tap t, chunk c) of row tile (r, w0) of batch item
// bi; conv: all tap rows of chunk c.
__device__ __forceinline__ void gemm_stage_tma(const GemmArgs& g, const CUtensorMap* map,
                                               void* dst, uint64_t* bar, int bi, int t, int r,
                                               int w0, int c) {
  if (g.f.kind == 1)
    tma_load_3d(dst, map, w0, c * 64, bi, bar);
  else if (g.f.kind == 0)
    tma_load_3d(dst, map, c * g.kw, t * (g.f.tap_stride / g.f.lda) + w0, 0, bar);
  else
    tma_load_3d(dst, map, c * g.kw, w0, r, bar);
}

__device__ __forceinline__ void gemm_consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// out (reps, batch, M, N) = round(sum_t A_t (M x K) @ b[t] (K x N)); a
// persistent grid (a multiple of `splits`): block x owns column tile x %
// splits and walks units x, x + gridDim.x, ...; unit u is column tile u %
// splits of row tile (u / splits) % (R * wtiles) of output u / (splits * R *
// wtiles) (copy * batch + batch item).  Shared memory, 1024-byte aligned:
// B (NT / 64 column atoms of taps * Kp rows of 128 bytes, MN-major, the
// 128-byte swizzle), the A ring, the output tile (NT / 64 atoms of 64 rows
// of 128 bytes, swizzled), the mbarriers.
template <int NT, int TA, int KW, int CONV>
__global__ void __launch_bounds__(kGemmThreads, 1)
tile_gemm_wgmma_kernel(const __grid_constant__ GemmMaps maps, const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int NA = NT / 64;
  unsigned char* bimg = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const unsigned b_atom = (unsigned)g.taps * g.Kp * 128;
  unsigned char* ring = bimg + (size_t)NA * b_atom;
  const unsigned stage_bytes = (unsigned)gemm_slot_bytes(KW, g.taps, CONV);
  // stages a unit: (tap, chunk), or for conv taps (chunk): its tap (dy, dx)
  // is tap row dy's 72 pixels from row dx on
  const int stap = CONV ? 1 : g.taps;
  unsigned char* otile = ring + (size_t)g.ring * stage_bytes;
  uint64_t* bfull = reinterpret_cast<uint64_t*>(otile + NA * kAtom);
  uint64_t* full = bfull + 1;
  uint64_t* empty = full + kGemmMaxRing;
  const int rtiles = g.R * g.wtiles;
  const int n0 = (blockIdx.x % g.splits) * NT;

  pdl_launch_dependents();
  if (threadIdx.x == 0) {
    mbar_init(bfull, 1);
    for (int s = 0; s < g.ring; ++s) {
      mbar_init(&full[s], g.tma ? 1 : 128);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  pdl_wait();  // the grid before has completed: a, b and out are ours

  if (threadIdx.x >= 128) {
    // ---- producer warpgroup: B once by TMA; A by TMA (one thread) or by
    // cp.async (all 128)
    const int p = threadIdx.x - 128;
    if (p == 0) {
      if (g.tma) asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.a) : "memory");
      const int tb = g.kbox == g.Kp ? g.taps : 1;  // taps a box holds
      mbar_expect(bfull, NA * b_atom);
      for (int at = 0; at < NA; ++at)
        for (int t = 0; t < g.taps; t += tb)
          for (int k = 0; k < g.Kp; k += g.kbox)
            tma_load_3d(bimg + (size_t)at * b_atom + ((size_t)t * g.Kp + k) * 128, &maps.b,
                        n0 + 64 * at, k, t, bfull);
    }
    if (g.tma && p != 0) return;
    int q = 0;  // stages issued
    for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
      const int rest = u / g.splits, rt = rest % rtiles, bi = (rest / rtiles) % g.batch;
      const int r = rt / g.wtiles, w0 = (rt % g.wtiles) * kGemmMT;
      for (int t = 0; t < stap; ++t)
        for (int c = 0; c < g.nk; ++c, ++q) {
          const int slot = q % g.ring;
          mbar_wait(&empty[slot], ((q / g.ring) & 1) ^ 1);
          unsigned char* st = ring + (size_t)slot * stage_bytes;
          if (g.tma) {
            mbar_expect(&full[slot], (unsigned)gemm_stage_bytes(KW, g.taps, CONV));
            gemm_stage_tma(g, &maps.a, st, &full[slot], bi, t, r, w0, c);
            continue;
          }
          gemm_stage_copy(g, su32(st), p, bi, t, r, w0, c * g.kw);
          cp_async_commit();
          if (q >= 1) {  // the stage before has landed: visible to wgmma, full
            cp_async_wait<1>();
            fence_async_shared();
            mbar_arrive(&full[(q - 1) % g.ring]);
          }
        }
    }
    if (!g.tma && q > 0) {
      cp_async_wait<0>();
      fence_async_shared();
      mbar_arrive(&full[(q - 1) % g.ring]);
    }
    return;
  }

  // ---- the consumer warpgroup: wgmma chains, then the epilogue
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.out) : "memory");
  const unsigned ring_a = su32(ring), b_a = su32(bimg);
  // A: K-major rows of KW * 2 bytes in 8-row groups (k16 steps 32 bytes
  // along a row; the 128- or 64-byte swizzle), or MN-major 128-byte k rows
  // (k16 steps 2048 bytes); B: MN-major 128-byte k rows, 64-column atoms
  // b_atom apart.  Up to kLag chains stay in flight; a stage goes back to
  // the producer when its chain is done.
  constexpr unsigned a_sbo = TA ? 1024 : 16 * KW, a_mode = KW == 64 ? 1 : 2;
  constexpr unsigned a_step = TA ? 2048 : 32;
  constexpr int kLag = 3;
  float acc[NT / 2];
  int q = 0;
  mbar_wait(bfull, 0);
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const int rest = u / g.splits, rt = rest % rtiles, z = rest / rtiles;
    const int r = rt / g.wtiles, w0 = (rt % g.wtiles) * kGemmMT;
    const int q0 = q;
    for (int t0 = 0; t0 < stap; ++t0)
      for (int c = 0; c < g.nk; ++c, ++q) {
        const int slot = q % g.ring;
        mbar_wait(&full[slot], (q / g.ring) & 1);
        wg_fence();
        pin_regs(acc);
        const unsigned sa = ring_a + slot * stage_bytes;
#pragma unroll
        for (int i = 0; i < (CONV ? 9 : 1); ++i) {  // conv: the nine taps
          const int t = CONV ? i : t0;
          // conv: tap (dy, dx) starts dx rows into tap row dy; the wgmma
          // unit swizzles by absolute shared-memory address, as TMA does,
          // so a start off the swizzle period needs no base offset
          const unsigned a0 = CONV ? sa + ((i / 3) * kConvRows + i % 3) * KW * 2 : sa;
          const unsigned sb = b_a + (t * g.Kp + c * KW) * 128;
#pragma unroll
          for (int s = 0; s < KW / 16; ++s)
            Wgmma<NT>::template mmaT<TA, 1>(acc, mat_desc_sw(a0 + s * a_step, 16, a_sbo, a_mode),
                                            mat_desc_sw(sb + s * 2048, b_atom, 1024, 1),
                                            q > q0 || i > 0 || s > 0);
        }
        wg_commit();
        pin_regs(acc);
        if (q - q0 >= kLag) {  // the chain kLag back is done with its stage
          wg_wait<kLag>();
          if (threadIdx.x == 0) mbar_arrive(&empty[(q - kLag) % g.ring]);
        }
      }
    wg_wait<0>();
    pin_regs(acc);
    if (threadIdx.x == 0) {
      for (int i = q - kLag > q0 ? q - kLag : q0; i < q; ++i) mbar_arrive(&empty[i % g.ring]);
      bulk_wait_read<0>();  // the last tile's stores have read the output tile
    }
    gemm_consumers_sync();
    // register 4j + 2h + e: row 16 warp + lane / 4 + 8h, column 8j + 2 (lane
    // % 4) + e: 16-byte chunk j % 8 of the row of atom j / 8, swizzled
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(otile + (j / 8) * kAtom + row * 128 +
                                           (((j & 7) ^ (row & 7)) << 4) + 4 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    fence_async_shared();  // the staged tile, visible to the TMA stores
    gemm_consumers_sync();
    if (threadIdx.x == 0) {
      for (int at = 0; at < NA && n0 + 64 * at < g.N; ++at)
        tma_store_4d(&maps.out, otile + at * kAtom, n0 + 64 * at, w0, r, z);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<0>();  // the stores are done before shared memory goes
}

}  // namespace vmg

// x: (slabs' frame, H2, Wp, C) bf16, out: (slabs, R - 2, Wp, C); the caller
// checks the 16-byte rule (Wp * C * 2 and wpiece * C * 2 multiples of 16).
extern "C" int vmg_probe_slab_copy(const void* x, void* out, int Wp, int C, int R,
                                   int slabs, int wpiece, void* stream) {
  if (R < 3 || wpiece < 1 || ((size_t)wpiece * C * 2) % 16 || ((size_t)Wp * C * 2) % 16 ||
      (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * wpiece * C * 2 + (size_t)R * 8;
  if (smem > vmg::kMaxSmem) return (int)cudaErrorInvalidValue;
  const int e = vmg::set_smem(vmg::slab_copy_kernel, smem);
  if (e != 0) return e;
  const dim3 grid((Wp + wpiece - 1) / wpiece, slabs);
  return vmg::launch_pdl(vmg::slab_copy_kernel, grid, dim3(32), smem, stream, (const vmg::bf16*)x,
                         (vmg::bf16*)out, Wp, C, R, wpiece);
}

// in: (A, Bin, Cin), out: (A, Bout, Cout) bf16, 16-byte aligned.  kind 0
// slice (p0 row offset, p1 channel offset), 1 taps (p0 taps), 2 roll (p0
// shift, 0 <= p0 < Cin), 3 tile; rows, threads, stage (bytes) and smem:
// `probes.relayout_plan`'s.  Checked here only that the stage holds the
// largest span a block reads, with relay_vec's room past it, and that smem
// holds the stage, the run table and the mbarrier.
extern "C" int vmg_probe_relayout(const void* in, void* out, int A, int Bin, int Cin,
                                  int Bout, int Cout, int kind, int p0, int p1, int rows,
                                  int threads, int stage, int smem, void* stream) {
  using namespace vmg;
  if (A < 1 || A > 65535 || Bin < 1 || Cin < 1 || Bout < 1 || Cout < 1 || rows < 1 ||
      threads < 32 || threads > kRelayMaxThreads || threads % 32 || (uintptr_t)in % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  long long span;  // input elements a block stages at most
  switch (kind) {
    case 0:
      if (p0 < 0 || p1 < 0 || p0 + Bout > Bin || p1 + Cout > Cin) return (int)cudaErrorInvalidValue;
      span = (long long)(rows - 1) * Cin + Cout;
      break;
    case 1:
      if (p0 < 1 || Cout != p0 * Cin || Bout + p0 - 1 > Bin) return (int)cudaErrorInvalidValue;
      span = (long long)(rows - 1 + p0) * Cin;
      break;
    case 2:
      if (p0 < 0 || p0 >= Cin || Bout != Bin || Cout != Cin) return (int)cudaErrorInvalidValue;
      span = (long long)rows * Cin;
      break;
    case 3:
      if (Cout != Cin) return (int)cudaErrorInvalidValue;
      span = (long long)(rows > Bin || Bin % rows ? Bin : rows) * Cin;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (stage % 16 || stage < 2 * span + 48 || smem > (long long)kMaxSmem ||
      smem < stage + (12LL * rows + 7) / 8 * 8 + 8)
    return (int)cudaErrorInvalidValue;
  const int e = set_smem(relayout_kernel, (size_t)smem);
  if (e != 0) return e;
  const RelayArgs g{(const bf16*)in, (bf16*)out, Bin, Cin, Bout, Cout, kind, p0, p1, rows,
                    (long long)A * Bin * Cin};
  return launch_pdl(relayout_kernel, dim3((Bout + rows - 1) / rows, A), dim3(threads),
                    (size_t)smem, stream, g, stage);
}

// a: the A source in the form's layout; b: (taps, K, N); out: (reps, batch,
// M, N), all bf16.  N % 8 == 0, N <= 192; K, the strides and the channel
// counts multiples of 4 (8-byte A units; M for kind 1).  nt, kw, kbox,
// ring, grid and tma: `probes.gemm_plan`'s, checked here.
extern "C" int vmg_probe_tile_gemm(const void* a, const void* b, void* out, int M, int N,
                                   int K, int taps, int batch, int reps, int kind, int lda,
                                   int tap_stride, int batch_stride, int Wo, int Wx, int Cx,
                                   int cg, int stride, int arows, int nt, int kw, int kbox,
                                   int ring, int grid, int tma, void* stream) {
  using namespace vmg;
  if (N % 8 || N > 192 || M < 1 || K < 1 || taps < 1 || batch < 1 || reps < 1 || kind < 0 ||
      kind > 3 || (uintptr_t)b % 16 || (uintptr_t)a % 8 || (uintptr_t)out % 16 || K % 4 ||
      lda % 4 || tap_stride % 4 || batch_stride % 4 || Cx % 4 || cg % 4 || stride % 4 ||
      (kind == 1 && M % 4) || ((kind == 2 || kind == 3) && (Wo < 1 || M % Wo)) ||
      (kind == 3 && (stride < cg || K != 9 * stride)) || nt < 64 || nt % 64 || nt > 192)
    return (int)cudaErrorInvalidValue;
  // the assembled form as nine conv taps of cg columns, B's tap t at row t * stride
  const long long b_tap = (kind == 3 ? (long long)stride : K) * N * 2;
  if (kind == 3) {
    K = cg;
    taps = 9;
    kind = 2;
  }
  const int R = kind == 2 ? M / Wo : 1, W = kind == 2 ? Wo : M;
  const int wtiles = (W + kGemmMT - 1) / kGemmMT, splits = (N + nt - 1) / nt;
  const int Kp = (K + kw - 1) / kw * kw;
  const long long units = (long long)reps * batch * R * wtiles * splits;
  const bool tma_ok = (uintptr_t)a % 16 == 0 &&
                      (kind == 1   ? M % 8 == 0
                       : kind == 0 ? lda % 8 == 0 && (taps == 1 || tap_stride % lda == 0)
                                   : Cx % 8 == 0);
  if ((kw != 32 && kw != 64) || (kind == 1 && kw != 64) || units > (1LL << 30) ||
      (long long)reps * batch > (1LL << 30) || kbox < 8 || kbox > 256 || kbox % 8 ||
      Kp % kbox || (kbox == Kp && taps > 256) || ring < (tma ? 4 : 5) || ring > kGemmMaxRing ||
      grid < 1 || grid % splits || grid > units || (tma && !tma_ok))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem(taps, Kp, nt, kw, ring, kind == 2);
  if (kind == 2 && taps != 9) return (int)cudaErrorInvalidValue;  // a 3x3 conv
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  GemmMaps maps{};
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  {  // B: (taps, K, N), 64 columns x kbox rows x (all taps where kbox == Kp)
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)taps};
    const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)b_tap};
    const cuuint32_t box[3] = {64, (cuuint32_t)kbox, (cuuint32_t)(kbox == Kp ? taps : 1)};
    int e = bf16_map(&maps.b, b, 3, dims, strides, box, sw128);
    if (e != 0) return e;
  }
  {  // out: (reps * batch, R, W, N), 64 columns x 64 rows of one image row
    const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)W, (cuuint64_t)R,
                                (cuuint64_t)reps * batch};
    const cuuint64_t strides[3] = {(cuuint64_t)N * 2, (cuuint64_t)W * N * 2,
                                   (cuuint64_t)R * W * N * 2};
    const cuuint32_t box[4] = {64, kGemmMT, 1, 1};
    int e = bf16_map(&maps.out, out, 4, dims, strides, box, sw128);
    if (e != 0) return e;
  }
  if (tma) {  // A: 64 rows x kw columns (K-major), or 64 x 64 (cols, MN-major)
    cuuint64_t dims[3], strides[2];
    cuuint32_t box[3] = {(cuuint32_t)kw, kGemmMT, 1};
    if (kind == 1) {
      dims[0] = M, dims[1] = K, dims[2] = batch;
      strides[0] = (cuuint64_t)M * 2, strides[1] = (cuuint64_t)K * M * 2;
      box[0] = 64, box[1] = 64;
    } else if (kind == 0) {
      dims[0] = K, dims[1] = arows, dims[2] = 1;
      strides[0] = (cuuint64_t)lda * 2, strides[1] = (cuuint64_t)arows * lda * 2;
    } else {  // a tap's K channels of 72 pixels of the tap rows (the rest of Cx
              // out of bounds: zeros)
      dims[0] = K, dims[1] = Wx, dims[2] = arows;
      strides[0] = (cuuint64_t)Cx * 2, strides[1] = (cuuint64_t)Wx * Cx * 2;
      box[1] = kConvRows, box[2] = (taps + 2) / 3;
    }
    int e = bf16_map(&maps.a, a, 3, dims, strides, box,
                     kw == 64 ? sw128 : CU_TENSOR_MAP_SWIZZLE_64B);
    if (e != 0) return e;
  }
  const GemmArgs g{(const bf16*)a, M, N, K, taps, batch, (int)units, R, W, wtiles,
                   Kp, kw, Kp / kw, kbox, ring, splits, tma,
                   GemmForm{kind, lda, tap_stride, batch_stride, Wx, Cx}};
  int e = 0;
  // A MN-major ("cols", 64-column stages), or K-major in 64- or 32-column
  // stages of rows or of conv tap rows
  const int form = kind == 1 ? 0 : (kw == 64 ? 1 : 2) + (kind == 2 ? 2 : 0);
#define VMG_GEMM_LAUNCH(W, TA, KW, CONV)                                                  \
  e = set_smem(tile_gemm_wgmma_kernel<W, TA, KW, CONV>, smem);                            \
  if (e == 0)                                                                             \
    e = launch_pdl(tile_gemm_wgmma_kernel<W, TA, KW, CONV>, dim3(grid), dim3(kGemmThreads), \
                   smem, stream, maps, g);
#define VMG_GEMM_NT(W)                                   \
  case W:                                                \
    switch (form) {                                      \
      case 0: VMG_GEMM_LAUNCH(W, 1, 64, 0) break;        \
      case 1: VMG_GEMM_LAUNCH(W, 0, 64, 0) break;        \
      case 2: VMG_GEMM_LAUNCH(W, 0, 32, 0) break;        \
      case 3: VMG_GEMM_LAUNCH(W, 0, 64, 1) break;        \
      default: VMG_GEMM_LAUNCH(W, 0, 32, 1) break;       \
    }                                                    \
    break;
  switch (nt) {  // the compiled widths: probes.GEMM_WIDTHS
    VMG_GEMM_NT(64)
    VMG_GEMM_NT(128)
    VMG_GEMM_NT(192)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VMG_GEMM_NT
#undef VMG_GEMM_LAUNCH
  return e;
}
