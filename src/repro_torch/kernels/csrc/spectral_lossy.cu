// The spectral lossy codec's device kernels for Hopper (sm_90a): the DCT
// with its coarse or its flat histogram, the refine histogram, the
// threshold quantiser, and the dequantise + inverse DCT of restore.
//
// Replaces, in src/repro/kernels/spectral_lossy.py (the Pallas TPU kernels):
//   dct_hist_coarse_tiled  <- _dct_hist_coarse_tiled_kernel  (dct_hist_coarse_tiled)
//   hist_refine_tiled      <- _hist_refine_tiled_kernel      (hist_refine_tiled)
//   dct_hist_coarse        <- _dct_hist_coarse_kernel        (dct_hist_coarse)
//   hist_refine            <- _hist_refine_kernel            (hist_refine)
//   dct_hist_tiled         <- _dct_hist_tiled_kernel         (dct_hist_tiled)
//   dct_hist               <- _dct_hist_kernel               (dct_hist)
//   threshold_quant        <- _threshold_quant_kernel        (threshold_quant)
//   dequant_idct           <- _dequant_idct_kernel           (dequant_idct)
//
// What each computes (BLOCK = 256 elements per row, D the orthonormal
// 256-point DCT-II matrix, bin(a) the flat 512-bin index of
// kernels/ref.py::bin_index, tiles of 8 rows):
//   dct_hist_coarse_tiled  y = x . D^T; per tile, for the 32 coarse bins
//                          bin(|y|) / 16: the count and sum of |y|^2
//   hist_refine_tiled      per tile, for the 16 fine bins inside each row's
//                          coarse bin: the count and sum of |y|^2 (other
//                          elements add nothing)
//   dct_hist_coarse,       the same two, with the tile rows summed into ONE
//   hist_refine            histogram of the whole tensor (the single-tensor
//                          codec's selection statistics)
//   dct_hist_tiled         y = x . D^T; per tile, for the 512 flat bins
//                          bin(|y|): the count and sum of |y|^2
//   dct_hist               the same, summed into ONE 512-bin histogram (the
//                          flat selector, the baseline the two-level pair
//                          is measured against)
//   threshold_quant        kept = |y| >= t_row ? y : 0; scale = amax *
//                          f32(1/127) (1 for an all-zero row);
//                          q = clip(rint(kept / scale), -127, 127)
//   dequant_idct           x = (q * scale_row) . D
//
// Bounds on this card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s f32 FMA outside
// the tensor cores; TF32 is not allowed for this codec; the counts are
// repro_torch/roofline/kernels.py::kernel_cost):
//   the DCT kernels (with any histogram) and the inverse are bound by
//   operations: 512 flops per element (a 256-long dot product) against 8
//   bytes moved (f32 in and out), about 64 flops per byte where the card
//   balances at 20. dct_hist_tiled's rows add 4 KB per 8 rows (half the
//   bytes of y), which leaves it bound by operations. The refine
//   histogram and the quantiser read 4 bytes per element and do a log2 or
//   a divide on it: bound by bytes.
//
// Design (a first, simple one; right before fast):
//   * DCT kernels: one CTA of 256 threads per 64 rows. The CTA's rows sit
//     transposed in shared memory (68 KB); D cannot (256 KB against 227
//     KB per block), so it streams through in panels of 32 rows of the
//     basis (32 KB), each read once per CTA from L2 (D is 256 KB, resident
//     there). Every thread owns an 8 x 8 block of outputs in registers and
//     runs the classic outer-product loop: two float4 reads of the row
//     tile and two of the panel feed 64 FFMAs. Every output is one
//     sequential f32 FMA chain over k = 0..255: no TF32, no split sums.
//     The coarse kernels run this body (dct_rows) and the flat pair its
//     pipelined twin (dct_rows_pipe), with the same chain per output, so
//     every forward-DCT kernel gives the same y bits for the same input.
//   * Coarse histogram: the rows a thread owns are one 8-row tile. After
//     the product each thread bins its 64 outputs into a private column of
//     a shared-memory table (the row tile's space, reused), and one thread
//     per (tile, bin) sums the 32 columns of its tile in a fixed order and
//     writes the tile's row. No atomics anywhere: a run is deterministic,
//     as the TPU's in-order grid was.
//   * Flat pair: its own product body (dct_rows_pipe: the same
//     arithmetic, D's panels double-buffered by cp.async so that the copy
//     of the next 16 basis rows overlaps the FFMAs of this one). Private
//     columns of 512 bins would take 1 MiB per CTA, so each thread bins
//     its 64 outputs straight from registers into its tile's bins in
//     shared memory with u32 atomic adds, which are exact and so give the
//     same bits in any order: a bin's |y|^2 are integer multiples of one
//     unit (see flat_base for the bound), summed as integers and rounded
//     once, so energies of bins 1..510 equal the plain version's f64 sums
//     bit for bit. Bins 0 and 511 take the coarse kernel's fixed-order
//     columns. dct_hist runs persistent CTAs over fixed ranges of row
//     groups, each with one 512-bin row in shared memory, and writes no
//     tile rows.
//   * Refine: one warp per 8-row tile (2048 elements, 64 per lane),
//     private per-lane bins in shared memory, then the same fixed-order
//     sum. Quantiser: one warp per row, a warp max for amax.
//   * Single-tensor histograms: the TPU kernel carries one histogram from
//     grid step to grid step; CTAs here run in no order. The coarse and
//     refine kernels write their tile rows into scratch and one CTA of
//     1024 threads sums them in a fixed order: counts as 64-bit integers,
//     energies in double, rounded once. The flat one (512 bins) sums in
//     its persistent CTAs, then adds their range rows in a fixed order. No
//     float atomics anywhere.
//   * Ragged edges are masked in the kernels: rows past n_blocks read as
//     zero and are never written, which is what the JAX wrappers' zero pad
//     and slice amount to.
//
// Arithmetic kept identical to the plain versions (kernels/ref.py):
// log2f (not __log2f), the f32 bin scale passed in by the wrapper, a
// truncating float->int conversion then a clamp, the coarse bin as the
// flat bin / 16, |y|^2 rounded before it is summed, the scale as a product
// with the f32 reciprocal of 127, IEEE division (nvcc's default
// -prec-div=true) and rintf (round half to even, not roundf) for q. Built without
// --use_fast_math and without --ftz: 1e-38 (bin_index's floor) is itself a
// subnormal in f32, and energies of 1e-20-scaled payloads are subnormal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;            // elements per spectral block (row)
constexpr int kTile = 8;               // rows per histogram tile
constexpr int kCoarse = 32;            // coarse bins
constexpr int kFine = 16;              // fine bins per coarse bin
constexpr int kNbins = 512;
// scale = amax * f32(1/127): the JAX package's compiled arithmetic (XLA
// rewrites its ``amax / 127.0`` so), kept so that frames stay identical
constexpr float kInv127 = 1.f / 127.f;

constexpr int kRows = 64;              // rows per CTA in the DCT kernels
constexpr int kPanel = 32;             // basis rows staged per panel
constexpr int kXs = kRows + 4;         // padded stride of the transposed tile
constexpr int kThreads = 256;
constexpr int kHs = kThreads + 1;      // padded stride of the private bins
constexpr size_t kTileBytes = (size_t)kBlock * kXs * sizeof(float);
constexpr size_t kPanelBytes = (size_t)kPanel * kBlock * sizeof(float);
constexpr size_t kDctSmem = kTileBytes + kPanelBytes;
static_assert(2 * kCoarse * kHs * sizeof(float) <= kTileBytes,
              "private coarse bins must fit in the row tile's space");

__device__ __forceinline__ int bin_index(float a, float bin_scale) {
  const float lg = a > 0.f ? log2f(fmaxf(a, 1e-38f)) : -40.f;
  const int i = (int)(__fmul_rn(__fadd_rn(lg, 40.f), bin_scale));
  return min(max(i, 0), kNbins - 1);
}

// Thread layout of the DCT kernels: 8 warps as 2 (rows) x 4 (columns);
// inside a warp 4 x 8 threads. Thread (tr, tc) owns rows tr*8 .. tr*8+7 of
// the CTA (histogram tile tr) and columns c0 .. c0+3, c0+128 .. c0+131.
struct Owner {
  int tr, c0;
  __device__ Owner() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    tr = (warp >> 2) * 4 + (lane >> 3);
    c0 = (warp & 3) * 32 + (lane & 7) * 4;
  }
};

// acc[i][j] = sum_k a[tr*8+i][k] * m[k][col(j)] over k = 0..255, with the
// CTA's A tile already transposed in xs (xs[k*kXs + r]).
__device__ __forceinline__ void gemm_rows(const float* xs, float* panel,
                                          const float* __restrict__ m,
                                          const Owner& o, float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kBlock; k0 += kPanel) {
    __syncthreads();  // the A tile is written / the last panel is consumed
    const float4* src = reinterpret_cast<const float4*>(m + (size_t)k0 * kBlock);
    float4* dst = reinterpret_cast<float4*>(panel);
#pragma unroll
    for (int i = 0; i < kPanel * kBlock / 4 / kThreads; ++i)
      dst[threadIdx.x + i * kThreads] = src[threadIdx.x + i * kThreads];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kPanel; ++kk) {
      const float* ar = xs + (k0 + kk) * kXs + o.tr * 8;
      const float* br = panel + kk * kBlock + o.c0;
      const float4 a0 = *reinterpret_cast<const float4*>(ar);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 128);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Lane mapping of the A-tile loads (f = 0 .. kRows*kBlock/4 - 1, one
// 4-element slot each): 8 lanes read contiguous slots of a row, a warp
// covers 4 rows per access, so the transposed shared-memory writes spread
// over 8 banks (4-way conflicts on a load that runs once per CTA).
__device__ __forceinline__ void tile_slot(int f, int& r, int& k4) {
  const int l = f & 31, g = f >> 5;
  r = (g >> 3) * 4 + (l >> 3);
  k4 = ((g & 7) * 8 + (l & 7)) * 4;
}

// y = x . D^T for the CTA's kRows rows (rows past nb read as zero): the
// thread's 8 x 8 outputs stay in acc, and those of live rows are written
// to y. Every kernel that computes the forward DCT runs this body or
// dct_rows_pipe (the same FMA chain per output), so all of them give the
// same bits for the same input. Returns whether the
// thread's 8-row tile is live (nb is a multiple of kTile).
__device__ __forceinline__ bool dct_rows(const float* __restrict__ x,
                                         const float* __restrict__ dt,
                                         float* __restrict__ y, int nb,
                                         float* xs, float* panel,
                                         const Owner& o, float acc[8][8]) {
  const long row0 = (long)blockIdx.x * kRows;
  for (int f = threadIdx.x; f < kRows * kBlock / 4; f += kThreads) {
    int r, k4;
    tile_slot(f, r, k4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nb)
      v = *reinterpret_cast<const float4*>(x + (row0 + r) * kBlock + k4);
    xs[(k4 + 0) * kXs + r] = v.x;
    xs[(k4 + 1) * kXs + r] = v.y;
    xs[(k4 + 2) * kXs + r] = v.z;
    xs[(k4 + 3) * kXs + r] = v.w;
  }
  gemm_rows(xs, panel, dt, o, acc);

  const bool live = row0 + o.tr * 8 < nb;
  if (live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* yr = y + (row0 + o.tr * 8 + i) * kBlock;
      *reinterpret_cast<float4*>(yr + o.c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(yr + o.c0 + 128) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  return live;
}

__global__ void __launch_bounds__(kThreads, 2)
dct_hist_coarse_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,   // D^T, row-major
                       float* __restrict__ y, float* __restrict__ cnt,
                       float* __restrict__ eng, int nb, float bin_scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* panel = xs + kTileBytes / sizeof(float);
  const long row0 = (long)blockIdx.x * kRows;
  const Owner o;
  float acc[8][8];
  const bool live = dct_rows(x, dt, y, nb, xs, panel, o, acc);
  // private (count, energy) columns, in the row tile's space
  __syncthreads();
  float* hc = xs;
  float* he = xs + kCoarse * kHs;
  const int tid = threadIdx.x;
#pragma unroll
  for (int b = 0; b < kCoarse; ++b) {
    hc[b * kHs + tid] = 0.f;
    he[b * kHs + tid] = 0.f;
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = fabsf(acc[i][j]);
        const int b = bin_index(a, bin_scale) >> 4;
        hc[b * kHs + tid] += 1.f;
        he[b * kHs + tid] = __fadd_rn(he[b * kHs + tid], __fmul_rn(a, a));
      }
  }
  __syncthreads();
  // one thread per (tile, bin): sum the tile's 32 owner columns in order
  const int t = tid >> 5, b = tid & 31;
  const long tile = blockIdx.x * (long)(kRows / kTile) + t;
  if (row0 + t * kTile < nb) {
    float c = 0.f, e = 0.f;
    for (int tc = 0; tc < 32; ++tc) {
      const int src = (((t >> 2) * 4 + (tc >> 3)) << 5) + (t & 3) * 8 + (tc & 7);
      c += hc[b * kHs + src];
      e = __fadd_rn(e, he[b * kHs + src]);
    }
    cnt[tile * kCoarse + b] = c;
    eng[tile * kCoarse + b] = e;
  }
}

// ---------------------------------------------------------------------------
// The flat 512-bin pair (dct_hist_tiled, dct_hist): its own product body,
// its exact binning from registers, and the two kernels built on them.
// ---------------------------------------------------------------------------

// The product body of the flat pair. gemm_rows' arithmetic (each output
// one sequential f32 FMA chain over k = 0..255, so y is the same bits),
// with D's rows streamed through two 16-row stages by cp.async: the copy
// of panel p + 1 is in flight while panel p is consumed, one barrier per
// panel. Kernels 2, 5 and 6 still run gemm_rows; the smoke holds the two
// bodies to the same y bit for bit.
constexpr int kPipePanel = 16;                     // basis rows per stage
constexpr int kPanels = kBlock / kPipePanel;
constexpr int kStageFloats = kPipePanel * kBlock;  // 16 KB
constexpr size_t kFlatSmem = kTileBytes + 2 * kStageFloats * sizeof(float);

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Basis rows k0 .. k0 + kPipePanel - 1 of m into a stage, as one group.
__device__ __forceinline__ void issue_panel(float* stage,
                                            const float* __restrict__ m,
                                            int k0) {
  const float4* src = reinterpret_cast<const float4*>(m + (size_t)k0 * kBlock);
  float4* dst = reinterpret_cast<float4*>(stage);
#pragma unroll
  for (int i = 0; i < kStageFloats / 4 / kThreads; ++i)
    cp_async16(dst + threadIdx.x + i * kThreads, src + threadIdx.x + i * kThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// acc = A . m as gemm_rows computes it; the caller has issued panel 0
// into stage 0 and written the transposed A tile into xs.
__device__ __forceinline__ void gemm_rows_pipe(const float* xs, float* stages,
                                               const float* __restrict__ m,
                                               const Owner& o,
                                               float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < kPanels; ++p) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // panel p (and the A tile) is visible to all; every thread is done
    // with panel p - 1, whose stage the next copy overwrites
    __syncthreads();
    if (p + 1 < kPanels)
      issue_panel(stages + ((p + 1) & 1) * kStageFloats, m,
                  (p + 1) * kPipePanel);
    const float* panel = stages + (p & 1) * kStageFloats;
    // the whole panel unrolled (by 4 only, ptxas scheduled the range
    // kernel's loop visibly slower on the H100)
#pragma unroll
    for (int kk = 0; kk < kPipePanel; ++kk) {
      const float* ar = xs + (p * kPipePanel + kk) * kXs + o.tr * 8;
      const float* br = panel + kk * kBlock + o.c0;
      const float4 a0 = *reinterpret_cast<const float4*>(ar);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 128);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// dct_rows for the kRows rows from row0, through gemm_rows_pipe: the first
// panel's copy overlaps the load of the row tile.
__device__ __forceinline__ bool dct_rows_pipe(const float* __restrict__ x,
                                              const float* __restrict__ dt,
                                              float* __restrict__ y, int nb,
                                              long row0, float* xs,
                                              float* stages, const Owner& o,
                                              float acc[8][8]) {
  issue_panel(stages, dt, 0);
#pragma unroll 4
  for (int f = threadIdx.x; f < kRows * kBlock / 4; f += kThreads) {
    int r, k4;
    tile_slot(f, r, k4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nb)
      v = *reinterpret_cast<const float4*>(x + (row0 + r) * kBlock + k4);
    xs[(k4 + 0) * kXs + r] = v.x;
    xs[(k4 + 1) * kXs + r] = v.y;
    xs[(k4 + 2) * kXs + r] = v.z;
    xs[(k4 + 3) * kXs + r] = v.w;
  }
  gemm_rows_pipe(xs, stages, dt, o, acc);
  const bool live = row0 + o.tr * 8 < nb;
  if (live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* yr = y + (row0 + o.tr * 8 + i) * kBlock;
      *reinterpret_cast<float4*>(yr + o.c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(yr + o.c0 + 128) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  return live;
}

// Exact, order-free energies of the flat bins 1..510.
//
// bin_index puts a in bin b when trunc((log2 a + 40) * 6.4) = b, so a bin
// spans 80/512 = 5/32 octaves of |y| and 5/16 of |y|^2: a^2 of bin b lies
// in [2^(5b/16 - 80), 2^(5(b+1)/16 - 80)). Write the f32 a^2 = m * 2^(e-23)
// with m its 24-bit significand. Then e is floor(5b/16) - 80 or one more;
// allowing one binade less for log2f's rounding at the low edge, e - E_b
// lies in [0, 2] with the bin's base E_b = floor(5b/16) - 81. So every
// square of bin b is an integer count of units 2^(E_b - 23), m << (e -
// E_b), below 2^26 units (tests/test_torch_flat_exact.py checks both
// edges of every bin, and one ulp either side, against this).
//
// Integer sums are exact in any order, so lanes add into a tile's bin
// with shared-memory atomics and the bits are the same in every run. The
// sum goes into two u32 words (u32 is the one shared atomic add the card
// has: u64, f32 and f64 compile to CAS loops): lo = the units' low 20
// bits, hi = (count << 20) + the units' high bits (< 2^6). A tile holds
// kTile * kBlock = 2048 elements, so lo < 2^11 * 2^20 = 2^31, the high
// sum < 2^17 stays below bit 20, and count << 20 <= 2^31: no word can
// carry out. Bins 0 (zeros and subnormal squares) and 511 (up to inf)
// have no such span and take the coarse kernel's fixed order instead.
//
// dct_hist's ranges add the tiles' exact sums into u64 units: exact while
// a histogram counts fewer than kMaxFlatCount = 2^37 elements (2^37 *
// 2^26 < 2^64), which spectral_dct_hist checks.
constexpr int kLoBits = 20;
constexpr unsigned kLoMask = (1u << kLoBits) - 1u;
constexpr long long kMaxFlatCount = 1ll << 37;
constexpr int kTiles = kRows / kTile;              // tiles per CTA
constexpr int kWords = kTiles * kNbins;            // u32 words per kind
static_assert(kTile * kBlock <= (1 << (32 - kLoBits - 1)),
              "a tile's count must fit above the low bits of its hi word");
static_assert((2 * kWords + 4 * kHs + 4 * kTiles) * sizeof(float) <=
                  kTileBytes,
              "the flat words must fit in the row tile's space");

__device__ __forceinline__ int flat_base(int b) { return ((5 * b) >> 4) - 81; }

__device__ __forceinline__ unsigned flat_units(float a2, int b) {
  const unsigned u = __float_as_uint(a2);
  return ((u & 0x7fffffu) | 0x800000u) << ((int)(u >> 23) - 127 - flat_base(b));
}

// An exact sum of bin b's units as f32: rounded once, then scaled by the
// unit (a power of two, exact: the result is at least 2^-81, below 2^120).
__device__ __forceinline__ float flat_energy(unsigned long long s, int b) {
  return __fmul_rn(__ull2float_rn(s),
                   __uint_as_float((unsigned)(flat_base(b) - 23 + 127) << 23));
}

// The row tile's space after the product: per tile t, the words lo[t][b]
// and hi[t][b]; per thread, its (count, energy) of bins 0 and 511 (sp);
// per tile, those summed over its 32 owners (sres[t] = c0, e0, c511, e511).
struct FlatWords {
  unsigned* lo;
  unsigned* hi;
  float* sp;
  float* sres;
  __device__ explicit FlatWords(float* xs)
      : lo(reinterpret_cast<unsigned*>(xs)), hi(lo + kWords),
        sp(xs + 2 * kWords), sres(sp + 4 * kHs) {}
};

// Bin the thread's 64 outputs (tile o.tr) into the CTA's words. Starts and
// ends with a barrier.
__device__ __forceinline__ void bin_flat(float acc[8][8], bool live,
                                         float bin_scale, const FlatWords& w,
                                         const Owner& o) {
  const int tid = threadIdx.x;
  __syncthreads();  // every thread is done with the row tile and the stages
  uint4* z = reinterpret_cast<uint4*>(w.lo);
  for (int i = tid; i < 2 * kWords / 4; i += kThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  float c0 = 0.f, e0 = 0.f, c1 = 0.f, e1 = 0.f;
  if (live) {
    unsigned* lo = w.lo + o.tr * kNbins;
    unsigned* hi = w.hi + o.tr * kNbins;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = fabsf(acc[i][j]);
        const int b = bin_index(a, bin_scale);
        const float a2 = __fmul_rn(a, a);
        if (b == 0) {
          c0 += 1.f;
          e0 = __fadd_rn(e0, a2);
        } else if (b == kNbins - 1) {
          c1 += 1.f;
          e1 = __fadd_rn(e1, a2);
        } else {
          const unsigned u = flat_units(a2, b);
          atomicAdd(lo + b, u & kLoMask);
          atomicAdd(hi + b, (1u << kLoBits) | (u >> kLoBits));
        }
      }
  }
  w.sp[0 * kHs + tid] = c0;
  w.sp[1 * kHs + tid] = e0;
  w.sp[2 * kHs + tid] = c1;
  w.sp[3 * kHs + tid] = e1;
  __syncthreads();
  // one thread per (tile, bin 0 or 511): its 32 owners in column order
  if (tid < 2 * kTiles) {
    const int t = tid >> 1, k = (tid & 1) * 2;
    float c = 0.f, e = 0.f;
    for (int tc = 0; tc < 32; ++tc) {
      const int src = (((t >> 2) * 4 + (tc >> 3)) << 5) + (t & 3) * 8 + (tc & 7);
      c += w.sp[k * kHs + src];
      e = __fadd_rn(e, w.sp[(k + 1) * kHs + src]);
    }
    w.sres[t * 4 + k] = c;
    w.sres[t * 4 + k + 1] = e;
  }
  __syncthreads();
}

// dct_hist_tiled: one CTA per 64 rows; each live tile's 512-bin row.
__global__ void __launch_bounds__(kThreads, 2)
dct_flat_tiled_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,   // D^T, row-major
                      float* __restrict__ y, float* __restrict__ cnt,
                      float* __restrict__ eng, int nb, float bin_scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* stages = xs + kTileBytes / sizeof(float);
  const long row0 = (long)blockIdx.x * kRows;
  const Owner o;
  float acc[8][8];
  const bool live = dct_rows_pipe(x, dt, y, nb, row0, xs, stages, o, acc);
  const FlatWords w(xs);
  bin_flat(acc, live, bin_scale, w, o);
  const long tile0 = row0 / kTile;
  for (int idx = threadIdx.x; idx < kWords; idx += kThreads) {
    const int t = idx / kNbins, b = idx % kNbins;
    if (row0 + t * kTile >= nb) break;   // t only grows with idx
    float c, e;
    if (b == 0 || b == kNbins - 1) {
      const int k = b ? 2 : 0;
      c = w.sres[t * 4 + k];
      e = w.sres[t * 4 + k + 1];
    } else {
      const unsigned h = w.hi[idx];
      c = (float)(h >> kLoBits);
      e = flat_energy(((unsigned long long)(h & kLoMask) << kLoBits) + w.lo[idx], b);
    }
    cnt[(tile0 + t) * kNbins + b] = c;
    eng[(tile0 + t) * kNbins + b] = e;
  }
}

// dct_hist: CTA g runs the 64-row groups [g * per, (g + 1) * per) in
// order and keeps one 512-bin row for the range in shared memory, each
// bin owned by one thread: counts and the exact units of bins 1..510 as
// u64, bins 0 and 511 as double sums of the tiles' fixed-order f32 sums
// in tile order. It writes the range's row to the partial rows, which
// flat_total_kernel sums in a fixed order. per depends on n_blocks alone.
constexpr int kMaxParts = 264;   // 2 CTAs on each of an H100's 132 SMs
constexpr size_t kRangeSmem = kFlatSmem + 2 * kNbins * sizeof(unsigned long long);

__global__ void __launch_bounds__(kThreads, 2)
dct_flat_range_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,   // D^T, row-major
                      float* __restrict__ y,
                      unsigned long long* __restrict__ part_c,
                      unsigned long long* __restrict__ part_e, int nb,
                      long per, float bin_scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* stages = xs + kTileBytes / sizeof(float);
  unsigned long long* sum_c =
      reinterpret_cast<unsigned long long*>(stages + 2 * kStageFloats);
  unsigned long long* sum_e = sum_c + kNbins;
  const Owner o;
  const FlatWords w(xs);
  const int tid = threadIdx.x;
  for (int b = tid; b < kNbins; b += kThreads) sum_c[b] = sum_e[b] = 0ull;
  const long n_groups = (nb + kRows - 1) / kRows;
  const long g0 = blockIdx.x * per;
  const long g1 = g0 + per < n_groups ? g0 + per : n_groups;
  float acc[8][8];
  for (long g = g0; g < g1; ++g) {
    const long row0 = g * kRows;
    __syncthreads();  // the last group's sums are done with the row tile
    const bool live = dct_rows_pipe(x, dt, y, nb, row0, xs, stages, o, acc);
    bin_flat(acc, live, bin_scale, w, o);
    for (int b = tid; b < kNbins; b += kThreads) {
      unsigned long long c = sum_c[b], e = sum_e[b];
      for (int t = 0; t < kTiles && row0 + t * kTile < nb; ++t) {
        if (b == 0 || b == kNbins - 1) {
          const int k = b ? 2 : 0;
          c += (unsigned long long)w.sres[t * 4 + k];
          e = (unsigned long long)__double_as_longlong(
              __longlong_as_double((long long)e) + (double)w.sres[t * 4 + k + 1]);
        } else {
          const unsigned h = w.hi[t * kNbins + b];
          c += h >> kLoBits;
          e += ((unsigned long long)(h & kLoMask) << kLoBits) + w.lo[t * kNbins + b];
        }
      }
      sum_c[b] = c;
      sum_e[b] = e;
    }
  }
  for (int b = tid; b < kNbins; b += kThreads) {
    part_c[blockIdx.x * kNbins + b] = sum_c[b];
    part_e[blockIdx.x * kNbins + b] = sum_e[b];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
dequant_idct_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    const float* __restrict__ d,        // D, row-major
                    float* __restrict__ x, int nb) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* panel = xs + kTileBytes / sizeof(float);
  const long row0 = (long)blockIdx.x * kRows;
  for (int f = threadIdx.x; f < kRows * kBlock / 4; f += kThreads) {
    int r, k4;
    tile_slot(f, r, k4);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < nb) {
      const char4 c = *reinterpret_cast<const char4*>(q + (row0 + r) * kBlock + k4);
      const float s = scale[row0 + r];
      v[0] = __fmul_rn((float)c.x, s);
      v[1] = __fmul_rn((float)c.y, s);
      v[2] = __fmul_rn((float)c.z, s);
      v[3] = __fmul_rn((float)c.w, s);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[(k4 + j) * kXs + r] = v[j];
  }
  const Owner o;
  float acc[8][8];
  gemm_rows(xs, panel, d, o, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = row0 + o.tr * 8 + i;
    if (row >= nb) break;
    float* xr = x + row * kBlock;
    *reinterpret_cast<float4*>(xr + o.c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(xr + o.c0 + 128) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// One warp per 8-row tile; lane l reads the float4s l, l+32, ... of the
// tile (coalesced) and bins them into its private column.
constexpr int kRefineWarps = 8;
constexpr int kRefineThreads = kRefineWarps * 32;
constexpr int kRs = kRefineThreads + 1;

__global__ void __launch_bounds__(kRefineThreads)
hist_refine_kernel(const float* __restrict__ y,
                   const int* __restrict__ coarse, float* __restrict__ cnt,
                   float* __restrict__ eng, int n_tiles, float bin_scale) {
  __shared__ float hc[kFine * kRs];
  __shared__ float he[kFine * kRs];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int b = 0; b < kFine; ++b) {
    hc[b * kRs + tid] = 0.f;
    he[b * kRs + tid] = 0.f;
  }
  const long tile = (long)blockIdx.x * kRefineWarps + warp;
  if (tile < n_tiles) {
    const float* yt = y + tile * kTile * kBlock;
    const int* ct = coarse + tile * kTile;
#pragma unroll 4
    for (int f = lane; f < kTile * kBlock / 4; f += 32) {
      const int c = ct[f / (kBlock / 4)];
      const float4 v = *reinterpret_cast<const float4*>(yt + f * 4);
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = fabsf(vs[j]);
        const int idx = bin_index(a, bin_scale);
        if ((idx >> 4) == c) {
          const int k = idx - c * kFine;
          hc[k * kRs + tid] += 1.f;
          he[k * kRs + tid] = __fadd_rn(he[k * kRs + tid], __fmul_rn(a, a));
        }
      }
    }
  }
  __syncwarp();
  if (tile < n_tiles && lane < kFine) {
    float c = 0.f, e = 0.f;
    for (int l = 0; l < 32; ++l) {
      c += hc[lane * kRs + warp * 32 + l];
      e = __fadd_rn(e, he[lane * kRs + warp * 32 + l]);
    }
    cnt[tile * kFine + lane] = c;
    eng[tile * kFine + lane] = e;
  }
}

// One warp per row: lane l holds elements 8l .. 8l+7.
constexpr int kQuantWarps = 8;

__global__ void __launch_bounds__(kQuantWarps * 32)
threshold_quant_kernel(const float* __restrict__ y,
                       const float* __restrict__ t, int8_t* __restrict__ q,
                       float* __restrict__ scale, int nb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kQuantWarps + warp;
  if (row >= nb) return;
  const float* yr = y + row * kBlock + lane * 8;
  const float4 v0 = *reinterpret_cast<const float4*>(yr);
  const float4 v1 = *reinterpret_cast<const float4*>(yr + 4);
  const float th = t[row];
  float kept[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    kept[j] = fabsf(kept[j]) >= th ? kept[j] : 0.f;
    amax = fmaxf(amax, fabsf(kept[j]));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  char4 out[2];
  signed char* o = reinterpret_cast<signed char*>(out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float r = rintf(__fdiv_rn(kept[j], s));
    o[j] = (signed char)fminf(fmaxf(r, -127.f), 127.f);
  }
  *reinterpret_cast<uint2*>(q + row * kBlock + lane * 8) =
      *reinterpret_cast<const uint2*>(out);
  if (lane == 0) scale[row] = s;
}

// One histogram row from n_rows per-tile rows of NB bins, summed in an
// order fixed by n_rows alone: thread t takes bin t % NB of rows t / NB,
// t / NB + G, ... (G = 1024 / NB; a warp reads whole rows, coalesced),
// then one thread per bin adds the G partial sums in order. Counts are
// exact integers (a tile counts at most 2048); energies are summed in
// double and rounded once.
constexpr int kReduceThreads = 1024;

template <int NB>
__global__ void __launch_bounds__(kReduceThreads)
reduce_rows_kernel(const float* __restrict__ cnt_rows,
                   const float* __restrict__ eng_rows, long n_rows,
                   float* __restrict__ cnt, float* __restrict__ eng) {
  constexpr int kG = kReduceThreads / NB;
  __shared__ long long sc[kReduceThreads];
  __shared__ double se[kReduceThreads];
  const int t = threadIdx.x, b = t % NB, g = t / NB;
  long long c = 0;
  double e = 0.0;
  for (long r = g; r < n_rows; r += kG) {
    c += (long long)cnt_rows[r * NB + b];
    e += (double)eng_rows[r * NB + b];
  }
  sc[t] = c;
  se[t] = e;
  __syncthreads();
  if (g == 0) {
    for (int k = 1; k < kG; ++k) {
      c += sc[k * NB + b];
      e += se[k * NB + b];
    }
    cnt[b] = (float)c;
    eng[b] = (float)e;
  }
}

// The flat single histogram from dct_flat_range_kernel's partial rows.
// CTA k takes 32 bins; its thread (slice s, bin) adds rows s, s + 16, ...
// (a warp reads 32 bins of a row, coalesced) and the first slice adds the
// 16 slice sums in order: counts and the exact units of bins 1..510 as
// u64 (rounded once by flat_energy), bins 0 and 511 in double, rounded
// once. The order depends on n_parts alone. (One CTA over all rows took
// tens of microseconds: one SM's share of the card's bandwidth.)
constexpr int kTotalBins = 32;
constexpr int kTotalSlices = 16;

__global__ void __launch_bounds__(kTotalBins * kTotalSlices)
flat_total_kernel(const unsigned long long* __restrict__ part_c,
                  const unsigned long long* __restrict__ part_e, int n_parts,
                  float* __restrict__ cnt, float* __restrict__ eng) {
  __shared__ unsigned long long sc[kTotalSlices][kTotalBins];
  __shared__ unsigned long long se[kTotalSlices][kTotalBins];
  const int i = threadIdx.x % kTotalBins, s = threadIdx.x / kTotalBins;
  const int b = blockIdx.x * kTotalBins + i;
  const bool edge = b == 0 || b == kNbins - 1;
  unsigned long long c = 0, u = 0;
  double d = 0.0;
  for (int g = s; g < n_parts; g += kTotalSlices) {
    c += part_c[g * kNbins + b];
    if (edge)
      d += __longlong_as_double((long long)part_e[g * kNbins + b]);
    else
      u += part_e[g * kNbins + b];
  }
  sc[s][i] = c;
  se[s][i] = edge ? (unsigned long long)__double_as_longlong(d) : u;
  __syncthreads();
  if (s != 0) return;
  for (int k = 1; k < kTotalSlices; ++k) {
    c += sc[k][i];
    if (edge)
      d += __longlong_as_double((long long)se[k][i]);
    else
      u += se[k][i];
  }
  cnt[b] = __ull2float_rn(c);
  eng[b] = edge ? (float)d : flat_energy(u, b);
}

}  // namespace

extern "C" {

// Every entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the launch (0 when n_blocks is 0).

size_t spectral_dct_smem_bytes() { return kDctSmem; }

int spectral_dct_hist_coarse_tiled(const float* x, const float* dt, float* y,
                                   float* cnt, float* eng, int nb,
                                   float bin_scale, void* stream) {
  if (nb <= 0) return 0;
  cudaFuncSetAttribute(dct_hist_coarse_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kDctSmem);
  const int grid = (nb + kRows - 1) / kRows;
  dct_hist_coarse_kernel<<<grid, kThreads, kDctSmem, (cudaStream_t)stream>>>(
      x, dt, y, cnt, eng, nb, bin_scale);
  return (int)cudaGetLastError();
}

int spectral_hist_refine_tiled(const float* y, const int* coarse, float* cnt,
                               float* eng, int nb, float bin_scale,
                               void* stream) {
  if (nb <= 0) return 0;
  const int n_tiles = nb / kTile;
  const int grid = (n_tiles + kRefineWarps - 1) / kRefineWarps;
  hist_refine_kernel<<<grid, kRefineThreads, 0, (cudaStream_t)stream>>>(
      y, coarse, cnt, eng, n_tiles, bin_scale);
  return (int)cudaGetLastError();
}

// The single-tensor pair: the tiled kernel into the caller's scratch rows
// (n_blocks / 8 of them), then their fixed-order sum into cnt and eng (all
// zero for n_blocks = 0).
int spectral_dct_hist_coarse(const float* x, const float* dt, float* y,
                             float* cnt_rows, float* eng_rows, float* cnt,
                             float* eng, int nb, float bin_scale,
                             void* stream) {
  const int err = spectral_dct_hist_coarse_tiled(x, dt, y, cnt_rows, eng_rows,
                                                 nb, bin_scale, stream);
  if (err != 0) return err;
  reduce_rows_kernel<kCoarse><<<1, kReduceThreads, 0, (cudaStream_t)stream>>>(
      cnt_rows, eng_rows, nb > 0 ? nb / kTile : 0, cnt, eng);
  return (int)cudaGetLastError();
}

int spectral_hist_refine(const float* y, const int* coarse, float* cnt_rows,
                         float* eng_rows, float* cnt, float* eng, int nb,
                         float bin_scale, void* stream) {
  const int err = spectral_hist_refine_tiled(y, coarse, cnt_rows, eng_rows, nb,
                                             bin_scale, stream);
  if (err != 0) return err;
  reduce_rows_kernel<kFine><<<1, kReduceThreads, 0, (cudaStream_t)stream>>>(
      cnt_rows, eng_rows, nb > 0 ? nb / kTile : 0, cnt, eng);
  return (int)cudaGetLastError();
}

int spectral_dct_hist_tiled(const float* x, const float* dt, float* y,
                            float* cnt, float* eng, int nb, float bin_scale,
                            void* stream) {
  if (nb <= 0) return 0;
  cudaFuncSetAttribute(dct_flat_tiled_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kFlatSmem);
  cudaFuncSetAttribute(dct_flat_tiled_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int grid = (nb + kRows - 1) / kRows;
  dct_flat_tiled_kernel<<<grid, kThreads, kFlatSmem, (cudaStream_t)stream>>>(
      x, dt, y, cnt, eng, nb, bin_scale);
  return (int)cudaGetLastError();
}

// Bytes of the partial rows spectral_dct_hist needs as scratch: kMaxParts
// rows of 512 (u64 count, u64 energy) pairs.
size_t spectral_dct_hist_parts_bytes() {
  return (size_t)kMaxParts * kNbins * 2 * sizeof(unsigned long long);
}

// The flat single histogram: dct_flat_range_kernel over ranges of 64-row
// groups fixed by n_blocks alone (ceil(groups / kMaxParts) each) into
// ``parts`` (spectral_dct_hist_parts_bytes()), then their total into cnt
// and eng (all zero for n_blocks = 0). Refuses (cudaErrorInvalidValue) a
// histogram of kMaxFlatCount elements or more, past which the exact u64
// sums could carry out.
int spectral_dct_hist(const float* x, const float* dt, float* y, void* parts,
                      float* cnt, float* eng, int nb, float bin_scale,
                      void* stream) {
  if ((long long)nb * kBlock >= kMaxFlatCount) return (int)cudaErrorInvalidValue;
  const long n_groups = nb > 0 ? (nb + kRows - 1) / kRows : 0;
  const long per = n_groups > 0 ? (n_groups + kMaxParts - 1) / kMaxParts : 1;
  const int n_parts = (int)((n_groups + per - 1) / per);
  unsigned long long* part_c = static_cast<unsigned long long*>(parts);
  unsigned long long* part_e = part_c + (size_t)kMaxParts * kNbins;
  if (n_parts > 0) {
    cudaFuncSetAttribute(dct_flat_range_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kRangeSmem);
    cudaFuncSetAttribute(dct_flat_range_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    dct_flat_range_kernel<<<n_parts, kThreads, kRangeSmem,
                            (cudaStream_t)stream>>>(x, dt, y, part_c, part_e,
                                                    nb, per, bin_scale);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  flat_total_kernel<<<kNbins / kTotalBins, kTotalBins * kTotalSlices, 0,
                      (cudaStream_t)stream>>>(part_c, part_e, n_parts, cnt,
                                              eng);
  return (int)cudaGetLastError();
}

int spectral_threshold_quant(const float* y, const float* t, int8_t* q,
                             float* scale, int nb, void* stream) {
  if (nb <= 0) return 0;
  const int grid = (nb + kQuantWarps - 1) / kQuantWarps;
  threshold_quant_kernel<<<grid, kQuantWarps * 32, 0, (cudaStream_t)stream>>>(
      y, t, q, scale, nb);
  return (int)cudaGetLastError();
}

int spectral_dequant_idct(const int8_t* q, const float* scale, const float* d,
                          float* x, int nb, void* stream) {
  if (nb <= 0) return 0;
  cudaFuncSetAttribute(dequant_idct_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kDctSmem);
  const int grid = (nb + kRows - 1) / kRows;
  dequant_idct_kernel<<<grid, kThreads, kDctSmem, (cudaStream_t)stream>>>(
      q, scale, d, x, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
