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
//   histograms and the quantiser read 4 bytes per element and do a few
//   integer operations (a log2 for some) or a divide on it: bound by
//   bytes.
//
// Design:
//   * DCT kernels: one CTA of 256 threads per 64 rows. The CTA's rows sit
//     transposed in shared memory (68 KB); D cannot (256 KB against 227
//     KB per block), so it streams through in panels of the basis, each
//     read once per CTA from L2 (D is 256 KB, resident there). Every thread
//     owns an 8 x 8 block of outputs in registers and runs the classic
//     outer-product loop: two float4 reads of the row tile and two of the
//     panel feed 64 FFMAs. Every output is one sequential f32 FMA chain
//     over k = 0..255: no TF32, no split sums. Both histogram pairs run
//     dct_rows_pipe, whose 16-row panels are double-buffered by cp.async
//     (the copy of the next panel overlaps the FFMAs of this one) and which
//     runs at cuBLAS's time. The inverse runs the same body on its
//     dequantised int8 tile (16 bytes of q per load, conflict-free
//     transposed writes). Every kernel gives the same y bits for the same
//     input.
//   * Coarse histogram: the rows a thread owns are one 8-row tile. After
//     the product each thread bins its 64 outputs into a private column of
//     a shared-memory table (the row tile's space, reused), and one thread
//     per (tile, bin) sums the 32 columns of its tile in a fixed order: the
//     tile's row. No atomics: a run is deterministic, as the TPU's in-order
//     grid was. (u32 shared atomics into exact integer words, as the flat
//     pair's, timed slower here, with one word pair per (tile, bin) or
//     eight: tools/torch_coarse_split.py.)
//   * Flat pair: private columns of 512 bins would take 1 MiB per CTA, so
//     each thread bins its 64 outputs straight from registers into its
//     tile's bins in shared memory with u32 atomic adds, which are exact
//     and so give the same bits in any order: a bin's |y|^2 are integer
//     multiples of one unit (see flat_base for the bound), summed as
//     integers and rounded once, so energies of bins 1..510 equal the plain
//     version's f64 sums bit for bit. Bins 0 and 511 take the coarse
//     kernel's fixed-order columns.
//   * Refine, per tile (hist_refine_tiled): one warp per 8-row tile (2048
//     elements, 64 per lane), private per-lane bins in shared memory, then
//     the same fixed-order sum. Quantiser: one warp per row, a warp max for
//     amax.
//   * Single-tensor histograms: the TPU kernel carries one histogram from
//     grid step to grid step; CTAs here run in no order. dct_hist_coarse
//     and dct_hist run persistent CTAs over ranges of 64-row groups fixed
//     by n_blocks alone (not by the SM count), each adding its tiles into
//     one row for its range in tile order, then a small kernel adds the
//     range rows in a fixed order: counts as 64-bit integers, energies in
//     double (or exact integers), rounded once. They write no tile rows.
//     hist_refine makes one pass over y at HBM rate on the same ranges:
//     membership in the coarse bin is decided on the bits of |y| by a
//     table of intervals built on the card with bin_index itself (so the
//     logarithm runs only inside the interval, ~10 % of the elements on a
//     moment), each warp keeps a whole 8-row tile of loads in flight,
//     members add exact integer units into per-warp u32 words (flat bins 0
//     and 511 in double, in a fixed order), and a small kernel adds the
//     range rows in a fixed order. No float atomics anywhere.
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
constexpr int kXs = kRows + 4;         // padded stride of the transposed tile
constexpr int kThreads = 256;
constexpr int kHs = kThreads + 1;      // padded stride of the private bins
constexpr size_t kTileBytes = (size_t)kBlock * kXs * sizeof(float);
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

// Lane mapping of the A-tile loads (f = 0 .. kRows*kBlock/4 - 1, one
// 4-element slot each): 8 lanes read contiguous slots of a row, a warp
// covers 4 rows per access, so the transposed shared-memory writes spread
// over 8 banks (4-way conflicts on a load that runs once per CTA).
__device__ __forceinline__ void tile_slot(int f, int& r, int& k4) {
  const int l = f & 31, g = f >> 5;
  r = (g >> 3) * 4 + (l >> 3);
  k4 = ((g & 7) * 8 + (l & 7)) * 4;
}

// ---------------------------------------------------------------------------
// The product body of every DCT kernel (both histogram pairs and the
// inverse).
// ---------------------------------------------------------------------------

// acc[i][j] = sum_k a[tr*8+i][k] * m[k][col(j)], each output one sequential
// f32 FMA chain over k = 0..255 (so y is the same bits in every kernel and
// cuBLAS's), with the CTA's A tile transposed in xs (xs[k*kXs + r]) and
// m's rows streamed through two 16-row stages by cp.async: the copy of
// panel p + 1 is in flight while panel p is consumed, one barrier per panel.
constexpr int kPipePanel = 16;                     // basis rows per stage
constexpr int kPanels = kBlock / kPipePanel;
constexpr int kStageFloats = kPipePanel * kBlock;  // 16 KB
constexpr size_t kPipeSmem = kTileBytes + 2 * kStageFloats * sizeof(float);

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

// acc = A . m; the caller has issued panel 0 into stage 0 and written the
// transposed A tile into xs.
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

// y = x . D^T for the CTA's kRows rows from row0 (rows past nb read as
// zero): the thread's 8 x 8 outputs stay in acc, and those of live rows are
// written to y. The first panel's copy overlaps the load of the row tile.
// Returns whether the thread's 8-row tile is live (nb is a multiple of
// kTile).
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

// ---------------------------------------------------------------------------
// The flat 512-bin pair (dct_hist_tiled, dct_hist): its exact binning from
// registers, and the two kernels built on it.
// ---------------------------------------------------------------------------

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
constexpr size_t kRangeSmem = kPipeSmem + 2 * kNbins * sizeof(unsigned long long);

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

// dequant_idct: one CTA per 64 rows. The first basis panel's copy is in
// flight while the int8 tile is loaded, 16 bytes of q a load: a warp's
// lanes take 32 consecutive rows r of one 16-column segment k16, so the
// transposed write of column k16 + j lands in bank (4 j + r) mod 32 (k16 *
// kXs is a multiple of 32): 32 distinct banks.
__global__ void __launch_bounds__(kThreads, 2)
dequant_idct_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    const float* __restrict__ d,        // D, row-major
                    float* __restrict__ x, int nb) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* stages = xs + kTileBytes / sizeof(float);
  const long row0 = (long)blockIdx.x * kRows;
  issue_panel(stages, d, 0);
#pragma unroll
  for (int i = 0; i < kRows * kBlock / 16 / kThreads; ++i) {
    const int f = threadIdx.x + i * kThreads;
    const int r = ((f >> 5) & 1) * 32 + (f & 31);
    const int k16 = (f >> 6) * 16;
    int4 c = make_int4(0, 0, 0, 0);
    float s = 0.f;
    if (row0 + r < nb) {
      c = *reinterpret_cast<const int4*>(q + (row0 + r) * kBlock + k16);
      s = scale[row0 + r];
    }
    const int w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // byte j of the segment, sign-extended: the int8 coefficient
      const int e = (int)((unsigned)w[j >> 2] << (24 - 8 * (j & 3))) >> 24;
      xs[(k16 + j) * kXs + r] = __fmul_rn((float)e, s);
    }
  }
  const Owner o;
  float acc[8][8];
  gemm_rows_pipe(xs, stages, d, o, acc);
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

// ---------------------------------------------------------------------------
// The single-tensor refine histogram (hist_refine): one pass over y.
// ---------------------------------------------------------------------------

// Membership by the bits of |y|. Non-negative floats order as their bit
// patterns do, and an element adds to the refine histogram of coarse bin c
// only if bin_index(|y|) >> 4 == c. The table holds, for each c, the least
// interval [lo_c, hi_c) of patterns that holds every pattern whose coarse
// bin is c, found by refine_table_scan with bin_index itself over all 2^31
// non-negative patterns (never from another library's log2). An element
// outside c's interval is no member; bin_index decides inside it, so the
// table can only spend time, never change a bin. bin_index puts NaN
// patterns in bin 0, so coarse bin 0's interval reaches the top of the
// range and every element is tested there (a selection picks bin 0 only
// for a tensor whose energy lies almost all below 2^-37.5, such as a
// 1e-20-scaled payload). Layout: lo[32], then hi[32].
constexpr unsigned kPatterns = 0x80000000u;        // non-negative patterns
constexpr int kScanPer = 1024;                     // patterns per thread
constexpr int kScanThreads = 256;

__global__ void refine_table_init(unsigned* __restrict__ table) {
  table[threadIdx.x] = 0xffffffffu;
  table[kCoarse + threadIdx.x] = 0u;
}

__global__ void __launch_bounds__(kScanThreads)
refine_table_scan(unsigned* __restrict__ table, float bin_scale) {
  const unsigned first = (blockIdx.x * kScanThreads + threadIdx.x) * kScanPer;
  int cur = -1;
  unsigned lo = 0u;
  for (unsigned u = first; u < first + kScanPer; ++u) {
    const int c = bin_index(__uint_as_float(u), bin_scale) >> 4;
    if (c != cur) {
      if (cur >= 0) {
        atomicMin(table + cur, lo);
        atomicMax(table + kCoarse + cur, u);
      }
      cur = c;
      lo = u;
    }
  }
  atomicMin(table + cur, lo);
  atomicMax(table + kCoarse + cur, first + kScanPer);
}

// Whether bit pattern u (of |y|) lies in the interval [lo, lo + span).
__device__ __forceinline__ bool refine_candidate(unsigned u, unsigned lo,
                                                 unsigned span) {
  return u - lo < span;
}

// (lo, span) of coarse bin c; no pattern for a c outside 0..31, which has
// no members.
__device__ __forceinline__ void refine_interval(const unsigned* table, int c,
                                                unsigned& lo, unsigned& span) {
  const bool ok = c >= 0 && c < kCoarse;
  lo = ok ? table[c] : 0u;
  span = ok ? table[kCoarse + c] - lo : 0u;
}

// Patterns whose membership the table decides differently from bin_index:
// a pattern outside the interval of its own coarse bin (inside the others'
// intervals bin_index decides). Counted into *bad; must be 0.
__global__ void __launch_bounds__(kScanThreads)
refine_table_check_kernel(const unsigned* __restrict__ table, float bin_scale,
                          unsigned long long* __restrict__ bad) {
  const unsigned first = (blockIdx.x * kScanThreads + threadIdx.x) * kScanPer;
  unsigned long long n = 0;
  for (unsigned u = first; u < first + kScanPer; ++u) {
    unsigned lo, span;
    refine_interval(table, bin_index(__uint_as_float(u), bin_scale) >> 4, lo,
                    span);
    n += !refine_candidate(u, lo, span);
  }
  if (n) atomicAdd(bad, n);
}

// The coarse bin of block i: the caller's value when there is no tensor,
// else its int32 or int64 element i * stride (stride 0: one for all).
__device__ __forceinline__ int coarse_at(const void* coarse, int elem,
                                         long i, int value) {
  if (coarse == nullptr) return value;
  return elem == 8 ? (int)static_cast<const long long*>(coarse)[i]
                   : static_cast<const int*>(coarse)[i];
}

// The range kernel. CTA g takes the 8-row tiles of range_parts' range g,
// warp w the tiles w, w + 8, ... of it, in half tiles (4 rows, 8 float4 a
// lane, 4 KB a warp) copied by cp.async into a ring of kStages half tiles
// per warp in shared memory: while the warp scans one, the next two are on
// the way (8 KB a warp, 128 KB an SM at two CTAs an SM), so the loads no
// longer wait for the scan's instructions, nor it for them. Each lane reads
// back only the 16-byte slots it copied. An element's bits decide whether it is
// a candidate (above). A divergent branch on that would cost every lane
// the logarithm whenever any lane of the warp has a candidate (nearly
// always), so the warp compacts its candidates into a queue in shared
// memory (a ballot, each candidate at its rank) and bins them 32 at a
// time, one per lane. A member adds to its warp's words of the 16 fine
// bins with u32 shared atomics: its count and the exact units of its
// square (flat_units of flat bin 16c + k, which lies in 1..510 for coarse
// bins 1..30 and for all but fine bin 0 of c = 0 and fine bin 15 of c =
// 31). The words of a tile cannot carry out (as the flat pair's: 2048
// elements), and after each tile lane k adds those of fine bin k into a
// u64 count and a u64 sum of units, exact in any order. Flat bins 0 and
// 511 (zeros and subnormal squares; squares up to inf) have no such unit:
// each thread sums their squares in double in the order the queue hands
// them to it, and the CTA adds the threads' sums in a fixed order. With one
// coarse bin for all blocks (PER_BLOCK false), a range's units stay exact;
// with a coarse bin per block, a run of rows of one bin is turned into
// double (units times the bin's unit, exact) when the bin changes, and
// added in row order. The CTA writes its range's row (counts, units,
// doubles); refine_total_kernel adds the rows in a fixed order. Every
// order here depends on y and n_blocks alone.
constexpr int kRangeWarps = 8;
constexpr int kRangeThreads = kRangeWarps * 32;
constexpr int kTileLoads = kTile * kBlock / 4 / 32;    // float4 a lane: 16
constexpr int kHalfLoads = kTileLoads / 2;
constexpr int kQueue = 32 + 4 * 32;    // < 32 left over + one float4 a lane
constexpr int kStages = 3;             // half tiles in a warp's ring
constexpr size_t kRingSmem =
    (size_t)kRangeWarps * kStages * kHalfLoads * 32 * sizeof(float4);  // 96 KB

__device__ __forceinline__ void refine_flush(unsigned* lo_w, unsigned* hi_w,
                                             int lane,
                                             unsigned long long& cnt,
                                             unsigned long long& units) {
  __syncwarp();
  if (lane < kFine) {
    const unsigned h = hi_w[lane];
    cnt += h >> kLoBits;
    units += ((unsigned long long)(h & kLoMask) << kLoBits) + lo_w[lane];
    lo_w[lane] = 0u;
    hi_w[lane] = 0u;
  }
  __syncwarp();
}

// Bins the candidates q[0 .. n) (n <= 32), one per lane: a member of
// coarse bin c adds to the warp's words, or to the thread's double sums of
// flat bins 0 and 511.
__device__ __forceinline__ void refine_members(const float* q, int n,
                                               int lane, int c,
                                               float bin_scale,
                                               unsigned* lo_w, unsigned* hi_w,
                                               double& e0, double& e511) {
  if (lane >= n) return;
  const float a = q[lane];
  const int b = bin_index(a, bin_scale);
  const int k = b - c * kFine;
  if ((unsigned)k >= (unsigned)kFine) return;
  const float a2 = __fmul_rn(a, a);
  if (b == 0 || b == kNbins - 1) {
    if (b == 0)
      e0 += (double)a2;
    else
      e511 += (double)a2;
    atomicAdd(hi_w + k, 1u << kLoBits);
  } else {
    const unsigned un = flat_units(a2, b);
    atomicAdd(lo_w + k, un & kLoMask);
    atomicAdd(hi_w + k, (1u << kLoBits) | (un >> kLoBits));
  }
}

// units of coarse bin c's fine bin k as double: the integer rounded once
// to 53 bits, times the unit (a power of two, exact)
__device__ __forceinline__ double refine_units_energy(unsigned long long units,
                                                      int c, int k) {
  const long long e = flat_base(c * kFine + k) - 23 + 1023;
  return __ull2double_rn(units) * __longlong_as_double(e << 52);
}

template <bool PER_BLOCK>
__global__ void __launch_bounds__(kRangeThreads, 2)
refine_range_kernel(const float* __restrict__ y, const void* coarse,
                    int coarse_elem, int coarse_value,
                    const unsigned* __restrict__ table,
                    unsigned long long* __restrict__ part_c,
                    unsigned long long* __restrict__ part_u,
                    double* __restrict__ part_d, int nb, long per,
                    float bin_scale) {
  extern __shared__ float4 ring_smem[];   // kRingSmem: the warps' rings
  __shared__ unsigned words[kRangeWarps][2][kFine];
  __shared__ float queue[kRangeWarps][kQueue];
  __shared__ unsigned long long sc[kRangeWarps][kFine], su[kRangeWarps][kFine];
  __shared__ double sd[kRangeWarps][kFine];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned* lo_w = words[warp][0];
  unsigned* hi_w = words[warp][1];
  float* q = queue[warp];
  if (lane < kFine) lo_w[lane] = hi_w[lane] = 0u;
  __syncwarp();
  const long n_groups = (nb + kRows - 1) / kRows;
  const long g1 = (blockIdx.x + 1) * per < n_groups ? (blockIdx.x + 1) * per
                                                    : n_groups;
  const long t1 = g1 * (kRows / kTile) < nb / kTile ? g1 * (kRows / kTile)
                                                   : nb / kTile;
  // the run's coarse bin and interval (one for all blocks: read once)
  int run_c = PER_BLOCK ? -1 : coarse_at(coarse, coarse_elem, 0, coarse_value);
  unsigned lo, span;
  refine_interval(table, run_c, lo, span);
  unsigned long long cnt = 0ull, units = 0ull;   // fine bin `lane` (< 16)
  double dbl = 0.0;
  double e0 = 0.0, e511 = 0.0;                   // this thread's flat 0, 511
  int qn = 0;   // candidates in the warp's queue (the same in every lane)
  int row_c[kTile];
  // scan float4s i0 .. i0 + 7 of a tile (rows i0 / 2 ..): queue the
  // candidates, bin them 32 at a time
  auto scan = [&](const float4 (&v)[kHalfLoads], int i0) {
#pragma unroll
    for (int i = 0; i < kHalfLoads; ++i) {
      // float4 i0 + i of every lane lies in row (i0 + i) / 2 of the tile
      if constexpr (PER_BLOCK) {
        const int c = row_c[(i0 + i) / 2];
        if (c != run_c) {   // the same for the whole warp
          __syncwarp();
          refine_members(q, qn, lane, run_c, bin_scale, lo_w, hi_w, e0, e511);
          qn = 0;
          refine_flush(lo_w, hi_w, lane, cnt, units);
          if (lane < kFine && run_c >= 0 && run_c < kCoarse)
            dbl += refine_units_energy(units, run_c, lane);
          units = 0ull;
          run_c = c;
          refine_interval(table, run_c, lo, span);
        }
      }
      const float vs[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned u = __float_as_uint(vs[j]) & 0x7fffffffu;
        const bool cand = refine_candidate(u, lo, span);
        const unsigned m = __ballot_sync(0xffffffffu, cand);
        if (cand) q[qn + __popc(m & below)] = __uint_as_float(u);
        qn += __popc(m);
      }
      if (qn >= 32) {
        __syncwarp();
        do {
          qn -= 32;
          refine_members(q + qn, 32, lane, run_c, bin_scale, lo_w, hi_w, e0,
                         e511);
        } while (qn >= 32);
        __syncwarp();
      }
    }
  };
  // the warp's half tiles h = 0, 1, ...: tile t0 + (h / 2) * 8, half h % 2
  const long t0 = blockIdx.x * per * (kRows / kTile) + warp;
  const int n_half = t0 < t1 ? 2 * (int)((t1 - t0 + kRangeWarps - 1) /
                                        kRangeWarps)
                             : 0;
  float4* ring = reinterpret_cast<float4*>(ring_smem) +
                 (size_t)warp * kStages * kHalfLoads * 32;
  // copy half h into its stage, as one group (an empty group past the end,
  // so that wait_group counts the same every step)
  auto issue = [&](int h) {
    if (h < n_half) {
      const float4* src = reinterpret_cast<const float4*>(
          y + (t0 + (long)(h / 2) * kRangeWarps) * kTile * kBlock) +
          (h % 2) * kHalfLoads * 32 + lane;
      float4* dst = ring + (h % kStages) * kHalfLoads * 32 + lane;
#pragma unroll
      for (int i = 0; i < kHalfLoads; ++i) cp_async16(dst + 32 * i, src + 32 * i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int h = 0; h < kStages - 1; ++h) issue(h);
  for (int h = 0; h < n_half; ++h) {
    issue(h + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const long t = t0 + (long)(h / 2) * kRangeWarps;
    if (PER_BLOCK && h % 2 == 0) {
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        row_c[r] = coarse_at(coarse, coarse_elem, t * kTile + r, 0);
    }
    const float4* stage = ring + (h % kStages) * kHalfLoads * 32 + lane;
    float4 v[kHalfLoads];
#pragma unroll
    for (int i = 0; i < kHalfLoads; ++i) v[i] = stage[32 * i];
    scan(v, (h % 2) * kHalfLoads);
    if (h % 2 == 1) {   // the tile is done: bin what is queued, flush
      __syncwarp();
      refine_members(q, qn, lane, run_c, bin_scale, lo_w, hi_w, e0, e511);
      qn = 0;
      refine_flush(lo_w, hi_w, lane, cnt, units);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (PER_BLOCK && lane < kFine && run_c >= 0 && run_c < kCoarse) {
    dbl += refine_units_energy(units, run_c, lane);
    units = 0ull;
  }
  // the warp's flat 0 and 511 sums in a fixed tree order, to fine bins 0
  // and 15
  for (int off = 16; off > 0; off >>= 1) {
    e0 += __shfl_down_sync(0xffffffffu, e0, off);
    e511 += __shfl_down_sync(0xffffffffu, e511, off);
  }
  e511 = __shfl_sync(0xffffffffu, e511, 0);
  if (lane == 0) dbl += e0;
  if (lane == kFine - 1) dbl += e511;
  if (lane < kFine) {
    sc[warp][lane] = cnt;
    su[warp][lane] = units;
    sd[warp][lane] = dbl;
  }
  __syncthreads();
  if (threadIdx.x < kFine) {
    const int k = threadIdx.x;
    unsigned long long c = 0ull, s = 0ull;
    double d = 0.0;
    for (int w = 0; w < kRangeWarps; ++w) {
      c += sc[w][k];
      s += su[w][k];
      d += sd[w][k];
    }
    part_c[blockIdx.x * kFine + k] = c;
    part_u[blockIdx.x * kFine + k] = s;
    part_d[blockIdx.x * kFine + k] = d;
  }
}

// The refine histogram from refine_range_kernel's rows, in one CTA: thread
// (slice s, bin k) adds rows s, s + 16, ... and the first slice adds the 16
// slice sums in order. Counts and units as u64, rounded once; with one
// coarse bin for all blocks a bin's units are its exact energy (flat_energy
// of flat bin 16c + k); the doubles (flat bins 0 and 511, or the runs of a
// coarse bin per block) are rounded once. The order depends on n_parts
// alone.
__global__ void __launch_bounds__(kFine * kTotalSlices)
refine_total_kernel(const unsigned long long* __restrict__ part_c,
                    const unsigned long long* __restrict__ part_u,
                    const double* __restrict__ part_d, int n_parts,
                    const void* coarse, int coarse_elem, int coarse_value,
                    float* __restrict__ out) {
  __shared__ unsigned long long sc[kTotalSlices][kFine], su[kTotalSlices][kFine];
  __shared__ double sd[kTotalSlices][kFine];
  const int k = threadIdx.x % kFine, s = threadIdx.x / kFine;
  // every load of the slice issued before the first add (one L2 round
  // trip, not one a row), then the adds in row order
  constexpr int kRowsPer = (kMaxParts + kTotalSlices - 1) / kTotalSlices;
  unsigned long long pc[kRowsPer], pu[kRowsPer];
  double pd[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int g = s + i * kTotalSlices;
    const bool in = g < n_parts;
    pc[i] = in ? part_c[g * kFine + k] : 0ull;
    pu[i] = in ? part_u[g * kFine + k] : 0ull;
    pd[i] = in ? part_d[g * kFine + k] : 0.0;
  }
  unsigned long long c = 0ull, u = 0ull;
  double d = 0.0;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    c += pc[i];
    u += pu[i];
    d += pd[i];
  }
  sc[s][k] = c;
  su[s][k] = u;
  sd[s][k] = d;
  __syncthreads();
  if (s != 0) return;
  for (int i = 1; i < kTotalSlices; ++i) {
    c += sc[i][k];
    u += su[i][k];
    d += sd[i][k];
  }
  out[k] = __ull2float_rn(c);
  // units are left only with one coarse bin for all blocks, which then
  // has members: c lies in 0..31 and 16c + k in 1..510
  out[kFine + k] = u ? flat_energy(u, coarse_at(coarse, coarse_elem, 0,
                                                coarse_value) * kFine + k)
                     : (float)d;
}

// ---------------------------------------------------------------------------
// The coarse 32-bin pair (dct_hist_coarse_tiled, dct_hist_coarse): the
// pipelined product, then each thread's 64 outputs binned into private
// columns in fixed order, and the two kernels built on them.
// ---------------------------------------------------------------------------

// Bin the thread's 64 outputs (tile o.tr) into its private (count, energy)
// columns of the 32 coarse bins, in the row tile's space, then return the
// cell (tile tid / 32, bin tid % 32): that tile's 32 owner columns summed
// in a fixed order (a tile past nb sums to zeros). Starts with a barrier;
// the caller puts one between this and the next write of the row tile.
__device__ __forceinline__ void bin_coarse(float acc[8][8], bool live,
                                           float bin_scale, float* xs,
                                           float& c, float& e) {
  float* hc = xs;
  float* he = xs + kCoarse * kHs;
  const int tid = threadIdx.x;
  __syncthreads();  // every thread is done with the row tile
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
  const int t = tid >> 5, b = tid & 31;
  c = 0.f;
  e = 0.f;
  for (int tc = 0; tc < 32; ++tc) {
    const int src = (((t >> 2) * 4 + (tc >> 3)) << 5) + (t & 3) * 8 + (tc & 7);
    c += hc[b * kHs + src];
    e = __fadd_rn(e, he[b * kHs + src]);
  }
}

// dct_hist_coarse_tiled: one CTA per 64 rows; each live tile's 32-bin row.
__global__ void __launch_bounds__(kThreads, 2)
dct_coarse_tiled_kernel(const float* __restrict__ x,
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
  float c, e;
  bin_coarse(acc, live, bin_scale, xs, c, e);
  const int t = threadIdx.x >> 5, b = threadIdx.x & 31;
  if (row0 + t * kTile < nb) {
    const long tile = row0 / kTile + t;
    cnt[tile * kCoarse + b] = c;
    eng[tile * kCoarse + b] = e;
  }
}

// dct_hist_coarse: CTA g runs the 64-row groups [g * per, (g + 1) * per)
// in order (per from n_blocks alone, at most kMaxParts ranges) and adds
// each live tile's cells, in tile order, into one 32-bin row for the range
// held by the first warp: counts as u64, energies in double. It writes
// that row to the partial rows, which coarse_total_kernel sums in a fixed
// order. So the histogram is kernel 2's tile rows summed in double in an
// order fixed by n_blocks, rounded once.
constexpr size_t kCellsAt = 2 * kCoarse * kHs;     // floats into the row tile
static_assert((kCellsAt + 2 * kThreads) * sizeof(float) <= kTileBytes,
              "the tile cells must fit in the row tile's space");

__global__ void __launch_bounds__(kThreads, 2)
dct_coarse_range_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,   // D^T, row-major
                        float* __restrict__ y,
                        unsigned long long* __restrict__ part_c,
                        double* __restrict__ part_e, int nb, long per,
                        float bin_scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* stages = xs + kTileBytes / sizeof(float);
  float* cells = xs + kCellsAt;   // counts [tile][bin], then energies
  const Owner o;
  const int tid = threadIdx.x;
  const long n_groups = (nb + kRows - 1) / kRows;
  const long g0 = blockIdx.x * per;
  const long g1 = g0 + per < n_groups ? g0 + per : n_groups;
  unsigned long long sum_c = 0ull;   // bin tid of the range (tid < 32)
  double sum_e = 0.0;
  float acc[8][8];
  for (long g = g0; g < g1; ++g) {
    const long row0 = g * kRows;
    __syncthreads();  // the last group's sums are done with the cells
    const bool live = dct_rows_pipe(x, dt, y, nb, row0, xs, stages, o, acc);
    float c, e;
    bin_coarse(acc, live, bin_scale, xs, c, e);
    cells[tid] = c;
    cells[kThreads + tid] = e;
    __syncthreads();
    if (tid < kCoarse) {
      for (int t = 0; t < kTiles && row0 + t * kTile < nb; ++t) {
        sum_c += (unsigned long long)cells[t * kCoarse + tid];
        sum_e += (double)cells[kThreads + t * kCoarse + tid];
      }
    }
  }
  if (tid < kCoarse) {
    part_c[blockIdx.x * kCoarse + tid] = sum_c;
    part_e[blockIdx.x * kCoarse + tid] = sum_e;
  }
}

// The coarse single histogram from dct_coarse_range_kernel's partial rows,
// in one CTA: thread (slice s, bin) adds rows s, s + 16, ... and the first
// slice adds the 16 slice sums in order; counts as u64, energies in
// double, each rounded once. The order depends on n_parts alone.
__global__ void __launch_bounds__(kCoarse * kTotalSlices)
coarse_total_kernel(const unsigned long long* __restrict__ part_c,
                    const double* __restrict__ part_e, int n_parts,
                    float* __restrict__ cnt, float* __restrict__ eng) {
  __shared__ unsigned long long sc[kTotalSlices][kCoarse];
  __shared__ double se[kTotalSlices][kCoarse];
  const int b = threadIdx.x % kCoarse, s = threadIdx.x / kCoarse;
  unsigned long long c = 0;
  double e = 0.0;
  for (int g = s; g < n_parts; g += kTotalSlices) {
    c += part_c[g * kCoarse + b];
    e += part_e[g * kCoarse + b];
  }
  sc[s][b] = c;
  se[s][b] = e;
  __syncthreads();
  if (s != 0) return;
  for (int k = 1; k < kTotalSlices; ++k) {
    c += sc[k][b];
    e += se[k][b];
  }
  cnt[b] = __ull2float_rn(c);
  eng[b] = (float)e;
}

// The ranges of the persistent single-histogram kernels: n_blocks' 64-row
// groups in at most kMaxParts ranges of ``per`` groups (from n_blocks
// alone, never the SM count). Returns the number of ranges.
int range_parts(int nb, long& per) {
  const long n_groups = nb > 0 ? (nb + kRows - 1) / kRows : 0;
  per = n_groups > 0 ? (n_groups + kMaxParts - 1) / kMaxParts : 1;
  return (int)((n_groups + per - 1) / per);
}

}  // namespace

extern "C" {

// Every entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the launch (0 when n_blocks is 0).

int spectral_dct_hist_coarse_tiled(const float* x, const float* dt, float* y,
                                   float* cnt, float* eng, int nb,
                                   float bin_scale, void* stream) {
  if (nb <= 0) return 0;
  cudaFuncSetAttribute(dct_coarse_tiled_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kPipeSmem);
  cudaFuncSetAttribute(dct_coarse_tiled_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int grid = (nb + kRows - 1) / kRows;
  dct_coarse_tiled_kernel<<<grid, kThreads, kPipeSmem, (cudaStream_t)stream>>>(
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

// Bytes of the partial rows spectral_dct_hist_coarse needs as scratch:
// kMaxParts rows of 32 (u64 count, f64 energy) pairs.
size_t spectral_dct_hist_coarse_parts_bytes() {
  return (size_t)kMaxParts * kCoarse * (sizeof(unsigned long long) +
                                        sizeof(double));
}

// The coarse single histogram: dct_coarse_range_kernel over range_parts'
// ranges into ``parts`` (spectral_dct_hist_coarse_parts_bytes()), then their
// total into cnt and eng (all zero for n_blocks = 0).
int spectral_dct_hist_coarse(const float* x, const float* dt, float* y,
                             void* parts, float* cnt, float* eng, int nb,
                             float bin_scale, void* stream) {
  long per;
  const int n_parts = range_parts(nb, per);
  unsigned long long* part_c = static_cast<unsigned long long*>(parts);
  double* part_e = reinterpret_cast<double*>(part_c + (size_t)kMaxParts * kCoarse);
  if (n_parts > 0) {
    cudaFuncSetAttribute(dct_coarse_range_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kPipeSmem);
    cudaFuncSetAttribute(dct_coarse_range_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    dct_coarse_range_kernel<<<n_parts, kThreads, kPipeSmem,
                              (cudaStream_t)stream>>>(x, dt, y, part_c, part_e,
                                                      nb, per, bin_scale);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  coarse_total_kernel<<<1, kCoarse * kTotalSlices, 0, (cudaStream_t)stream>>>(
      part_c, part_e, n_parts, cnt, eng);
  return (int)cudaGetLastError();
}

// Bytes of the partial rows spectral_hist_refine needs as scratch:
// kMaxParts rows of 16 (u64 count, u64 units, f64) triples.
size_t spectral_hist_refine_parts_bytes() {
  return (size_t)kMaxParts * kFine * (2 * sizeof(unsigned long long) +
                                      sizeof(double));
}

// The refine kernel's membership table (2 x 32 u32: lo, then hi) into
// ``table``, by a scan of all 2^31 non-negative patterns with bin_index.
int spectral_refine_table(void* table, float bin_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* t = static_cast<unsigned*>(table);
  refine_table_init<<<1, kCoarse, 0, s>>>(t);
  refine_table_scan<<<kPatterns / kScanPer / kScanThreads, kScanThreads, 0,
                      s>>>(t, bin_scale);
  return (int)cudaGetLastError();
}

// Adds to *bad (u64) the non-negative patterns whose membership ``table``
// decides differently from bin_index (all 2^31 of them checked).
int spectral_refine_table_check(const void* table, void* bad, float bin_scale,
                                void* stream) {
  refine_table_check_kernel<<<kPatterns / kScanPer / kScanThreads,
                              kScanThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned*>(table), bin_scale,
      static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}

// The refine histogram of one tensor into out (16 counts, then 16
// energies): refine_range_kernel over range_parts' ranges into ``parts``
// (spectral_hist_refine_parts_bytes()), then their total (all zero for
// n_blocks = 0). The coarse bin: ``coarse_value`` when ``coarse`` is null,
// else the int32 or int64 (``coarse_elem`` bytes) tensor at ``coarse``, one
// value for all blocks (``coarse_stride`` 0) or one per block (1).
// ``table`` is spectral_refine_table's. Refuses (cudaErrorInvalidValue) a
// histogram of kMaxFlatCount elements or more, past which the exact u64
// sums could carry out.
int spectral_hist_refine(const float* y, const void* coarse, int coarse_elem,
                         int coarse_stride, int coarse_value,
                         const void* table, void* parts, float* out, int nb,
                         float bin_scale, void* stream) {
  if ((long long)nb * kBlock >= kMaxFlatCount) return (int)cudaErrorInvalidValue;
  long per;
  const int n_parts = range_parts(nb, per);
  unsigned long long* part_c = static_cast<unsigned long long*>(parts);
  unsigned long long* part_u = part_c + (size_t)kMaxParts * kFine;
  double* part_d = reinterpret_cast<double*>(part_u + (size_t)kMaxParts * kFine);
  const unsigned* t = static_cast<const unsigned*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_parts > 0) {
    const void* fns[2] = {(const void*)refine_range_kernel<true>,
                          (const void*)refine_range_kernel<false>};
    for (const void* fn : fns) {
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kRingSmem);
      cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    }
    if (coarse_stride)
      refine_range_kernel<true><<<n_parts, kRangeThreads, kRingSmem, s>>>(
          y, coarse, coarse_elem, coarse_value, t, part_c, part_u, part_d, nb,
          per, bin_scale);
    else
      refine_range_kernel<false><<<n_parts, kRangeThreads, kRingSmem, s>>>(
          y, coarse, coarse_elem, coarse_value, t, part_c, part_u, part_d, nb,
          per, bin_scale);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  refine_total_kernel<<<1, kFine * kTotalSlices, 0, s>>>(
      part_c, part_u, part_d, n_parts, coarse, coarse_elem, coarse_value, out);
  return (int)cudaGetLastError();
}

int spectral_dct_hist_tiled(const float* x, const float* dt, float* y,
                            float* cnt, float* eng, int nb, float bin_scale,
                            void* stream) {
  if (nb <= 0) return 0;
  cudaFuncSetAttribute(dct_flat_tiled_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kPipeSmem);
  cudaFuncSetAttribute(dct_flat_tiled_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int grid = (nb + kRows - 1) / kRows;
  dct_flat_tiled_kernel<<<grid, kThreads, kPipeSmem, (cudaStream_t)stream>>>(
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
  long per;
  const int n_parts = range_parts(nb, per);
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
                       (int)kPipeSmem);
  const int grid = (nb + kRows - 1) / kRows;
  dequant_idct_kernel<<<grid, kThreads, kPipeSmem, (cudaStream_t)stream>>>(
      q, scale, d, x, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
