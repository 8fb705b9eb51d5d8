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
//   balances at 20. The flat pair's tile rows add 4 KB per 8 rows (half
//   the bytes of y), which leaves it bound by operations. The refine
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
//     Every forward-DCT kernel runs this one body (dct_rows), so their y
//     is the same bits for the same input.
//   * Coarse histogram: the rows a thread owns are one 8-row tile. After
//     the product each thread bins its 64 outputs into a private column of
//     a shared-memory table (the row tile's space, reused), and one thread
//     per (tile, bin) sums the 32 columns of its tile in a fixed order and
//     writes the tile's row. No atomics anywhere: a run is deterministic,
//     as the TPU's in-order grid was.
//   * Flat histogram: private columns would take 512 bins x 2 x 4 B x 256
//     threads = 1 MiB per CTA, so the CTA's y goes back to shared memory
//     and each warp bins one tile into its own 512-bin histogram, lanes
//     that share a bin merged by the lowest of them in lane order (see
//     dct_hist_flat_kernel). Chosen over a per-tile sort by bin: it needs
//     no second copy of the tile and costs a pass over the group only for
//     the lanes that lead one.
//   * Refine: one warp per 8-row tile (2048 elements, 64 per lane),
//     private per-lane bins in shared memory, then the same fixed-order
//     sum. Quantiser: one warp per row, a warp max for amax.
//   * Single-tensor histograms: the TPU kernel carries one histogram from
//     grid step to grid step; CTAs here run in no order, so the tiled
//     kernel writes its tile rows into scratch and more kernels, from the
//     same C entry and stream, sum them into one row in a fixed order:
//     counts as 64-bit integers, energies in double, rounded once. The
//     coarse and refine rows (32 and 16 bins) take one CTA of 1024
//     threads; the flat rows (512 bins) a grid of CTAs over fixed ranges
//     of rows and then one CTA over the ranges. No float atomics.
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
// to y. Every kernel that computes the forward DCT runs this one body, so
// all of them give the same bits for the same input. Returns whether the
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

// The flat 512-bin histogram. After the product the CTA's y goes back to
// shared memory row-major (64 KB, the row tile's space) and warp w bins
// tile w (8 warps, 8 tiles per CTA) into its own 512-bin (u32 count, f32
// energy) histogram (4 KB per warp, the panel's space). The warp walks the
// tile's 2048 elements 32 at a time in a fixed order; __match_any_sync
// groups the lanes whose elements share a bin, and the group's lowest lane
// sums its peers' |y|^2 in lane order and alone adds that sum and the
// group's size to the bin: every bin sees the same sums in the same order
// in every run. A bin's energy is at most 31 lane-ordered then 63 f32
// additions, the coarse kernel's error bound. The leaders' loops run side
// by side, so a step costs the largest group, not the warp.
static_assert((size_t)kRows * kBlock * sizeof(float) <= kTileBytes,
              "the CTA's y must fit in the row tile's space");
static_assert((size_t)(kThreads / 32) * 2 * kNbins * sizeof(float)
                  <= kPanelBytes,
              "per-warp flat histograms must fit in the panel's space");

__global__ void __launch_bounds__(kThreads, 2)
dct_hist_flat_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,     // D^T, row-major
                     float* __restrict__ y, float* __restrict__ cnt,
                     float* __restrict__ eng, int nb, float bin_scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* panel = xs + kTileBytes / sizeof(float);
  const long row0 = (long)blockIdx.x * kRows;
  const Owner o;
  float acc[8][8];
  dct_rows(x, dt, y, nb, xs, panel, o, acc);
  __syncthreads();  // every thread is done with the row tile and the panel
  float* ys = xs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* yr = ys + (o.tr * 8 + i) * kBlock;
    *reinterpret_cast<float4*>(yr + o.c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(yr + o.c0 + 128) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* hc = reinterpret_cast<unsigned*>(panel) + warp * 2 * kNbins;
  float* he = panel + warp * 2 * kNbins + kNbins;
  for (int b = lane; b < kNbins; b += 32) {
    hc[b] = 0u;
    he[b] = 0.f;
  }
  __syncthreads();
  if (row0 + warp * kTile >= nb) return;   // the warp's tile is past the end
  const float* yt = ys + warp * kTile * kBlock;
  for (int it = 0; it < kTile * kBlock / 32; ++it) {
    const float* yi = yt + it * 32;
    const int b = bin_index(fabsf(yi[lane]), bin_scale);
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (lane == __ffs(peers) - 1) {
      float s = 0.f;
      for (unsigned m = peers; m; m &= m - 1) {
        const float a = fabsf(yi[__ffs(m) - 1]);
        s = __fadd_rn(s, __fmul_rn(a, a));
      }
      hc[b] += __popc(peers);
      he[b] = __fadd_rn(he[b], s);
    }
    __syncwarp();
  }
  const long tile = blockIdx.x * (long)(kRows / kTile) + warp;
  for (int b = lane; b < kNbins; b += 32) {
    cnt[tile * kNbins + b] = (float)hc[b];
    eng[tile * kNbins + b] = he[b];
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

// The flat single histogram from its tile rows, in two fixed-order stages
// (one CTA summing 131k rows of 512 bins would leave 2 threads per bin):
// CTA g of the first sums rows [g * per, (g + 1) * per), thread b down bin
// b (a warp reads 32 bins of a row, coalesced), counts as 64-bit integers
// and energies in double; the second adds the partial rows in range order
// and rounds once. per, and with it the order, depends on n_rows alone.
constexpr int kMaxParts = 256;

__host__ __device__ inline long flat_rows_per_part(long n_rows) {
  const long per = (n_rows + kMaxParts - 1) / kMaxParts;
  return per < 16 ? 16 : per;
}

__global__ void __launch_bounds__(kNbins)
flat_partial_kernel(const float* __restrict__ cnt_rows,
                    const float* __restrict__ eng_rows, long n_rows,
                    long per, long long* __restrict__ part_c,
                    double* __restrict__ part_e) {
  const int b = threadIdx.x;
  const long r0 = blockIdx.x * per;
  const long r1 = r0 + per < n_rows ? r0 + per : n_rows;
  long long c = 0;
  double e = 0.0;
  for (long r = r0; r < r1; ++r) {
    c += (long long)cnt_rows[r * kNbins + b];
    e += (double)eng_rows[r * kNbins + b];
  }
  part_c[blockIdx.x * kNbins + b] = c;
  part_e[blockIdx.x * kNbins + b] = e;
}

__global__ void __launch_bounds__(kNbins)
flat_total_kernel(const long long* __restrict__ part_c,
                  const double* __restrict__ part_e, int n_parts,
                  float* __restrict__ cnt, float* __restrict__ eng) {
  const int b = threadIdx.x;
  long long c = 0;
  double e = 0.0;
  for (int g = 0; g < n_parts; ++g) {
    c += part_c[g * kNbins + b];
    e += part_e[g * kNbins + b];
  }
  cnt[b] = (float)c;
  eng[b] = (float)e;
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
  cudaFuncSetAttribute(dct_hist_flat_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kDctSmem);
  const int grid = (nb + kRows - 1) / kRows;
  dct_hist_flat_kernel<<<grid, kThreads, kDctSmem, (cudaStream_t)stream>>>(
      x, dt, y, cnt, eng, nb, bin_scale);
  return (int)cudaGetLastError();
}

// Bytes of the partial rows spectral_dct_hist needs as scratch.
size_t spectral_dct_hist_parts_bytes() {
  return (size_t)kMaxParts * kNbins * (sizeof(long long) + sizeof(double));
}

// The flat single histogram: the tiled kernel into the caller's scratch
// rows (n_blocks / 8 of them), their partial sums into ``parts``
// (spectral_dct_hist_parts_bytes()), then the total into cnt and eng (all
// zero for n_blocks = 0).
int spectral_dct_hist(const float* x, const float* dt, float* y,
                      float* cnt_rows, float* eng_rows, void* parts,
                      float* cnt, float* eng, int nb, float bin_scale,
                      void* stream) {
  int err = spectral_dct_hist_tiled(x, dt, y, cnt_rows, eng_rows, nb,
                                    bin_scale, stream);
  if (err != 0) return err;
  const long n_rows = nb > 0 ? nb / kTile : 0;
  const long per = flat_rows_per_part(n_rows);
  const int n_parts = (int)((n_rows + per - 1) / per);
  long long* part_c = static_cast<long long*>(parts);
  double* part_e = reinterpret_cast<double*>(part_c + kMaxParts * kNbins);
  if (n_parts > 0) {
    flat_partial_kernel<<<n_parts, kNbins, 0, (cudaStream_t)stream>>>(
        cnt_rows, eng_rows, n_rows, per, part_c, part_e);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  flat_total_kernel<<<1, kNbins, 0, (cudaStream_t)stream>>>(
      part_c, part_e, n_parts, cnt, eng);
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
