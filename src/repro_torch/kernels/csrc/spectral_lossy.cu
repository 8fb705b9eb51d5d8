// The spectral lossy codec's device kernels for Hopper (sm_90a): the DCT
// with its coarse histogram, the refine histogram, the threshold quantiser,
// and the dequantise + inverse DCT of restore.
//
// Replaces, in src/repro/kernels/spectral_lossy.py (the Pallas TPU kernels):
//   dct_hist_coarse_tiled  <- _dct_hist_coarse_tiled_kernel  (dct_hist_coarse_tiled)
//   hist_refine_tiled      <- _hist_refine_tiled_kernel      (hist_refine_tiled)
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
//   threshold_quant        kept = |y| >= t_row ? y : 0; scale = amax *
//                          f32(1/127) (1 for an all-zero row);
//                          q = clip(rint(kept / scale), -127, 127)
//   dequant_idct           x = (q * scale_row) . D
//
// Bounds on this card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s f32 FMA outside
// the tensor cores; TF32 is not allowed for this codec):
//   the two DCT kernels are bound by operations: 512 flops per element
//   (a 256-long dot product) against 8 bytes moved (f32 in and out), about
//   64 flops per byte where the card balances at 20. The refine histogram
//   and the quantiser read 4 bytes per element and do a log2 or a divide
//   on it: bound by bytes.
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
//   * The rows a thread owns are one 8-row histogram tile. After the
//     product each thread bins its 64 outputs into a private column of a
//     shared-memory table (the row tile's space, reused), and one thread
//     per (tile, bin) sums the 32 columns of its tile in a fixed order and
//     writes the tile's row. No atomics anywhere: a run is deterministic,
//     as the TPU's in-order grid was.
//   * Refine: one warp per 8-row tile (2048 elements, 64 per lane),
//     private per-lane bins in shared memory, then the same fixed-order
//     sum. Quantiser: one warp per row, a warp max for amax.
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

__global__ void __launch_bounds__(kThreads, 2)
dct_hist_coarse_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,   // D^T, row-major
                       float* __restrict__ y, float* __restrict__ cnt,
                       float* __restrict__ eng, int nb, float bin_scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* panel = xs + kTileBytes / sizeof(float);
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
  const Owner o;
  float acc[8][8];
  gemm_rows(xs, panel, dt, o, acc);

  const bool live = row0 + o.tr * 8 < nb;   // nb is a multiple of kTile
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
