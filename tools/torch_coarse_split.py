#!/usr/bin/env python3
"""Where the coarse DCT pair (``dct_hist_coarse_tiled``, ``dct_hist_coarse``)
spends its time, on the card.

Appends cut-down variants of the coarse kernel to a copy of
``spectral_lossy.cu``, each built from the source's own device functions
and each adding one part to the one before, and times each with CUDA
events on the same inputs, beside the source's own entries and
``torch.matmul`` of the same f32 product (TF32 off). The variants
(``old_product`` only for a source whose coarse kernel still runs
``dct_rows``, as ``git show
c51a8cf:src/repro_torch/kernels/csrc/spectral_lossy.cu`` prints one):

  old_product   the synchronous-panel product and the store of y
  product       the pipelined product (``dct_rows_pipe``) and the store of y
  zeros         + 2 x 32 private columns zeroed
  bins          + every element's coarse bin
  rmw           + the two shared read-modify-writes per element
  full_pipe     + the column sums and tile rows (kernel 2 on ``dct_rows_pipe``)
  atomics       probe: ``product`` + words zeroed, every element's bin and
                exact units, two u32 shared atomic adds per element into
                one word pair per (tile, bin); bins 0 and 31 in registers
  atomics_x8    probe: the same into eight padded copies per tile (one per
                owner lane of a warp)
  lut_bins      probe: ``zeros`` + every element's coarse bin from a table
                per binade of its bits (bin_index only inside a window
                where the table cannot decide)
  lut_full      probe: ``full_pipe`` with the table's bins

beside the source's own entries:

  kernel2       ``spectral_dct_hist_coarse_tiled``
  kernel6       ``spectral_dct_hist_coarse`` (the old source: kernel 2 into
                per-tile scratch rows and their one-CTA sum; the new one:
                persistent range CTAs and a fixed-order total)

The old source runs old_product, product, bins, rmw, full_pipe and the
atomics probes; the new one product, zeros, bins, rmw and the lut probes.
The table is built on the card by a scan of every bit pattern with
bin_index itself, and checked against bin_index over all 2^31 non-negative
patterns.

Also prints ``nvcc -Xptxas -v`` for every kernel of the source and the
variants, and, when ``cuobjdump`` is there, static SASS counts of each.
Run from the repository root on a machine with one card::

    python3 tools/torch_coarse_split.py [--source path/to/spectral_lossy.cu]

It writes ``build/coarse_split_<kernel>.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# Every variant, in the order of the split; the kernel's template argument
# is the index here. old_product needs a source that still has dct_rows.
ALL_VARIANTS = ("old_product", "product", "zeros", "bins", "rmw", "full_pipe",
                "atomics", "atomics_x8", "lut_bins", "lut_full")
OLD_VARIANTS = ("old_product", "product", "bins", "rmw", "full_pipe",
                "atomics", "atomics_x8")
NEW_VARIANTS = ("product", "zeros", "bins", "rmw", "lut_bins", "lut_full")

# Appended to the source (so the anonymous namespace's helpers are in
# scope), after ``#define SPLIT_OLD 0`` or 1.
_VARIANTS = r"""
namespace {
#if SPLIT_OLD
constexpr size_t kPipeSmem = kFlatSmem;   // the old source's name
#endif
enum { OLD_PRODUCT, PRODUCT, ZEROS, BINS, RMW, FULL_PIPE, ATOMICS, ATOMICS_X8,
       LUT_BINS, LUT_FULL };
constexpr int kCopies = 8;
constexpr int kCopyStride = kCoarse + 1;
constexpr size_t kLutSmem = kPipeSmem + 256 * sizeof(uint4);

__device__ __forceinline__ unsigned split_units(float a2, int c) {
  const unsigned u = __float_as_uint(a2);
  return ((u & 0x7fffffu) | 0x800000u) << ((int)(u >> 23) - 127 - flat_base(c << 4));
}

__device__ __noinline__ int split_bin_slow(float a, float bin_scale) {
  return bin_index(a, bin_scale) >> 4;
}

// The coarse bin from a table per binade of a's f32 bits (u >> 23):
// {lo, hi, bin below lo, bin from hi}; between lo and hi bin_index decides.
__device__ __forceinline__ int split_lut_bin(float a, const uint4* lut,
                                             float bin_scale) {
  const unsigned u = __float_as_uint(a);
  const uint4 t = lut[u >> 23];
  if (u < t.x) return (int)t.z;
  if (u >= t.y) return (int)t.w;
  return split_bin_slow(a, bin_scale);
}

// The table, by a scan of every bit pattern of each binade with
// bin_index itself: lo = the least pattern whose bin is not the binade's
// first, hi = one past the greatest whose bin is not its last.
__global__ void split_lut_scan(float bin_scale, uint4* lut) {
  const unsigned e = blockIdx.x;
  const unsigned first = e << 23, last = first | 0x7fffffu;
  const int c_lo = bin_index(__uint_as_float(first), bin_scale) >> 4;
  const int c_hi = bin_index(__uint_as_float(last), bin_scale) >> 4;
  unsigned lo = last + 1, hi = first;
  for (unsigned m = blockIdx.y * blockDim.x + threadIdx.x; m <= 0x7fffffu;
       m += gridDim.y * blockDim.x) {
    const unsigned u = first | m;
    const int c = bin_index(__uint_as_float(u), bin_scale) >> 4;
    if (c != c_lo) lo = min(lo, u);
    if (c != c_hi) hi = max(hi, u + 1);
  }
  atomicMin(&lut[e].x, lo);
  atomicMax(&lut[e].y, hi);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    lut[e].z = (unsigned)c_lo;
    lut[e].w = (unsigned)c_hi;
  }
}

__global__ void split_lut_init(uint4* lut) {
  const unsigned e = threadIdx.x;
  lut[e] = make_uint4((e + 1) << 23, e << 23, 0u, 0u);   // no pattern yet
}

template <int V>
__global__ void __launch_bounds__(kThreads, 2)
split_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             float* __restrict__ y, float* __restrict__ cnt,
             float* __restrict__ eng, int nb, float bin_scale,
             const uint4* __restrict__ lut_g) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* stages = xs + kTileBytes / sizeof(float);
  uint4* lut = reinterpret_cast<uint4*>(stages + 2 * kStageFloats);
  const long row0 = (long)blockIdx.x * kRows;
  const Owner o;
  float acc[8][8];
  const int tid = threadIdx.x;
  if constexpr (V == OLD_PRODUCT) {
#if SPLIT_OLD
    dct_rows(x, dt, y, nb, xs, stages, o, acc);
#endif
  } else {
    if constexpr (V >= LUT_BINS) lut[tid] = lut_g[tid];
    const bool live = dct_rows_pipe(x, dt, y, nb, row0, xs, stages, o, acc);
    if constexpr (V == PRODUCT) return;
    if constexpr (V <= FULL_PIPE || V >= LUT_BINS) {
      __syncthreads();
      float* hc = xs;
      float* he = xs + kCoarse * kHs;
#pragma unroll
      for (int b = 0; b < kCoarse; ++b) {
        hc[b * kHs + tid] = 0.f;
        he[b * kHs + tid] = 0.f;
      }
      unsigned sink = 0u;
      if (live && V != ZEROS) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float a = fabsf(acc[i][j]);
            int b;
            if constexpr (V >= LUT_BINS)
              b = split_lut_bin(a, lut, bin_scale);
            else
              b = bin_index(a, bin_scale) >> 4;
            if constexpr (V == BINS || V == LUT_BINS) {
              sink += (unsigned)b + __float_as_uint(__fmul_rn(a, a));
            } else {
              hc[b * kHs + tid] += 1.f;
              he[b * kHs + tid] = __fadd_rn(he[b * kHs + tid], __fmul_rn(a, a));
            }
          }
      }
      if (sink == 0x9e3779b9u) hc[tid] = 1.f;
      __syncthreads();
      if constexpr (V == ZEROS || V == BINS || V == RMW || V == LUT_BINS) {
        if (hc[tid] == 12345.f) cnt[blockIdx.x] = 1.f;   // keeps the columns
      } else {
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
    } else {   // ATOMICS, ATOMICS_X8: exact u32 words, as the flat pair's
      __syncthreads();
      constexpr int kPer = V == ATOMICS ? 1 : kCopies;
      constexpr int kStride = V == ATOMICS ? kCoarse : kCopyStride;
      constexpr int kW = kTiles * kPer * kStride;
      unsigned* lo = reinterpret_cast<unsigned*>(xs);
      unsigned* hi = lo + kW;
      for (int i = tid; i < 2 * kW; i += kThreads) lo[i] = 0u;
      __syncthreads();
      const int base = (o.tr * kPer + (V == ATOMICS ? 0 : (tid & 7))) * kStride;
      float c0 = 0.f, e0 = 0.f, c1 = 0.f, e1 = 0.f;
      if (live) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float a = fabsf(acc[i][j]);
            const int b = bin_index(a, bin_scale) >> 4;
            const float a2 = __fmul_rn(a, a);
            if (b == 0) {
              c0 += 1.f;
              e0 = __fadd_rn(e0, a2);
            } else if (b == kCoarse - 1) {
              c1 += 1.f;
              e1 = __fadd_rn(e1, a2);
            } else {
              const unsigned u = split_units(a2, b);
              atomicAdd(lo + base + b, u & 0x1fffffu);
              atomicAdd(hi + base + b, (1u << 20) | (u >> 21));
            }
          }
      }
      __syncthreads();
      if (lo[tid] == 0x9e3779b9u || c0 + e0 + c1 + e1 == 12345.f)
        cnt[blockIdx.x] = 1.f;                           // keeps the words
    }
  }
}

template <int V>
int split_go(const float* x, const float* dt, float* y, float* cnt,
             float* eng, int nb, float bin_scale, const uint4* lut,
             cudaStream_t s) {
  cudaFuncSetAttribute(split_kernel<V>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kLutSmem);
  cudaFuncSetAttribute(split_kernel<V>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const size_t smem = V >= LUT_BINS ? kLutSmem : kPipeSmem;
  split_kernel<V><<<(nb + kRows - 1) / kRows, kThreads, smem, s>>>(
      x, dt, y, cnt, eng, nb, bin_scale, lut);
  return (int)cudaGetLastError();
}
}  // namespace

// The lookup table of the lut variants (256 uint4), built on the stream.
extern "C" int split_lut(float bin_scale, void* lut, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  split_lut_init<<<1, 256, 0, s>>>(static_cast<uint4*>(lut));
  split_lut_scan<<<dim3(256, 64), 256, 0, s>>>(bin_scale,
                                               static_cast<uint4*>(lut));
  return (int)cudaGetLastError();
}

// Bits, among all 2^31 non-negative patterns, whose lut bin differs from
// bin_index's coarse bin, counted into *bad.
__global__ void split_lut_check_kernel(float bin_scale, const uint4* lut,
                                       unsigned long long* bad) {
  unsigned long long n = 0;
  for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       u < (1ull << 31); u += (unsigned long long)gridDim.x * blockDim.x) {
    const float a = __uint_as_float((unsigned)u);
    n += split_lut_bin(a, lut, bin_scale) != (bin_index(a, bin_scale) >> 4);
  }
  if (n) atomicAdd(bad, n);
}

extern "C" int split_lut_check(float bin_scale, const void* lut, void* bad,
                               void* stream) {
  split_lut_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      bin_scale, static_cast<const uint4*>(lut),
      static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}

extern "C" int split_launch(int v, const float* x, const float* dt, float* y,
                            float* cnt, float* eng, int nb, float bin_scale,
                            const void* lut, void* stream) {
  if (nb <= 0) return 0;
  const uint4* t = static_cast<const uint4*>(lut);
  cudaStream_t s = (cudaStream_t)stream;
  switch (v) {
    case OLD_PRODUCT: return split_go<OLD_PRODUCT>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case PRODUCT: return split_go<PRODUCT>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case ZEROS: return split_go<ZEROS>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case BINS: return split_go<BINS>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case RMW: return split_go<RMW>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case FULL_PIPE: return split_go<FULL_PIPE>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case ATOMICS: return split_go<ATOMICS>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case ATOMICS_X8: return split_go<ATOMICS_X8>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case LUT_BINS: return split_go<LUT_BINS>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
    case LUT_FULL: return split_go<LUT_FULL>(x, dt, y, cnt, eng, nb, bin_scale, t, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build(work: Path, src: str) -> tuple[Path, str]:
    from repro_torch.kernels import _build

    cu = work / "coarse_split.cu"
    cu.write_text(src)
    so = work / "coarse_split.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed\n{out.stdout}{out.stderr}")
    return so, out.stdout + out.stderr


def ptxas_table(log: str) -> dict:
    """``-Xptxas -v`` per kernel: registers, shared memory, spills."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"registers|spill", ln):
            out.setdefault(fn, []).append(ln.split("ptxas info    :")[-1]
                                          .strip())
    return out


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction counts of the coarse kernels and variants:
    all, and FFMA, shared loads/stores/atomics, MUFU, barriers, cp.async."""
    from repro_torch.kernels import _build

    dump = Path(_build.nvcc()).with_name("cuobjdump")
    if not dump.exists():
        return {"cuobjdump": "not found"}
    sass = subprocess.run([str(dump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = (m.group(1) if re.search(r"split_kernel|coarse|reduce_rows",
                                          m.group(1)) else None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if fn and m:
            c = out.setdefault(fn, {"all": 0})
            c["all"] += 1
            op = m.group(1)
            for key in ("FFMA", "LDS", "STS", "ATOMS", "MUFU", "BAR",
                        "LDGSTS", "STG"):
                if op.startswith(key):
                    c[key] = c.get(key, 0) + 1
    return out


def time_call(fn, *, reps=10, samples=5) -> float:
    """Median over ``samples`` of the mean device ms of ``reps`` back-to-back
    calls (CUDA events), after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def _checked(fn, *args):
    err = fn(*args)
    if err:
        raise SystemExit(f"launch failed with CUDA error {err}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=Path, default=ROOT / "src" / "repro_torch"
                    / "kernels" / "csrc" / "spectral_lossy.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spectral_lossy as K

    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.device_line(), flush=True)
    src = args.source.read_text()
    old = "bool dct_rows(" in src
    variants = OLD_VARIANTS if old else NEW_VARIANTS
    kernel = "dct_hist_coarse_kernel" if old else "dct_coarse_tiled_kernel"
    work = Path(tempfile.mkdtemp(prefix="coarse_split_"))
    so, log = build(work, src + f"\n#define SPLIT_OLD {int(old)}\n"
                    + _VARIANTS)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.split_launch.argtypes = [I, P, P, P, P, P, I, F, P, P]
    lib.split_lut.argtypes = [F, P, P]
    lib.split_lut_check.argtypes = [F, P, P, P]
    lib.spectral_dct_hist_coarse_tiled.argtypes = [P] * 5 + [I, F, P]
    if old:
        lib.spectral_dct_hist_coarse.argtypes = [P] * 7 + [I, F, P]
    else:
        lib.spectral_dct_hist_coarse.argtypes = [P] * 6 + [I, F, P]
        lib.spectral_dct_hist_coarse_parts_bytes.restype = ctypes.c_size_t
    ptxas = ptxas_table(log)
    print("ptxas:\n" + "\n".join(f"  {k}: {v}" for k, v in ptxas.items()),
          flush=True)
    sass = sass_counts(so)
    print("SASS: " + json.dumps(sass), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    cfg = configs.get("smollm-135m")
    keys, sizes, rows = smoke.moment_rows(cfg)
    n_embed = sizes[keys.index("['mu']['embed']['embedding']")]
    shapes = {
        "packed": smoke._spectral_payload(gen, sizes, rows, dev),
        "embed": ops._pad_blocks(ref.blockize(smoke._leaf_payload(
            gen, n_embed, dev, "mu"))[0], K.HIST_TILE),
        "4096": torch.randn((4096, ref.BLOCK), generator=gen, device=dev),
    }
    dt = ref.dct_tensor(dev).T.contiguous()
    result = {"device": smoke.device_line(), "kernel": kernel,
              "source": str(args.source), "ptxas": ptxas, "sass": sass,
              "ms": {}}
    stream = torch.cuda.current_stream().cuda_stream
    # the lut variants' table, and its disagreements with bin_index over
    # every non-negative f32 bit pattern (a must be 0 for the variant to
    # bin as the kernel does)
    lut = torch.zeros(256 * 4, dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    _checked(lib.split_lut, K._BIN_SCALE, lut.data_ptr(), stream)
    _checked(lib.split_lut_check, K._BIN_SCALE, lut.data_ptr(),
             bad.data_ptr(), stream)
    table = lut.view(256, 4).cpu().numpy().astype("uint32")
    windows = [int(e) for e in range(256) if table[e, 0] < table[e, 1]]
    result["lut"] = {"disagreements": int(bad.item()),
                     "binades_with_a_window": windows,
                     "table": table.tolist()}
    print(f"lut: {int(bad.item())} of 2^31 patterns off bin_index; binades "
          f"where bin_index decides a window: {windows}", flush=True)
    for label, x in shapes.items():
        nb = x.shape[0]
        y = torch.empty_like(x)
        cnt = torch.empty((nb // 8, ref.NBINS_COARSE), device=dev)
        eng = torch.empty_like(cnt)
        out = torch.empty((2, ref.NBINS_COARSE), device=dev)
        common = (x.data_ptr(), dt.data_ptr(), y.data_ptr())
        calls = {n: (lambda v=ALL_VARIANTS.index(n): _checked(
            lib.split_launch, v, *common, cnt.data_ptr(), eng.data_ptr(), nb,
            K._BIN_SCALE, lut.data_ptr(), stream)) for n in variants}
        calls["kernel2"] = lambda: _checked(
            lib.spectral_dct_hist_coarse_tiled, *common, cnt.data_ptr(),
            eng.data_ptr(), nb, K._BIN_SCALE, stream)
        if old:
            calls["kernel6"] = lambda: _checked(
                lib.spectral_dct_hist_coarse, *common, cnt.data_ptr(),
                eng.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), nb,
                K._BIN_SCALE, stream)
        else:
            parts = torch.empty(lib.spectral_dct_hist_coarse_parts_bytes()
                                // 8, dtype=torch.int64, device=dev)
            calls["kernel6"] = lambda: _checked(
                lib.spectral_dct_hist_coarse, *common, parts.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), nb, K._BIN_SCALE,
                stream)
        calls["torch.matmul"] = lambda: torch.matmul(x, dt)
        ms = {n: [] for n in calls}
        for order in (list(calls), list(calls)[::-1]):       # in turns
            for n in order:
                ms[n].append(time_call(calls[n]))
        row = {n: statistics.mean(v) for n, v in ms.items()}
        result["ms"][label] = {"blocks": nb, **row}
        print(f"{label} ({nb} blocks): " + ", ".join(
            f"{n} {v:.4f} ms" for n, v in row.items()), flush=True)
    out_path = ROOT / "build" / f"coarse_split_{kernel}.json"
    out_path.parent.mkdir(exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path.relative_to(ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
