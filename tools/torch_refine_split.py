#!/usr/bin/env python3
"""Where the single-tensor refine histogram (``hist_refine``) spends its
time, on the card.

Appends cut-down variants of the refine kernel to a copy of
``spectral_lossy.cu`` (the source's own ``bin_index`` and constants are in
scope) and times each with CUDA events on the same inputs: the ``embed``
moment leaf of full-width ``smollm-135m`` (110,592 blocks, 113 MB of f32
coefficients) and 1,008 blocks, each the DCT of a moment-like payload, with
the coarse bin a real selection picks there (``select_coarse`` at eps
1e-2). The variants of the one-warp-per-8-row-tile layout of kernel 7's
first launch (``hist_refine_kernel``; 1,728 CTAs of 256 threads at
``embed``), each adding one part to the one before:

  loads        the 16-byte loads of y alone, kept alive by a sum
  zeros        + the 2 x 16 x 257 f32 private columns zeroed per CTA
  bins         + the block's coarse value loaded per float4 and
               ``bin_index`` on every element
  rmw          + the two shared read-modify-writes per member

beside the source's own entries:

  refine_rows  ``spectral_hist_refine_tiled``: + the column sums and the
               tile rows (kernel 7's first launch as it was)
  kernel7      ``spectral_hist_refine``: the whole kernel (the old source:
               the tile rows and ``reduce_rows_kernel``; the new one:
               range CTAs and a fixed-order total)
  wrapper      ``hist_refine`` of this tree, per call (host steps
               included), and its device time by ``torch.profiler``

and probes of a one-pass design (persistent CTAs over the ranges
``range_parts`` gives, 8 warps, each loading a whole 8-row tile, 16 float4
a lane, before its first use):

  stream       the loads alone, kept alive by a sum: the floor of a pass
  stream_cs    the same with ``__ldcs`` (evict-first) loads
  stream_bins  + ``bin_index`` on every element
  torch.sum    one ``torch.sum`` over y (a yardstick of a pass)

Before timing, the source's kernel 7 is held against the plain version
(counts equal, energies rtol 1e-5), its counts against this tree's, and
the source's kernel 3 rows (``spectral_hist_refine_tiled``) against this
tree's bit for bit.

Prints ``nvcc -Xptxas -v`` for every kernel and, where ``cuobjdump`` is
there, static SASS counts of the refine kernels. Run from the repository root
on a machine with one card::

    python3 tools/torch_refine_split.py [--source path/to/spectral_lossy.cu]

(an older source: ``git show b535e70:src/repro_torch/kernels/csrc/
spectral_lossy.cu``). It writes ``build/refine_split.json``.
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

VARIANTS = ("loads", "zeros", "bins", "rmw", "stream", "stream_cs",
            "stream_bins")

_VARIANTS = r"""
namespace {
enum { RS_LOADS, RS_ZEROS, RS_BINS, RS_RMW, RS_STREAM, RS_STREAM_CS,
       RS_STREAM_BINS };

// The old layout: one warp per 8-row tile, lane l reads float4s l, l + 32,
// ... of the tile, 4 unrolled.
template <int V>
__global__ void __launch_bounds__(kRefineThreads)
rsplit_tile_kernel(const float* __restrict__ y, const int* __restrict__ coarse,
                   float* __restrict__ sink, int n_tiles, float bin_scale) {
  __shared__ float hc[kFine * kRs];
  __shared__ float he[kFine * kRs];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (V >= RS_ZEROS) {
#pragma unroll
    for (int b = 0; b < kFine; ++b) {
      hc[b * kRs + tid] = 0.f;
      he[b * kRs + tid] = 0.f;
    }
  }
  float acc = 0.f;
  unsigned acc_u = 0u;
  const long tile = (long)blockIdx.x * kRefineWarps + warp;
  if (tile < n_tiles) {
    const float* yt = y + tile * kTile * kBlock;
    const int* ct = coarse + tile * kTile;
#pragma unroll 4
    for (int f = lane; f < kTile * kBlock / 4; f += 32) {
      const float4 v = *reinterpret_cast<const float4*>(yt + f * 4);
      if constexpr (V <= RS_ZEROS) {
        acc += (v.x + v.y) + (v.z + v.w);
      } else {
        const int c = ct[f / (kBlock / 4)];
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = fabsf(vs[j]);
          const int idx = bin_index(a, bin_scale);
          if constexpr (V == RS_BINS) {
            acc_u += (unsigned)idx + ((idx >> 4) == c);
          } else if ((idx >> 4) == c) {
            const int k = idx - c * kFine;
            hc[k * kRs + tid] += 1.f;
            he[k * kRs + tid] = __fadd_rn(he[k * kRs + tid], __fmul_rn(a, a));
          }
        }
      }
    }
  }
  __syncthreads();
  bool keep = acc == 12345.f || acc_u == 0x9e3779b9u;
  if constexpr (V >= RS_ZEROS) keep = keep || hc[tid] + he[tid] == 12345.f;
  if (keep) sink[blockIdx.x] = 1.f;
}

// One pass: CTA g takes the 8-row tiles of range_parts' range g, warp w
// the tiles w, w + 8, ... of it, each loaded whole (16 float4 a lane)
// before its first use.
template <int V>
__global__ void __launch_bounds__(256, 2)
rsplit_stream_kernel(const float* __restrict__ y, float* __restrict__ sink,
                     int nb, long per, int c, float bin_scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long n_groups = (nb + kRows - 1) / kRows;
  const long g1 = (blockIdx.x + 1) * per < n_groups ? (blockIdx.x + 1) * per
                                                    : n_groups;
  const long t1 = g1 * (kRows / kTile) < nb / kTile ? g1 * (kRows / kTile)
                                                   : nb / kTile;
  float acc = 0.f;
  unsigned acc_u = 0u;
  for (long t = blockIdx.x * per * (kRows / kTile) + warp; t < t1; t += 8) {
    const float4* yt = reinterpret_cast<const float4*>(y + t * kTile * kBlock);
    float4 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = V == RS_STREAM_CS ? __ldcs(yt + lane + 32 * i) : yt[lane + 32 * i];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if constexpr (V == RS_STREAM_BINS) {
        const float vs[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = bin_index(fabsf(vs[j]), bin_scale);
          acc_u += (unsigned)idx + ((idx >> 4) == c);
        }
      } else {
        acc += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      }
    }
  }
  if (acc == 12345.f || acc_u == 0x9e3779b9u) sink[blockIdx.x] = 1.f;
}

template <int V>
int rsplit_go(const float* y, const int* coarse, float* sink, int nb, int c,
              float bin_scale, cudaStream_t s) {
  if constexpr (V <= RS_RMW) {
    const int n_tiles = nb / kTile;
    rsplit_tile_kernel<V><<<(n_tiles + kRefineWarps - 1) / kRefineWarps,
                            kRefineThreads, 0, s>>>(y, coarse, sink, n_tiles,
                                                    bin_scale);
  } else {
    long per;
    const int n_parts = range_parts(nb, per);
    rsplit_stream_kernel<V><<<n_parts, 256, 0, s>>>(y, sink, nb, per, c,
                                                     bin_scale);
  }
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int rsplit_launch(int v, const float* y, const int* coarse,
                             float* sink, int nb, int c, float bin_scale,
                             void* stream) {
  if (nb <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (v) {
    case RS_LOADS: return rsplit_go<RS_LOADS>(y, coarse, sink, nb, c, bin_scale, s);
    case RS_ZEROS: return rsplit_go<RS_ZEROS>(y, coarse, sink, nb, c, bin_scale, s);
    case RS_BINS: return rsplit_go<RS_BINS>(y, coarse, sink, nb, c, bin_scale, s);
    case RS_RMW: return rsplit_go<RS_RMW>(y, coarse, sink, nb, c, bin_scale, s);
    case RS_STREAM: return rsplit_go<RS_STREAM>(y, coarse, sink, nb, c, bin_scale, s);
    case RS_STREAM_CS: return rsplit_go<RS_STREAM_CS>(y, coarse, sink, nb, c, bin_scale, s);
    case RS_STREAM_BINS: return rsplit_go<RS_STREAM_BINS>(y, coarse, sink, nb, c, bin_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build(work: Path, src: str) -> tuple[Path, str]:
    from repro_torch.kernels import _build

    cu = work / "refine_split.cu"
    cu.write_text(src)
    so = work / "refine_split.so"
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
    return {k: v for k, v in out.items()
            if re.search(r"refine|rsplit|reduce_rows|total", k)}


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction counts of the refine kernels and variants:
    all, and shared loads/stores/atomics, votes, MUFU, cp.async, global
    loads."""
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
            fn = (m.group(1) if re.search(r"refine|rsplit", m.group(1))
                  else None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if fn and m:
            c = out.setdefault(fn, {"all": 0})
            c["all"] += 1
            op = m.group(1)
            for key in ("LDS", "STS", "ATOMS", "VOTE", "POPC", "MUFU",
                        "LDGSTS", "LDG", "BAR", "WARPSYNC"):
                if op.startswith(key):
                    c[key] = c.get(key, 0) + 1
                    break
    return out


def time_call(fn, *, reps=10, samples=5) -> float:
    """Median over ``samples`` of the mean ms of ``reps`` back-to-back
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
    old = "float* cnt_rows" in src        # kernel 7 with per-tile rows
    work = Path(tempfile.mkdtemp(prefix="refine_split_"))
    so, log = build(work, src + _VARIANTS)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rsplit_launch.argtypes = [I, P, P, P, I, I, F, P]
    lib.spectral_hist_refine_tiled.argtypes = [P] * 4 + [I, F, P]
    if old:
        lib.spectral_hist_refine.argtypes = [P] * 6 + [I, F, P]
    else:
        lib.spectral_hist_refine.argtypes = [P, P, I, I, I, P, P, P, I, F, P]
        lib.spectral_hist_refine_parts_bytes.restype = ctypes.c_size_t
        lib.spectral_refine_table.argtypes = [P, F, P]
    ptxas = ptxas_table(log)
    print("ptxas:\n" + "\n".join(f"  {k}: {v}" for k, v in ptxas.items()),
          flush=True)
    sass = sass_counts(so)
    print("SASS: " + json.dumps(sass), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg = configs.get("smollm-135m")
    keys, sizes, _ = smoke.moment_rows(cfg)
    n_embed = sizes[keys.index("['mu']['embed']['embedding']")]
    stream = torch.cuda.current_stream().cuda_stream
    table = None
    if not old:
        table = torch.empty(2 * ref.NBINS_COARSE, dtype=torch.int32,
                            device=dev)
        _checked(lib.spectral_refine_table, table.data_ptr(), K._BIN_SCALE,
                 stream)
    result = {"device": smoke.device_line(), "source": str(args.source),
              "old_source": old, "ptxas": ptxas, "sass": sass, "shapes": {}}
    for label, n in (("embed", n_embed), ("1008", 1001 * 256 - 5)):
        x = smoke._leaf_payload(gen, n, dev, "mu")
        xb = ops._pad_blocks(ref.blockize(x)[0], K.HIST_TILE)
        nb = xb.shape[0]
        y, _, ce = K.dct_hist_coarse(xb)
        cc = ref.select_coarse(ce, smoke.EPS)[1]
        c = int(cc)
        block_cc = cc.to(torch.int32).expand(nb).contiguous()
        sink = torch.zeros(max(nb, 1), device=dev)
        rows = torch.empty((2, nb // 8, ref.NBINS_FINE), device=dev)
        out = torch.empty((2, ref.NBINS_FINE), device=dev)
        calls = {v: (lambda i=i: _checked(
            lib.rsplit_launch, i, y.data_ptr(), block_cc.data_ptr(),
            sink.data_ptr(), nb, c, K._BIN_SCALE, stream))
            for i, v in enumerate(VARIANTS)}
        calls["refine_rows"] = lambda: _checked(
            lib.spectral_hist_refine_tiled, y.data_ptr(), block_cc.data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(), nb, K._BIN_SCALE, stream)
        if old:
            calls["kernel7"] = lambda: _checked(
                lib.spectral_hist_refine, y.data_ptr(), block_cc.data_ptr(),
                rows[0].data_ptr(), rows[1].data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), nb, K._BIN_SCALE, stream)
        else:
            parts = torch.empty(lib.spectral_hist_refine_parts_bytes() // 8,
                                dtype=torch.int64, device=dev)
            calls["kernel7"] = lambda: _checked(
                lib.spectral_hist_refine, y.data_ptr(), cc.data_ptr(),
                cc.element_size(), 0, 0, table.data_ptr(), parts.data_ptr(),
                out.data_ptr(), nb, K._BIN_SCALE, stream)
        # kernel 3 of the source against this tree's, and kernel 7's
        # counts: the same bits, whatever the sources
        calls["refine_rows"]()
        cnt3, eng3 = K.hist_refine_tiled(y, block_cc)
        same3 = bool(torch.equal(rows[0], cnt3) and torch.equal(
            rows[1].view(torch.int32), eng3.view(torch.int32)))
        calls["kernel7"]()
        cnt7, eng7 = K.hist_refine(y, cc)
        same7 = bool(torch.equal(out[0], cnt7))
        rel7 = float(((out[1] - eng7).abs() / eng7.abs().clamp(min=1e-38))
                     .max())
        if not (same3 and same7):
            raise SystemExit(f"{label}: kernel 3's rows or kernel 7's counts "
                             f"differ between the source and this tree")
        calls["wrapper"] = lambda: K.hist_refine(y, cc)
        calls["torch.sum"] = lambda: torch.sum(y)
        # kernel 7 of the source against the plain version before timing
        cnt_p, eng_p = K.hist_refine_plain(y, block_cc)
        if not torch.equal(out[0], cnt_p):
            raise SystemExit(f"{label}: the source's kernel 7 counts differ "
                             f"from the plain version's")
        torch.testing.assert_close(out[1], eng_p, rtol=1e-5, atol=0.0)
        ms = {n_: [] for n_ in calls}
        for order in (list(calls), list(calls)[::-1]):       # in turns
            for n_ in order:
                ms[n_].append(time_call(calls[n_]))
        row = {n_: statistics.mean(v) for n_, v in ms.items()}
        syms = (("hist_refine_kernel", "reduce_rows_kernel") if "cnt_rows"
                in (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                    / "spectral_lossy.cu").read_text()
                else ("refine_range_kernel", "refine_total_kernel"))
        dev_ms, dev_ops = smoke.kernel_device_ms(calls["wrapper"], syms, n=5)
        members = int(cnt_p.sum())
        result["shapes"][label] = {
            "blocks": nb, "coarse": c, "members": members,
            "member_share": members / (nb * ref.BLOCK), "ms": row,
            "kernel3_rows_same_bits": same3, "kernel7_counts_same": same7,
            "kernel7_energy_rel_vs_tree": rel7,
            "wrapper_device_ms": dev_ms, "wrapper_device_ops": dev_ops}
        print(f"{label} ({nb} blocks, coarse {c}, members "
              f"{members / (nb * ref.BLOCK):.4f} of elements): " + ", ".join(
                  f"{n_} {v:.4f} ms" for n_, v in row.items())
              + f"; wrapper device {dev_ms} ms {dev_ops}; kernel 3 rows "
              f"same bits as this tree's: {same3}; kernel 7 counts same: "
              f"{same7}, energies rel {rel7:.3e}", flush=True)
    out_path = ROOT / "build" / "refine_split.json"
    out_path.parent.mkdir(exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path.relative_to(ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
