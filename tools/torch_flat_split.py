#!/usr/bin/env python3
"""Where the flat 512-bin kernel ``dct_hist_tiled`` spends its time, on
the card.

Builds variants of the kernel from a copy of ``spectral_lossy.cu``, each
adding one part to the one before, and times each with CUDA events on
the same inputs. For the earlier source, whose ``dct_hist_flat_kernel``
merged per-warp bins with ``__match_any_sync`` (``git show
76e661f:src/repro_torch/kernels/csrc/spectral_lossy.cu`` prints it):

  product      the DCT and the store of y, nothing after it
  bin_index    + y back to shared memory and every element's flat bin
  match        + ``__match_any_sync`` over the warp's bins
  full         the kernel as it is (+ the leaders' loops and bin updates)

For the current source (``dct_flat_tiled_kernel``):

  product      the pipelined DCT and the store of y, nothing after it
  bin_math     + the words zeroed, every element's bin and units (no
               atomics, no sums of bins 0 and 511, no rows)
  atomics      + the two u32 atomic adds per element
  edge_bins    + the fixed-order sums of bins 0 and 511
  full         the kernel as it is (+ the tile rows)

Also prints ``nvcc -Xptxas -v`` for the source as given and, when
``cuobjdump`` is there, the SASS that shared-memory ``atomicAdd`` on u32,
u64, f32 and f64 compile to. The variants live in a temporary directory
and nowhere in the package. Run from the repository root on a machine
with one card::

    python3 tools/torch_flat_split.py [--source path/to/spectral_lossy.cu]

It writes ``build/flat_split_<kernel>.json``.
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

VARIANTS = ("product", "bin_index", "match", "full")
NEW_VARIANTS = ("product", "bin_math", "atomics", "edge_bins", "full")

_STORE = "  dct_rows(x, dt, y, nb, xs, panel, o, acc);\n  __syncthreads();"
_LOOP_HEAD = ("  for (int it = 0; it < kTile * kBlock / 32; ++it) {\n"
              "    const float* yi = yt + it * 32;\n"
              "    const int b = bin_index(fabsf(yi[lane]), bin_scale);\n")
_LEADER = "    const unsigned peers = __match_any_sync(0xffffffffu, b);\n"
_LOOP_TAIL = "    __syncwarp();\n  }\n"

_PROBE = r"""
#include <cuda_runtime.h>
__global__ void atoms_u32(const unsigned* v, unsigned* out) {
  __shared__ unsigned h[512];
  h[threadIdx.x] = 0u; __syncthreads();
  atomicAdd(&h[v[threadIdx.x] & 511], v[threadIdx.x]); __syncthreads();
  out[threadIdx.x] = h[threadIdx.x];
}
__global__ void atoms_u64(const unsigned* v, unsigned long long* out) {
  __shared__ unsigned long long h[512];
  h[threadIdx.x] = 0ull; __syncthreads();
  atomicAdd(&h[v[threadIdx.x] & 511], (unsigned long long)v[threadIdx.x]);
  __syncthreads();
  out[threadIdx.x] = h[threadIdx.x];
}
__global__ void atoms_f32(const unsigned* v, float* out) {
  __shared__ float h[512];
  h[threadIdx.x] = 0.f; __syncthreads();
  atomicAdd(&h[v[threadIdx.x] & 511], (float)v[threadIdx.x]); __syncthreads();
  out[threadIdx.x] = h[threadIdx.x];
}
__global__ void atoms_f64(const unsigned* v, double* out) {
  __shared__ double h[512];
  h[threadIdx.x] = 0.0; __syncthreads();
  atomicAdd(&h[v[threadIdx.x] & 511], (double)v[threadIdx.x]); __syncthreads();
  out[threadIdx.x] = h[threadIdx.x];
}
"""


def variant_source(src: str, name: str) -> str:
    """The source with dct_hist_flat_kernel cut down to ``name``."""
    if name == "full":
        return src
    for anchor in (_STORE, _LOOP_HEAD, _LEADER):
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in the source: "
                             f"{anchor!r}")
    if name == "product":
        return src.replace(_STORE, _STORE.replace(
            "\n  __syncthreads();", "\n  return;\n  __syncthreads();"))
    head = src.index(_LOOP_HEAD) + len(_LOOP_HEAD)
    tail = src.index(_LOOP_TAIL, head)
    keep = ("    sink += (unsigned)b;\n" if name == "bin_index" else
            "    sink += __match_any_sync(0xffffffffu, b);\n")
    body = ("  unsigned sink = 0u;\n" + _LOOP_HEAD + keep + _LOOP_TAIL
            + "  hc[lane] += sink;\n")
    return src[:src.index(_LOOP_HEAD)] + body + src[tail + len(_LOOP_TAIL):]


_TILED = ("  const bool live = dct_rows_pipe(x, dt, y, nb, row0, xs, stages, o,"
          " acc);\n  const FlatWords w(xs);")
_ATOMS = """          const unsigned u = flat_units(a2, b);
          atomicAdd(lo + b, u & kLoMask);
          atomicAdd(hi + b, (1u << kLoBits) | (u >> kLoBits));"""
_SPECIAL = "  if (tid < 2 * kTiles) {"
_ROW = "    float c, e;\n    if (b == 0 || b == kNbins - 1) {"
_ROW_END = "    eng[(tile0 + t) * kNbins + b] = e;\n"
_SUMS = "  float c0 = 0.f, e0 = 0.f, c1 = 0.f, e1 = 0.f;\n"
_SP = "  w.sp[0 * kHs + tid] = c0;\n"


def new_variant_source(src: str, name: str) -> str:
    """The current source with dct_flat_tiled_kernel cut down to ``name``."""
    if name == "full":
        return src
    for anchor in (_TILED, _ATOMS, _SPECIAL, _ROW, _SUMS, _SP):
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in the source: "
                             f"{anchor!r}")
    if name == "product":
        return src.replace(_TILED, _TILED.replace("acc);\n",
                                                  "acc);\n  return;\n"))
    i = src.index(_ROW)
    j = src.index(_ROW_END, i) + len(_ROW_END)
    src = (src[:i] + "    if (w.lo[idx] == 0x9e3779b9u) cnt[idx] = 1.f;\n"
           + src[j:])                   # no rows (one load keeps the words)
    if name == "edge_bins":
        return src
    src = src.replace(_SPECIAL, "  if (tid < 0) {")
    if name == "atomics":
        return src
    src = src.replace(_ATOMS, "          sink += flat_units(a2, b) + b;")
    src = src.replace(_SUMS, _SUMS + "  unsigned sink = 0u;\n")
    return src.replace(_SP, "  if (sink == 0x9e3779b9u) w.lo[tid] = sink;\n"
                       + _SP)


def build(work: Path, name: str, src: str) -> tuple[Path, str]:
    from repro_torch.kernels import _build

    cu = work / f"flat_{name}.cu"
    cu.write_text(src)
    so = work / f"flat_{name}.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{out.stdout}{out.stderr}")
    return so, out.stdout + out.stderr


def ptxas_lines(log: str, kernel: str) -> list[str]:
    lines = log.splitlines()
    return [ln.strip() for i, ln in enumerate(lines)
            if any(kernel in p for p in lines[max(0, i - 3):i + 1])
            and re.search(r"registers|spill|smem", ln)]


def sass_probe(work: Path) -> dict:
    from repro_torch.kernels import _build

    cu = work / "atoms.cu"
    cu.write_text(_PROBE)
    cubin = work / "atoms.cubin"
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-cubin", "-o", str(cubin), str(cu)], check=True)
    dump = Path(_build.nvcc()).with_name("cuobjdump")
    if not dump.exists():
        return {"cuobjdump": "not found"}
    sass = subprocess.run([str(dump), "-sass", str(cubin)],
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"ATOMS|ATOM\b|CAS|BSSY|BRA", ln):
            out.setdefault(fn, []).append(
                re.sub(r"\s+", " ", ln.split(";")[0]).strip())
    return out


def sass_ops(lib: Path) -> dict:
    """Instruction counts (static) of the flat kernels in a built library:
    all, and the atomics, FFMAs, cp.async copies and barriers."""
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
            fn = (m.group(1) if re.search(r"dct_flat|flat_total|dct_hist_flat",
                                          m.group(1)) else None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", ln)
        if fn and m:
            c = out.setdefault(fn, {"all": 0})
            c["all"] += 1
            op = m.group(1)
            for key in ("ATOMS.ADD", "ATOMS.CAS", "FFMA", "LDGSTS", "BAR.SYNC"):
                if op.startswith(key):
                    c[key] = c.get(key, 0) + 1
    return out


def time_variant(lib, x, dt, y, cnt, eng, bin_scale, *, reps=10, samples=5):
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), dt.data_ptr(), y.data_ptr(), cnt.data_ptr(),
            eng.data_ptr(), x.shape[0], bin_scale, stream)
    for _ in range(3):
        if lib.spectral_dct_hist_tiled(*args):
            raise SystemExit("launch failed")
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            lib.spectral_dct_hist_tiled(*args)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


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
    new = "dct_flat_tiled_kernel" in src
    variants, cut, kernel = ((NEW_VARIANTS, new_variant_source,
                              "dct_flat_tiled_kernel") if new else
                             (VARIANTS, variant_source, "dct_hist_flat_kernel"))
    work = Path(tempfile.mkdtemp(prefix="flat_split_"))
    libs, ptxas = {}, {}
    for name in variants:
        so, log = build(work, name, cut(src, name))
        libs[name] = ctypes.CDLL(str(so))
        fn = libs[name].spectral_dct_hist_tiled
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptxas[name] = ptxas_lines(log, kernel)
        print(f"ptxas {name}: {ptxas[name]}", flush=True)
    full_log = build(work, "ptxas_all", src)[1]
    print("ptxas, every kernel of the source:\n" + "\n".join(
        ln for ln in full_log.splitlines()
        if re.search(r"Compiling entry|registers|spill", ln)), flush=True)
    probe = sass_probe(work)
    print("shared-memory atomicAdd SASS: " + json.dumps(probe), flush=True)
    ops_full = sass_ops(work / "flat_full.so")
    print("SASS of the flat kernels: " + json.dumps(ops_full), flush=True)

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
    result = {"device": smoke.device_line(), "kernel": kernel, "ptxas": ptxas,
              "sass_atomics": probe, "sass_flat": ops_full, "ms": {}}
    for label, x in shapes.items():
        nb = x.shape[0]
        y = torch.empty_like(x)
        cnt = torch.empty((nb // 8, ref.NBINS), device=dev)
        eng = torch.empty_like(cnt)
        ms = {n: [] for n in variants}
        for order in (variants, variants[::-1]):       # in turns
            for n in order:
                ms[n].append(time_variant(libs[n], x, dt, y, cnt, eng,
                                          K._BIN_SCALE))
        mm = smoke.time_ms(lambda: torch.matmul(x, dt), warmup=2, samples=5,
                           reps=3)
        row = {n: statistics.mean(v) for n, v in ms.items()}
        row["torch.matmul"] = mm
        result["ms"][label] = {"blocks": nb, **row}
        print(f"{label} ({nb} blocks): " + ", ".join(
            f"{n} {v:.4f} ms" for n, v in row.items()), flush=True)
    out = ROOT / "build" / f"flat_split_{kernel}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
