#!/usr/bin/env python3
"""Where the paged decode-attention kernel spends its time, on the card;
and, with ``--dequant``, the inverse DCT kernel of one source against
another's, bit for bit.

Paged attention (the default). Appends cut-down variants of the one-CTA-
per-(row, kv head) kernel (the design of ``git show
6ebcf91:src/repro_torch/kernels/csrc/paged_attention.cu``: 128 threads,
the row's pages one after another, each staged to f32 in shared memory,
four barriers a page) to a copy of ``--source`` and times each with CUDA
events, bf16, at the serving shape (B=8, 9 q / 3 kv heads, D=64, page 16,
a 4-page table, length 64) and the long one (a 256-page table, length
4096), every row at full length. Each variant adds one part:

  stage      the page id and the scalar staging loops (a 2-byte load and
             an integer division per element), two barriers a page
  stage_vec  the same pages staged with 16-byte loads, all of a thread's
             loads issued before its first store
  scores     + the G x ps scores (a warp per (g, t), shuffles)
  softmax    + the online softmax (a warp per query head)
  pv         + acc = acc * corr + p . V: the old kernel on 16-byte staging

beside:

  kernel     the source's own ``paged_decode_attention`` entry (the old
             kernel for the old source, split-K over pages for the new)
  sdpa       ``scaled_dot_product_attention`` on the gathered cache (a
             yardstick only)

``pv`` and ``kernel`` are held against the plain version (bf16, atol
3.2e-2) before they are timed, and ``kernel``'s output against this
tree's ``paged_decode_attention`` bit for bit (``bits_equal_to_tree``:
an older source gives the same bits where this tree's plan keeps one
group of all kv heads).

``--dequant``: builds ``--old-spectral`` (an older ``spectral_lossy.cu``,
as ``git show 6ebcf91:src/repro_torch/kernels/csrc/spectral_lossy.cu``
prints one) beside the tree's, runs both ``spectral_dequant_idct`` entries
on the same int8 coefficients and scales at the packed moment buffer of
full-width ``smollm-135m`` (1,050,928 blocks), at its ``embed`` leaf
(110,592) and at 1001 blocks, checks that x is the same bits, and times
both beside ``torch.matmul`` of the same f32 product (TF32 off).

Prints ``nvcc -Xptxas -v`` per kernel. Run from the repository root on a
machine with one card::

    python3 tools/torch_paged_split.py [--source path/to/paged_attention.cu]
    python3 tools/torch_paged_split.py --dequant --old-spectral path/to/old.cu

It writes ``build/paged_split.json`` (``build/dequant_split.json`` with
``--dequant``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = ("stage", "stage_vec", "scores", "softmax", "pv")

# Appended to the source: self-contained, so that it builds beside the old
# kernel and the new one alike.
_VARIANTS = r"""
namespace paged_split {
constexpr float kNeg = -0.7f * FLT_MAX;
constexpr int kThr = 128;
constexpr int kMaxChunks = 4;     // 16-byte loads a thread a page, per K/V
enum { STAGE, STAGE_VEC, SCORES, SOFTMAX, PV };

__device__ __forceinline__ float wsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float wmax(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_floats(int group, int d_k, int d_v, int ps) {
  return (size_t)group * d_k + (size_t)ps * d_k + (size_t)ps * d_v +
         (size_t)group * ps + (size_t)group * d_v + 3 * (size_t)group;
}

// A (ps x d) page slice of one kv head into f32 shared memory with 16-byte
// loads (8 bf16), every load of the thread issued before its first store.
__device__ __forceinline__ void stage_vec(const __nv_bfloat16* src,
                                          long long tok, int ps, int d,
                                          float* dst) {
  const int cpr = d / 8, n = ps * cpr;
  uint4 r[kMaxChunks];
#pragma unroll
  for (int u = 0; u < kMaxChunks; ++u) {
    const int i = threadIdx.x + u * kThr;
    if (i < n) {
      const int t = i / cpr, c = i - t * cpr;
      r[u] = *reinterpret_cast<const uint4*>(src + t * tok + c * 8);
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxChunks; ++u) {
    const int i = threadIdx.x + u * kThr;
    if (i < n) {
      const unsigned w[4] = {r[u].x, r[u].y, r[u].z, r[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[i * 8 + 2 * e] = __uint_as_float(w[e] << 16);
        dst[i * 8 + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThr)
variant_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k_pages,
               const __nv_bfloat16* __restrict__ v_pages,
               const int32_t* __restrict__ table,
               const int32_t* __restrict__ length,
               __nv_bfloat16* __restrict__ out, int n_kv, int group, int d_k,
               int d_v, int page_size, int pages_per_seq, float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x % n_kv;
  const int b = blockIdx.x / n_kv;
  const int hq = n_kv * group;
  float* q_s = smem;
  float* k_s = q_s + group * d_k;
  float* v_s = k_s + page_size * d_k;
  float* p_s = v_s + page_size * d_v;
  float* acc = p_s + group * page_size;
  float* m_s = acc + group * d_v;
  float* l_s = m_s + group;
  float* c_s = l_s + group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const __nv_bfloat16* q_rows = q + ((long long)b * hq + (long long)n * group) * d_k;
  for (int i = tid; i < group * d_k; i += blockDim.x)
    q_s[i] = __bfloat162float(q_rows[i]);
  for (int i = tid; i < group * d_v; i += blockDim.x) acc[i] = 0.f;
  for (int g = tid; g < group; g += blockDim.x) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  const int len = length[b];
  int n_pages = len > 0 ? (len + page_size - 1) / page_size : pages_per_seq;
  if (n_pages > pages_per_seq) n_pages = pages_per_seq;
  const long long k_tok = (long long)n_kv * d_k, v_tok = (long long)n_kv * d_v;
  for (int j = 0; j < n_pages; ++j) {
    const long long page = table[(long long)b * pages_per_seq + j];
    __syncthreads();
    const __nv_bfloat16* kp = k_pages + page * page_size * k_tok + (long long)n * d_k;
    const __nv_bfloat16* vp = v_pages + page * page_size * v_tok + (long long)n * d_v;
    if (V == STAGE) {
      for (int i = tid; i < page_size * d_k; i += blockDim.x) {
        const int t = i / d_k;
        k_s[i] = __bfloat162float(kp[t * k_tok + (i - t * d_k)]);
      }
      for (int i = tid; i < page_size * d_v; i += blockDim.x) {
        const int t = i / d_v;
        v_s[i] = __bfloat162float(vp[t * v_tok + (i - t * d_v)]);
      }
    } else {
      stage_vec(kp, k_tok, page_size, d_k, k_s);
      stage_vec(vp, v_tok, page_size, d_v, v_s);
    }
    __syncthreads();
    if (V >= SCORES) {
      for (int idx = warp; idx < group * page_size; idx += n_warps) {
        const int g = idx / page_size, t = idx - g * page_size;
        float dot = 0.f;
        for (int d = lane; d < d_k; d += 32)
          dot += q_s[g * d_k + d] * k_s[t * d_k + d];
        dot = wsum(dot);
        if (lane == 0)
          p_s[idx] = (j * page_size + t < len) ? dot * scale : kNeg;
      }
      __syncthreads();
    }
    if (V >= SOFTMAX) {
      for (int g = warp; g < group; g += n_warps) {
        float* row = p_s + g * page_size;
        float mx = kNeg;
        for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, row[t]);
        mx = wmax(mx);
        const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < page_size; t += 32) {
          const float p = expf(row[t] - m_new);
          row[t] = p;
          sum += p;
        }
        sum = wsum(sum);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          c_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
    }
    if (V >= PV) {
      for (int i = tid; i < group * d_v; i += blockDim.x) {
        const int g = i / d_v, d = i - g * d_v;
        const float* p = p_s + g * page_size;
        float a = 0.f;
        for (int t = 0; t < page_size; ++t) a += p[t] * v_s[t * d_v + d];
        acc[i] = acc[i] * c_s[g] + a;
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* o_rows = out + ((long long)b * hq + (long long)n * group) * d_v;
  for (int i = tid; i < group * d_v; i += blockDim.x) {
    // variants without PV keep their staged (or scored) bytes alive here
    const float extra = V >= PV ? 0.f
                        : V >= SCORES ? p_s[i % (group * page_size)]
                                      : k_s[i % (page_size * d_k)] +
                                            v_s[i % (page_size * d_v)];
    o_rows[i] = __float2bfloat16(acc[i] / fmaxf(l_s[i / d_v], 1e-37f) + extra);
  }
}

template <int V>
int go(const void* q, const void* k, const void* v, const void* table,
       const void* length, void* out, int batch, int n_kv, int group, int d_k,
       int d_v, int ps, int pps, float scale, cudaStream_t s) {
  const size_t smem = smem_floats(group, d_k, d_v, ps) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        variant_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  variant_kernel<V><<<batch * n_kv, kThr, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(length), static_cast<__nv_bfloat16*>(out),
      n_kv, group, d_k, d_v, ps, pps, scale);
  return (int)cudaGetLastError();
}
}  // namespace paged_split

extern "C" int split_variant(int variant, const void* q, const void* k,
                             const void* v, const void* table,
                             const void* length, void* out, int batch,
                             int n_kv, int group, int d_k, int d_v, int ps,
                             int pps, float scale, void* stream) {
  using namespace paged_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ps * d_k / 8 > kMaxChunks * kThr || ps * d_v / 8 > kMaxChunks * kThr ||
      d_k % 8 || d_v % 8)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case STAGE: return go<STAGE>(q, k, v, table, length, out, batch, n_kv, group, d_k, d_v, ps, pps, scale, s);
    case STAGE_VEC: return go<STAGE_VEC>(q, k, v, table, length, out, batch, n_kv, group, d_k, d_v, ps, pps, scale, s);
    case SCORES: return go<SCORES>(q, k, v, table, length, out, batch, n_kv, group, d_k, d_v, ps, pps, scale, s);
    case SOFTMAX: return go<SOFTMAX>(q, k, v, table, length, out, batch, n_kv, group, d_k, d_v, ps, pps, scale, s);
    case PV: return go<PV>(q, k, v, table, length, out, batch, n_kv, group, d_k, d_v, ps, pps, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build(work: Path, name: str, src: str) -> tuple[Path, str]:
    from repro_torch.kernels import _build

    cu = work / f"{name}.cu"
    cu.write_text(src)
    so = work / f"{name}.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed on {name}\n{out.stdout}{out.stderr}")
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


def in_turns(calls: dict) -> dict:
    """Mean of two turns (forward, then reversed) of each call's time."""
    ms = {n: [] for n in calls}
    for order in (list(calls), list(calls)[::-1]):
        for n in order:
            ms[n].append(time_call(calls[n]))
    return {n: statistics.mean(v) for n, v in ms.items()}


def _checked(fn, *args):
    err = fn(*args)
    if err:
        raise SystemExit(f"launch failed with CUDA error {err}")


def paged(args) -> dict:
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import paged_attention as PK

    src = args.source.read_text()
    new = "int n_splits" in src
    grouped = "int n_h," in src       # the entry takes the head group
    work = Path(tempfile.mkdtemp(prefix="paged_split_"))
    so, log = build(work, "paged_split", src + _VARIANTS)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.split_variant.argtypes = [I] + [P] * 6 + [I] * 7 + [F, P]
    lib.split_variant.restype = I
    if new:
        lib.paged_decode_attention.argtypes = ([I] + [P] * 7
                                               + [I] * (10 if grouped else 9)
                                               + [F, P])
    else:
        lib.paged_decode_attention.argtypes = [I] + [P] * 6 + [I] * 7 + [F, P]
    lib.paged_decode_attention.restype = I
    ptxas = ptxas_table(log)
    print("ptxas:\n" + "\n".join(f"  {k}: {v}" for k, v in ptxas.items()),
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smoke.device_line(), "source": str(args.source),
              "kernel": "split-K" if new else "one CTA per (row, kv head)",
              "ptxas": ptxas, "ms": {}}
    for label, width in (("serve", 4), ("long", 256)):
        shp = smoke._serve_shape(width)
        full = shp["ps"] * width
        a = smoke._paged_case(gen, lengths=[full] * shp["b"],
                              dtype=torch.bfloat16, dev=dev, **shp)
        q, k, v, table, length = a
        b, hq, n_kv, d, ps = shp["b"], shp["hq"], shp["n_kv"], shp["d"], shp["ps"]
        group = hq // n_kv
        scale = 1.0 / math.sqrt(d)
        out = torch.empty((b, 1, hq, d), dtype=torch.bfloat16, device=dev)
        ptrs = [t.data_ptr() for t in a]
        if new:
            n_splits, per = PK.split_plan(width, ps, b, n_kv)
            part = torch.empty(b * n_splits * hq * (2 + d), device=dev)
            heads = ((n_kv, PK.head_group(n_kv, group, d, d, ps, 2, per))
                     if grouped else (n_kv,))
            full_call = lambda: _checked(
                lib.paged_decode_attention, 1, *ptrs, out.data_ptr(),
                part.data_ptr() if n_splits > 1 else None, b, *heads, group,
                d, d, ps, width, n_splits, per, scale, stream)
        else:
            n_splits, per = 1, width
            full_call = lambda: _checked(
                lib.paged_decode_attention, 1, *ptrs, out.data_ptr(), b,
                n_kv, group, d, d, ps, width, scale, stream)
        calls = {name: (lambda i=i: _checked(
            lib.split_variant, i, *ptrs, out.data_ptr(), b, n_kv, group, d,
            d, ps, width, scale, stream)) for i, name in enumerate(VARIANTS)}
        calls["kernel"] = full_call
        calls["sdpa"] = smoke._sdpa_call(*a)
        ref = PK.paged_decode_attention_plain(*a).float()
        errs = {}
        for name in ("pv", "kernel"):
            calls[name]()
            torch.cuda.synchronize()
            errs[name] = (out.float() - ref).abs().max().item()
            torch.testing.assert_close(out.float(), ref, rtol=0.0,
                                       atol=smoke.BF16_ATOL)
        calls["kernel"]()
        torch.cuda.synchronize()
        same = torch.equal(out.view(torch.int16),
                           PK.paged_decode_attention(*a).view(torch.int16))
        row = in_turns(calls)
        result["ms"][label] = {"b": b, "width": width, "len": full,
                               "splits": n_splits, "pages_per_split": per,
                               "max_abs_err": errs,
                               "bits_equal_to_tree": same, **row}
        print(f"{label} (B={b}, {width} pages, len {full}, {n_splits} splits"
              f" of {per}): " + ", ".join(f"{n} {t:.4f} ms"
                                          for n, t in row.items())
              + f"; |err| {errs}; the source's kernel bitwise this tree's: "
              f"{same}", flush=True)
    return result


def dequant(args) -> dict:
    import torch
    import chip_smoke as smoke
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K

    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="dequant_split_"))
    libs, ptxas = {}, {}
    tree = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "spectral_lossy.cu"
    for name, path in (("old", args.old_spectral), ("new", tree)):
        so, log = build(work, f"spectral_{name}", path.read_text())
        lib = ctypes.CDLL(str(so))
        lib.spectral_dequant_idct.argtypes = K._SIGNATURES[
            "spectral_dequant_idct"][0]
        lib.spectral_dequant_idct.restype = ctypes.c_int
        libs[name] = lib
        ptxas[name] = {k: v for k, v in ptxas_table(log).items()
                       if "dequant" in k}
        print(f"ptxas {name}: {ptxas[name]}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    _, _, rows = smoke.moment_rows(configs.get("smollm-135m"))
    d_ = K._basis(dev, False)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smoke.device_line(), "old": str(args.old_spectral),
              "ptxas": ptxas, "shapes": {}}
    for label, nb in (("packed", sum(rows)), ("embed", 110592),
                      ("1001", 1001)):
        q = torch.randint(-127, 128, (nb, ref.BLOCK), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.int8)
        s = torch.exp(torch.randn(nb, generator=gen, device=dev) * 4.0)
        q[::97] = 0                       # all-zero blocks, as the codec's
        s[::97] = 1.0
        x = {n: torch.empty((nb, ref.BLOCK), device=dev) for n in libs}
        calls = {n: (lambda n=n: _checked(
            libs[n].spectral_dequant_idct, q.data_ptr(), s.data_ptr(),
            d_.data_ptr(), x[n].data_ptr(), nb, stream)) for n in libs}
        for n in libs:
            calls[n]()
        torch.cuda.synchronize()
        same = torch.equal(x["old"].view(torch.int32),
                           x["new"].view(torch.int32))
        yq = ref.dequantize_blocks(q, s)
        calls["torch.matmul"] = lambda: torch.matmul(yq, d_)
        row = in_turns(calls)
        result["shapes"][label] = {"blocks": nb, "bitwise_equal": same, **row}
        print(f"dequant_idct {label} ({nb} blocks): x bitwise equal {same}; "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in row.items()),
              flush=True)
        if not same:
            raise SystemExit(f"dequant_idct at {label}: x differs from the "
                             f"old kernel's")
        del q, s, x, yq
        torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=Path, default=ROOT / "src" / "repro_torch"
                    / "kernels" / "csrc" / "paged_attention.cu")
    ap.add_argument("--dequant", action="store_true")
    ap.add_argument("--old-spectral", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.dequant and args.old_spectral is None:
        ap.error("--dequant needs --old-spectral")
    import chip_smoke as smoke

    print(smoke.device_line(), flush=True)
    result = dequant(args) if args.dequant else paged(args)
    out_path = ROOT / "build" / ("dequant_split.json" if args.dequant
                                 else "paged_split.json")
    out_path.parent.mkdir(exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path.relative_to(ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
