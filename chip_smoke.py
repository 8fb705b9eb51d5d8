#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is swallowed):

1. device  — the card's name and power limit, as ``nvidia-smi`` reports
   them.
2. build   — every kernel of the serving and training paths, compiled from
   ``src/repro_torch/kernels/csrc`` by ``nvcc`` (one process per source,
   all started together).
3. kernels — the paged decode-attention kernel held against its plain
   PyTorch version on the card, in f32 (tol 1e-5) and bf16 (atol 3.2e-2, see
   ``tests/test_torch_paged_attention_card.py`` for why), at the serving
   shapes and at one long-context shape; timed per call with CUDA events
   (warm-up, then the median of 25 samples of 10 launches; host overhead
   between launches included) and on the device alone with
   ``torch.profiler``, beside the plain version,
   ``scaled_dot_product_attention`` on the gathered cache (a yardstick
   only; the port never calls it) and the least time the card could take
   (HBM 3.35 TB/s, f32 FMA 67 TFLOP/s; the larger bound).
4. spectral kernels — the four kernels of the hybrid checkpoint path
   (``csrc/spectral_lossy.cu``) held against their plain versions on the
   card, f32 with TF32 off, at the main path's shape (the packed moment
   buffer of full-width ``smollm-135m``: both moments of every parameter,
   each leaf padded to 8-block tiles, ~1.05 M blocks of 256) and at edge
   shapes (a block count that is no multiple of a CTA's 64 rows, all-zero
   blocks, 1e-20-scaled payloads with subnormal energies, eps >= 1).
   Gates: y of the DCT and x of the inverse allclose (rtol 1e-5, atol
   1e-5 x the block's RMS); on the kernel's own y, counts equal to the
   plain histogram and energies rtol 1e-5; q and scale bitwise for the
   same y and t. Each kernel is timed per call (CUDA events) and on the
   device (profiler) beside its plain version, its bound, and — for the
   two DCT kernels — one ``torch.matmul`` of the same f32 product (matmul
   only, a yardstick). How many per-leaf thresholds the all-kernel path
   and the all-plain path pick differently is recorded, not gated (the
   kernel and cuBLAS sum the DCT in different orders).
5. serve   — the port's ``serve_loop("smollm-135m", smoke=False)``: full
   published widths (30 layers, d_model 576, 9 query / 3 KV heads, d_ff
   1536, vocab 49152), bf16 random weights from seed 0, 16 requests of 32
   new tokens over a 17-page pool (requests queue on pages), with the
   default async ``serve_snapshot`` plan persisting its chain under
   ``build/``. Asserts: all served, pool empty at exit, snapshots
   published, the chain restores bit-identically to what was emitted at
   its step, and the kernel ran once per layer per decode step. Then one
   full-width decode step runs twice from the same state — through the
   kernel and through the plain version — and the logits are compared
   (atol 0.125: a few bf16 steps of attention difference carried through
   30 layers; logits are O(1)), and ten decode steps are profiled: host
   wall per step, device busy time and idle share, the busiest device ops.

6. train   — the port's ``train_loop("smollm-135m", smoke=False)``:
   full published widths, batch 4 x 4096 tokens (``train_4k``'s length,
   its global batch of 256 cut to 4 for one card), bf16 state from seed
   0, HYBRID placement. First 20 steps with no checkpoint task bound (what
   the in-situ work costs), then 20 steps with a checkpoint every 5 steps
   under ``build/`` (launch counts are set to 0 just before and read just
   after: kernels 2-4 once per save), then a direct restore of the newest
   step (kernel 5 once per lossy leaf) whose params must equal bitwise
   the state emitted at that step and whose moments must be within
   ``error_bound(eps)`` relative L2 per leaf, then a second run that
   resumes from it. Also: one train step's device profile and the device
   stage alone on the trained state.

The last lines are the card line, one JSON object with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 3.2e-2
LOGIT_ATOL = 0.125
SERVE = dict(n_requests=16, max_new=32, num_pages=17, page_size=16, slots=4)
EPS = 1e-2                          # the checkpoint's lossy_eps
TRAIN = dict(steps=20, ckpt_every=5, resume_steps=5)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_profile(fn, n: int) -> dict:
    """Run ``fn`` n times under ``torch.profiler``: wall time, the device's
    busy time (sum of kernel and copy time on the card) and each device
    op's time, per call. Device numbers are None when the profiler saw no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = {}
    host_ops = 0
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            host_ops += e.count
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                ops[e.key] = us / 1e3 / n
    busy = sum(ops.values())
    return {"wall_ms": wall * 1e3 / n, "host_aten_ops": host_ops / n,
            "device_busy_ms": busy if ops else None,
            "device_idle_share": (1 - busy / (wall * 1e3 / n)) if ops
            else None,
            "top": sorted(ops.items(), key=lambda kv: -kv[1])[:8]}


def time_ms(fn, *, warmup: int = 5, samples: int = 25, reps: int = 10):
    import torch

    for _ in range(warmup):
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


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _paged_case(gen, *, b, hq, n_kv, d, ps, pps, lengths, dtype, dev):
    import torch

    num_pages = b * pps + 1
    k = torch.randn((num_pages, ps, n_kv, d), generator=gen)
    v = torch.randn((num_pages, ps, n_kv, d), generator=gen)
    q = torch.randn((b, 1, hq, d), generator=gen)
    table = (1 + torch.randperm(b * pps, generator=gen)).reshape(b, pps)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            table.to(dev, torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _bound_ms(q, k, v, table, length):
    """Least time for one call on these inputs: each needed input byte
    read once (the pages holding valid positions), the output written
    once; flops of the scores and the PV product in f32."""
    b, _, hq, d_k = q.shape
    _, ps, n_kv, _ = k.shape
    d_v = v.shape[3]
    el = q.element_size()
    lens = [int(x) for x in length.tolist()]
    pages = sum(table.shape[1] if n == 0 else min(table.shape[1],
                                                   -(-n // ps))
                for n in lens)
    nbytes = (pages * ps * n_kv * (d_k + d_v) * el + q.numel() * el
              + b * hq * d_v * el + table.numel() * 4 + length.numel() * 4)
    tokens = sum(table.shape[1] * ps if n == 0 else n for n in lens)
    flops = 2 * hq * tokens * (d_k + d_v)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _sdpa_call(q, k, v, table, length):
    """One ``scaled_dot_product_attention`` over the gathered cache (GQA
    by ``enable_gqa``), as a timing yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention as A

    kg = A.gather_pages(k, table).transpose(1, 2)     # (B, N, S, D)
    vg = A.gather_pages(v, table).transpose(1, 2)
    qh = q.transpose(1, 2)                            # (B, Hq, 1, D)
    pos = torch.arange(kg.shape[2], device=q.device)
    mask = (pos[None, :] < length[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)


def kernel_phase(serve_table_width: int) -> dict:
    import torch
    from repro_torch.kernels import paged_attention as PK

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    ps = SERVE["page_size"]
    shapes = {
        "serve": dict(b=8, hq=9, n_kv=3, d=64, ps=ps, pps=serve_table_width),
        "long": dict(b=8, hq=9, n_kv=3, d=64, ps=ps, pps=4096 // ps),
    }
    out: dict = {"max_err_f32": 0.0, "max_err_bf16": 0.0}
    for name, shp in shapes.items():
        full = shp["ps"] * shp["pps"]
        lengths = [0, 1, ps, ps + 1, full, full, full // 2 + 3, full - 1]
        for dtype in (torch.float32, torch.bfloat16):
            args = _paged_case(gen, lengths=lengths, dtype=dtype, dev=dev,
                               **shp)
            got = PK.paged_decode_attention(*args)
            torch.cuda.synchronize()
            ref = PK.paged_decode_attention_plain(*args)
            err = (got.float() - ref.float()).abs().max().item()
            if not math.isfinite(err):
                raise AssertionError(f"{name} {dtype}: non-finite output")
            tol = (F32_TOL if dtype == torch.float32
                   else dict(rtol=0.0, atol=BF16_ATOL))
            torch.testing.assert_close(got.float(), ref.float(), **tol)
            key = "max_err_f32" if dtype == torch.float32 else "max_err_bf16"
            out[key] = max(out[key], err)
            log(f"kernel {name} {str(dtype)[6:]}: max |kernel - plain| "
                f"= {err:.3e} (lengths {lengths})")
        # timing: bf16 (the serving dtype), every row at full length
        args = _paged_case(gen, lengths=[full] * shp["b"],
                           dtype=torch.bfloat16, dev=dev, **shp)
        ref = PK.paged_decode_attention_plain(*args)
        err = (PK.paged_decode_attention(*args).float()
               - ref.float()).abs().max().item()
        k_ms = time_ms(lambda: PK.paged_decode_attention(*args))
        p_ms = time_ms(lambda: PK.paged_decode_attention_plain(*args))
        lib_ms = time_ms(_sdpa_call(*args))
        b_ms, b_by = _bound_ms(*args)
        prof = device_profile(lambda: PK.paged_decode_attention(*args), 20)
        dev_ms = sum(ms for op, ms in prof["top"]
                     if "paged_decode_kernel" in op) or None
        out[name] = {"shape": dict(shp, len=full, dtype="bfloat16"),
                     "max_abs_err": err, "ms": k_ms, "device_ms": dev_ms,
                     "plain_ms": p_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"kernel {name} timing (bf16, B={shp['b']}, len={full}): "
            f"kernel {k_ms:.4f} ms per call (device {dev_ms} ms), plain "
            f"{p_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
    return out


# ---------------------------------------------------------------------------
# spectral kernel phase
# ---------------------------------------------------------------------------

def moment_rows(cfg) -> tuple[list[str], list[int], list[int]]:
    """The hybrid save's packed buffer for ``cfg``: (leaf keys, elements,
    rows) of every moment leaf (mu then nu, JAX flatten order), each padded
    to the 8-block histogram tile."""
    from repro_torch.core import pytree
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.models import transformer

    keys, sizes, rows = [], [], []
    for grp in ("mu", "nu"):
        for path, s in pytree.flatten_with_path(transformer.param_spec(cfg)):
            n = math.prod(s.shape)
            nb = -(-n // 256)
            keys.append(pytree.keystr((grp,) + path))
            sizes.append(n)
            rows.append(nb + (-nb) % K.HIST_TILE)
    return keys, sizes, rows


def _spectral_payload(gen, sizes, rows, dev, kind="moments"):
    """Packed (rows, 256) f32 buffer, leaf by leaf: moment-like values (mu
    ~ N(0, 1e-3), nu ~ |N(0, 1e-6)|^2-ish) or an edge class."""
    import torch

    buf = torch.zeros((sum(rows), 256), device=dev)
    flat = buf.view(-1)
    off = 0
    for i, (n, r) in enumerate(zip(sizes, rows)):
        v = torch.randn(n, generator=gen, device=dev)
        if kind == "tiny":
            v = v * 1e-20
        elif kind == "zeros":
            v = v * (torch.arange(n, device=dev) // 256 % 3 != 0)
        elif i >= len(sizes) // 2:
            v = (v * 1e-3) ** 2                   # nu: positive, small
        else:
            v = v * 1e-3                          # mu
        flat[off:off + n] = v
        off += r * 256
    return buf


def _leaf_bounds(rows):
    out, off = [], 0
    for r in rows:
        out.append((off // 8, (off + r) // 8))
        off += r
    return out


def _block_rms(x):
    import torch
    return torch.sqrt(torch.mean(x.double() ** 2, dim=1, keepdim=True)).float()


def _check_close(name, got, want, rows_of):
    """allclose with rtol 1e-5 and atol 1e-5 x the block's RMS."""
    tol = 1e-5 * _block_rms(rows_of) + 1e-5 * want.abs()
    err = (got - want).abs()
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} elements off (max err "
                             f"{err.max().item():.3e})")
    return err.max().item()


def spectral_check(xb, rows, eps, label):
    """Every kernel against its plain version on one packed buffer, with
    the thresholds the path computes. Returns the max errors and the
    kernel path's intermediate results."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spectral_lossy as K

    bounds = _leaf_bounds(rows)
    n_rows = torch.tensor(rows, device=xb.device)
    y, cnt, eng = K.dct_hist_coarse_tiled(xb)
    torch.cuda.synchronize()
    y_p = ref.dct_blocks(xb)
    err_y = _check_close(f"{label} dct y", y, y_p, y_p)
    a = torch.abs(y)
    coarse = torch.div(ref.bin_index(a), 16, rounding_mode="floor")
    cnt_p, eng_p = K._tile_sums(a * a, coarse, 32, 8)
    del a, coarse
    if not torch.equal(cnt, cnt_p):
        raise AssertionError(f"{label} coarse counts differ "
                             f"({int((cnt != cnt_p).sum())} of {cnt.numel()})")
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)
    err_e = ((eng - eng_p).abs() / eng_p.abs().clamp(min=1e-38)).max().item()
    c, cc, base, budget = ref.select_coarse(ops._segment_rows(eng, bounds), eps)
    block_cc = torch.repeat_interleave(cc.to(torch.int32), n_rows)
    fcnt, feng = K.hist_refine_tiled(y, block_cc)
    fcnt_p, feng_p = K.hist_refine_tiled_plain(y, block_cc)
    if not torch.equal(fcnt, fcnt_p):
        raise AssertionError(f"{label} refine counts differ")
    torch.testing.assert_close(feng, feng_p, rtol=1e-5, atol=0.0)
    t_leaf = ref.select_fine(ops._segment_rows(feng, bounds), c, cc, base,
                             budget)
    t = torch.repeat_interleave(t_leaf, n_rows)
    q, s = K.threshold_quant(y, t)
    q_p, s_p = K.threshold_quant_plain(y, t)
    if not (torch.equal(q, q_p) and torch.equal(s, s_p)):
        raise AssertionError(f"{label} q/scale differ from the plain version")
    err_q = max((q.int() - q_p.int()).abs().max().item(),
                (s - s_p).abs().max().item())
    x = K.dequant_idct(q, s)
    x_p = K.dequant_idct_plain(q, s)
    err_x = _check_close(f"{label} dequant_idct", x, x_p,
                         ref.dequantize_blocks(q, s))
    # the all-plain path's per-leaf thresholds (cuBLAS y, plain histograms)
    a_p = torch.abs(y_p)
    _, eng_pp = K._tile_sums(a_p * a_p, torch.div(
        ref.bin_index(a_p), 16, rounding_mode="floor"), 32, 8)
    del a_p
    c2, cc2, b2, bu2 = ref.select_coarse(ops._segment_rows(eng_pp, bounds),
                                         eps)
    _, feng_pp = K.hist_refine_tiled_plain(
        y_p, torch.repeat_interleave(cc2.to(torch.int32), n_rows))
    t_plain = ref.select_fine(ops._segment_rows(feng_pp, bounds), c2, cc2,
                              b2, bu2)
    differ = int((t_plain != t_leaf).sum())
    return {"y": y, "t": t, "q": q, "s": s, "t_leaf": t_leaf,
            "err": {"dct_hist_coarse_tiled": err_y,
                    "hist_refine_tiled": (feng - feng_p).abs().max().item(),
                    "threshold_quant": err_q, "energy_rel": err_e,
                    "dequant_idct": err_x},
            "thresholds_differing": differ, "leaves": len(rows),
            "dropped_all": bool((q == 0).all().item())}


def _dct_bound(nb, *, out_bytes, in_bytes):
    """Least time for a 256-point DCT over nb blocks: 512 flops per
    element (f32 FMA, no TF32) against the bytes in and out."""
    elems = nb * 256
    t_ops = 512 * elems / F32_FLOPS_PER_S * 1e3
    t_bytes = (in_bytes + out_bytes + 256 * 256 * 4) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _pass_bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def spectral_phase() -> dict:
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    cfg = configs.get("smollm-135m")
    keys, sizes, rows = moment_rows(cfg)
    nb = sum(rows)
    log(f"spectral main shape: {len(rows)} moment leaves, {sum(sizes)} "
        f"elements, {nb} blocks ({nb * 1024 / 1e9:.3f} GB f32)")
    xb = _spectral_payload(gen, sizes, rows, dev)
    main = spectral_check(xb, rows, EPS, "main")
    log(f"spectral main: max err y {main['err']['dct_hist_coarse_tiled']:.3e}"
        f", energy rel {main['err']['energy_rel']:.3e}, x "
        f"{main['err']['dequant_idct']:.3e}; per-leaf thresholds differing "
        f"kernel vs plain path: {main['thresholds_differing']} of "
        f"{main['leaves']}")

    # edge shapes: a block count no CTA multiple, zero blocks, subnormal
    # energies, eps >= 1 (drop everything)
    edge_rows = [8, 16, 1000, 24]            # 1048 blocks: 16 CTAs + 24 rows
    edge_sizes = [8 * 256 - 5, 16 * 256, 1000 * 256 - 100, 17 * 256]
    edges = {}
    for kind, eps in (("moments", EPS), ("zeros", EPS), ("tiny", EPS),
                      ("moments", 1.5)):
        xe = _spectral_payload(gen, edge_sizes, edge_rows, dev, kind)
        res = spectral_check(xe, edge_rows, eps, f"edge {kind} eps {eps}")
        if eps >= 1 and not res["dropped_all"]:
            raise AssertionError("eps >= 1 kept coefficients")
        edges[f"{kind}/eps={eps}"] = {
            "err": res["err"], "thresholds_differing":
                res["thresholds_differing"]}
        log(f"spectral edge {kind} eps {eps}: max err {res['err']}, "
            f"thresholds differing {res['thresholds_differing']}")
    # quantiser and inverse at a block count that is no tile multiple
    yo = torch.randn((1001, 256), generator=gen, device=dev)
    yo[::7] = 0
    to = torch.rand(1001, generator=gen, device=dev)
    qo, so = K.threshold_quant(yo, to)
    if not (torch.equal(qo, K.threshold_quant_plain(yo, to)[0])
            and torch.equal(so, K.threshold_quant_plain(yo, to)[1])):
        raise AssertionError("threshold_quant differs at 1001 blocks")
    _check_close("dequant_idct 1001", K.dequant_idct(qo, so),
                 K.dequant_idct_plain(qo, so), ref.dequantize_blocks(qo, so))

    # timings at the main shape
    y, t, q, s = main["y"], main["t"], main["q"], main["s"]
    block_cc = torch.full((nb,), 20, dtype=torch.int32, device=dev)
    dt_ = ref.dct_tensor(dev).T.contiguous()
    d_ = ref.dct_tensor(dev)
    yq = ref.dequantize_blocks(q, s)
    calls = {
        "dct_hist_coarse_tiled": (
            lambda: K.dct_hist_coarse_tiled(xb),
            lambda: K.dct_hist_coarse_tiled_plain(xb),
            lambda: torch.matmul(xb, dt_), "dct_hist_coarse_kernel"),
        "hist_refine_tiled": (
            lambda: K.hist_refine_tiled(y, block_cc),
            lambda: K.hist_refine_tiled_plain(y, block_cc), None,
            "hist_refine_kernel"),
        "threshold_quant": (
            lambda: K.threshold_quant(y, t),
            lambda: K.threshold_quant_plain(y, t), None,
            "threshold_quant_kernel"),
        "dequant_idct": (
            lambda: K.dequant_idct(q, s),
            lambda: K.dequant_idct_plain(q, s),
            lambda: torch.matmul(yq, d_), "dequant_idct_kernel"),
    }
    el = nb * 256
    bounds = {
        "dct_hist_coarse_tiled": _dct_bound(
            nb, in_bytes=4 * el, out_bytes=4 * el + nb // 8 * 32 * 8),
        "hist_refine_tiled": _pass_bound(4 * el + 4 * nb + nb // 8 * 16 * 8,
                                         3 * el),
        "threshold_quant": _pass_bound(4 * el + 4 * nb + el + 4 * nb,
                                       3 * el),
        "dequant_idct": _dct_bound(nb, in_bytes=el + 4 * nb,
                                   out_bytes=4 * el),
    }
    timing = {}
    for name, (kern, plain, lib, sym) in calls.items():
        k_ms = time_ms(kern, warmup=2, samples=5, reps=3)
        p_ms = time_ms(plain, warmup=1, samples=3, reps=1)
        l_ms = (time_ms(lib, warmup=2, samples=5, reps=3)
                if lib is not None else None)
        prof = device_profile(kern, 3)
        dev_ms = sum(ms for op, ms in prof["top"] if sym in op) or None
        b_ms, b_by = bounds[name]
        timing[name] = {"ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
                        "library_ms": l_ms, "bound_ms": b_ms,
                        "bound_by": b_by}
        log(f"spectral {name}: kernel {k_ms:.4f} ms per call (device "
            f"{dev_ms} ms), plain {p_ms:.4f} ms, library {l_ms} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    out = {"blocks": nb, "elements": sum(sizes), "leaves": len(rows),
           "max_abs_err": {k: main["err"][k] for k in (
               "dct_hist_coarse_tiled", "hist_refine_tiled",
               "threshold_quant", "dequant_idct")},
           "energy_rel_err": main["err"]["energy_rel"],
           "thresholds_differing": main["thresholds_differing"],
           "edges": edges, "timing": timing}
    del main, xb, y, t, q, s, yq
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def serve_phase(chain_dir: Path) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.core.session import (Every, InSituPlan, Placement,
                                          TaskSpec)
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.launch.serve import default_serve_plan, serve_loop
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serving import snapshot as S
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine, make_paged_decode

    cfg = configs.get("smollm-135m")
    if chain_dir.exists():
        shutil.rmtree(chain_dir)
    # the default plan, persisted on disk, plus a probe on the same stream
    # that keeps what was emitted at each firing (to check the restore);
    # the probe runs SYNC, a D2H copy on the loop every 4 steps, so that it
    # never holds ring slots the snapshot task competes for
    emitted: dict[int, dict] = {}
    base = InSituPlan.from_dict(
        default_serve_plan(snapshot_dir=str(chain_dir)))
    probe = TaskSpec(name="probe", stream="kv_pages", trigger=Every(4),
                     placement=Placement.SYNC,
                     sink=lambda step, p: emitted.__setitem__(
                         step, S._flatten(p["cache"])))
    plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                      workers=base.workers,
                      staging_capacity=base.staging_capacity)

    lines: list[str] = []

    def serve_log(msg: str) -> None:
        lines.append(msg)
        log(f"serve: {msg}")

    # first the same traffic with no in-situ task bound (what the
    # snapshots cost; it also warms the full-width shapes up)
    bare = serve_loop("smollm-135m", smoke=False, device="cuda", seed=0,
                      plan={"streams": ["kv_pages"]}, log=lambda _: None,
                      **SERVE)
    assert all(r.done for r in bare["requests"])
    log(f"serve: without in-situ tasks: {bare['tok_per_s']:.1f} tok/s")

    PK.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = serve_loop("smollm-135m", smoke=False, device="cuda", plan=plan,
                     seed=0, log=serve_log, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PK.paged_decode_attention.launches

    reqs = out["requests"]
    decode_steps = len(out["telemetry"].spans("step/compute"))
    served = sum(1 for r in reqs if r.done)
    assert served == SERVE["n_requests"], f"served {served}/{len(reqs)}"
    for r in reqs:
        assert len(r.out) == r.max_new, f"request {r.rid}: {len(r.out)} tokens"
        assert all(0 <= t < cfg.vocab_size for t in r.out), r.rid
    pool = next(m for m in (re.match(r"page pool: (\d+)/(\d+)", ln)
                            for ln in lines) if m)
    assert int(pool.group(1)) == 0, f"page pool not empty at exit: {pool[0]}"
    rep = out["session_report"]
    snap = rep["tasks"]["kv_snapshot"]
    assert rep["n_errors"] == 0, rep["errors"]
    assert snap["publishes"] > 0, "no snapshot published"
    assert launches == decode_steps * cfg.n_layers, (
        f"kernel launches {launches} != {decode_steps} decode steps x "
        f"{cfg.n_layers} layers")

    store = S.SnapshotStore(str(chain_dir))
    step, leaves = store.restore("kv_pages")
    want = emitted[step]
    assert list(leaves) == list(want), "restored leaf keys differ"
    for key, arr in leaves.items():
        assert arr.shape == want[key].shape, key
        if not np.array_equal(arr.reshape(-1).view(np.uint8),
                              want[key].reshape(-1).view(np.uint8)):
            raise AssertionError(f"restored leaf {key} differs at step {step}")
    log(f"serve: chain restores bit-identically to the payload emitted at "
        f"step {step} ({len(leaves)} leaves, "
        f"{sum(a.nbytes for a in leaves.values())} bytes)")

    # one full-width decode step from one state, kernel vs plain version
    params = P.materialize(torch.Generator().manual_seed(0),
                           transformer.param_spec(cfg), "cuda")
    eng = PagedServingEngine(cfg, params, num_pages=33, page_size=16,
                             max_reqs=8, prompt_len=16, max_len=64,
                             device="cuda")
    rng = np.random.default_rng(5)
    for i in range(8):
        assert eng.admit(Request(i, rng.integers(0, cfg.vocab_size, 16),
                                 max_new=32))
    for _ in range(7):
        eng.step()

    def one_step(decode):
        pool = tree_map(lambda t: t.clone(), eng.pool)
        logits, *_ = decode(eng.params, pool, eng.state,
                            eng.page_table.clone(), eng.tokens.clone(),
                            eng.lengths.clone())
        return logits[:, -1, :cfg.vocab_size].float()

    with_kernel = one_step(make_paged_decode(cfg, 16))
    with_plain = one_step(make_paged_decode(
        cfg, 16, attend=PK.paged_decode_attention_plain))
    diff = (with_kernel - with_plain).abs().max().item()
    agree = (with_kernel.argmax(-1) == with_plain.argmax(-1)).float().mean()
    torch.testing.assert_close(with_kernel, with_plain, rtol=0.0,
                               atol=LOGIT_ATOL)
    log(f"serve: one full-width decode step, kernel vs plain attention: "
        f"max |dlogit| = {diff:.4e} (logit range "
        f"{with_plain.min().item():.3f}..{with_plain.max().item():.3f}), "
        f"argmax agreement {agree.item():.3f}")

    # where a full-width decode step's time goes (8 active rows, no
    # in-situ work): host wall per step against device busy time
    decode = device_profile(eng.step, 10)
    log(f"serve: decode step (8 rows, full width): {decode['wall_ms']:.2f} "
        f"ms wall, {decode['host_aten_ops']:.0f} aten ops on the host, "
        f"device busy {decode['device_busy_ms']} ms, idle share "
        f"{decode['device_idle_share']}")
    for op, ms in decode["top"]:
        log(f"serve:   {ms * 1e3:9.1f} us/step  {op[:90]}")
    loop = {k: rep[k] for k in ("step_compute_s", "handoff_dispatch_s",
                                "handoff_materialize_s", "sync_stall_s",
                                "staging_backpressure_s",
                                "async_overlapped_s")}

    return {"tok_per_s": out["tok_per_s"], "wall_s": wall,
            "tok_per_s_without_insitu": bare["tok_per_s"],
            "step_compute_s_without_insitu":
                bare["session_report"]["step_compute_s"],
            "loop": loop, "decode_profile": decode,
            "requests": served, "decode_steps": decode_steps,
            "launches": launches, "snapshots": snap["publishes"],
            "snapshot_drops": rep["drops"].get("kv_snapshot", 0),
            "effective_compression_x": snap["effective_compression_x"],
            "logit_max_abs_diff": diff,
            "argmax_agreement": agree.item()}


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def _per_step(report: dict, steps: int) -> dict:
    keys = ("step_compute_s", "handoff_dispatch_s", "handoff_materialize_s",
            "sync_stall_s", "staging_backpressure_s", "async_overlapped_s")
    return {k: report[k] for k in keys} | {
        "step_s": report["step_compute_s"] / steps}


def train_phase(ckpt_dir: Path) -> dict:
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.configs import base as configs
    from repro_torch.core import pytree
    from repro_torch.core.session import (InSituPlan, Placement, TaskSpec,
                                          When)
    from repro_torch.data.pipeline import batch_spec_for, synth_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.launch import train as T

    cfg = configs.get("smollm-135m")
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    steps, every = TRAIN["steps"], TRAIN["ckpt_every"]
    newest = (steps - 1) // every * every
    n_saves = (steps - 1) // every + 1
    _, sizes, rows = moment_rows(cfg)
    n_lossy = len(rows)

    # 1. the same steps with no checkpoint task bound (analytics only)
    t0 = time.perf_counter()
    bare = T.train_loop("smollm-135m", smoke=False, steps=steps,
                        insitu_mode="hybrid", device="cuda", seed=0,
                        log=lambda m: log(f"train (no ckpt): {m}"))
    torch.cuda.synchronize()
    bare_wall = time.perf_counter() - t0
    assert np.isfinite(bare["losses"]).all(), bare["losses"]
    bare_rep = bare["session_report"]
    assert bare_rep["n_errors"] == 0, bare_rep["errors"]

    # 2. HYBRID checkpoints every `every` steps, plus a probe that keeps
    #    the state emitted at the newest save's step
    emitted: dict = {}

    def keep(step, payload):
        emitted["step"] = step
        emitted["state"] = {pytree.keystr(p): np.array(a) for p, a in
                            pytree.flatten_with_path(payload)}

    base = InSituPlan.from_dict(T.default_train_plan(
        insitu_mode="hybrid", ckpt_dir=str(ckpt_dir), ckpt_every=every,
        device="cuda"))
    probe = TaskSpec(name="probe", stream="train_state",
                     trigger=When(lambda st: st == newest),
                     placement=Placement.SYNC, sink=keep)
    plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                      workers=base.workers,
                      staging_capacity=base.staging_capacity)
    K.reset_launches()
    t0 = time.perf_counter()
    out = T.train_loop("smollm-135m", smoke=False, steps=steps, plan=plan,
                       device="cuda", seed=0,
                       log=lambda m: log(f"train (hybrid ckpt): {m}"))
    torch.cuda.synchronize()
    ckpt_wall = time.perf_counter() - t0
    save_launches = {k.__name__: k.launches for k in K.KERNELS}
    rep = out["session_report"]
    assert rep["n_errors"] == 0, rep["errors"]
    assert np.isfinite(out["losses"]).all(), out["losses"]
    ck = rep["checkpoint"]
    assert ck["saves"] == n_saves and ck["last_step"] == newest, ck
    for name in ("dct_hist_coarse_tiled", "hist_refine_tiled",
                 "threshold_quant"):
        assert save_launches[name] == n_saves, (name, save_launches)
    assert save_launches["dequant_idct"] == 0, save_launches
    probe_s = sum(sp.dt for sp in out["telemetry"].spans("insitu-sync/probe"))
    device_stage_enqueue_s = out["telemetry"].total("insitu-device/")

    # 3. restore the newest step directly: params bitwise, moments within
    #    the codec's bound per leaf
    template = T.init_state(cfg, 1, T.StepConfig().opt, device="cuda")
    K.reset_launches()
    t0 = time.perf_counter()
    restored = ser.read_state(str(ckpt_dir / f"step_{newest:09d}"), template,
                              "cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_launches = K.dequant_idct.launches
    assert restore_launches == n_lossy, (restore_launches, n_lossy)
    assert emitted.get("step") == newest, emitted.get("step")
    worst = 0.0
    for path, t in pytree.flatten_with_path(restored):
        key = pytree.keystr(path)
        want = emitted["state"][key]
        if key.startswith("['mu']") or key.startswith("['nu']"):
            w = torch.from_numpy(want.view(np.int16)).view(torch.bfloat16) \
                if want.dtype.kind == "u" else torch.from_numpy(want)
            err = ref.rel_l2_error(w.float(), t.float().cpu())
            worst = max(worst, err)
            assert err <= ref.error_bound(EPS), (key, err)
        else:
            got = (t.view(torch.int16) if t.dtype == torch.bfloat16
                   else t).cpu().numpy()
            if not np.array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8)):
                raise AssertionError(f"restored {key} differs from step "
                                     f"{newest}'s state")
    log(f"train: restored step {newest} in {restore_s:.2f}s: params bitwise, "
        f"moments worst rel L2 {worst:.4e} (bound "
        f"{ref.error_bound(EPS):.4e}), {restore_launches} dequant_idct "
        f"launches")

    # 4. the device stage alone, on the restored (trained) state
    policy = lambda k: "'mu'" in k or "'nu'" in k
    stage_ms = time_ms(lambda: ops.spectral_compress_tree(restored, EPS,
                                                          policy),
                       warmup=1, samples=3, reps=1)

    # 5. a second run resumes from the newest step
    lines: list[str] = []
    K.reset_launches()
    res = T.train_loop("smollm-135m", smoke=False,
                       steps=TRAIN["resume_steps"], insitu_mode="hybrid",
                       ckpt_dir=str(ckpt_dir), ckpt_every=every,
                       device="cuda", seed=0, log=lines.append)
    torch.cuda.synchronize()
    assert f"resumed from step {newest}" in lines, lines
    assert np.isfinite(res["losses"]).all(), res["losses"]
    assert res["session_report"]["n_errors"] == 0
    resume_launches = {k.__name__: k.launches for k in K.KERNELS}
    assert resume_launches["dequant_idct"] == n_lossy, resume_launches
    log(f"train: resumed from step {newest}; losses {res['losses']}")

    # 6. one full-width train step's device profile (no in-situ work)
    state = T.init_state(cfg, 0, T.StepConfig().opt, device="cuda")
    step_fn = T.make_train_step(cfg, T.StepConfig())
    spec = batch_spec_for(cfg, T.FULL_SHAPE)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synth_batch(spec, 0).items()}
    step_fn(state, batch)
    torch.cuda.reset_peak_memory_stats()
    prof = device_profile(lambda: step_fn(state, batch), 2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train: step (4 x 4096 tokens, full width): {prof['wall_ms']:.1f} "
        f"ms wall, {prof['host_aten_ops']:.0f} aten ops, device busy "
        f"{prof['device_busy_ms']} ms, idle share "
        f"{prof['device_idle_share']}, peak memory {peak_gb:.1f} GB")
    for op, ms in prof["top"]:
        log(f"train:   {ms:9.2f} ms/step  {op[:90]}")

    with_ckpt, without = _per_step(rep, steps), _per_step(bare_rep, steps)
    result = {
        "losses_without_ckpt": bare["losses"], "losses": out["losses"],
        "resume_losses": res["losses"],
        "step_s_without_ckpt": without["step_s"],
        "step_s_with_ckpt": with_ckpt["step_s"],
        "wall_s_without_ckpt": bare_wall, "wall_s_with_ckpt": ckpt_wall,
        "loop": with_ckpt, "loop_without_ckpt": without,
        "probe_sync_s": probe_s,
        "device_stage_enqueue_s": device_stage_enqueue_s,
        "device_stage_ms": stage_ms,
        "saves": ck["saves"], "raw_bytes": ck["raw_bytes"],
        "stored_bytes": ck["stored_bytes"],
        "effective_compression_x": ck["raw_bytes"] / ck["stored_bytes"],
        "save_launches": save_launches, "restore_launches": restore_launches,
        "resume_launches": resume_launches, "restore_s": restore_s,
        "moments_worst_rel_l2": worst, "step_profile": prof,
        "peak_memory_gb": peak_gb,
    }
    log(f"train: step {without['step_s'] * 1e3:.1f} ms without the "
        f"checkpoint task, {with_ckpt['step_s'] * 1e3:.1f} ms with it; "
        f"loop-blocking handoff dispatch {with_ckpt['handoff_dispatch_s']:.3f}"
        f" s, sync stall {with_ckpt['sync_stall_s']:.3f} s (probe "
        f"{probe_s:.3f} s of it), device stage alone {stage_ms:.2f} ms; "
        f"checkpoint {ck['raw_bytes']} -> {ck['stored_bytes']} bytes "
        f"({result['effective_compression_x']:.2f}x) over {ck['saves']} saves")
    del state, restored, template
    torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    card = device_line()
    log(card)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build(["paged_attention", "spectral_lossy"])
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in built.items())})")
    for name in built:
        ptxas = _build.target(name).with_suffix(".log").read_text()
        for ln in ptxas.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"build {name}: {ln.strip()}")

    t0 = time.perf_counter()
    kern = kernel_phase(serve_table_width=4)
    log(f"kernel phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    spec = spectral_phase()
    log(f"spectral kernel phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve = serve_phase(ROOT / "build" / "smoke_chain")
    log(f"serve phase: {time.perf_counter() - t0:.1f}s, "
        f"{serve['tok_per_s']:.1f} tok/s")
    t0 = time.perf_counter()
    train = train_phase(ROOT / "build" / "smoke_ckpt")
    log(f"train phase: {time.perf_counter() - t0:.1f}s")

    main_path = kern["serve"]
    record = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:76",
        "tpu_kernel": "src/repro/kernels/paged_attention.py:76",
        "launches": serve["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "max_err_f32": kern["max_err_f32"],
        "max_err_bf16": kern["max_err_bf16"],
        "ms": main_path["ms"],
        "kernel_ms": main_path["ms"],
        "device_ms": main_path["device_ms"],
        "plain_ms": main_path["plain_ms"],
        "library_ms": main_path["library_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "shape": main_path["shape"],
        "long_context": kern["long"],
    }
    records = [record]
    tpu = "src/repro/kernels/spectral_lossy.py"
    for name, line, launches in (
            ("dct_hist_coarse_tiled", 335,
             train["save_launches"]["dct_hist_coarse_tiled"]),
            ("hist_refine_tiled", 386,
             train["save_launches"]["hist_refine_tiled"]),
            ("threshold_quant", 436, train["save_launches"]["threshold_quant"]),
            ("dequant_idct", 488, train["resume_launches"]["dequant_idct"])):
        tm = spec["timing"][name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_lossy.cu",
            "replaces": f"{tpu}:{line}", "tpu_kernel": f"{tpu}:{line}",
            "launches": launches,
            "launches_per": "restore" if name == "dequant_idct" else "save",
            "max_abs_err": spec["max_abs_err"][name],
            "ms": tm["ms"], "kernel_ms": tm["ms"],
            "device_ms": tm["device_ms"], "plain_ms": tm["plain_ms"],
            "library_ms": tm["library_ms"],
            "library_call": ("torch.matmul, f32, TF32 off (matmul only)"
                             if tm["library_ms"] is not None else None),
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "shape": {"blocks": spec["blocks"], "block": 256,
                      "dtype": "float32", "leaves": spec["leaves"]},
        })
    log(json.dumps({"serve": serve}))
    log(json.dumps({"spectral": {k: v for k, v in spec.items()
                                 if k != "timing"}}))
    log(json.dumps({"train": train}))
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
