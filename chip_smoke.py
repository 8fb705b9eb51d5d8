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
   shapes (one split of 4 pages) and at one long-context shape (a
   256-page table: 32 splits of 8 pages a row, gated to at least two CTAs
   per (row, kv head)); timed per call with CUDA events (warm-up, then
   the median of 25 samples of 10 launches; host overhead between
   launches included) and on the device alone with ``torch.profiler``
   (the split kernel plus, for several splits, the combine), beside the
   plain version,
   ``scaled_dot_product_attention`` on the gathered cache (a yardstick
   only; the port never calls it) and the least time the card could take
   (HBM 3.35 TB/s, and 67 TFLOP/s f32 FMA or 989 TFLOP/s bf16 by the
   operands' type; the larger bound). Every bound in this script is
   ``repro_torch.roofline.kernels.kernel_cost`` over the HBM rate and the
   kernel's own peak rate (:func:`bound_ms`).
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
5. single-tensor spectral kernels — ``dct_hist_coarse`` and
   ``hist_refine`` (the lossy stage of the SYNC and ASYNC placements, one
   leaf at a time) held against their plain versions at the shape of each
   of the 22 moment leaves of full-width ``smollm-135m`` (8 to 110,592
   blocks) and at edge shapes (8 blocks, 1001 -> 1008 blocks, 1e-20-scaled
   and 1 %-sparse payloads). Gates: y of the DCT as in 4, and bitwise
   ``dct_hist_coarse_tiled``'s; ``dct_hist_coarse``'s histogram equal to
   ``dct_hist_coarse_tiled``'s tile rows summed (counts exactly, energies
   rtol 1e-6 of the rows summed in f64); on the kernel's own y, counts
   equal and energies rtol 1e-5; the thresholds of the
   card's two-level route equal to the CPU's flat route; and
   ``spectral_compress`` on the card bitwise equal (q and scale) to
   ``spectral_compress`` of the same leaf on the CPU; ``hist_refine``'s
   membership table deciding none of the 2^31 non-negative f32 bit
   patterns differently from the kernel's ``bin_index``, and its output
   the same bits over 5 calls and from two calls at once on two worker
   threads' streams (at ``embed``). Each kernel is timed
   at the ``embed`` leaf (as in 4; ``torch.matmul`` of the same f32
   product is the DCT's yardstick) and summed over the 22 leaves of one
   save.
6. roofline — the flat 512-bin pair (``dct_hist_tiled``, ``dct_hist``)
   held against its plain version and against the two-level kernels on
   the card, at the edge shapes of 4, at ``benchmarks/kernel_roofline.py``'s
   256 and 4096 standard-normal blocks (seed 0), at the ``embed``
   moment leaf in four payload kinds (1e-20 and 1 %-sparse included) and
   at the packed moment buffer of 4 (the main shape of its table row).
   Gates: y (and ``dct_hist_coarse``'s) bitwise equal to
   ``dct_hist_coarse_tiled``'s; on the kernel's own y, counts equal to the
   plain version's (an element on a bin edge
   where the kernel's log2f and ``ref.bin_index`` could round apart may
   move, and is counted and printed) and energies rtol 1e-5; the single
   histogram equal to the tile rows summed (energies rtol 1e-6); every 16
   flat bins equal to the coarse kernel's bin, and the 16 inside a tile's
   coarse bin to the refine kernel's counts; the flat threshold bitwise
   equal to the two-level kernels' (``dct_hist_coarse`` + ``hist_refine``)
   at eps 1e-3, 1e-2, 1e-1 and 1.5. Then the roofline of all nine kernels:
   launch counts set to 0, ``kernel_report(..., measure=True)`` of each
   kernel at its table shape (paged attention at the serving shape, the
   tiled spectral kernels at the packed buffer, the single-tensor ones at
   ``embed``, the flat pair at the packed buffer, at 4096 blocks and, the
   single one, at ``embed``), one JSON line each, counts read. Last, the
   flat pair's reports (per-call ms and bound) beside its device time (as
   in 4), its plain version and ``torch.matmul``, and the flat/two-level
   ratios: kernel 9 against 6 + 7 at ``embed``,
   kernel 8 against 2 + 3 at the packed buffer (not gated: the 3x gate of
   ``kernel_roofline`` is about one-hot binning on a TPU's MXU).
7. serve   — the port's ``serve_loop("smollm-135m", smoke=False)``: full
   published widths (30 layers, d_model 576, 9 query / 3 KV heads, d_ff
   1536, vocab 49152), bf16 random weights from seed 0, 16 requests of 32
   new tokens over a 17-page pool (requests queue on pages). The same
   traffic runs four times: with no in-situ task and with the default
   async ``serve_snapshot`` plan (persisting its chain under ``build/``),
   each once stepping eagerly (``cuda_graph=False``) and once replaying
   the decode step's CUDA graph (the default); tok/s of all four are
   printed. Asserts: the four runs decode the same token streams; all
   served, pool empty at exit, snapshots published, each chain restores
   bit-identically to what was emitted at its step, and in the graphed
   run with snapshots the kernel ran once per layer per decode step
   (launches counted under replay). Then a graphed and an eager engine
   step 8 times from one state and their logits must be the same bits;
   one full-width decode step runs twice from one state — through the
   kernel and through the plain version — and the logits are compared
   (atol 0.125: a few bf16 steps of attention difference carried through
   30 layers; logits are O(1)); and ten decode steps of each engine are
   profiled: host wall per step, aten ops, device busy time and idle
   share, the busiest device ops.

8. train   — the port's ``train_loop("smollm-135m", smoke=False)``:
   full published widths, batch 4 x 4096 tokens (``train_4k``'s length,
   its global batch of 256 cut to 4 for one card), bf16 state from seed
   0, each step a replay of the captured train step (the default). First
   the bare loop (no in-situ task), 5 steps from seed 0, eagerly twice
   and graphed once: the graphed losses must be bitwise the eager ones if
   the two eager runs are bitwise equal, else within their spread. Then,
   in HYBRID placement, 20 steps with no checkpoint task bound (what the
   in-situ work costs), then 20 steps with a checkpoint every 5 steps
   under ``build/`` (launch counts are set to 0 just before and read just
   after: kernels 2-4 once per save), then a direct restore of the newest
   step (kernel 5 once per lossy leaf) whose params must equal bitwise
   the state emitted at that step and whose moments must be within
   ``error_bound(eps)`` relative L2 per leaf, then a second run that
   resumes from it. Also: the device stage alone on the trained state,
   and one train step's device profile, eager and replayed, each with
   its peak memory (and what the graph's pool keeps).
9. train (sync/async ckpt) — the same graphed loop, 10 steps with a
   checkpoint every 5 steps (saves at 0 and 5) in SYNC and then in ASYNC
   placement: the lossy stage runs per leaf on the checkpoint's workers
   through the single-tensor kernels. Launch counts are set to 0 just
   before each run and read just after: 22 each of ``dct_hist_coarse``,
   ``hist_refine`` and ``threshold_quant`` per save, none of the tiled
   pair. Then a restore of step 5 (params bitwise as emitted, moments
   within ``error_bound(eps)``). Printed beside the HYBRID run's numbers:
   step time, the checkpoint's loop-blocking seconds, its worker seconds,
   raw/stored bytes and the restore time; the p_o/p_i allocator's choice
   from the measured SYNC and ASYNC save costs.

The last lines are the card line, one JSON object with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 3.2e-2
LOGIT_ATOL = 0.125
SERVE = dict(n_requests=16, max_new=32, num_pages=17, page_size=16, slots=4)
EPS = 1e-2                          # the checkpoint's lossy_eps
FLAT_EPS = (1e-3, 1e-2, 1e-1, 1.5)  # the flat/two-level threshold gate
ROOFLINE_ITERS = 10                 # timed calls per kernel_report
TRAIN = dict(steps=20, ckpt_every=5, resume_steps=5)
PLACEMENTS = dict(steps=10, ckpt_every=5)     # the SYNC/ASYNC runs


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
    ops, launches = {}, {}
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
                launches[e.key] = e.count
    busy = sum(ops.values())
    return {"wall_ms": wall * 1e3 / n, "host_aten_ops": host_ops / n,
            "device_busy_ms": busy if ops else None,
            "device_idle_share": (1 - busy / (wall * 1e3 / n)) if ops
            else None,
            "top": sorted(ops.items(), key=lambda kv: -kv[1])[:8],
            "per_launch_ms": {k: ms * n / launches[k]
                              for k, ms in ops.items()},
            "launches": launches}


def host_wall_ms(fn, n: int) -> float:
    """Host wall ms per call of ``fn`` over n calls, without the profiler
    (whose tracing of each kernel of a graph replay inflates the wall)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def kernel_device_ms(fn, syms, n: int = 3) -> tuple[float | None, dict]:
    """Device ms of one call of ``fn``, which launches each kernel named in
    ``syms`` once: the sum of their mean times per recorded launch, and
    per kernel (ms per launch, launches recorded of the n that ran). The
    profiler has recorded fewer launches than ran (1 or 2 of 3 for a 5 ms
    kernel on the H100), which a window's sum over n calls would report
    as time not spent."""
    prof = device_profile(fn, n)
    ops = {op: (ms, prof["launches"][op])
           for op, ms in prof["per_launch_ms"].items()
           if any(sym in op for sym in syms)}
    return sum(ms for ms, _ in ops.values()) or None, ops


def bound_ms(name: str, *args) -> tuple[float, str]:
    """Least time of kernel ``name`` on these arguments on one H100 and
    what bounds it: ``kernel_report``'s roofline time (its ``kernel_cost``
    over the HBM rate and the peak rate of the kernel's arithmetic,
    whichever is larger)."""
    from repro_torch.roofline.kernels import kernel_report

    rep = kernel_report(None, args, name=name)
    return rep.roofline_s * 1e3, ("operations" if rep.bound == "compute"
                                  else "bytes")


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
    shapes = {"serve": _serve_shape(serve_table_width),
              "long": _serve_shape(4096 // ps)}
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
        b_ms, b_by = bound_ms("paged_decode_attention", *args)
        # the split kernel and, for more than one split, the combine
        dev_ms, dev_ops = kernel_device_ms(
            lambda: PK.paged_decode_attention(*args),
            ("paged_decode_kernel", "paged_combine_kernel"), 20)
        splits, per = PK.split_plan(shp["pps"], ps, shp["b"], shp["n_kv"])
        if name == "long":     # at least two CTAs per (row, kv head)
            assert shp["b"] * splits >= 2 * shp["b"] * shp["n_kv"], splits
        out[name] = {"shape": dict(shp, len=full, dtype="bfloat16"),
                     "splits": splits, "pages_per_split": per,
                     "max_abs_err": err, "ms": k_ms, "device_ms": dev_ms,
                     "device_ops": dev_ops, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"kernel {name} timing (bf16, B={shp['b']}, len={full}, "
            f"{splits} splits of {per} pages): kernel {k_ms:.4f} ms per "
            f"call (device {dev_ms} ms: {dev_ops}), plain {p_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
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
            lambda: torch.matmul(xb, dt_), "dct_coarse_tiled_kernel"),
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
    bounds = {
        "dct_hist_coarse_tiled": bound_ms("dct_hist_coarse_tiled", xb),
        "hist_refine_tiled": bound_ms("hist_refine_tiled", y, block_cc),
        "threshold_quant": bound_ms("threshold_quant", y, t),
        "dequant_idct": bound_ms("dequant_idct", q, s),
    }
    timing = {}
    for name, (kern, plain, lib, sym) in calls.items():
        k_ms = time_ms(kern, warmup=2, samples=5, reps=3)
        p_ms = time_ms(plain, warmup=1, samples=3, reps=1)
        l_ms = (time_ms(lib, warmup=2, samples=5, reps=3)
                if lib is not None else None)
        dev_ms, _ = kernel_device_ms(kern, (sym,))
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
# single-tensor spectral kernel phase
# ---------------------------------------------------------------------------

def _leaf_payload(gen, n, dev, kind):
    """One leaf's values: moment-like (``mu`` ~ N(0, 1e-3), ``nu`` its
    square-ish) or an edge class."""
    import torch

    v = torch.randn(n, generator=gen, device=dev)
    if kind == "tiny":
        return v * 1e-20
    if kind == "sparse":
        return v * (torch.rand(n, generator=gen, device=dev) < 0.01)
    if kind == "nu":
        return (v * 1e-3) ** 2
    return v * 1e-3


def _rel_err(got, want):
    import torch

    return ((got - want).abs() / want.abs().clamp(min=1e-38)).max().item()


def single_tensor_check(x, eps, label):
    """``dct_hist_coarse`` and ``hist_refine`` against their plain versions
    on one leaf, the card's two-level thresholds against the CPU's flat
    ones, and ``spectral_compress`` on the card against the CPU's."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spectral_lossy as K

    xb = ops._pad_blocks(ref.blockize(x)[0], K.HIST_TILE)
    nb = xb.shape[0]
    y, cnt, eng = K.dct_hist_coarse(xb)
    y2, cnt2, eng2 = K.dct_hist_coarse_tiled(xb)
    torch.cuda.synchronize()
    # kernel 6 is kernel 2's tile rows summed: y and counts bitwise, the
    # energies to rtol 1e-6 of the rows summed in f64 (each is a double sum
    # of the same f32 rows, in its own order, rounded once)
    if not torch.equal(y, y2):
        raise AssertionError(f"{label}: dct_hist_coarse y is not "
                             f"dct_hist_coarse_tiled's")
    cnt_s, eng_s = K._sum_rows(cnt2, eng2)
    del y2, cnt2, eng2
    if not torch.equal(cnt, cnt_s):
        raise AssertionError(f"{label}: dct_hist_coarse counts are not "
                             f"dct_hist_coarse_tiled's rows summed")
    torch.testing.assert_close(eng, eng_s, rtol=1e-6, atol=0.0)
    y_p = ref.dct_blocks(xb)
    err_y = _check_close(f"{label} dct y", y, y_p, y_p)
    del y_p
    a = torch.abs(y)
    coarse = torch.div(ref.bin_index(a), 16, rounding_mode="floor")
    cnt_p, eng_p = K._sum_rows(*K._tile_sums(a * a, coarse, 32, 8))
    del a, coarse
    if not torch.equal(cnt, cnt_p):
        raise AssertionError(f"{label} dct_hist_coarse counts differ: "
                             f"{cnt.tolist()} vs {cnt_p.tolist()}")
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)
    c, cc, base, budget = ref.select_coarse(eng, eps)
    fcnt, feng = K.hist_refine(y, cc)
    fcnt_p, feng_p = K.hist_refine_plain(
        y, K._per_block(cc, nb, torch.int32, y.device))
    if not torch.equal(fcnt, fcnt_p):
        raise AssertionError(f"{label} hist_refine counts differ")
    torch.testing.assert_close(feng, feng_p, rtol=1e-5, atol=0.0)
    t = ref.select_fine(feng, c, cc, base, budget)
    # the CPU's route on the same leaf: the flat selector, the CPU product
    x_cpu = x.cpu()
    y_cpu, t_cpu = ops.select_flat(xb.cpu(), eps)
    y_differ = int((y.cpu() != y_cpu).sum())
    del y_cpu
    thresholds_differ = int(not torch.equal(t.cpu(), t_cpu))
    if thresholds_differ:
        raise AssertionError(f"{label}: card threshold {t.item()!r} != CPU "
                             f"flat threshold {t_cpu.item()!r}")
    card = ops.spectral_compress(x, eps)
    cpu = ops.spectral_compress(x_cpu, eps)
    if not (torch.equal(card.q.cpu(), cpu.q)
            and torch.equal(card.scale.cpu(), cpu.scale)):
        raise AssertionError(
            f"{label}: spectral_compress on the card differs from the CPU's "
            f"(q {int((card.q.cpu() != cpu.q).sum())}, scale "
            f"{int((card.scale.cpu() != cpu.scale).sum())} differing)")
    return {"blocks": nb, "err_y": err_y,
            "energy_rel": _rel_err(eng, eng_p),
            "rows_energy_rel": _rel_err(eng, eng_s),
            "refine_energy_rel": _rel_err(feng, feng_p),
            "refine_abs_err": (feng - feng_p).abs().max().item(),
            "y_differing_vs_cpu": y_differ,
            "thresholds_differing": thresholds_differ,
            "dropped_all": bool((card.q == 0).all().item()),
            "xb": xb, "y": y, "cc": cc}


def refine_gates(y, cc) -> dict:
    """``hist_refine``'s membership table against ``bin_index`` over all
    2^31 non-negative f32 patterns (0 decided differently), and its bits:
    the same over 5 calls, and from two calls at once on two worker
    threads, each on its own stream."""
    import threading

    import torch
    from repro_torch.kernels import spectral_lossy as K

    dev = y.device
    t0 = time.perf_counter()
    bad = K.refine_table_errors(dev)
    check_s = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"hist_refine: the membership table decides "
                             f"{bad} of 2^31 patterns differently from "
                             f"bin_index")
    bits = lambda: torch.cat(K.hist_refine(y, cc)).view(torch.int32)  # noqa: E731
    first = bits().clone()
    for i in range(4):
        if not torch.equal(bits(), first):
            raise AssertionError(f"hist_refine: call {i + 2} gave other bits")
    outs, errors = [None, None], []
    streams = [torch.cuda.Stream(dev) for _ in outs]
    main = torch.cuda.current_stream(dev)
    for s in streams:
        s.wait_stream(main)

    def work(i):
        try:
            with torch.cuda.stream(streams[i]):
                outs[i] = bits().clone()
            streams[i].synchronize()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    if not all(torch.equal(o.to(first.device), first) for o in outs):
        raise AssertionError("hist_refine: two worker streams gave other bits")
    table = (K._refine_table(dev).cpu().long() & 0xFFFFFFFF).view(2, -1)
    return {"table_patterns_off": bad, "table_check_s": check_s,
            "same_bits_calls": 5, "same_bits_streams": 2,
            "table_lo": table[0].tolist(), "table_hi": table[1].tolist()}


def single_tensor_phase() -> dict:
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg = configs.get("smollm-135m")
    keys, sizes, rows = moment_rows(cfg)
    leaves, per_save = {}, {"dct_hist_coarse": {}, "hist_refine": {}}
    embed = None
    for key, n in zip(keys, sizes):
        x = _leaf_payload(gen, n, dev, "nu" if key.startswith("['nu']")
                          else "mu")
        res = single_tensor_check(x, EPS, key)
        xb, y, cc = res.pop("xb"), res.pop("y"), res.pop("cc")
        nb = xb.shape[0]
        bounds = {"dct_hist_coarse": bound_ms("dct_hist_coarse", xb),
                  "hist_refine": bound_ms("hist_refine", y, cc)}
        block_cc = K._per_block(cc, nb, torch.int32, dev).contiguous()
        calls = {
            "dct_hist_coarse": (lambda: K.dct_hist_coarse(xb),
                                lambda: K.dct_hist_coarse_plain(xb)),
            "hist_refine": (lambda: K.hist_refine(y, cc),
                            lambda: K.hist_refine_plain(y, block_cc)),
        }
        for name, (kern, plain) in calls.items():
            row = per_save[name]
            row["ms"] = row.get("ms", 0.0) + time_ms(kern, warmup=2,
                                                     samples=3, reps=3)
            row["plain_ms"] = row.get("plain_ms", 0.0) + time_ms(
                plain, warmup=1, samples=3, reps=1)
            row["bound_ms"] = row.get("bound_ms", 0.0) + bounds[name][0]
        leaves[key] = res
        log(f"single {key}: {nb} blocks, max err y {res['err_y']:.3e}, "
            f"energy rel {res['energy_rel']:.3e} / refine "
            f"{res['refine_energy_rel']:.3e}, y differing vs CPU "
            f"{res['y_differing_vs_cpu']}, thresholds differing "
            f"{res['thresholds_differing']}")
        if key == "['mu']['embed']['embedding']":
            embed = (xb, y, cc, block_cc, bounds)
        else:
            del xb, y
    # edge shapes
    edges = {}
    for label, n, kind in (("8 blocks", 8 * 256, "mu"),
                           ("1001 blocks", 1001 * 256 - 5, "mu"),
                           ("1e-20", 1001 * 256 - 5, "tiny"),
                           ("1% sparse", 1001 * 256 - 5, "sparse")):
        x = _leaf_payload(gen, n, dev, kind)
        res = single_tensor_check(x, EPS, f"edge {label}")
        for k in ("xb", "y", "cc"):
            res.pop(k)
        edges[label] = res
        log(f"single edge {label}: {res}")

    # the refine kernel's membership table and its bits (gates)
    xb, y, cc, block_cc, bounds = embed
    refine_bits = refine_gates(y, cc)
    log(f"single hist_refine gates: {refine_bits}")

    # timings at the embed leaf (the main path's largest call)
    dt_ = ref.dct_tensor(dev).T.contiguous()
    calls = {
        "dct_hist_coarse": (lambda: K.dct_hist_coarse(xb),
                            lambda: K.dct_hist_coarse_plain(xb),
                            lambda: torch.matmul(xb, dt_),
                            ("dct_coarse_range_kernel",
                             "coarse_total_kernel")),
        "hist_refine": (lambda: K.hist_refine(y, cc),
                        lambda: K.hist_refine_plain(y, block_cc), None,
                        ("refine_range_kernel", "refine_total_kernel")),
    }
    timing = {}
    for name, (kern, plain, lib, syms) in calls.items():
        k_ms = time_ms(kern, warmup=2, samples=5, reps=3)
        p_ms = time_ms(plain, warmup=1, samples=3, reps=1)
        l_ms = (time_ms(lib, warmup=2, samples=5, reps=3)
                if lib is not None else None)
        dev_ms, dev_ops = kernel_device_ms(kern, syms)
        b_ms, b_by = bounds[name]
        timing[name] = {"ms": k_ms, "device_ms": dev_ms,
                        "device_ops": dev_ops, "plain_ms": p_ms,
                        "library_ms": l_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "per_save": per_save[name]}
        log(f"single {name} at embed ({xb.shape[0]} blocks): kernel "
            f"{k_ms:.4f} ms per call (device {dev_ops}), plain {p_ms:.4f} "
            f"ms, library {l_ms} ms, bound {b_ms:.4f} ms ({b_by}); summed "
            f"over one save's 22 leaves: {per_save[name]}")
    out = {"leaves": leaves, "edges": edges, "timing": timing,
           "embed_blocks": xb.shape[0], "refine_gates": refine_bits,
           "max_abs_err": {
               "dct_hist_coarse": max(r["err_y"] for r in leaves.values()),
               "hist_refine": max(r["refine_abs_err"]
                                  for r in leaves.values())},
           "thresholds_differing": sum(r["thresholds_differing"]
                                       for r in leaves.values())}
    del embed, xb, y
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# roofline phase
# ---------------------------------------------------------------------------

def _flat_counts_gate(label, cnt, cnt_p, a, bins):
    """The flat kernel's counts against the plain version's: equal, except
    that an element on a bin edge, where the kernel's log2f and
    ``ref.bin_index`` could round apart, may sit one bin over. Such moves
    are counted, printed, and allowed up to the edge elements found (in
    f64, within 1e-4 of a bin's width from an edge)."""
    import torch
    from repro_torch.kernels import ref

    if torch.equal(cnt, cnt_p):
        return 0
    moved = int((cnt - cnt_p).abs().sum().item()) // 2
    pos = (torch.log2(a.double().clamp(min=1e-38)) - ref.LOG2_LO
           ) * ref._BIN_SCALE
    edge = (a > 0) & ((pos - pos.round()).abs() < 1e-4)
    log(f"{label}: {moved} elements in another flat bin than ref.bin_index "
        f"puts them; {int(edge.sum())} elements sit on a bin edge: "
        f"{a[edge][:8].tolist()} (bins {bins[edge][:8].tolist()})")
    if moved > int(edge.sum()):
        raise AssertionError(f"{label}: flat counts differ from the plain "
                             f"version's beyond the bin-edge elements")
    return moved


def flat_check(xb, label):
    """The flat pair against its plain version and the two-level kernels
    on one input (see the module docstring, phase 6)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K

    y8, cnt8, eng8 = K.dct_hist_tiled(xb)
    y9, cnt9, eng9 = K.dct_hist(xb)
    y2, cnt2, _ = K.dct_hist_coarse_tiled(xb)
    torch.cuda.synchronize()
    if not (torch.equal(y8, y2) and torch.equal(y9, y2)):
        raise AssertionError(f"{label}: the flat pair's y is not the coarse "
                             f"kernel's")
    y_p = ref.dct_blocks(xb)
    err_y = _check_close(f"{label} flat y", y8, y_p, y_p)
    del y_p
    a = torch.abs(y8)
    bins = ref.bin_index(a)
    cnt_p, eng_p = K._tile_sums(a * a, bins, ref.NBINS, K.HIST_TILE)
    moved = _flat_counts_gate(label, cnt8, cnt_p, a, bins)
    same = cnt8 == cnt_p
    torch.testing.assert_close(eng8[same], eng_p[same], rtol=1e-5, atol=0.0)
    del a, bins
    cnt_s, eng_s = K._sum_rows(cnt8, eng8)
    if not torch.equal(cnt9, cnt_s):
        raise AssertionError(f"{label}: dct_hist counts are not its tile "
                             f"rows summed")
    torch.testing.assert_close(eng9, eng_s, rtol=1e-6, atol=0.0)
    n_tiles = cnt8.shape[0]
    if not torch.equal(cnt8.view(n_tiles, ref.NBINS_COARSE,
                                 ref.NBINS_FINE).sum(-1), cnt2):
        raise AssertionError(f"{label}: 16 flat bins differ from their "
                             f"coarse bin")
    c_tile = cnt2.argmax(1).to(torch.int32)
    fcnt, _ = K.hist_refine_tiled(y8, c_tile.repeat_interleave(K.HIST_TILE))
    idx = (c_tile[:, None].long() * ref.NBINS_FINE
           + torch.arange(ref.NBINS_FINE, device=xb.device))
    if not torch.equal(cnt8.gather(1, idx), fcnt):
        raise AssertionError(f"{label}: flat bins inside a coarse bin differ "
                             f"from the refine kernel's counts")
    y6, _, ce = K.dct_hist_coarse(xb)
    if not torch.equal(y6, y2):
        raise AssertionError(f"{label}: dct_hist_coarse y is not "
                             f"dct_hist_coarse_tiled's")
    thresholds = {}
    for eps in FLAT_EPS:
        c, cc, base, budget = ref.select_coarse(ce, eps)
        _, fe = K.hist_refine(y6, cc)
        t_two = ref.select_fine(fe, c, cc, base, budget)
        t_flat = ref.threshold_from_histogram(eng9, eps)
        if not torch.equal(t_two, t_flat):
            raise AssertionError(f"{label} eps {eps}: flat threshold "
                                 f"{t_flat.item()!r} != two-level "
                                 f"{t_two.item()!r}")
        thresholds[eps] = t_flat.item()
    return {"blocks": xb.shape[0], "err_y": err_y,
            "energy_rel": _rel_err(eng8[same], eng_p[same]),
            "single_energy_rel": _rel_err(eng9, eng_s),
            "moved": moved, "thresholds": thresholds}


def _serve_shape(table_width: int) -> dict:
    return dict(b=8, hq=9, n_kv=3, d=64, ps=SERVE["page_size"],
                pps=table_width)


def _in_turns(a, b) -> tuple[float, float]:
    """Per-call ms of two callables timed in turns (a, b, b, a)."""
    ta = [time_ms(a, warmup=2, samples=5, reps=3)]
    tb = [time_ms(b, warmup=2, samples=5, reps=3) for _ in range(2)]
    ta.append(time_ms(a, warmup=2, samples=5, reps=3))
    return statistics.mean(ta), statistics.mean(tb)


def roofline_phase(serve_table_width: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.roofline.kernels import kernel_report

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    cfg = configs.get("smollm-135m")
    keys, sizes, rows = moment_rows(cfg)
    n_embed = sizes[keys.index("['mu']['embed']['embedding']")]

    # 1. the flat pair against its plain version and the two-level kernels
    checks = {}
    edge_rows = [8, 16, 1000, 24]
    edge_sizes = [8 * 256 - 5, 16 * 256, 1000 * 256 - 100, 17 * 256]
    for kind in ("moments", "zeros", "tiny"):
        checks[f"edge {kind}"] = flat_check(
            _spectral_payload(gen, edge_sizes, edge_rows, dev, kind),
            f"flat edge {kind}")
    bench = {}
    for nb in (256, 4096):              # benchmarks/kernel_roofline.py
        bench[nb] = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (nb, ref.BLOCK)).astype(np.float32)).to(dev)
        checks[f"kernel_roofline {nb}"] = flat_check(bench[nb],
                                                     f"flat {nb} blocks")
    for kind in ("mu", "nu", "tiny", "sparse"):
        x = _leaf_payload(gen, n_embed, dev, kind)
        xe = ops._pad_blocks(ref.blockize(x)[0], K.HIST_TILE)
        checks[f"embed {kind}"] = flat_check(xe, f"flat embed {kind}")
    for label, res in checks.items():
        log(f"flat {label}: {res}")
    xe = ops._pad_blocks(ref.blockize(_leaf_payload(gen, n_embed, dev, "mu")
                                      )[0], K.HIST_TILE)

    # 2. every kernel on the roofline, counted from a fresh start
    xb = _spectral_payload(gen, sizes, rows, dev)
    checks["packed"] = flat_check(xb, "flat packed")
    log(f"flat packed: {checks['packed']}")
    nb = xb.shape[0]
    y = K.dct_hist_coarse_tiled(xb)[0]
    block_cc = torch.full((nb,), 20, dtype=torch.int32, device=dev)
    t = torch.full((nb,), 1e-4, dtype=torch.float32, device=dev)
    q, s = K.threshold_quant(y, t)
    ye, _, ce = K.dct_hist_coarse(xe)
    cc_e = ref.select_coarse(ce, EPS)[1]
    gen_cpu = torch.Generator().manual_seed(1234)
    shp = _serve_shape(serve_table_width)
    full = shp["ps"] * shp["pps"]
    paged = _paged_case(gen_cpu, lengths=[full] * shp["b"],
                        dtype=torch.bfloat16, dev=dev, **shp)
    cases = [
        ("paged_decode_attention", "serve", PK.paged_decode_attention, paged),
        ("dct_hist_coarse_tiled", "packed", K.dct_hist_coarse_tiled, (xb,)),
        ("hist_refine_tiled", "packed", K.hist_refine_tiled, (y, block_cc)),
        ("threshold_quant", "packed", K.threshold_quant, (y, t)),
        ("dequant_idct", "packed", K.dequant_idct, (q, s)),
        ("dct_hist_coarse", "embed", K.dct_hist_coarse, (xe,)),
        ("hist_refine", "embed", K.hist_refine, (ye, cc_e)),
        ("dct_hist_tiled", "packed", K.dct_hist_tiled, (xb,)),
        ("dct_hist", "packed", K.dct_hist, (xb,)),
        ("dct_hist_tiled", "4096", K.dct_hist_tiled, (bench[4096],)),
        ("dct_hist", "4096", K.dct_hist, (bench[4096],)),
        ("dct_hist", "embed", K.dct_hist, (xe,)),
    ]
    torch.cuda.synchronize()
    K.reset_launches()
    PK.paged_decode_attention.launches = 0
    reports = []
    for name, shape, fn, args in cases:
        rep = kernel_report(fn, args, name=name, measure=True,
                            iters=ROOFLINE_ITERS)
        reports.append({"shape": shape, **rep.to_dict()})
        log(json.dumps({"roofline": reports[-1]}))
    launches = {k.__name__: k.launches for k in K.KERNELS}
    launches["paged_decode_attention"] = PK.paged_decode_attention.launches
    for name, _, _, _ in cases:
        want = (1 + ROOFLINE_ITERS) * sum(c[0] == name for c in cases)
        assert launches[name] == want, (name, launches)
    log(f"roofline launches: {launches}")

    # 3. the flat pair's reports beside its device time, its plain
    #    version and the library product, and against the two-level pair
    dt_ = ref.dct_tensor(dev).T.contiguous()
    placed = {(r["name"], r["shape"]): r for r in reports}
    timing = {}
    for name, fn, syms in (
            ("dct_hist_tiled", K.dct_hist_tiled, ("dct_flat_tiled_kernel",)),
            ("dct_hist", K.dct_hist, ("dct_flat_range_kernel",
                                      "flat_total_kernel"))):
        plain = getattr(K, f"{name}_plain")
        shapes = {"packed": xb, "4096": bench[4096]}
        if name == "dct_hist":
            shapes["embed"] = xe
        for label, x in shapes.items():
            rep = placed[name, label]
            k_ms = rep["measured_s"] * 1e3
            b_ms = rep["roofline_s"] * 1e3
            b_by = "operations" if rep["bound"] == "compute" else "bytes"
            p_ms = time_ms(lambda: plain(x), warmup=1, samples=3, reps=1)
            l_ms = time_ms(lambda: torch.matmul(x, dt_), warmup=2, samples=5,
                           reps=3)
            dev_ms, dev_ops = kernel_device_ms(lambda: fn(x), syms)
            timing.setdefault(name, {})[label] = {
                "blocks": x.shape[0], "ms": k_ms, "device_ms": dev_ms,
                "device_ops": dev_ops, "plain_ms": p_ms, "library_ms": l_ms,
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"roofline {name} at {label} ({x.shape[0]} blocks): kernel "
                f"{k_ms:.4f} ms per call (device {dev_ops}), plain "
                f"{p_ms:.4f} ms, torch.matmul {l_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
    flat_e, two_e = _in_turns(
        lambda: K.dct_hist(xe),
        lambda: (K.dct_hist_coarse(xe), K.hist_refine(ye, cc_e)))
    flat_p, two_p = _in_turns(
        lambda: K.dct_hist_tiled(xb),
        lambda: (K.dct_hist_coarse_tiled(xb),
                 K.hist_refine_tiled(y, block_cc)))
    ratios = {"embed": {"flat_ms": flat_e, "two_level_ms": two_e,
                        "flat_over_two_level": flat_e / two_e,
                        "kernels": "dct_hist vs dct_hist_coarse + "
                                   "hist_refine"},
              "packed": {"flat_ms": flat_p, "two_level_ms": two_p,
                         "flat_over_two_level": flat_p / two_p,
                         "kernels": "dct_hist_tiled vs dct_hist_coarse_tiled"
                                    " + hist_refine_tiled"}}
    log(f"flat / two-level on the card (per call, timed in turns): embed "
        f"{flat_e:.4f} / {two_e:.4f} ms = {flat_e / two_e:.3f}x; packed "
        f"{flat_p:.4f} / {two_p:.4f} ms = {flat_p / two_p:.3f}x")
    out = {"checks": checks, "reports": reports, "launches": launches,
           "timing": timing, "ratios": ratios,
           "max_abs_err": max(r["err_y"] for r in checks.values())}
    del xb, y, q, s, t, xe, ye, bench
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def _serve_wall_s(run: dict) -> float:
    """The serve loop's wall seconds (its tokens over its tok/s)."""
    return sum(len(r.out) for r in run["requests"]) / run["tok_per_s"]


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
    eager_dir = chain_dir.with_name(chain_dir.name + "_eager")
    for d in (chain_dir, eager_dir):
        if d.exists():
            shutil.rmtree(d)

    def snapshot_plan(directory: Path, emitted: dict) -> InSituPlan:
        # the default plan, persisted on disk, plus a probe on the same
        # stream that keeps what was emitted at each firing (to check the
        # restore); the probe runs SYNC, a D2H copy on the loop every 4
        # steps, so that it never holds ring slots the snapshot task
        # competes for
        base = InSituPlan.from_dict(
            default_serve_plan(snapshot_dir=str(directory)))
        probe = TaskSpec(name="probe", stream="kv_pages", trigger=Every(4),
                         placement=Placement.SYNC,
                         sink=lambda step, p: emitted.__setitem__(
                             step, S._flatten(p["cache"])))
        return InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                          workers=base.workers,
                          staging_capacity=base.staging_capacity)

    lines: list[str] = []

    def serve_log(msg: str) -> None:
        lines.append(msg)
        log(f"serve: {msg}")

    # the same traffic four times: with no in-situ task bound (what the
    # snapshots cost; the first run also warms the full-width shapes up)
    # and with the snapshot plan, each stepping eagerly and replaying the
    # captured decode graph; all four must decode the same tokens
    runs = {}
    for graph in (False, True):
        runs["bare", graph] = serve_loop(
            "smollm-135m", smoke=False, device="cuda", seed=0,
            plan={"streams": ["kv_pages"]}, log=lambda _: None,
            cuda_graph=graph, **SERVE)
        assert all(r.done for r in runs["bare", graph]["requests"])
    emitted_eager: dict[int, dict] = {}
    runs["plan", False] = serve_loop(
        "smollm-135m", smoke=False, device="cuda", seed=0,
        plan=snapshot_plan(eager_dir, emitted_eager), cuda_graph=False,
        log=lambda m: log(f"serve (eager): {m}"), **SERVE)
    bare = runs["bare", True]

    emitted: dict[int, dict] = {}
    PK.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = serve_loop("smollm-135m", smoke=False, device="cuda",
                     plan=snapshot_plan(chain_dir, emitted), seed=0,
                     log=serve_log, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PK.paged_decode_attention.launches
    runs["plan", True] = out
    tok_s = {f"{'graph' if g else 'eager'}_{k}": r["tok_per_s"]
             for (k, g), r in runs.items()}
    log(f"serve: tok/s {tok_s}")
    for (k, g), r in runs.items():
        rep = r["session_report"]
        log(f"serve: {'graph' if g else 'eager'}_{k}: wall "
            f"{_serve_wall_s(r):.3f} s = admissions "
            f"{r['telemetry'].total('serve/admit'):.3f} + decode "
            f"steps {rep['step_compute_s']:.3f} + hand-off dispatch "
            f"{rep['handoff_dispatch_s']:.3f} + sync stall "
            f"{rep['sync_stall_s']:.3f} + the rest")
    streams = {key: [r.out for r in run["requests"]]
               for key, run in runs.items()}
    for key, got in streams.items():
        assert got == streams["plan", True], (
            f"serve run {key} decoded other tokens than the graphed run "
            f"with snapshots")
    log(f"serve: the four runs decode the same {SERVE['n_requests']} token "
        f"streams ({sum(map(len, streams['plan', True]))} tokens)")

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

    for directory, kept in ((chain_dir, emitted), (eager_dir, emitted_eager)):
        store = S.SnapshotStore(str(directory))
        step, leaves = store.restore("kv_pages")
        want = kept[step]
        assert list(leaves) == list(want), "restored leaf keys differ"
        for key, arr in leaves.items():
            assert arr.shape == want[key].shape, key
            if not np.array_equal(arr.reshape(-1).view(np.uint8),
                                  want[key].reshape(-1).view(np.uint8)):
                raise AssertionError(f"{directory.name}: restored leaf {key} "
                                     f"differs at step {step}")
        log(f"serve: {directory.name} restores bit-identically to the "
            f"payload emitted at step {step} ({len(leaves)} leaves, "
            f"{sum(a.nbytes for a in leaves.values())} bytes)")

    # a graphed engine and an eager one from one state: 8 full-width
    # steps whose logits must be the same bits
    params = P.materialize(torch.Generator().manual_seed(0),
                           transformer.param_spec(cfg), "cuda")
    engines = {}
    for graph in (True, False):
        e = engines[graph] = PagedServingEngine(
            cfg, params, num_pages=33, page_size=16, max_reqs=8,
            prompt_len=16, max_len=64, device="cuda", cuda_graph=graph)
        rng = np.random.default_rng(5)
        for i in range(8):
            assert e.admit(Request(i, rng.integers(0, cfg.vocab_size, 16),
                                   max_new=32))
    eng, eng_eager = engines[True], engines[False]
    for _ in range(8):
        eng.step()
        eng_eager.step()
        if not torch.equal(eng.logits, eng_eager.logits):
            raise AssertionError("graphed and eager decode logits differ")
    log("serve: 8 full-width decode steps (8 rows), graph replay and eager "
        "step: logits bitwise equal")

    # one full-width decode step from one state, kernel vs plain version

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
    # in-situ work): host wall per step against device busy time, graph
    # replay beside the eager step
    profiles = {}
    for name, e in (("graph", eng), ("eager", eng_eager)):
        decode = profiles[name] = device_profile(e.step, 10)
        decode["wall_ms_unprofiled"] = host_wall_ms(e.step, 10)
        decode["device_idle_share_unprofiled"] = (
            1 - decode["device_busy_ms"] / decode["wall_ms_unprofiled"])
        log(f"serve: decode step ({name}, 8 rows, full width): "
            f"{decode['wall_ms']:.2f} ms wall under the profiler, "
            f"{decode['wall_ms_unprofiled']:.3f} without, "
            f"{decode['host_aten_ops']:.0f} aten ops on the host, device "
            f"busy {decode['device_busy_ms']} ms, idle share "
            f"{decode['device_idle_share']} "
            f"({decode['device_idle_share_unprofiled']} of the wall "
            f"without the profiler)")
        for op, ms in decode["top"]:
            log(f"serve:   {ms * 1e3:9.1f} us/step  {op[:90]}")
        decode["paged_launches_recorded"] = sum(
            c for op, c in decode["launches"].items()
            if "paged_decode_kernel" in op)
        log(f"serve: the profiler recorded "
            f"{decode['paged_launches_recorded']} paged-attention launches "
            f"of the {10 * cfg.n_layers} that ran")
    decode = profiles["graph"]
    loop = {k: rep[k] for k in ("step_compute_s", "handoff_dispatch_s",
                                "handoff_materialize_s", "sync_stall_s",
                                "staging_backpressure_s",
                                "async_overlapped_s")}

    return {"tok_per_s": out["tok_per_s"], "wall_s": wall,
            "tok_per_s_without_insitu": bare["tok_per_s"],
            "tok_per_s_by_run": tok_s,
            "step_compute_s_without_insitu":
                bare["session_report"]["step_compute_s"],
            "loop_by_run": {
                f"{'graph' if g else 'eager'}_{k}": {
                    "wall_s": _serve_wall_s(r),
                    "admit_s": r["telemetry"].total("serve/admit"),
                    **{m: r["session_report"][m] for m in (
                        "step_compute_s", "handoff_dispatch_s",
                        "sync_stall_s")}}
                for (k, g), r in runs.items()},
            "loop": loop, "decode_profile": decode,
            "decode_profile_eager": profiles["eager"],
            "requests": served, "decode_steps": decode_steps,
            "launches": launches, "snapshots": snap["publishes"],
            "snapshot_drops": rep["drops"].get("kv_snapshot", 0),
            "effective_compression_x": snap["effective_compression_x"],
            "logit_max_abs_diff": diff,
            "argmax_agreement": agree.item()}


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def _per_step(report: dict, steps: int, tm=None) -> dict:
    """The loop's seconds from a session report; ``step_s`` is the mean
    step (the first, warming up, included), ``step_median_s`` the median
    of the ``step/compute`` spans of telemetry ``tm``."""
    keys = ("step_compute_s", "handoff_dispatch_s", "handoff_materialize_s",
            "sync_stall_s", "staging_backpressure_s", "async_overlapped_s")
    out = {k: report[k] for k in keys} | {
        "step_s": report["step_compute_s"] / steps}
    if tm is not None:
        out["step_median_s"] = statistics.median(
            sp.dt for sp in tm.spans("step/compute"))
    return out


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

    # 0. the bare loop (no in-situ task) from seed 0, 5 steps: eager twice
    #    and graphed once; the graphed losses are bitwise the eager ones
    #    where two eager runs are, else within their spread
    short = {}
    for name, graph in (("eager", False), ("eager_again", False),
                        ("graph", True)):
        run = T.train_loop("smollm-135m", smoke=False, steps=5,
                           plan={"streams": ["grads", "train_state"]},
                           device="cuda", seed=0, cuda_graph=graph,
                           log=lambda m: None)
        short[name] = run["losses"]
        assert np.isfinite(run["losses"]).all(), (name, run["losses"])
        short[f"{name}_step_median_s"] = statistics.median(
            sp.dt for sp in run["telemetry"].spans("step/compute"))
    eager_spread = max(abs(a - b) for a, b in zip(short["eager"],
                                                  short["eager_again"]))
    graph_off = max(abs(a - b) for a, b in zip(short["eager"],
                                                short["graph"]))
    short["eager_bitwise"] = short["eager"] == short["eager_again"]
    if short["eager_bitwise"]:
        assert short["graph"] == short["eager"], short
    else:
        assert graph_off <= eager_spread, short
    short.update(eager_spread=eager_spread, graph_off=graph_off)
    log(f"train: 5 bare steps from seed 0, losses eager {short['eager']}, "
        f"eager again {short['eager_again']}, graphed {short['graph']}: "
        f"eager runs {'bitwise equal' if short['eager_bitwise'] else 'apart'}"
        f" (max |dloss| {eager_spread}), graph vs eager max |dloss| "
        f"{graph_off}; median step s eager "
        f"{short['eager_step_median_s']:.4f} / graphed "
        f"{short['graph_step_median_s']:.4f}")

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

    # 6. one full-width train step's device profile (no in-situ work),
    #    eager and replayed from its CUDA graph, with peak memory
    state = T.init_state(cfg, 0, T.StepConfig().opt, device="cuda")
    step_fn = T.make_train_step(cfg, T.StepConfig())
    spec = batch_spec_for(cfg, T.FULL_SHAPE)
    host_batch = synth_batch(spec, 0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host_batch.items()}
    step_fn(state, batch)
    torch.cuda.reset_peak_memory_stats()
    prof = device_profile(lambda: step_fn(state, batch), 2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph_step = T.graph_train_step(cfg, T.StepConfig(), state, batch)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_step(host_batch)
    prof_graph = device_profile(lambda: graph_step(host_batch), 2)
    peak_graph_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    torch.cuda.empty_cache()            # keeps only the live graph's pool
    held_gb = (torch.cuda.memory_reserved() - before) / 1e9
    for name, pr, peak in (("eager", prof, peak_gb),
                           ("graph", prof_graph, peak_graph_gb)):
        log(f"train: step ({name}, 4 x 4096 tokens, full width): "
            f"{pr['wall_ms']:.1f} ms wall, {pr['host_aten_ops']:.0f} aten "
            f"ops, device busy {pr['device_busy_ms']} ms, idle share "
            f"{pr['device_idle_share']}, peak memory {peak:.2f} GB")
        for op, ms in pr["top"]:
            log(f"train:   {ms:9.2f} ms/step  {op[:90]}")
    log(f"train: capture (2 warm-up steps + capture) {capture_s:.2f} s; the "
        f"graph's pool holds {held_gb:.2f} GB for the loop's life")
    del graph_step

    with_ckpt = _per_step(rep, steps, out["telemetry"])
    without = _per_step(bare_rep, steps, bare["telemetry"])
    blocking = _ckpt_blocking_s(out["telemetry"])
    result = {
        "ckpt_blocking_s": blocking,
        "ckpt_blocking_s_per_save": blocking / n_saves,
        "losses_without_ckpt": bare["losses"], "losses": out["losses"],
        "resume_losses": res["losses"],
        "step_s_without_ckpt": without["step_s"],
        "step_s_with_ckpt": with_ckpt["step_s"],
        "step_median_s_without_ckpt": without["step_median_s"],
        "step_median_s_with_ckpt": with_ckpt["step_median_s"],
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
        "peak_memory_gb": peak_gb, "step_profile_graph": prof_graph,
        "peak_memory_gb_graph": peak_graph_gb,
        "graph_pool_reserved_gb": held_gb, "graph_capture_s": capture_s,
        "bare_5_steps": short,
    }
    log(f"train: step {without['step_s'] * 1e3:.1f} ms without the "
        f"checkpoint task, {with_ckpt['step_s'] * 1e3:.1f} ms with it (median "
        f"{without['step_median_s'] * 1e3:.1f} / "
        f"{with_ckpt['step_median_s'] * 1e3:.1f}); "
        f"loop-blocking handoff dispatch {with_ckpt['handoff_dispatch_s']:.3f}"
        f" s, sync stall {with_ckpt['sync_stall_s']:.3f} s (probe "
        f"{probe_s:.3f} s of it), device stage alone {stage_ms:.2f} ms; "
        f"checkpoint {ck['raw_bytes']} -> {ck['stored_bytes']} bytes "
        f"({result['effective_compression_x']:.2f}x) over {ck['saves']} saves")
    del state, restored, template
    torch.cuda.empty_cache()
    return result


def _ckpt_blocking_s(tm) -> float:
    """Seconds the checkpoint task held the loop: its SYNC chain, its
    device stage (HYBRID), its hand-off dispatch and any blocking
    hand-off."""
    return sum(sp.dt for sp in tm.spans()
               if sp.name in ("insitu-sync/checkpoint",
                              "insitu-device/checkpoint")
               or (sp.name in ("handoff/dispatch", "step/handoff")
                   and sp.meta.get("task") == "checkpoint"))


def placements_phase(ckpt_root: Path, hybrid: dict) -> dict:
    """SYNC and ASYNC checkpoints of the full-width training run."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.configs import base as configs
    from repro_torch.core import pytree
    from repro_torch.core.allocator import Allocator
    from repro_torch.core.session import (InSituPlan, Placement, TaskSpec,
                                          When)
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.launch import train as T

    cfg = configs.get("smollm-135m")
    steps, every = PLACEMENTS["steps"], PLACEMENTS["ckpt_every"]
    newest = (steps - 1) // every * every
    n_saves = (steps - 1) // every + 1
    n_lossy = len(moment_rows(cfg)[2])
    out = {}
    for mode in ("sync", "async"):
        ckpt_dir = ckpt_root / mode
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        emitted: dict = {}

        def keep(step, payload):
            emitted["step"] = step
            emitted["state"] = {pytree.keystr(p): np.array(a) for p, a in
                                pytree.flatten_with_path(payload)}

        base = InSituPlan.from_dict(T.default_train_plan(
            insitu_mode=mode, ckpt_dir=str(ckpt_dir), ckpt_every=every,
            device="cuda"))
        probe = TaskSpec(name="probe", stream="train_state",
                         trigger=When(lambda st: st == newest),
                         placement=Placement.SYNC, sink=keep)
        plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                          workers=base.workers,
                          staging_capacity=base.staging_capacity)
        K.reset_launches()
        t0 = time.perf_counter()
        run = T.train_loop("smollm-135m", smoke=False, steps=steps,
                           plan=plan, device="cuda", seed=0,
                           log=lambda m, mode=mode: log(f"train ({mode} "
                                                        f"ckpt): {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in K.KERNELS}
        rep = run["session_report"]
        assert rep["n_errors"] == 0, rep["errors"]
        assert np.isfinite(run["losses"]).all(), run["losses"]
        ck = rep["checkpoint"]
        assert ck["saves"] == n_saves and ck["last_step"] == newest, ck
        for name in ("dct_hist_coarse", "hist_refine", "threshold_quant"):
            assert launches[name] == n_lossy * n_saves, (mode, launches)
        for name in ("dct_hist_coarse_tiled", "hist_refine_tiled",
                     "dequant_idct"):
            assert launches[name] == 0, (mode, launches)
        tm = run["telemetry"]
        blocking = _ckpt_blocking_s(tm)
        worker_s = tm.total("insitu-async/checkpoint")

        template = T.init_state(cfg, 1, T.StepConfig().opt, device="cuda")
        K.reset_launches()
        t0 = time.perf_counter()
        restored = ser.read_state(str(ckpt_dir / f"step_{newest:09d}"),
                                  template, "cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert K.dequant_idct.launches == n_lossy, K.dequant_idct.launches
        assert emitted.get("step") == newest, emitted.get("step")
        worst = 0.0
        for path, t in pytree.flatten_with_path(restored):
            key = pytree.keystr(path)
            want = emitted["state"][key]
            if key.startswith("['mu']") or key.startswith("['nu']"):
                w = torch.from_numpy(want.view(np.int16)).view(torch.bfloat16)
                err = ref.rel_l2_error(w.float(), t.float().cpu())
                worst = max(worst, err)
                assert err <= ref.error_bound(EPS), (mode, key, err)
            else:
                got = (t.view(torch.int16) if t.dtype == torch.bfloat16
                       else t).cpu().numpy()
                if not np.array_equal(got.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8)):
                    raise AssertionError(f"{mode}: restored {key} differs "
                                         f"from step {newest}'s state")
        del restored, template, emitted
        torch.cuda.empty_cache()
        loop = _per_step(rep, steps, tm)
        out[mode] = {
            "losses": run["losses"], "wall_s": wall,
            "step_s": loop["step_s"], "step_median_s": loop["step_median_s"],
            "loop": loop,
            "ckpt_blocking_s": blocking,
            "ckpt_blocking_s_per_save": blocking / n_saves,
            "ckpt_worker_s": worker_s,
            "probe_sync_s": tm.total("insitu-sync/probe"),
            "saves": ck["saves"], "raw_bytes": ck["raw_bytes"],
            "stored_bytes": ck["stored_bytes"],
            "effective_compression_x": ck["raw_bytes"] / ck["stored_bytes"],
            "launches": launches, "restore_s": restore_s,
            "restore_launches": n_lossy, "moments_worst_rel_l2": worst}
        log(f"train ({mode} ckpt): step {loop['step_s'] * 1e3:.1f} ms "
            f"(median {loop['step_median_s'] * 1e3:.1f}), wall {wall:.2f} s; "
            f"the checkpoint held the loop {blocking:.3f} s over {n_saves} "
            f"saves ({blocking / n_saves:.3f} s per save; sync stall "
            f"{loop['sync_stall_s']:.3f} s, handoff dispatch "
            f"{loop['handoff_dispatch_s']:.3f} s, probe "
            f"{out[mode]['probe_sync_s']:.3f} s of the stall), worker "
            f"seconds {worker_s:.3f}; {ck['raw_bytes']} -> "
            f"{ck['stored_bytes']} bytes "
            f"({out[mode]['effective_compression_x']:.2f}x); restore of "
            f"step {newest} {restore_s:.2f} s, moments worst rel L2 "
            f"{worst:.4e}; launches {launches}")
    sync, asyn = out["sync"], out["async"]
    assert sync["ckpt_blocking_s"] > asyn["ckpt_blocking_s"], (
        "the SYNC checkpoint held the loop no longer than the ASYNC one")
    log(f"train placements (ckpt every {every} of {steps} steps; HYBRID "
        f"every {TRAIN['ckpt_every']} of {TRAIN['steps']}): median step s "
        f"sync {sync['step_median_s']:.4f} / async "
        f"{asyn['step_median_s']:.4f} / hybrid "
        f"{hybrid['step_median_s_with_ckpt']:.4f} (no ckpt "
        f"{hybrid['step_median_s_without_ckpt']:.4f}); wall s sync "
        f"{sync['wall_s']:.2f} / async {asyn['wall_s']:.2f}; "
        f"loop-blocking s per save "
        f"sync {sync['ckpt_blocking_s_per_save']:.4f} / async "
        f"{asyn['ckpt_blocking_s_per_save']:.4f} / hybrid "
        f"{hybrid['ckpt_blocking_s_per_save']:.4f}; compression sync "
        f"{sync['effective_compression_x']:.3f}x / async "
        f"{asyn['effective_compression_x']:.3f}x / hybrid "
        f"{hybrid['effective_compression_x']:.3f}x; restore s sync "
        f"{sync['restore_s']:.2f} / async {asyn['restore_s']:.2f} / hybrid "
        f"{hybrid['restore_s']:.2f}")
    # the paper's allocator (Table I, F1, F6) on the measured costs
    p_total = os.cpu_count() or 8
    al = Allocator(p_total=p_total,
                   handoff_s=asyn["ckpt_blocking_s_per_save"])
    al.observe_app(p_total, hybrid["step_s_without_ckpt"])
    al.observe_task(p_total, sync["ckpt_blocking_s_per_save"])
    al.observe_task(2, asyn["ckpt_worker_s"] / n_saves)
    choice = al.plan(n_steps=steps, every=every)
    out["allocator"] = {"mode": choice.mode, "p_app": choice.p_app,
                        "p_insitu": choice.p_insitu,
                        "predicted_total_s": choice.predicted_total_s,
                        "detail": choice.detail}
    log(f"allocator (p_total {p_total}): {out['allocator']}")

    # the same placements stepping eagerly, 10 steps with a checkpoint
    # every 5: what the graph changed in each, within this run; the
    # losses are the graphed runs' (bitwise where two eager runs are,
    # else within their spread)
    spread = hybrid["bare_5_steps"]
    graphed = {"hybrid": hybrid["losses"], "sync": sync["losses"],
               "async": asyn["losses"]}
    out["eager"] = {}
    for mode in ("hybrid", "sync", "async"):
        ckpt_dir = ckpt_root / f"eager_{mode}"
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        t0 = time.perf_counter()
        run = T.train_loop("smollm-135m", smoke=False, steps=steps,
                           insitu_mode=mode, ckpt_dir=str(ckpt_dir),
                           ckpt_every=every, device="cuda", seed=0,
                           cuda_graph=False, log=lambda m: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = run["session_report"]
        assert rep["n_errors"] == 0, rep["errors"]
        assert rep["checkpoint"]["saves"] == n_saves, rep["checkpoint"]
        want = graphed[mode][:steps]
        off = max(abs(a - b) for a, b in zip(run["losses"], want))
        if spread["eager_bitwise"]:
            assert run["losses"] == want, (mode, run["losses"], want)
        else:
            assert off <= spread["eager_spread"], (mode, run["losses"], want)
        tm = run["telemetry"]
        loop = _per_step(rep, steps, tm)
        blocking = _ckpt_blocking_s(tm)
        out["eager"][mode] = {
            "losses": run["losses"], "wall_s": wall,
            "step_median_s": loop["step_median_s"], "loop": loop,
            "ckpt_blocking_s_per_save": blocking / n_saves,
            "ckpt_worker_s": tm.total("insitu-async/checkpoint"),
            "graph_loss_max_abs_diff": off}
    eager = out["eager"]
    log(f"train placements, eager (ckpt every {every} of {steps} steps): "
        f"median step s hybrid {eager['hybrid']['step_median_s']:.4f} / "
        f"sync {eager['sync']['step_median_s']:.4f} / async "
        f"{eager['async']['step_median_s']:.4f}; loop-blocking s per save "
        f"hybrid {eager['hybrid']['ckpt_blocking_s_per_save']:.4f} / sync "
        f"{eager['sync']['ckpt_blocking_s_per_save']:.4f} / async "
        f"{eager['async']['ckpt_blocking_s_per_save']:.4f}; worker s async "
        f"{eager['async']['ckpt_worker_s']:.3f}; losses equal to the "
        f"graphed runs' (max |dloss| "
        f"{max(e['graph_loss_max_abs_diff'] for e in eager.values())})")
    return out


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
    single = single_tensor_phase()
    log(f"single-tensor spectral kernel phase: "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    roof = roofline_phase(serve_table_width=4)
    log(f"roofline phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve = serve_phase(ROOT / "build" / "smoke_chain")
    log(f"serve phase: {time.perf_counter() - t0:.1f}s, "
        f"{serve['tok_per_s']:.1f} tok/s")
    t0 = time.perf_counter()
    train = train_phase(ROOT / "build" / "smoke_ckpt")
    log(f"train phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    placements = placements_phase(ROOT / "build" / "smoke_ckpt_placements",
                                  train)
    log(f"train (sync/async ckpt) phase: {time.perf_counter() - t0:.1f}s")

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
    for name, line in (("dct_hist_coarse", 184), ("hist_refine", 245)):
        tm = single["timing"][name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_lossy.cu",
            "replaces": f"{tpu}:{line}", "tpu_kernel": f"{tpu}:{line}",
            "launches": placements["async"]["launches"][name],
            "launches_per": "ASYNC training run with 2 saves (22 per save)",
            "launches_by_run": {m: placements[m]["launches"][name]
                                for m in ("sync", "async")},
            "max_abs_err": single["max_abs_err"][name],
            "ms": tm["ms"], "kernel_ms": tm["ms"],
            "device_ms": tm["device_ms"], "plain_ms": tm["plain_ms"],
            "library_ms": tm["library_ms"],
            "library_call": ("torch.matmul, f32, TF32 off (matmul only)"
                             if tm["library_ms"] is not None else None),
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "per_save": tm["per_save"],
            "shape": {"blocks": single["embed_blocks"], "block": 256,
                      "dtype": "float32", "leaf": "['mu']['embed']"},
        })
    for name, line in (("dct_hist_tiled", 299), ("dct_hist", 133)):
        main_shape = "packed" if name == "dct_hist_tiled" else "embed"
        tm = roof["timing"][name]
        at = ", ".join(r["shape"] for r in roof["reports"]
                       if r["name"] == name)
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_lossy.cu",
            "replaces": f"{tpu}:{line}", "tpu_kernel": f"{tpu}:{line}",
            "launches": roof["launches"][name],
            "launches_per": (f"roofline phase: kernel_report at {at}, "
                             f"1 + {ROOFLINE_ITERS} calls each"),
            "max_abs_err": roof["max_abs_err"],
            **{k: tm[main_shape][k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")},
            "kernel_ms": tm[main_shape]["ms"],
            "library_call": "torch.matmul, f32, TF32 off (matmul only)",
            "shape": {"blocks": tm[main_shape]["blocks"], "block": 256,
                      "dtype": "float32", "at": main_shape},
            "at": tm,
            "flat_over_two_level": roof["ratios"],
        })
    log(json.dumps({"serve": serve}))
    log(json.dumps({"spectral": {k: v for k, v in spec.items()
                                 if k != "timing"}}))
    log(json.dumps({"train": train}))
    log(json.dumps({"single_tensor": {k: v for k, v in single.items()
                                      if k != "timing"}}))
    log(json.dumps({"train_placements": placements}))
    log(json.dumps({"roofline": {k: v for k, v in roof.items()
                                 if k != "reports"}}))
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
