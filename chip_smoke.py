#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is swallowed):

1. device  — the card's name and power limit, as ``nvidia-smi`` reports
   them.
2. build   — every kernel of the serving path, compiled from
   ``src/repro_torch/kernels/csrc`` by ``nvcc`` (one process per source,
   all started together).
3. kernels — each kernel held against its plain PyTorch version on the
   card, in f32 (tol 1e-5) and bf16 (atol 3.2e-2, see
   ``tests/test_torch_paged_attention_card.py`` for why), at the serving
   shapes and at one long-context shape; timed per call with CUDA events
   (warm-up, then the median of 25 samples of 10 launches; host overhead
   between launches included) and on the device alone with
   ``torch.profiler``, beside the plain version,
   ``scaled_dot_product_attention`` on the gathered cache (a yardstick
   only; the port never calls it) and the least time the card could take
   (HBM 3.35 TB/s, f32 FMA 67 TFLOP/s; the larger bound).
4. serve   — the port's ``serve_loop("smollm-135m", smoke=False)``: full
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
    built = _build.build(["paged_attention"])
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
    serve = serve_phase(ROOT / "build" / "smoke_chain")
    log(f"serve phase: {time.perf_counter() - t0:.1f}s, "
        f"{serve['tok_per_s']:.1f} tok/s")

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
    log(json.dumps({"serve": serve}))
    log(card)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
