#!/usr/bin/env python3
"""Where a checkpoint's loop-blocking seconds go, eager against graphed,
on the card.

1. ``train_loop`` of full-width ``smollm-135m`` (4 x 4096 tokens, bf16,
   seed 0), 10 steps with a checkpoint every 5 (saves at steps 0 and 5),
   in HYBRID and then ASYNC placement, stepping eagerly
   (``cuda_graph=False``) and replaying the captured train step in turns:
   eager, graph, graph, eager. For each save it prints the seconds of the
   two spans that hold the loop: the HYBRID device stage
   (``insitu-device/checkpoint``) and the hand-off dispatch
   (``handoff/dispatch``: device clones of the state and their copies
   into pinned host buffers), beside the run's median step; the dispatch
   split into its parts (host seconds of the clones, the side streams,
   the pinned buffers, the copies' enqueue, the rest: events and
   ``record_stream``), timed inside a copy of ``runtime._start_d2h`` that
   does the same calls in the same order; and the worker seconds
   (``insitu-async/`` spans) that overlap each dispatch.
2. On one full-width state: the host seconds of the dispatch's two
   allocations, every leaf's device ``clone`` and a pinned host buffer
   for it, after an eager step and after a replay in turns, three times
   each (each round freed before the next; the first finds no cache).

Run from the repository root on a machine with one CUDA card::

    python3 tools/torch_graph_handoff.py [--out build/graph_handoff.json]

It imports nothing of JAX. Every number it prints is measured in its run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def per_save(tm, name: str) -> dict[int, float]:
    """Seconds of the checkpoint task's spans ``name`` by step."""
    out: dict[int, float] = {}
    for sp in tm.spans(name):
        if name == "handoff/dispatch" and sp.meta.get("task") != "checkpoint":
            continue
        out[sp.step] = out.get(sp.step, 0.0) + sp.dt
    return out


def timed_start_d2h(parts: list):
    """``runtime._start_d2h`` with the host seconds of its parts appended
    to ``parts`` (one dict a call); the same calls in the same order."""
    import torch
    from repro_torch.core import host, pytree

    pc = time.perf_counter

    def start_d2h(payload, snapshot=False):
        acc = dict.fromkeys(("clone", "stream", "pinned", "copy", "rest"),
                            0.0)

        def start(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.device.type != "cuda":
                return x.clone() if snapshot else x
            t0 = pc()
            src = x.clone() if snapshot else x
            t1 = pc()
            loop = torch.cuda.current_stream(x.device)
            side = torch.cuda.Stream(device=x.device)
            side.wait_stream(loop)
            t2 = pc()
            with torch.cuda.stream(side):
                copy = host.HostCopy.__new__(host.HostCopy)
                copy.host = torch.empty(src.shape, dtype=src.dtype,
                                        pin_memory=True)
                t3 = pc()
                copy.host.copy_(src, non_blocking=True)
                t4 = pc()
                copy.done = torch.cuda.Event()
                copy.done.record()
            src.record_stream(side)
            if not snapshot:
                loop.wait_stream(side)
            t5 = pc()
            for k, dt in zip(acc, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                   t5 - t4)):
                acc[k] += dt
            return copy

        out = pytree.tree_map(start, payload)
        parts.append(acc)
        return out

    return start_d2h


def overlap(tm, t0: float, t1: float, prefix: str) -> float:
    """Seconds of spans ``prefix`` that fall inside [t0, t1]."""
    return sum(max(0.0, min(t1, sp.t1) - max(t0, sp.t0))
               for sp in tm.spans(prefix))


def loop_runs(work: Path) -> list[dict]:
    import shutil

    import torch
    from repro_torch.core import runtime
    from repro_torch.launch import train as T

    parts: list = []
    runtime._start_d2h = timed_start_d2h(parts)
    rows = []
    for mode in ("hybrid", "async"):
        for turn, graph in enumerate((False, True, True, False)):
            d = work / f"{mode}_{turn}"
            if d.exists():
                shutil.rmtree(d)
            del parts[:]
            t0 = time.perf_counter()
            run = T.train_loop("smollm-135m", smoke=False, steps=10,
                               insitu_mode=mode, ckpt_dir=str(d),
                               ckpt_every=5, device="cuda", seed=0,
                               cuda_graph=graph, log=lambda m: None)
            torch.cuda.synchronize()
            tm = run["telemetry"]
            row = {"mode": mode, "turn": turn,
                   "step": "graph" if graph else "eager",
                   "wall_s": time.perf_counter() - t0,
                   "step_median_s": statistics.median(
                       sp.dt for sp in tm.spans("step/compute")),
                   "device_stage_s": per_save(tm, "insitu-device/checkpoint"),
                   "dispatch_s": per_save(tm, "handoff/dispatch"),
                   "losses": run["losses"]}
            # the checkpoint's dispatches, in step order, with their parts
            # (other tasks' dispatches are small and left out)
            ck = [sp for sp in tm.spans("handoff/dispatch")
                  if sp.meta.get("task") == "checkpoint"]
            by_t0 = sorted(tm.spans("handoff/dispatch"), key=lambda sp: sp.t0)
            row["dispatch_parts"] = {
                sp.step: {**parts[by_t0.index(sp)],
                          "workers_busy_s": overlap(tm, sp.t0, sp.t1,
                                                    "insitu-async/")}
                for sp in ck}
            rows.append(row)
            print(f"{mode} turn {turn} ({row['step']}): median step "
                  f"{row['step_median_s']:.4f} s; per save (step: s) device "
                  f"stage {row['device_stage_s']}, dispatch "
                  f"{row['dispatch_s']}; dispatch parts "
                  f"{row['dispatch_parts']}", flush=True)
    return rows


def allocation_rounds() -> dict:
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.core.pytree import leaves
    from repro_torch.data.pipeline import batch_spec_for, synth_batch
    from repro_torch.launch import train as T

    cfg = configs.get("smollm-135m")
    state = T.init_state(cfg, 0, T.StepConfig().opt, device="cuda")
    host_batch = synth_batch(batch_spec_for(cfg, T.FULL_SHAPE), 0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host_batch.items()}
    eager = T.make_train_step(cfg, T.StepConfig())
    graph = T.graph_train_step(cfg, T.StepConfig(), state, batch)
    steps = {"eager": lambda: eager(state, batch),
             "graph": lambda: graph(host_batch)}
    rounds = []
    for name in ("eager", "graph") * 3:     # in turns; the first is cold
        steps[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clones = [t.clone() for t in leaves(state)]
        t1 = time.perf_counter()
        pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                  for t in clones]
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        rounds.append({"after": name, "clone_s": t1 - t0,
                       "pinned_s": t2 - t1})
        print(f"allocations after an {name} step: clones {t1 - t0:.4f} s, "
              f"pinned buffers {t2 - t1:.4f} s", flush=True)
        del clones, pinned
    return {"rounds": rounds}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "graph_handoff.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_graph_handoff: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    print(card, flush=True)
    work = ROOT / "build" / "graph_handoff"
    result = {"card": card, "loops": loop_runs(work),
              "allocations": allocation_rounds()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
