"""Full-width xlstm-1.3b served through the CLI with its default snapshot plan.

    python3 tools/torch_xlstm_serve_plan.py [--traffic cli|serve] [--floor-gib G]

Runs ``python -m repro_torch.launch.serve --arch xlstm-1.3b --full`` in this
process: the CLI's own argument parsing, so the default async
``serve_snapshot`` plan (zlib, a base every 8 publishes, 2 workers, the
session's staging ring, the chain kept in memory with 2 chains retained).
``--traffic cli`` keeps the CLI's default traffic (8 requests x 8 new
tokens); ``--traffic serve`` adds ``--requests 16 --max-new 32``, the
traffic of ``chip_smoke.py``'s ``SERVE``. Needs the card.

Every 0.2 s a watcher thread reads ``MemAvailable`` and this process's
resident set. Should ``MemAvailable`` fall below ``--floor-gib``, the
script prints what it has so far with ``"aborted": "host memory"`` and
exits 4, before the host runs out.

Prints one line ``XLSTM_PLAN_RESULT {json}``: the CLI's wall seconds, the
serve loop's wall split into admissions, decode steps, hand-off dispatch,
sync stall and the rest (mostly the session's end draining the firings
in flight), tok/s, firings published (base / delta / noop) and dropped,
raw and stored bytes, the card's peak memory, the process's peak resident
set and the least ``MemAvailable`` seen, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

ARCH = "xlstm-1.3b"
TRAFFIC = {"cli": [], "serve": ["--requests", "16", "--max-new", "32"]}


def _meminfo_gib(key: str) -> float:
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith(key + ":"):
                return int(ln.split()[1]) / 2**20
    raise RuntimeError(f"no {key} in /proc/meminfo")


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) / 2**20
    raise RuntimeError("no VmRSS in /proc/self/status")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class _Watcher(threading.Thread):
    """Samples host memory; ends the process below ``floor_gib``."""

    def __init__(self, floor_gib: float, result: dict) -> None:
        super().__init__(daemon=True)
        self.floor_gib = floor_gib
        self.result = result
        self.min_available = _meminfo_gib("MemAvailable")
        self.max_rss = _rss_gib()
        self.done = threading.Event()

    def run(self) -> None:
        while not self.done.wait(0.2):
            avail = _meminfo_gib("MemAvailable")
            self.min_available = min(self.min_available, avail)
            self.max_rss = max(self.max_rss, _rss_gib())
            if avail < self.floor_gib:
                self.result.update(self.memory(), aborted="host memory")
                print("XLSTM_PLAN_RESULT " + json.dumps(self.result),
                      flush=True)
                os._exit(4)

    def memory(self) -> dict:
        return {"min_mem_available_gib": self.min_available,
                "max_rss_gib_sampled": self.max_rss,
                "peak_rss_gib": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 2**20}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", choices=sorted(TRAFFIC), default="cli")
    ap.add_argument("--floor-gib", type=float, default=8.0,
                    help="end the run when MemAvailable falls below this")
    args = ap.parse_args()

    import torch
    from repro_torch.launch import serve

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    argv = ["--arch", ARCH, "--full"] + TRAFFIC[args.traffic]
    result = {"command": "python -m repro_torch.launch.serve "
                         + " ".join(argv),
              "card": _card(),
              "mem_total_gib": _meminfo_gib("MemTotal"),
              "mem_available_gib_before": _meminfo_gib("MemAvailable")}
    watcher = _Watcher(args.floor_gib, result)
    watcher.start()

    runs = []
    serve_loop = serve.serve_loop

    def recording_serve_loop(*a, **kw):
        runs.append(serve_loop(*a, **kw))
        return runs[-1]

    serve.serve_loop = recording_serve_loop
    sys.argv = ["repro_torch.launch.serve"] + argv
    t0 = time.perf_counter()
    try:
        serve.main()
    finally:
        serve.serve_loop = serve_loop
    torch.cuda.synchronize()
    cli_wall_s = time.perf_counter() - t0
    watcher.done.set()
    watcher.join()

    run = runs[0]
    rep = run["session_report"]
    tm = run["telemetry"]
    toks = sum(len(r.out) for r in run["requests"])
    wall = toks / run["tok_per_s"]
    parts = {"admit_s": tm.total("serve/admit"),
             "step_compute_s": rep["step_compute_s"],
             "handoff_dispatch_s": rep["handoff_dispatch_s"],
             "sync_stall_s": rep["sync_stall_s"]}
    snap = rep["tasks"].get("kv_snapshot", {})
    result.update(
        cli_wall_s=cli_wall_s, serve_wall_s=wall, **parts,
        rest_s=wall - sum(parts.values()), tok_per_s=run["tok_per_s"],
        served=sum(1 for r in run["requests"] if r.done),
        requests=len(run["requests"]), tokens=toks,
        decode_steps=len(tm.spans("step/compute")),
        snapshot={k: snap.get(k) for k in (
            "publishes", "bases", "deltas", "noops", "raw_bytes",
            "stored_bytes", "codec", "keep_chains")},
        snapshot_drops=rep["drops"].get("kv_snapshot", 0),
        n_errors=rep["n_errors"],
        card_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        mem_available_gib_after=_meminfo_gib("MemAvailable"),
        **watcher.memory())
    print("XLSTM_PLAN_RESULT " + json.dumps(result), flush=True)
    ok = rep["n_errors"] == 0 and result["served"] == result["requests"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
