"""Two-process replica hydration on the port: serve, mirror, hydrate, compare.

    python3 tools/torch_hydrate_smoke.py [--device cpu] [--full]

Process A (child, ``--replica``): a cold replica. It listens on a port
the OS picks (``ReplicaHydrator("tcp://127.0.0.1:0")``), ingests the
producer's mirrored snapshot chain until a restorable snapshot with
in-flight requests arrives, builds the paged engine from it mid-serve
(``from_snapshot``: on CUDA the decode step is captured first and the
snapshot written into its buffers in place), stays attached to tail the
rest of the chain, decodes its requests to completion with zero prefill,
and prints one ``HYDRATE_RESULT`` JSON line: each request's continuation,
the buffers' addresses before and after the snapshot was applied, the
paged-attention launches of its steps, ``ingest_s`` / ``restore_s``, the
first replay, and a warm hydrate-then-step against re-prefilling the same
requests (the cold-replica time to first token).

Process B (this process): ``repro_torch.launch.serve.serve_loop`` with
``default_serve_plan(snapshot_to="tcp://...")`` pointed at the replica.

Passes when every token the replica decodes equals the producer's token
at the same position of the same request, the replica ran no prefill
after hydration, its buffers kept their addresses, the producer's mirror
had no failed send, and (on CUDA) the kernel ran once per layer per
replica step. ``chip_smoke.py`` runs the same pair at full width.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

ARCH = "smollm-135m"
MARKER = "HYDRATE_RESULT "
#: the traffic of chip_smoke.py's serve phase
SERVE = dict(n_requests=16, max_new=32, num_pages=17, page_size=16, slots=4)


def _best_s(once, sync, repeats: int = 3) -> float:
    once()                                       # warm
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        once()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# child: the cold replica
# ---------------------------------------------------------------------------

def replica_main(device: str, full: bool, seed: int) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import base as configs
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.launch.hydrate import ReplicaHydrator
    from repro_torch.models import params as P_lib
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine

    cfg = configs.get(ARCH, smoke=not full)
    dev = torch.device(device)
    params = P_lib.materialize(torch.Generator().manual_seed(seed),
                               transformer.param_spec(cfg), dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    # what _apply_snapshot writes into: the buffers' addresses before and
    # after, and the leaves it was given (for the warm re-hydration below)
    applied: list[dict] = []
    apply = PagedServingEngine._apply_snapshot

    def ptrs(e):
        return [e.pool["kv"]["k"].data_ptr(), e.pool["kv"]["v"].data_ptr(),
                e.page_table.data_ptr(), e.lengths.data_ptr(),
                e.tokens.data_ptr()]

    def traced(self, leaves, meta):
        before = ptrs(self)
        apply(self, leaves, meta)
        applied.append({"before": before, "after": ptrs(self),
                        "leaves": leaves})

    PagedServingEngine._apply_snapshot = traced
    hyd = ReplicaHydrator("tcp://127.0.0.1:0")

    def ready() -> bool:
        # restorable is not enough: wait for a snapshot with work in
        # flight, so the decode comparison has something to decode
        if not hyd.store.restorable(hyd.stream):
            return False
        _, leaves = hyd.store.restore(hyd.stream)
        meta = json.loads(np.asarray(leaves["['meta']"],
                                     np.uint8).tobytes())
        return any(a is not None for a in meta["active"])

    engine, info = hyd.hydrate(cfg, params, ready=ready, device=dev,
                               idle_timeout_s=60.0, start_grace_s=300.0,
                               detach=False, log=print)
    followed: dict = {}
    tail = threading.Thread(target=lambda: followed.update(
        hyd.follow(idle_timeout_s=5.0, log=print)))
    tail.start()

    live = [a for a in engine.active if a is not None]
    offsets = {r.rid: len(r.out) for r in live}
    prefill_before = engine.prefill_tokens
    launches0 = PK.paged_decode_attention.launches
    sync()
    t0 = time.perf_counter()
    engine.step()
    sync()
    first_replay_s = time.perf_counter() - t0
    steps = 1
    while any(a is not None for a in engine.active):
        engine.step()
        steps += 1
    sync()
    launches = PK.paged_decode_attention.launches - launches0
    records = [{"rid": r.rid, "offset": offsets[r.rid],
                "tokens": r.out[offsets[r.rid]:]} for r in live]
    prefill_after = engine.prefill_tokens - prefill_before

    # cold-replica time to first token, both warm: the chain written back
    # into this engine and one step, against a fresh engine of the same
    # geometry re-admitting (re-prefilling) the same requests and one step
    leaves = applied[0]["leaves"]

    def hydrate_once():
        engine.load_snapshot(leaves)
        engine.step()

    fresh = PagedServingEngine(cfg, params, device=dev, **{
        k: getattr(engine, k) for k in ("num_pages", "page_size",
                                        "max_reqs", "prompt_len",
                                        "max_len")})

    def reprefill_once():
        for row, a in enumerate(fresh.active):
            if a is not None:
                fresh.free_resource(row)
        for r in live:
            assert fresh.admit(Request(r.rid, np.asarray(r.prompt).copy(),
                                       max_new=r.max_new))
        fresh.step()

    ttft_hydrate_s = _best_s(hydrate_once, sync)
    ttft_reprefill_s = _best_s(reprefill_once, sync)
    tail.join(600)
    out = {"records": records, "steps": steps, "launches": launches,
           "n_layers": cfg.n_layers,
           "prefill_after_hydration": prefill_after,
           "ptrs_before": applied[0]["before"],
           "ptrs_after": applied[0]["after"],
           "ingest_s": info["ingest_s"], "restore_s": info["restore_s"],
           "frames_ingested": info["frames_ingested"],
           "frames_followed": followed.get("snapshot_frames"),
           "step": info["step"], "active_requests": info["active_requests"],
           "prefixes": info["prefixes"], "first_replay_s": first_replay_s,
           "first_token_s": info["restore_s"] + first_replay_s,
           "ttft_hydrate_s": ttft_hydrate_s,
           "ttft_reprefill_s": ttft_reprefill_s}
    print(MARKER + json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------------------
# parent: the producer, and the checks
# ---------------------------------------------------------------------------

def run_pair(*, device: str = "cuda", full: bool = False, seed: int = 0,
             serve: dict = SERVE, log=print) -> tuple[dict, dict]:
    """Start the replica child, serve against it, return (the producer's
    ``serve_loop`` output, the replica's result). Raises when the child
    fails or prints no result."""
    from repro_torch.launch.serve import default_serve_plan, serve_loop

    cmd = [sys.executable, "-u", os.path.abspath(__file__), "--replica",
           "--device", device, "--seed", str(seed)] + (
               ["--full"] if full else [])
    env = {**os.environ, "PYTHONPATH": SRC}
    child = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env)
    lines: list[str] = []
    address: dict = {}
    listening = threading.Event()

    def pump():
        for line in child.stdout:                # type: ignore[union-attr]
            lines.append(line)
            if "listening on tcp://" in line and not listening.is_set():
                address["url"] = line.split()[-1]
                listening.set()
        listening.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        if not listening.wait(600) or "url" not in address:
            raise RuntimeError("replica never started listening:\n"
                               + "".join(lines))
        log(f"replica listening on {address['url']} (pid {child.pid})")
        plan = default_serve_plan(snapshot_to=address["url"])
        out = serve_loop(ARCH, smoke=not full, device=device, seed=seed,
                         plan=plan, log=log, **serve)
        child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    reader.join(30)
    for line in lines:
        if not line.startswith(MARKER):
            log(f"replica: {line.rstrip()}")
    if child.returncode != 0:
        raise RuntimeError(f"replica exited {child.returncode}")
    marker = [ln for ln in lines if ln.startswith(MARKER)]
    if not marker:
        raise RuntimeError("replica printed no result")
    return out, json.loads(marker[0][len(MARKER):])


def check(out: dict, res: dict, *, device: str) -> list[str]:
    """The pair's gates; returns the failures (empty: passed)."""
    failures = []
    if res["frames_ingested"] < 1 or not res["records"]:
        failures.append("replica hydrated from no frame or with no "
                        "in-flight request")
    if res["prefill_after_hydration"] != 0:
        failures.append(f"replica ran {res['prefill_after_hydration']} "
                        f"prefill tokens after hydration (want 0)")
    if res["ptrs_before"] != res["ptrs_after"]:
        failures.append("replica buffers moved while the snapshot was "
                        "applied")
    if device != "cpu" and res["launches"] != res["steps"] * res["n_layers"]:
        failures.append(f"replica ran {res['launches']} paged-attention "
                        f"launches in {res['steps']} steps x "
                        f"{res['n_layers']} layers")
    snap = out["session_report"]["tasks"]["kv_snapshot"]
    if snap.get("mirror_failures", 0) != 0 or snap.get("mirror_frames", 0) < 1:
        failures.append(f"producer mirror: {snap.get('mirror_frames')} "
                        f"frames, {snap.get('mirror_failures')} failures")
    by_rid = {r.rid: r.out for r in out["requests"]}
    for rec in res["records"]:
        want = by_rid[rec["rid"]][rec["offset"]:
                                  rec["offset"] + len(rec["tokens"])]
        if not rec["tokens"] or rec["tokens"] != want:
            failures.append(f"request {rec['rid']} at offset "
                            f"{rec['offset']}: replica {rec['tokens']} vs "
                            f"producer {want}")
    return failures


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replica", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of the smoke config")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.replica:
        return replica_main(args.device, args.full, args.seed)
    out, res = run_pair(device=args.device, full=args.full, seed=args.seed)
    failures = check(out, res, device=args.device)
    for f in failures:
        print(f"FAIL: {f}")
    if failures:
        return 1
    print(f"hydrate smoke passed: replica hydrated over TCP at step "
          f"{res['step']} with {res['active_requests']} in-flight "
          f"requests, {res['steps']} lockstep steps, no prefill; ingest "
          f"{res['ingest_s']:.3f} s, restore {res['restore_s']:.3f} s, "
          f"first replay {res['first_replay_s'] * 1e3:.2f} ms; warm "
          f"hydrate+step {res['ttft_hydrate_s'] * 1e3:.2f} ms vs re-prefill"
          f"+step {res['ttft_reprefill_s'] * 1e3:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
