"""Two-process streaming smoke on the port: the server publishes, the
consumer steers.

    python3 tools/torch_stream_smoke.py [--device cpu] [--full]

Process A (child): ``tools/torch_insitu_consumer.py`` listening on a port
the OS picks, building a replica snapshot chain, pushing one steering
command (``{"task": "kv_snapshot", "every": 2}``) back up the wire, and
printing the digest of its restored state.

Process B (this process): ``repro_torch.launch.serve.serve_loop`` with
``default_serve_plan(snapshot_dir=..., snapshot_to="tcp://...")`` — every
chain frame the ``SnapshotStore`` publishes is mirrored over TCP while
the loop keeps serving.

Passes when the consumer's restored digest equals a restore from the
producer's on-disk chain, the producer's report shows the steering
command applied mid-run, every chain frame was mirrored with no failed
send, and the producer raised no task error.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

from repro_torch.launch.consume import restore_report  # noqa: E402
from repro_torch.launch.serve import (default_serve_plan,  # noqa: E402
                                      serve_loop)
from repro_torch.serving.snapshot import SnapshotStore  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of the smoke config")
    args = ap.parse_args()
    chain_dir = os.path.join(tempfile.mkdtemp(prefix="stream_smoke_"),
                             "producer_chain")
    steer = json.dumps({"task": "kv_snapshot", "every": 2})
    consumer = subprocess.Popen(
        [sys.executable, "-u", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "torch_insitu_consumer.py"),
         "--port", "0", "--idle-timeout", "5", "--start-grace", "600",
         "--steer", steer, "--restore", "kv_pages"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": SRC})
    lines: list[str] = []
    address: dict = {}
    listening = threading.Event()

    def pump():
        for line in consumer.stdout:             # type: ignore[union-attr]
            lines.append(line)
            if "listening on tcp://" in line and not listening.is_set():
                address["url"] = line.split()[-1]
                listening.set()
        listening.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        if not listening.wait(120) or "url" not in address:
            print("".join(lines))
            print("FAIL: consumer never started listening")
            return 1
        print(f"consumer listening on {address['url']} (pid {consumer.pid})")
        plan = default_serve_plan(insitu_mode="sync", snapshot_every=4,
                                  base_every=4, snapshot_dir=chain_dir,
                                  snapshot_to=address["url"])
        out = serve_loop("smollm-135m", n_requests=16, max_new=16,
                         insitu_mode="sync", plan=plan, device=args.device,
                         smoke=not args.full)
        consumer.wait(timeout=120)
    finally:
        if consumer.poll() is None:
            consumer.kill()
            consumer.wait()
    reader.join(30)
    stdout = "".join(lines)
    print("--- consumer output ---")
    print(stdout.strip())
    print("-----------------------")
    if consumer.returncode != 0:
        print(f"FAIL: consumer exited {consumer.returncode}")
        return 1

    failures = []
    rep = out["session_report"]
    local = restore_report({"store": SnapshotStore(chain_dir)}, "kv_pages")
    if f"digest {local['digest']}" not in stdout:
        failures.append(f"consumer restore digest != producer chain digest "
                        f"{local['digest'][:16]}...")
    else:
        print(f"restore parity OK: step {local['step']}, digest "
              f"{local['digest'][:16]}... on both sides")
    steering = rep.get("steering", {})
    applied = [s for s in steering.get("commands", [])
               if s.get("applied", {}).get("every") == 2]
    if not applied or steering.get("steering_rejected", 0):
        failures.append(f"steering not applied by the producer: {steering}")
    else:
        print(f"steering OK: {applied[0]}")
    snap = rep["tasks"].get("kv_snapshot", {})
    if rep.get("errors"):
        failures.append(f"producer task errors: {rep['errors']}")
    if snap.get("mirror_frames", 0) < 1 or snap.get("mirror_failures", 0):
        failures.append(f"mirror: {snap.get('mirror_frames')} frames, "
                        f"{snap.get('mirror_failures')} failures")
    else:
        print(f"streamed {snap['mirror_frames']} chain frames, 0 failures")
    for f in failures:
        print(f"FAIL: {f}")
    if failures:
        return 1
    print("stream smoke passed: two processes, live chain replication, "
          "bit-identical restore, mid-run steering")
    return 0


if __name__ == "__main__":
    sys.exit(main())
