"""Consumer side of a streamed in-situ run.

The producer's terminal stages publish frames through ``repro_torch.core.transport``
sinks (``to="tcp://host:port"`` in the plan options, a checkpoint ``mirror``,
or a ``SnapshotStore`` mirror). This module is the other end of the wire: a
:class:`~repro_torch.core.transport.StreamSource` listener that decodes every frame
with the shared registry and routes it by payload codec:

- ``raw``  — snapshot chain frames: ingested into a local replica
  :class:`~repro_torch.serving.snapshot.SnapshotStore`, so the consumer tails the
  producer's base+delta chain live and can ``restore()`` bit-identically at
  any point without stopping the producer.
- ``file`` — checkpoint shards mirrored by ``CheckpointManager``:
  materialized under ``out_dir`` with the same atomic tmp -> fsync -> rename
  publish as the producer side.
- ``tree`` / ``json`` — analysis artifacts (grad health reports, spectra):
  decoded and kept (latest per stream) for inspection.

The consumer also owns the steering back-channel: ``steer`` messages are
pushed up the same connections (``{"task": name, "every": N}`` or
``{"task": name, "lossy_eps": x}``) and applied by the producer's
``Session.poll_steering`` mid-run.

Host-only: no tensor touches a device here. CLI wrapper:
``tools/torch_insitu_consumer.py``.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Optional, Sequence

from repro_torch.core import host, transport
from repro_torch.serving.snapshot import SnapshotStore


def consume_loop(source: Optional[transport.StreamSource] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 out_dir: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 store: Optional[SnapshotStore] = None,
                 steer: Optional[Sequence[dict]] = None,
                 steer_after: int = 1,
                 idle_timeout_s: float = 5.0,
                 start_grace_s: Optional[float] = None,
                 max_frames: Optional[int] = None,
                 on_frame: Optional[Callable[[transport.Frame], None]] = None,
                 stop: Optional[Callable[[dict], bool]] = None,
                 log=print) -> dict:
    """Listen for frames and route them until the stream drains.

    Pass an already-listening ``source`` (e.g. from a test socketpair) or
    let the loop bind its own listener on ``host:port`` (``port=0`` picks a
    free one; the chosen address is logged and returned). ``steer`` messages
    are sent up the back-channel once ``steer_after`` data frames have
    arrived — by then at least one producer connection is live.

    ``store`` overrides the loop's own replica :class:`SnapshotStore`
    (``snapshot_dir`` is then ignored) — the replica-hydration path shares
    one store between this loop and the engine being hydrated. ``stop``
    is checked after each routed frame with the running report; returning
    True ends the loop early (e.g. "the chain is restorable now").

    Returns a report dict: frame/byte counts per stream and codec, the
    replica ``store`` (for ``restore()`` assertions), materialized file
    paths, decoded latest artifacts, and how many producers each steering
    message reached.
    """
    own_source = source is None
    if own_source:
        source = transport.StreamSource(host=host, port=port)
    if store is None:
        store = SnapshotStore(snapshot_dir) if snapshot_dir is not None \
            else SnapshotStore()
    steer = list(steer or [])
    report: dict[str, Any] = {
        "address": source.address,
        "frames": 0, "bytes": 0,
        "by_codec": {}, "by_stream": {},
        "snapshot_frames": 0, "files": [], "artifacts": {},
        "steering_sent": [], "errors": [],
        "store": store,
    }
    log(f"consumer listening on {source.address}")
    try:
        for frame in source.frames(idle_timeout_s=idle_timeout_s,
                                   start_grace_s=start_grace_s,
                                   max_frames=max_frames):
            report["frames"] += 1
            report["bytes"] += len(frame.payload)
            report["by_codec"][frame.codec] = \
                report["by_codec"].get(frame.codec, 0) + 1
            report["by_stream"][frame.stream] = \
                report["by_stream"].get(frame.stream, 0) + 1
            try:
                _route(frame, store, out_dir, report)
            except transport.TransportError as e:
                report["errors"].append(str(e))
                log(f"consumer: dropped frame ({e})")
            if on_frame is not None:
                on_frame(frame)
            if steer and report["frames"] >= steer_after:
                for msg in steer:
                    reached = source.send_control(msg)
                    report["steering_sent"].append(
                        {"message": msg, "reached": reached})
                    log(f"consumer: steered {msg} -> "
                        f"{reached} producer(s)")
                steer = []
            if stop is not None and stop(report):
                log("consumer: stop condition met, detaching")
                break
    finally:
        if own_source:
            source.close()
    log(f"consumer: {report['frames']} frames "
        f"({report['bytes'] / 1e6:.2f} MB) across "
        f"{sorted(report['by_stream'])}")
    return report


def _route(frame: transport.Frame, store: SnapshotStore,
           out_dir: Optional[str], report: dict) -> None:
    """One frame into the right terminal: replica chain, disk, or memory."""
    if frame.codec == transport.CODEC_RAW:
        # snapshot chain frame mirrored by SnapshotStore._forward_frame —
        # the payload is a complete versioned chain frame, self-describing
        placed = store.ingest(frame.stream, frame.payload)
        report["snapshot_frames"] += 1
        report.setdefault("last_snapshot", {})[frame.stream] = placed
    elif frame.codec == transport.CODEC_FILE:
        root = out_dir if out_dir is not None else "consumed"
        report["files"].append(transport.materialize_file(frame, root))
    else:
        obj = transport.decode_frame_payload(frame)
        report["artifacts"][frame.stream] = {"step": frame.step,
                                             "value": obj}


def restore_report(report: dict, stream: str = "kv_pages") -> dict:
    """Summarize the replica's newest restorable snapshot for ``stream``:
    step, leaf count, and a content digest (stable across producer and
    replica when the chains match bit-for-bit, and equal to the JAX
    package's: a bf16 leaf hashes under its logical dtype name)."""
    import hashlib

    store: SnapshotStore = report["store"]
    step, leaves = store.restore(stream)
    h = hashlib.sha256()
    for key in sorted(leaves):
        arr = leaves[key]
        dtype = getattr(arr, "dtype", None)
        name = (host.logical_name(dtype) or str(dtype) if dtype is not None
                else str(type(arr)))
        h.update(key.encode())
        h.update(name.encode())
        h.update(arr.tobytes() if hasattr(arr, "tobytes")
                 else repr(arr).encode())
    return {"stream": stream, "step": step, "n_leaves": len(leaves),
            "digest": h.hexdigest()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(
        description="attach to a producer's transport sinks, tail frames, "
                    "and optionally steer it back")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = pick a free one)")
    ap.add_argument("--out-dir", default=None,
                    help="root for materialized checkpoint shards")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist the replica snapshot chain here "
                         "(default: in-memory)")
    ap.add_argument("--idle-timeout", type=float, default=5.0,
                    help="exit after this many idle seconds with no "
                         "live connections")
    ap.add_argument("--start-grace", type=float, default=None,
                    help="wait this long for the first producer to "
                         "connect (default: --idle-timeout)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--steer", action="append", default=[],
                    metavar="JSON",
                    help="steering message to push back, e.g. "
                         "'{\"task\": \"kv_snapshot\", \"every\": 2}' "
                         "(repeatable)")
    ap.add_argument("--steer-after", type=int, default=1,
                    help="send steering once this many frames arrived")
    ap.add_argument("--restore", default=None, metavar="STREAM",
                    help="after draining, restore this stream from the "
                         "replica chain and print step + digest")
    args = ap.parse_args(argv)

    steer = [json.loads(s) for s in args.steer]
    report = consume_loop(host=args.host, port=args.port,
                          out_dir=args.out_dir,
                          snapshot_dir=args.snapshot_dir,
                          steer=steer, steer_after=args.steer_after,
                          idle_timeout_s=args.idle_timeout,
                          start_grace_s=args.start_grace,
                          max_frames=args.max_frames)
    if args.restore is not None:
        rr = restore_report(report, args.restore)
        print(f"restored {rr['stream']!r} at step {rr['step']}: "
              f"{rr['n_leaves']} leaves, digest {rr['digest']}")
        report["restore"] = rr
    return report


if __name__ == "__main__":
    main()
