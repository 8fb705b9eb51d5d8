"""End-to-end example (PyTorch/CUDA port): train a ~100M-param model with
the full in-situ stack.

smollm-135m at REDUCED width (pass --full-135m for the published widths
on the card), a few hundred steps, with the whole in-situ workflow —
analytics and compressed checkpointing — declared as one plain-dict
``InSituPlan`` (exactly what a TOML/JSON launcher config would contain):

  * async grad-health analytics every 10 steps on the ``grads`` stream
  * async compressed checkpointing every 50 steps (lossy moments) on the
    ``train_state`` stream
  * restart support: rerun the same command after an interruption and it
    resumes from the latest atomic checkpoint.

JAX-free; runs on the card by default::

    python3 examples/torch_train_insitu.py --steps 300 [--device cpu]

``--inject-sink-faults`` is the transient-IO drill: the analytics sink
fails with ``TransientError`` on a schedule (recovers under retry early,
exhausts retries later), and the run must complete anyway with the
degradation named in the session report.

``--stream-drill`` is the network version of the same drill: analytics
stream over a real TCP transport (``"to": "tcp://..."`` in the plan) to an
in-process consumer, with the connection severed mid-run — the sink must
reconnect transparently, the consumer must keep receiving frames, and the
train loop must never crash. The same ``inject_sink_fault`` hook drives
both drills; transport sinks are just sinks.
"""
import argparse
import os
import sys
import tempfile
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.runtime import TransientError  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402


def make_analytics_fault():
    """Deterministic transient-failure schedule for the analytics sink.

    Firings at steps < 10 fail twice then succeed (retry-with-backoff
    recovers); firings at steps >= 10 always fail (retries exhaust, the
    task degrades and later firings are dropped, not raised).
    """
    attempts: dict = {}

    def fault(step: int) -> None:
        attempts[step] = attempts.get(step, 0) + 1
        if step < 10:
            if attempts[step] <= 2:
                raise TransientError(f"injected transient IO @ step {step}")
            return
        raise TransientError(f"injected persistent IO outage @ step {step}")

    return fault


def run_stream_drill(args) -> None:
    """Network-fault drill: analytics over TCP with a mid-run connection cut.

    An in-process consumer (``repro_torch.launch.consume``) listens on
    localhost; the analytics preset forwards every report through a
    ``StreamSink``. A fault hook severs the TCP connection on the drill
    step — NOT by raising, but by ``drop_connection()`` on the live
    transport sink, the same thing a consumer crash or network blip does —
    and the next write must reconnect transparently. The run passes when
    the loop completes, the sink reports a reconnect, and the consumer
    received frames on both sides of the cut.
    """
    from repro_torch.core import transport
    from repro_torch.launch.consume import consume_loop

    source = transport.StreamSource(port=0)
    done: dict = {}

    def consume() -> None:
        # long start grace: the producer only connects after its first
        # steps (and, on the card, the graph capture)
        done["report"] = consume_loop(source, idle_timeout_s=3.0,
                                      start_grace_s=300.0,
                                      log=lambda *_: None)

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()

    plan = {
        "streams": ["grads"],
        "workers": 2,
        "tasks": {
            "analytics": {"stream": "grads", "preset": "grad_health",
                          "every": 5, "placement": "sync",
                          "retries": 3, "retry_backoff_s": 0.01,
                          "options": {"to": source.address}},
        },
    }

    drill_step = 5 * (args.steps // 10 or 1)  # an analytics firing mid-run
    grabbed: dict = {}

    def grab_transport(session) -> None:
        grabbed["sink"] = session.transport_of("analytics")

    def cut_connection(step: int) -> None:
        if step == drill_step:
            grabbed["sink"].drop_connection()

    out = train_loop(args.arch, steps=args.steps, smoke=not args.full_135m,
                     plan=plan, on_session=grab_transport,
                     sink_faults={"analytics": cut_connection},
                     device=args.device)
    consumer.join(timeout=10.0)
    source.close()

    rep = out["session_report"]
    tr = rep["tasks"]["analytics"]["transport"]
    got = done.get("report", {})
    print(f"\nstream drill: {tr['frames']} frames "
          f"({tr['bytes'] / 1e3:.1f}KB) over {tr['sink']}, "
          f"{tr['reconnects']} connects; consumer saw "
          f"{got.get('frames', 0)} frames")
    if rep["errors"]:
        raise SystemExit(f"no task may raise: {rep['errors']}")
    if tr["reconnects"] < 2:
        raise SystemExit(f"expected a reconnect after the cut, got "
                         f"{tr['reconnects']}")
    if got.get("frames", 0) < tr["frames"] - 1:
        raise SystemExit("consumer missed frames that were reported sent")
    print("stream drill passed: connection cut healed, no frames lost, "
          "loop never stalled")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--insitu", default="async",
                    choices=["sync", "async", "hybrid"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_insitu"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full-135m", action="store_true",
                    help="use the full config (needs accelerator memory)")
    ap.add_argument("--inject-sink-faults", action="store_true",
                    help="transient-IO drill on the analytics sink")
    ap.add_argument("--stream-drill", action="store_true",
                    help="network drill: analytics over TCP with a mid-run "
                         "connection cut (must reconnect, never crash)")
    args = ap.parse_args()

    if args.stream_drill:
        run_stream_drill(args)
        return

    # the drill pins analytics SYNC so the fail/degrade/drop schedule is
    # deterministic (async workers may lag the loop by a few steps)
    analytics_placement = "sync" if args.inject_sink_faults else args.insitu
    # the whole in-situ workflow, declared as data (TOML/JSON-loadable)
    plan = {
        "streams": ["grads", "train_state"],
        "workers": 2,
        "tasks": {
            "analytics": {"stream": "grads", "preset": "grad_health",
                          "every": 10, "placement": analytics_placement,
                          "retries": 3, "retry_backoff_s": 0.01},
            "checkpoint": {"stream": "train_state", "preset": "checkpoint",
                           "every": 50, "placement": args.insitu,
                           "options": {"directory": args.ckpt_dir,
                                       "device": args.device}},
        },
    }
    sink_faults = ({"analytics": make_analytics_fault()}
                   if args.inject_sink_faults else None)
    out = train_loop(args.arch, steps=args.steps, smoke=not args.full_135m,
                     plan=plan, sink_faults=sink_faults, device=args.device)

    losses = out["losses"]
    print(f"\nfirst loss {losses[0]:.4f} -> last loss {losses[-1]:.4f} "
          f"({len(losses)} steps)")
    print(f"in-situ artifacts produced: {out['insitu_results']}")
    rep = out["session_report"]
    print(f"device compute {rep['step_compute_s']:.2f}s | "
          f"sync stalls {rep['sync_stall_s']:.2f}s | "
          f"async overlapped {rep['async_overlapped_s']:.2f}s | "
          f"hand-off {rep['handoff_s']:.2f}s")
    if "checkpoint" in rep:
        ck = rep["checkpoint"]
        print(f"checkpoints: {ck['saves']} saves, "
              f"{ck['raw_bytes'] / 1e6:.1f}MB raw -> "
              f"{ck['stored_bytes'] / 1e6:.1f}MB stored, "
              f"kept steps {ck['kept_steps']}")
    print(f"stragglers: {out['straggler_report']['stragglers']}")
    if args.inject_sink_faults:
        retries = rep.get("retries", {}).get("analytics", 0)
        deg = rep.get("degraded", {}).get("analytics")
        print(f"sink-fault drill: {retries} retries, degraded={deg}")
        if retries <= 0:
            raise SystemExit("expected retried transient sink failures")
        if deg is None or deg["dropped"] < 1:
            raise SystemExit("expected the analytics task to degrade and "
                             "drop firings")
        if rep["errors"]:
            raise SystemExit(f"no task may raise: {rep['errors']}")
        print("sink-fault drill passed: run completed, degradation reported")


if __name__ == "__main__":
    main()
