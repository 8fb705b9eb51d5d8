"""Runtime event log: per-step / per-task wall-clock spans.

The paper's methodology is *measurement*: every figure is an execution-time
comparison between in-situ modes (plus NSight/HPC-monitor evidence that the
accelerator does or does not stall). This module is the framework's analog of
that instrumentation layer — a lightweight, thread-safe span recorder that the
training loop, the staging buffer, and the in-situ workers all write into; the
benchmarks then aggregate the spans exactly the way the paper's figures do
(total time, app time, in-situ time, hand-off time).

Spans are (name, t0, t1, thread, step, meta). Recording is contention-free:
each thread appends to its own buffer (registered once, lock-free afterwards)
and readers merge the buffers — a worker's ``span()`` in the hot loop never
serializes on a global lock against the training thread.

Aggregation is by name prefix:
  step/compute          device step (dispatch->blocked-on-result)
  handoff/dispatch      D2H copy dispatch the loop blocks on (the "send")
  handoff/materialize   transfer drain on the consumer side (overlapped)
  step/handoff          loop-blocking materialization (SYNC / non-pipelined)
  insitu-sync/<task>    inline (blocking) task execution
  insitu-async/<task>   worker-side task execution (overlapped)
  staging/wait          producer blocked on a full ring (backpressure)
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    thread: str
    step: int = -1
    meta: dict = field(default_factory=dict)

    @property
    def dt(self) -> float:
        return self.t1 - self.t0


class Telemetry:
    """Thread-safe span log. One instance per run (engine/loop share it).

    Writers are lock-free: the first record from a thread registers a
    per-thread buffer (one lock acquisition); every later append is a plain
    ``list.append`` — atomic under the GIL, invisible to other threads'
    hot paths. Readers snapshot and merge all buffers.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()       # buffer registry + counters only
        self._buffers: list[list[Span]] = []
        self._tls = threading.local()
        self._counters: dict[str, float] = defaultdict(float)

    # -- recording -----------------------------------------------------------

    def _buf(self) -> list:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = []
            self._tls.buf = buf
            with self._lock:
                self._buffers.append(buf)
        return buf

    @contextlib.contextmanager
    def span(self, name: str, step: int = -1, **meta: Any) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._buf().append(
                Span(name, t0, t1, threading.current_thread().name, step,
                     dict(meta)))

    def record(self, name: str, t0: float, t1: float, step: int = -1,
               **meta: Any) -> None:
        self._buf().append(
            Span(name, t0, t1, threading.current_thread().name, step,
                 dict(meta)))

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    # -- aggregation ---------------------------------------------------------

    def _merged(self) -> list[Span]:
        """All spans, unordered (aggregations that need t0 order sort the
        — usually much smaller — filtered subset themselves)."""
        with self._lock:
            buffers = list(self._buffers)
        out: list[Span] = []
        for buf in buffers:
            out.extend(buf)
        return out

    def spans(self, prefix: str = "") -> list[Span]:
        return sorted((s for s in self._merged()
                       if s.name.startswith(prefix)),
                      key=lambda s: s.t0)

    def total(self, prefix: str) -> float:
        return sum(s.dt for s in self._merged()
                   if s.name.startswith(prefix))

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def wall(self, prefix: str = "") -> float:
        """Wall-clock extent (union is approximated by max-end minus min-start)."""
        ss = self.spans(prefix)
        if not ss:
            return 0.0
        return max(s.t1 for s in ss) - min(s.t0 for s in ss)

    def busy(self, prefix: str = "") -> float:
        """Union of span intervals (true busy time across threads)."""
        ss = self.spans(prefix)          # merged spans arrive t0-sorted
        if not ss:
            return 0.0
        total = 0.0
        cur0, cur1 = ss[0].t0, ss[0].t1
        for s in ss[1:]:
            if s.t0 > cur1:
                total += cur1 - cur0
                cur0, cur1 = s.t0, s.t1
            else:
                cur1 = max(cur1, s.t1)
        return total + (cur1 - cur0)

    def summary(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        by_name: dict[str, list[Span]] = defaultdict(list)
        for s in self._merged():
            by_name[s.name].append(s)
        for name, ss in sorted(by_name.items()):
            dts = [s.dt for s in ss]
            out[name] = {
                "n": float(len(dts)),
                "total_s": sum(dts),
                "mean_s": sum(dts) / len(dts),
                "max_s": max(dts),
            }
        return out

    def step_overlap_report(self) -> dict[str, float]:
        """The paper's NSight question: did the device stall for in-situ work?

        ``handoff_s`` is the *critical-path* hand-off: copy dispatch plus any
        loop-blocking materialization (SYNC / non-pipelined / sharded). The
        overlapped drain is reported separately as ``handoff_materialize_s``.
        For an ideal pipelined async run the stall term is ~0 and only the
        dispatch remains on the critical path.
        """
        prefixes = {
            "step_compute_s": "step/compute",
            "handoff_dispatch_s": "handoff/dispatch",
            "handoff_materialize_s": "handoff/materialize",
            "_blocking": "step/handoff",
            "sync_stall_s": "insitu-sync/",
            "async_overlapped_s": "insitu-async/",
            "staging_backpressure_s": "staging/wait",
        }
        totals = dict.fromkeys(prefixes, 0.0)
        for s in self._merged():          # one merge for all seven prefixes
            for key, prefix in prefixes.items():
                if s.name.startswith(prefix):
                    totals[key] += s.dt
        totals["handoff_s"] = totals["handoff_dispatch_s"] \
            + totals.pop("_blocking")
        return totals

    def reset(self) -> None:
        with self._lock:
            for buf in self._buffers:
                buf.clear()
            self._counters.clear()


# A module-level default so simple call-sites don't need plumbing; the engine
# and benchmarks construct their own instances for isolation.
default = Telemetry()
