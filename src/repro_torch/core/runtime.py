"""The pluggable in-situ pipeline runtime.

Every in-situ consumer in the tree — training analytics, serving snapshots,
checkpointing — is one declarative task

    DeviceStage? -> Handoff -> [HostStage ...] -> Sink

scheduled by a single shared worker-pool scheduler that owns the staging
ring. The paper's three placements (Fig. 1) are *scheduling policies* of
that one scheduler, not separate code paths:

  SYNC   : the whole chain runs while the loop blocks (Fig. 1a). A
           non-sharded firing executes inline on the loop thread; an
           internally-parallel firing (``shards > 1``) fans its shards out
           on the shared pool and the loop waits on a latch — no transient
           executors are ever constructed.
  ASYNC  : the loop blocks only for DeviceStage + hand-off *dispatch*; the
           transfer drains, and host stages plus the sink run, on the pool,
           fed through the bounded staging ring (Fig. 1b, the ADIOS2-send
           analog).
  HYBRID : ASYNC scheduling for a task that declares a DeviceStage — a
           deeply-coupled device kernel shrinks the payload before the
           hand-off, so the D2H transfer ships the small residue (Fig. 1c,
           the NEKO pattern).

The hand-off is two-phase ("blocks only for the send", Fig. 1b):

  dispatch     (loop thread, ``handoff/dispatch``): snapshot tensor
               leaves with a device ``clone`` on the current stream (the
               application updates its tensors in place — see
               ``PipelineTask.snapshot``), start each leaf's D2H copy into
               pinned host memory on a side stream that waits for the
               clone, and enqueue a ``PendingHandoff`` token. This is the
               only hand-off cost the loop pays for a pipelined
               ASYNC/HYBRID task.
  materialize  (consumer thread, ``handoff/materialize``): the task's
               ``handoff`` function waits on each copy's event and turns
               the token's payload into host numpy — overlapped with the
               next device steps; the bounded staging ring double-buffers
               in-flight transfers.

SYNC tasks (and tasks with ``pipelined=False``, the pre-pipelined blocking
behaviour) run both phases inline under the legacy ``step/handoff`` span, so
the loop-blocking hand-off cost keeps its historical name. Sharded firings
also materialize on the loop (a token cannot be split); that stall is
likewise recorded as ``step/handoff``.

Backpressure on a full ring is a per-task policy:

  block : wait for a slot; the stall is recorded as ``staging/wait`` —
          the paper's F3 regime, and the default.
  drop  : shed the firing and count it (``runtime.drops``; telemetry
          counter ``staging/drop/<task>``) — for best-effort telemetry
          tasks that must never stall the loop.
  adapt : deliver, but under sustained pressure double the task's
          *effective* firing period (capped) — the F3 mitigation: fire
          less often when the in-situ side outgrows its resources.

A task with ``budget_s`` set additionally widens on *wall clock*: when the
loop-blocking in-situ cost of a firing (hand-off dispatch + any
loop-blocking materialization + sync chain time — exactly what the
telemetry spans charge to the critical path) exceeds the budget for
``adapt_after`` consecutive firings, the effective period doubles (capped
at ``adapt_max_every``). This is the straggler policy's lever: a contended
host sheds in-situ load before the application slows down.

Sink IO is failure-aware: a sink (or an injected fault hook — see
``inject_sink_fault``) raising :class:`TransientError` is retried with
capped exponential backoff (``retries`` / ``retry_backoff_s``); exhausted
retries put the task into a *degraded* state — the firing is dropped,
later firings are shed and counted (``runtime.degraded``), and the failure
is reported rather than raised, so a flaky sink can never crash the
training loop. Any other exception is permanent and still lands in
``runtime.errors`` (surfaced by ``Session.finish(raise_on_error=True)``).

Telemetry: every firing records per-placement spans under the same names
the pre-runtime engine used (``step/compute``, ``insitu-sync/<task>``,
``insitu-async/<task>``, ``insitu-device/<task>``, ``staging/wait``) plus
the hand-off split (``handoff/dispatch``, ``handoff/materialize``,
``step/handoff`` for loop-blocking transfers), so
``Telemetry.step_overlap_report`` and every benchmark figure read
identically; host stages additionally get ``stage/<task>/<stage>`` spans
for per-stage attribution, and a ``FanoutStage``'s stolen work items get
``stage/<task>/<stage>/item`` spans on whichever worker ran them.
"""
from __future__ import annotations

import enum
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import host, pytree, transport
from repro_torch.core.staging import (Closed, PendingHandoff, StagedItem,
                                      StagingBuffer)
from repro_torch.core.telemetry import Telemetry

PyTree = Any

BACKPRESSURE_POLICIES = ("block", "drop", "adapt")

_BACKOFF_CAP_S = 2.0          # ceiling for the exponential sink-retry backoff

# sentinel a degraded sink firing resolves to (never a caller-visible result)
_DEGRADED = object()


class TransientError(RuntimeError):
    """A sink failure expected to clear on retry (flaky IO, a briefly
    unreachable store, an injected fault). The runtime retries these with
    capped exponential backoff; anything else is permanent and goes to
    ``runtime.errors`` untouched."""


class Placement(enum.Enum):
    SYNC = "sync"
    ASYNC = "async"
    HYBRID = "hybrid"


@dataclass(frozen=True)
class Stage:
    """One named host stage: ``fn(step, payload) -> payload``."""
    name: str
    fn: Callable[[int, Any], Any]


@dataclass(frozen=True)
class FanoutStage:
    """A host stage whose work items fan out across the shared worker pool.

    ``split(step, payload)`` breaks the firing into independent work items
    (e.g. one per checkpoint leaf); ``fn(step, item)`` processes one item;
    ``gather(step, payload, results)`` merges the per-item results (ordered
    as split produced them) behind a barrier before the next stage / sink.

    Scheduling is help-first work stealing: the thread running the chain
    enqueues best-effort *steal tokens* on the staging ring and then drains
    the item queue itself; idle pool workers that pop a token pull items
    from the same queue concurrently. This is deadlock-free by construction
    — no thread ever blocks on ring capacity for fan-out work, and the
    barrier only waits on items another thread is actively executing — so it
    is safe at any pool size (a lone worker simply runs the items serially).
    """
    name: str
    split: Callable[[int, Any], Sequence]
    fn: Callable[[int, Any], Any]
    gather: Callable[[int, Any, list], Any]


class _CompletionLatch:
    """N-slot completion latch shared by sharded SYNC and fan-out firings."""

    def __init__(self, n: int) -> None:
        self.results: list = [None] * n
        self.errors: list[BaseException] = []
        self._remaining = n
        self._done = threading.Event()
        self._lock = threading.Lock()

    def complete(self, idx: int, result: Any,
                 error: Optional[BaseException] = None) -> None:
        with self._lock:
            if error is not None:
                self.errors.append(error)
            else:
                self.results[idx] = result
            self._remaining -= 1
            if self._remaining == 0:
                self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class _FanoutGroup(_CompletionLatch):
    """Shared work queue + completion latch for one fanned-out stage firing."""

    def __init__(self, step: int, task_name: str, stage: FanoutStage,
                 items: Sequence) -> None:
        super().__init__(len(items))
        self.step = step
        self.task_name = task_name
        self.stage = stage
        self._queue: deque = deque(enumerate(items))

    def take(self) -> Optional[tuple[int, Any]]:
        with self._lock:
            return self._queue.popleft() if self._queue else None


def _to_host(x: Any) -> Any:
    if isinstance(x, host.HostCopy):
        return x.result()
    if isinstance(x, torch.Tensor):
        return host.to_numpy(x.cpu())
    return x


def _start_d2h(payload: Any, snapshot: bool = False) -> Any:
    """Dispatch phase: start the device->host copy of every tensor leaf.

    For a CUDA leaf the copy goes into pinned host memory with
    ``non_blocking=True`` on a side stream that first waits for the work
    enqueued so far on the current stream; the returned token records an
    event the materialize phase waits on. The loop thread never waits for
    the transfer. Leaves that are not tensors (numpy, scalars, bytes) are
    already host-resident.

    ``snapshot`` detaches tensor leaves from the caller's storage with a
    ``clone()`` on the current stream first. Required whenever
    materialization is deferred past the next step and the application
    updates its tensors in place — the serving engine writes its KV pool
    at every decode step, and a copy that read the live pool would race
    that write. ``record_stream`` on the clone keeps the caching allocator
    from handing its memory out again before the side stream's copy is
    done. For a CPU leaf the clone is the whole transfer.

    Without ``snapshot`` the copy reads the caller's live tensor, so the
    current stream waits for the copy before its next work: a replayed
    CUDA graph rewrites its static tensors in place, and no later step may
    race a copy still reading them (the host never waits).
    """
    def start(x: Any) -> Any:
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type != "cuda":
            return x.clone() if snapshot else x
        src = x.clone() if snapshot else x
        loop = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(loop)
        with torch.cuda.stream(side):
            copy = host.HostCopy(src)
        src.record_stream(side)
        if not snapshot:
            loop.wait_stream(side)
        return copy

    return pytree.tree_map(start, payload)


def default_handoff(payload: Any) -> Any:
    """Materialize phase: every tensor leaf (or in-flight copy) becomes
    host numpy; bf16 arrives as the tagged uint16 host dtype."""
    return pytree.tree_map(_to_host, payload)


def split_payload(payload: Any, shards: int) -> list:
    """Shard a firing's payload on the leading axis.

    A bare ndarray splits directly; a pytree (dict/tuple/list) splits every
    array leaf on its leading axis, producing ``shards`` trees of the same
    structure. Payloads whose leaves cannot be sharded (scalars, 0-d arrays)
    raise — silently running one shard would miscount the parallelism the
    caller asked for.
    """
    if shards <= 1:
        return [payload]
    if isinstance(payload, np.ndarray):
        if payload.ndim < 1:
            raise ValueError("cannot shard a 0-d array payload")
        if payload.shape[0] < shards:
            raise ValueError(
                f"cannot shard leading axis of {payload.shape[0]} into "
                f"{shards} non-empty pieces")
        return np.array_split(payload, shards)
    leaves = pytree.leaves(payload)
    if not leaves:
        raise ValueError(
            f"cannot shard an empty payload of type {type(payload).__name__}")
    split_leaves = []
    for leaf in leaves:
        arr = _to_host(leaf) if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        if arr.ndim < 1:
            raise ValueError(
                f"cannot shard payload: leaf of type {type(leaf).__name__} "
                "has no leading axis")
        if arr.shape[0] < shards:
            raise ValueError(
                f"cannot shard leaf with leading axis {arr.shape[0]} into "
                f"{shards} non-empty pieces")
        split_leaves.append(np.array_split(arr, shards))
    keys = [pytree.keystr(p) for p, _ in pytree.flatten_with_path(payload)]
    return [pytree.unflatten_like(
                payload, {k: sl[i] for k, sl in zip(keys, split_leaves)})
            for i in range(shards)]


@dataclass
class PipelineTask:
    """Declarative pipeline: ``DeviceStage? -> Handoff -> [HostStage...] -> Sink``.

    ``source``        key into the providers dict passed to ``submit()``; the
                      provider is only called on steps where the task fires.
    ``sink``          terminal consumer: a :class:`repro_torch.core.transport.Sink`
                      (``write(step, payload) -> result``) or a legacy
                      ``sink(step, payload)`` callable — ``register``
                      normalizes callables through the ``CallableSink``
                      shim. The result lands in ``runtime.results``.
    ``host_stages``   ordered ``Stage`` chain run before the sink (same
                      thread as the sink, per the placement).
    ``device_stage``  optional ``fn(step, payload) -> payload`` run *before*
                      the hand-off (the hybrid device kernel).
    ``handoff``       the hand-off's *materialize* phase; override when the
                      transfer needs task-specific framing. For a pipelined
                      ASYNC/HYBRID task it runs on the consumer thread.
    ``pipelined``     two-phase hand-off (default): the loop only dispatches
                      the D2H copies; materialization overlaps on the pool.
                      ``False`` restores the blocking hand-off (the loop
                      materializes inline — the pre-pipelined behaviour,
                      kept for benchmark baselines and host-driven sources).
    ``snapshot``      device-side ``clone`` of tensor leaves at dispatch
                      (default): makes the deferred token immune to the
                      app's in-place updates at its next step. Without it
                      the app's stream waits (on the device) for each copy
                      of a live CUDA tensor before its next work.
    ``shards``        split each firing into N independent sub-items
                      (models the paper's internally-parallel in-situ tasks).
    ``backpressure``  ring-full policy: 'block' | 'drop' | 'adapt'.
    ``budget_s``      wall-clock widening: when a firing's loop-blocking
                      in-situ cost exceeds this budget ``adapt_after``
                      times in a row, the effective period doubles
                      (capped at ``adapt_max_every``).
    ``retries``       attempts re-run after a :class:`TransientError` from
                      the sink before the task degrades (drops firings
                      instead of raising).
    ``retry_backoff_s``  first retry delay; doubles per attempt, capped.
    """
    name: str
    source: str
    sink: Callable[[int, Any], Any]
    host_stages: Sequence[Stage] = ()
    device_stage: Optional[Callable[[int, Any], Any]] = None
    handoff: Callable[[Any], Any] = default_handoff
    pipelined: bool = True
    snapshot: bool = True
    placement: Placement = Placement.ASYNC
    every: int = 1
    shards: int = 1
    backpressure: str = "block"
    adapt_after: int = 2        # consecutive full-ring firings before adapting
    adapt_max_every: int = 64   # cap for the adapted firing period
    budget_s: Optional[float] = None
    retries: int = 3
    retry_backoff_s: float = 0.05

    def __post_init__(self) -> None:
        if self.backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"backpressure must be one of {BACKPRESSURE_POLICIES}, "
                f"got {self.backpressure!r}")
        if self.every < 1:
            raise ValueError("every must be >= 1")
        if self.budget_s is not None and self.budget_s <= 0:
            raise ValueError(f"budget_s must be > 0, got {self.budget_s}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")


@dataclass
class TaskResult:
    task: str
    step: int
    result: Any
    worker: str
    duration_s: float


class _SyncGroup(_CompletionLatch):
    """Completion latch for a sharded SYNC firing executed on the pool."""


class PipelineRuntime:
    """The single scheduler: staging ring + shared ``workers`` pool.

    Tasks are registered (``register``) and fired (``submit``); the runtime
    owns placement, backpressure, telemetry spans, and the drain protocol.
    """

    def __init__(self, tasks: Sequence[PipelineTask] = (), *,
                 workers: int = 2, staging_capacity: int = 4,
                 telemetry: Optional[Telemetry] = None) -> None:
        self.workers = workers
        self.telemetry = telemetry or Telemetry()
        self.staging = StagingBuffer(staging_capacity, self.telemetry)
        self.results: list[TaskResult] = []
        self.errors: list[tuple[str, int, BaseException]] = []
        self.drops: dict[str, int] = {}
        self.degraded: dict[str, dict] = {}       # task -> degradation info
        self.retry_counts: dict[str, int] = {}
        self._sink_faults: dict[str, Callable[[int], Any]] = {}
        self._sleep = time.sleep                  # injectable for tests
        self._tasks: dict[str, PipelineTask] = {}
        self._every: dict[str, int] = {}
        self._pressure: dict[str, int] = {}
        self._budget_over: dict[str, int] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queued = 0       # async items enqueued on the ring
        self._finished = 0     # async items completed (result or error)
        self._threads: list[threading.Thread] = []
        for t in tasks:
            self.register(t)

    # -- registration ---------------------------------------------------------

    def register(self, task: PipelineTask) -> PipelineTask:
        """Add a pipeline to the schedule; new workloads start here."""
        if task.name in self._tasks:
            raise ValueError(f"task {task.name!r} already registered")
        # one terminal protocol for every task: callables wear the
        # CallableSink shim, transport sinks pass through untouched
        task.sink = transport.as_sink(task.sink)
        self._tasks[task.name] = task
        self._every[task.name] = int(task.every)
        self._pressure[task.name] = 0
        self._budget_over[task.name] = 0
        self.drops[task.name] = 0
        self.retry_counts[task.name] = 0
        if (task.placement is not Placement.SYNC or task.shards > 1
                or any(isinstance(s, FanoutStage) for s in task.host_stages)):
            self._ensure_pool()
        return task

    @property
    def tasks(self) -> list[PipelineTask]:
        return list(self._tasks.values())

    def effective_every(self, name: str) -> int:
        """Current firing period (grows under the 'adapt' policy)."""
        return self._every[name]

    def widen_every(self, name: str, max_every: Optional[int] = None) -> bool:
        """Double a task's effective firing period (capped); False at cap.

        The shared lever behind the 'adapt' backpressure policy, the
        ``budget_s`` wall-clock trigger, and the straggler mitigation's
        shed-in-situ-load step (``Session.shed_insitu``).
        """
        task = self._tasks[name]
        cap = task.adapt_max_every if max_every is None else int(max_every)
        new = min(self._every[name] * 2, cap)
        if new == self._every[name]:
            return False
        self._every[name] = new
        return True

    def set_every(self, name: str, every: int) -> None:
        """Set a task's effective firing period directly — the steering
        channel's lever (a consumer retunes cadence mid-run); also resets
        the adapt/budget pressure counters so the new cadence gets a fair
        start."""
        if name not in self._tasks:
            raise ValueError(f"unknown task {name!r}")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self._every[name] = int(every)
        self._pressure[name] = 0
        self._budget_over[name] = 0

    def inject_sink_fault(self, name: str,
                          fault: Optional[Callable[[int], Any]] = None) -> None:
        """Install (or clear, with ``fault=None``) a fault hook in front of a
        task's sink. ``fault(step)`` runs before every sink attempt —
        including retries — and raises to simulate the failure
        (:class:`TransientError` exercises the retry/degrade path, anything
        else the permanent-error path)."""
        if name not in self._tasks:
            raise ValueError(f"unknown task {name!r}")
        if fault is None:
            self._sink_faults.pop(name, None)
        else:
            self._sink_faults[name] = fault

    def _ensure_pool(self) -> None:
        while len(self._threads) < self.workers:
            th = threading.Thread(target=self._worker_loop,
                                  name=f"insitu-{len(self._threads)}",
                                  daemon=True)
            th.start()
            self._threads.append(th)

    # -- worker side ----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            try:
                item = self.staging.get()
            except Closed:
                return
            if isinstance(item.group, _FanoutGroup):
                # steal token: pull items off the group's queue until dry
                # (a token popped after the group finished is a no-op)
                self._drain_fanout(item.group)
                continue
            task = self._tasks[item.name]
            if item.group is not None:
                self._run_sync_shard(task, item)
            else:
                self._run_async_item(task, item)

    def _resolve_payload(self, task: PipelineTask, item: StagedItem) -> Any:
        """Consumer-side phase 2: drain a pending transfer, if any."""
        payload = item.payload
        if isinstance(payload, PendingHandoff):
            with self.telemetry.span("handoff/materialize", step=item.step,
                                     task=task.name):
                payload = payload.materialize()
        return payload

    def _run_chain(self, task: PipelineTask, step: int, payload: Any) -> Any:
        for stage in task.host_stages:
            with self.telemetry.span(f"stage/{task.name}/{stage.name}",
                                     step=step):
                if isinstance(stage, FanoutStage):
                    payload = self._run_fanout_stage(task, stage, step,
                                                     payload)
                else:
                    payload = stage.fn(step, payload)
        return self._call_sink(task, step, payload)

    def _call_sink(self, task: PipelineTask, step: int, payload: Any) -> Any:
        """Sink IO with transient-failure retry and graceful degradation.

        :class:`TransientError` (from the sink or an injected fault hook)
        retries with capped exponential backoff; exhausting ``task.retries``
        degrades the task — the sentinel result is swallowed by every
        caller, the failure is recorded in ``self.degraded`` with step
        context, and later firings are shed in ``_fire``. Other exceptions
        propagate (permanent failures keep their existing error path).
        """
        attempt = 0
        while True:
            try:
                fault = self._sink_faults.get(task.name)
                if fault is not None:
                    fault(step)
                return task.sink.write(step, payload)
            except TransientError as e:
                attempt += 1
                if attempt > task.retries:
                    with self._lock:
                        # an already-degraded task keeps its first record
                        # (a racing in-flight firing must not reset the
                        # dropped counter)
                        self.degraded.setdefault(task.name, {
                            "step": step, "dropped": 0,
                            "retries": task.retries,
                            "error": f"{type(e).__name__}: {e}"})
                    self.telemetry.count(f"sink/degraded/{task.name}")
                    return _DEGRADED
                with self._lock:
                    self.retry_counts[task.name] += 1
                self.telemetry.count(f"sink/retry/{task.name}")
                self._sleep(min(task.retry_backoff_s * (2 ** (attempt - 1)),
                                _BACKOFF_CAP_S))

    def _drain_fanout(self, group: _FanoutGroup) -> None:
        """Run fan-out items until the group's queue is empty."""
        while (job := group.take()) is not None:
            idx, item = job
            try:
                with self.telemetry.span(
                        f"stage/{group.task_name}/{group.stage.name}/item",
                        step=group.step):
                    res = group.stage.fn(group.step, item)
            except BaseException as e:  # noqa: BLE001 - latch must fire
                group.complete(idx, None, e)
            else:
                group.complete(idx, res)

    def _run_fanout_stage(self, task: PipelineTask, stage: FanoutStage,
                          step: int, payload: Any) -> Any:
        items = list(stage.split(step, payload))
        if not items:
            return stage.gather(step, payload, [])
        group = _FanoutGroup(step, task.name, stage, items)
        if self._threads and len(items) > 1:
            # advertise steal tokens (best-effort: a full/closed ring just
            # means the coordinator keeps more of the work). Tokens bypass
            # the queued/finished accounting — they are hints, not items —
            # and are capped below the ring's free capacity: a hint must
            # never occupy the last free slot, or a busy pool would let
            # lingering tokens distort other tasks' backpressure (shed
            # 'drop' firings, stall 'block' producers, inflate 'adapt'
            # pressure) on a shared runtime.
            free = self.staging.capacity - len(self.staging)
            n_tokens = min(len(items) - 1, self.workers, free - 1)
            try:
                for _ in range(n_tokens):
                    if not self.staging.try_put(
                            StagedItem(step, task.name, None, group=group)):
                        break
            except Closed:
                pass
        self._drain_fanout(group)    # help-first: this thread works too
        group.wait()                 # gather barrier for stolen items
        if group.errors:
            raise group.errors[0]
        return stage.gather(step, payload, group.results)

    def _run_async_item(self, task: PipelineTask, item: StagedItem) -> None:
        t0 = time.perf_counter()
        try:
            payload = self._resolve_payload(task, item)
            with self.telemetry.span(f"insitu-async/{task.name}",
                                     step=item.step):
                res = self._run_chain(task, item.step, payload)
            with self._cv:
                if res is not _DEGRADED:
                    self.results.append(TaskResult(
                        task.name, item.step, res,
                        threading.current_thread().name,
                        time.perf_counter() - t0))
                self._finished += 1
                self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 - keep workers alive
            with self._cv:
                self.errors.append((task.name, item.step, e))
                self._finished += 1
                self._cv.notify_all()

    def _run_sync_shard(self, task: PipelineTask, item: StagedItem) -> None:
        try:
            payload = self._resolve_payload(task, item)
            res = self._run_chain(task, item.step, payload)
        except BaseException as e:  # noqa: BLE001 - latch must always fire
            item.group.complete(item.shard, None, e)
        else:
            item.group.complete(item.shard,
                                None if res is _DEGRADED else res)

    # -- loop side ------------------------------------------------------------

    def submit(self, step: int,
               providers: dict[str, Callable[[], Any]]) -> None:
        """Fire every registered task due at ``step`` with a provider."""
        for task in self._tasks.values():
            if step % self._every[task.name]:
                continue
            if task.source not in providers:
                continue
            self._fire(step, task, providers[task.source])

    def _fire(self, step: int, task: PipelineTask,
              provider: Callable[[], Any]) -> None:
        if task.name in self.degraded:
            # graceful degradation: an exhausted sink sheds firings instead
            # of crashing the loop; the dropped count is reported
            with self._lock:
                self.degraded[task.name]["dropped"] += 1
            self.telemetry.count(f"sink/degraded_drop/{task.name}")
            return
        pipelined = (task.pipelined and task.placement is not Placement.SYNC
                     and task.shards == 1)
        if (pipelined and task.backpressure == "drop"
                and len(self.staging) >= self.staging.capacity):
            # pre-flight shed: a drop task must never cost the loop, so
            # don't pay the provider, device stage, snapshot copy, or D2H
            # dispatch for a firing the full ring would discard anyway
            # (best-effort check — a race just falls through to try_put's
            # authoritative one).
            with self._lock:
                self.drops[task.name] += 1
            self.telemetry.count(f"staging/drop/{task.name}")
            return
        payload = provider()
        if task.device_stage is not None:
            with self.telemetry.span(f"insitu-device/{task.name}", step=step):
                payload = task.device_stage(step, payload)
        if pipelined:
            # two-phase: the loop pays only the copy dispatch; the consumer
            # materializes (handoff/materialize) off the critical path.
            t0 = time.perf_counter()
            with self.telemetry.span("handoff/dispatch", step=step,
                                     task=task.name):
                pending = PendingHandoff(
                    _start_d2h(payload, snapshot=task.snapshot), task.handoff)
            self._note_budget(task, time.perf_counter() - t0)
            self._enqueue(step, task, [pending])
            return
        # blocking hand-off: SYNC placement, non-pipelined tasks, and sharded
        # firings (a pending token cannot be split) materialize on the loop.
        t0 = time.perf_counter()
        with self.telemetry.span("step/handoff", step=step, task=task.name):
            payload = task.handoff(_start_d2h(payload))
        pieces = split_payload(payload, task.shards)
        if task.placement is Placement.SYNC:
            self._run_sync(step, task, pieces)
        else:
            self._enqueue(step, task, pieces)
        self._note_budget(task, time.perf_counter() - t0)

    def _note_budget(self, task: PipelineTask, cost_s: float) -> None:
        """Wall-clock Adaptive: widen the firing cadence when the
        loop-blocking cost of a firing (copy dispatch, blocking hand-off,
        sync in-situ work) stays over ``task.budget_s`` for ``adapt_after``
        consecutive firings."""
        if task.budget_s is None:
            return
        name = task.name
        if cost_s <= task.budget_s:
            self._budget_over[name] = 0
            return
        self._budget_over[name] += 1
        if self._budget_over[name] >= task.adapt_after:
            self._budget_over[name] = 0
            if self.widen_every(name):
                self.telemetry.count(f"budget/adapt/{name}")

    def _run_sync(self, step: int, task: PipelineTask, pieces: list) -> None:
        t0 = time.perf_counter()
        with self.telemetry.span(f"insitu-sync/{task.name}", step=step):
            if len(pieces) > 1:
                # internally-parallel sync firing: shards ride the shared
                # pool; the loop blocks on the latch (the "GPUs wait for
                # the CPU ranks" case) — no per-firing executor.
                group = _SyncGroup(len(pieces))
                for i, pc in enumerate(pieces):
                    self.staging.put(StagedItem(step, task.name, pc,
                                                group=group, shard=i))
                group.wait()
                if group.errors:
                    raise group.errors[0]
                res = group.results
            else:
                res = self._run_chain(task, step, pieces[0])
        if res is _DEGRADED:
            return
        with self._lock:
            self.results.append(TaskResult(
                task.name, step, res, threading.current_thread().name,
                time.perf_counter() - t0))

    def _enqueue(self, step: int, task: PipelineTask, pieces: list) -> None:
        for pc in pieces:
            item = StagedItem(step, task.name, pc)
            if task.backpressure == "block":
                self.staging.put(item)
                self._note_queued()
            elif task.backpressure == "drop":
                if self.staging.try_put(item):
                    self._note_queued()
                else:
                    with self._lock:
                        self.drops[task.name] += 1
                    self.telemetry.count(f"staging/drop/{task.name}")
            else:  # adapt
                if self.staging.try_put(item):
                    self._note_queued()
                    self._pressure[task.name] = 0
                else:
                    self._pressure[task.name] += 1
                    if self._pressure[task.name] >= task.adapt_after:
                        self._pressure[task.name] = 0
                        if self.widen_every(task.name):
                            self.telemetry.count(
                                f"backpressure/adapt/{task.name}")
                    self.staging.put(item)   # still deliver this firing
                    self._note_queued()

    def _note_queued(self) -> None:
        with self._cv:
            self._queued += 1

    # -- lifecycle ------------------------------------------------------------

    def wait_idle(self, timeout: float = 600.0) -> bool:
        """Block until every enqueued async item has finished."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._finished < self._queued:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def drain(self, timeout: float = 600.0) -> None:
        """Drain the ring, join workers, close sinks (the non-overlapped
        tail; transport-backed sinks flush and release their backend —
        a StreamSink sends its BYE frame here)."""
        with self.telemetry.span("insitu/drain"):
            self.staging.close()
            for th in self._threads:
                th.join(timeout=timeout)
        for task in self._tasks.values():
            try:
                task.sink.flush()
                task.sink.close()
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass

    # -- reporting ------------------------------------------------------------

    def report(self) -> dict[str, Any]:
        rep: dict[str, Any] = dict(self.telemetry.step_overlap_report())
        rep["n_results"] = len(self.results)
        rep["n_errors"] = len(self.errors)
        rep["staging_puts"] = self.staging.puts
        rep["drops"] = dict(self.drops)
        rep["effective_every"] = {n: self._every[n] for n in self._tasks}
        rep["retries"] = dict(self.retry_counts)
        rep["degraded"] = {n: dict(d) for n, d in self.degraded.items()}
        return rep
