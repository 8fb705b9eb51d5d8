"""StagingBuffer — the ADIOS2 "insituMPI" analog — and the pending-transfer
token of the two-phase hand-off.

In the paper's asynchronous mode (Fig. 1b), the application transfers data to
the in-situ ranks via an ADIOS2 writer/reader pair and *only blocks for the
send*; both sides then proceed concurrently. Our accelerator-host analog:

  producer (training loop):  put(step, payload)       # blocks only on hand-off
  consumers (p_i workers):   get() -> StagedItem      # FIFO, blocking

The ring is bounded (``capacity``) — a slow in-situ side eventually exerts
backpressure on the producer, which is precisely the paper's F3 regime (task
issued every 10 steps outgrows all spare cores and dominates). The time the
producer spends blocked on a full ring is recorded as ``staging/wait`` so the
benchmarks can attribute it, like the paper attributes ADIOS2 stalls.

Since the two-phase hand-off, the payload a producer stages is usually a
``PendingHandoff`` token: the loop thread only *dispatches* the device->host
copies (a device ``clone`` plus a ``non_blocking`` copy into pinned host
memory on a side stream) and enqueues the token; the consumer side waits on
the copy's event and materializes to numpy. The ring's bounded capacity then
double-buffers the transfers — step N+1's compute overlaps step N's D2H
drain.

Wake-ups are condition-variable driven: a consumer blocked in ``get`` is
notified the instant an item is put or the buffer closes — there is no
poll/timeout loop burning wake-ups on an idle ring.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from queue import Empty, Full
from typing import Any, Callable, Optional

from repro_torch.core.telemetry import Telemetry


@dataclass
class StagedItem:
    step: int
    name: str
    payload: Any                      # pytree / PendingHandoff / bytes / meta
    group: Any = None                 # _SyncGroup latch for sharded SYNC work
    shard: int = 0                    # shard index within the group
    enqueued_at: float = field(default_factory=time.perf_counter)


class Closed(Exception):
    """Raised by get() after close() once the ring has drained."""


class PendingHandoff:
    """A dispatched-but-not-yet-materialized device->host transfer.

    Phase 1 (producer/loop thread): the runtime starts the D2H copy for every
    tensor leaf and wraps the in-flight copies in this token — that dispatch
    is the only hand-off cost on the critical path. Phase 2 (consumer/worker
    thread): ``materialize()`` runs the task's hand-off function (default:
    wait on each copy's event and numpy-materialize every leaf), paying the
    transfer wait off the loop. Idempotent and thread-safe: the first caller
    materializes, later callers get the cached result.

    The application updates its tensors in place (the serving engine's KV
    pool is written by the very next decode step), so the runtime's dispatch
    phase snapshots tensor leaves with a device-side ``clone`` first
    (``PipelineTask.snapshot``): the token owns the bytes it will copy.
    """

    __slots__ = ("payload", "_materialize_fn", "_lock", "_done", "_result")

    def __init__(self, payload: Any,
                 materialize_fn: Callable[[Any], Any]) -> None:
        self.payload = payload
        self._materialize_fn = materialize_fn
        self._lock = threading.Lock()
        self._done = False
        self._result: Any = None

    def materialize(self) -> Any:
        with self._lock:
            if not self._done:
                self._result = self._materialize_fn(self.payload)
                self._done = True
                self.payload = None          # drop the device refs promptly
        return self._result

    @property
    def materialized(self) -> bool:
        return self._done


class StagingBuffer:
    def __init__(self, capacity: int = 4,
                 telemetry: Optional[Telemetry] = None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._items: deque[StagedItem] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._telemetry = telemetry
        self.puts = 0
        self.gets = 0

    # -- producer side --------------------------------------------------------

    def put(self, item: StagedItem, timeout: Optional[float] = None) -> None:
        t0 = time.perf_counter()
        waited = False
        with self._not_full:
            if self._closed:
                raise Closed("staging buffer is closed")
            while len(self._items) >= self.capacity:
                waited = True
                if not self._not_full.wait(timeout):
                    raise Full
                if self._closed:
                    raise Closed("staging buffer is closed")
            self._items.append(item)
            self.puts += 1
            self._not_empty.notify()
        if self._telemetry is not None and waited:
            t1 = time.perf_counter()
            if t1 - t0 > 1e-5:
                self._telemetry.record("staging/wait", t0, t1, step=item.step)

    def try_put(self, item: StagedItem) -> bool:
        """Non-blocking variant (drop-on-full policies, e.g. telemetry tasks)."""
        with self._not_full:
            if self._closed:
                raise Closed("staging buffer is closed")
            if len(self._items) >= self.capacity:
                return False
            self._items.append(item)
            self.puts += 1
            self._not_empty.notify()
            return True

    # -- consumer side ---------------------------------------------------------

    def get(self, timeout: Optional[float] = None) -> StagedItem:
        """Blocking pop; raises Closed when the buffer is closed *and* empty.

        Consumers are woken immediately by put()/close() — no polling. A
        ``timeout`` bounds the wait (raises ``queue.Empty`` on expiry with
        the buffer still open).
        """
        with self._not_empty:
            while not self._items:
                if self._closed:
                    raise Closed
                if not self._not_empty.wait(timeout):
                    if self._closed:
                        raise Closed
                    raise Empty
            item = self._items.popleft()
            self.gets += 1
            self._not_full.notify()
            return item

    # -- lifecycle --------------------------------------------------------------

    def close(self) -> None:
        """Close and wake every blocked producer/consumer immediately."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
