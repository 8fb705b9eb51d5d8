"""InSituEngine — deprecation shim over ``repro_torch.core.session``.

Fig. 1 of the paper, mapped to a PyTorch device loop (see session.py for
the declarative API and runtime.py for the scheduling semantics — SYNC/
ASYNC/HYBRID are policies of one shared worker-pool scheduler). The loop
dispatches its CUDA step (eager kernels or a graph replay) and offers the
step's payloads; the card keeps running while the host decides what to
do with them:

  SYNC   (Fig. 1a): the loop *blocks*: device->host copy, then the task
         runs inline on the loop thread — the GPU stall the paper's NSight
         timelines show.
  ASYNC  (Fig. 1b): the loop blocks only for the hand-off *dispatch* (a
         device clone and D2H copies into pinned memory on a side stream,
         the ADIOS2-send analog); p_i pool workers wait on the copies and
         consume the bounded staging ring concurrently with subsequent
         device steps.
  HYBRID (Fig. 1c): a deeply-coupled device stage (e.g. the spectral
         kernels of ``repro_torch.kernels.ops``) shrinks the payload on
         the card; the hand-off moves the small residue; host stages run
         async.

This module keeps the original task-list API (``InSituTask`` with a single
``fn``); each engine is a thin wrapper around a
:class:`~repro_torch.core.session.Session` built from the equivalent
:class:`~repro_torch.core.session.InSituPlan` — every task source becomes
a stream, every ``every=`` int becomes an ``Every`` trigger. New code
should declare an ``InSituPlan`` and drive a ``Session`` directly
(``repro_torch.insitu``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.runtime import (Placement, PipelineTask, TaskResult,
                                      split_payload)
from repro_torch.core.session import Every, InSituPlan, Session, TaskSpec
from repro_torch.core.telemetry import Telemetry

# The paper's three placements; kept under the historical name.
InSituMode = Placement


@dataclass
class InSituTask:
    """One in-situ task bound to a payload source (legacy single-fn form).

    ``source``   key into the providers dict the loop passes to on_step();
                 the provider is only called on steps where the task fires.
    ``fn``       host-side work: fn(step, payload) -> result. For HYBRID
                 tasks the payload is the *device-reduced* representation.
    ``every``    fire period in steps (paper: image every 50 / every 10).
    ``shards``   split each firing's payload into N independent sub-items —
                 the paper's internally-parallel in-situ tasks.
    """
    name: str
    source: str
    fn: Callable[[int, Any], Any]
    mode: InSituMode = InSituMode.ASYNC
    every: int = 1
    shards: int = 1

    def fires(self, step: int) -> bool:
        return step % self.every == 0

    def split(self, payload: Any) -> list:
        return split_payload(payload, self.shards)

    def to_spec(self) -> TaskSpec:
        """Lower to the declarative form: source -> stream, fn -> sink."""
        return TaskSpec(name=self.name, stream=self.source,
                        trigger=Every(self.every), placement=self.mode,
                        sink=self.fn, shards=self.shards)

    def to_pipeline(self) -> PipelineTask:
        """Legacy lowering straight to the runtime (kept for callers that
        wire a PipelineRuntime themselves)."""
        return PipelineTask(self.name, self.source, sink=self.fn,
                            placement=self.mode, every=self.every,
                            shards=self.shards)


class InSituEngine:
    """Thin shim: a Session built from the task list; on_step()/finish()."""

    def __init__(self, tasks: list[InSituTask], *, p_i: int = 2,
                 staging_capacity: int = 4,
                 telemetry: Optional[Telemetry] = None) -> None:
        self.tasks = list(tasks)
        self.p_i = p_i
        streams = list(dict.fromkeys(t.source for t in self.tasks))
        self.session = Session(
            InSituPlan(streams=streams,
                       tasks=[t.to_spec() for t in self.tasks],
                       workers=p_i, staging_capacity=staging_capacity),
            telemetry=telemetry)
        self.session._strict_streams = False   # legacy providers-dict contract
        self.runtime = self.session.runtime

    # the engine's public state is the session's state
    @property
    def telemetry(self) -> Telemetry:
        return self.session.telemetry

    @property
    def staging(self):
        return self.runtime.staging

    @property
    def results(self) -> list[TaskResult]:
        return self.runtime.results

    @property
    def errors(self) -> list[tuple[str, int, BaseException]]:
        return self.runtime.errors

    def on_step(self, step: int,
                providers: dict[str, Callable[[], Any]]) -> None:
        """Called once per training step, after the step is dispatched.

        Providers for sources no task declared are ignored (the legacy
        contract: the loop offers everything, tasks pick)."""
        for source, provider in providers.items():
            self.session.emit(source, step, provider)

    def finish(self, timeout: float = 600.0) -> None:
        """Drain the ring and join workers (the paper's non-overlapped
        tail); task failures stay in :attr:`errors`. Idempotent."""
        self.session.finish(timeout=timeout, raise_on_error=False)

    def report(self) -> dict[str, Any]:
        return self.session.report()


def run_workflow(n_steps: int,
                 app_step: Callable[[int], dict[str, Callable[[], Any]]],
                 engine: InSituEngine,
                 block_each_step: bool = True) -> Telemetry:
    """Run ``n_steps`` of the application with the in-situ engine attached.

    ``app_step(step)`` dispatches one device step and returns the providers
    dict; it runs inside a ``step/compute`` span. Deprecation shim: drives
    the engine's Session exactly like ``Session.run``, keeping the legacy
    providers-dict contract. ``block_each_step`` is accepted for the JAX
    package's signature and, as there, changes nothing.
    """
    tm = engine.telemetry
    for step in range(n_steps):
        with tm.span("step/compute", step=step):
            providers = app_step(step)
        engine.on_step(step, providers)
    engine.finish()
    return tm
