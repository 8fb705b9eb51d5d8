"""Fault tolerance: failure detection, elastic re-mesh planning, stragglers.

The paper's checkpointing motivation ("limited walltimes and/or failures of
system components") is the *why*; this module is the *how*, host-only
(it touches no device and no process group):

  * HeartbeatTracker — per-host liveness from periodic beats; a host missing
    ``grace`` seconds is declared failed (in a real deployment the beat is a
    tiny all-reduce or a KV write; here it is a call, injected by tests).
    Takes a ``clock=`` callable (the Session's injected monotonic clock) so
    failure detection is deterministic under test-driven time.
  * StragglerMonitor — per-host step-time EWMA; hosts slower than
    ``factor`` x median are flagged. Mitigation policy (documented, and what
    the ``fault`` preset applies): flagged hosts get their *in-situ* p_i
    budget reduced first (in-situ work is the elastic slack on a node), and
    if still slow they are scheduled for replacement at the next checkpoint
    boundary.
  * FaultController — the live subsystem the ``fault`` Session preset
    instantiates: every firing beats the heartbeat and feeds the EWMA, and
    mitigation decisions are *applied* (shed in-situ load by widening every
    bound task's cadence; queue replace-at-checkpoint candidates).
  * plan_elastic_remesh — given the surviving device count, pick the largest
    (data, model) grid that (a) fits the survivors, (b) keeps 'model' a
    divisor of the old model axis (so TP shards merge/split cleanly), and
    return the shard remap plan. Restore is checkpoint-based: state is
    logically complete on disk, so resuming on the new mesh is read +
    re-place (``Session.restore(elastic=True)`` places each leaf on a
    ``DeviceMesh`` of the survivors with ``distribute_tensor``).

Recovery invariant: checkpoint steps are atomic (manifest-last), so the
resumed step is always a step that fully finished.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch


class HeartbeatTracker:
    """Per-host liveness from periodic beats.

    ``clock`` is any monotonic zero-arg callable (default
    ``time.monotonic``); ``last_seen`` is seeded from it at construction so
    a test-injected clock starting near 0 does not declare every host dead
    before its first beat. ``beat``/``failed_hosts``/``alive_hosts`` read
    the same clock when ``now`` is not given.
    """

    def __init__(self, hosts: list[int], grace_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.grace_s = grace_s
        self._clock = clock if clock is not None else time.monotonic
        now = self._clock()
        self.last_seen: dict[int, float] = {h: now for h in hosts}

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_seen[host] = self._clock() if now is None else now

    def failed_hosts(self, now: Optional[float] = None) -> list[int]:
        now = self._clock() if now is None else now
        return sorted(h for h, t in self.last_seen.items()
                      if now - t > self.grace_s)

    def alive_hosts(self, now: Optional[float] = None) -> list[int]:
        failed = set(self.failed_hosts(now))
        return sorted(h for h in self.last_seen if h not in failed)


class StragglerMonitor:
    """Step-time EWMA per host; flags hosts slower than factor x median."""

    def __init__(self, alpha: float = 0.2, factor: float = 1.5) -> None:
        self.alpha = alpha
        self.factor = factor
        self.ewma: dict[int, float] = {}

    def observe(self, host: int, step_s: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = (step_s if prev is None
                           else (1 - self.alpha) * prev + self.alpha * step_s)

    def median(self) -> float:
        if not self.ewma:
            return 0.0
        vals = sorted(self.ewma.values())
        return vals[len(vals) // 2]

    def stragglers(self) -> list[int]:
        med = self.median()
        if med <= 0:
            return []
        return sorted(h for h, v in self.ewma.items()
                      if v > self.factor * med)

    def mitigation(self, host: int) -> str:
        """Policy: shed in-situ load first, then replace at ckpt boundary."""
        med = self.median()
        v = self.ewma.get(host, 0.0)
        if med <= 0 or v <= self.factor * med:
            return "none"
        if v <= 2 * self.factor * med:
            return "reduce_insitu_pi"      # free host cores for the app
        return "replace_at_checkpoint"

    def report(self) -> dict:
        return {"median_s": self.median(), "stragglers": self.stragglers(),
                "ewma": dict(self.ewma)}


class FaultController:
    """Liveness + straggler policy for one run, with mitigations applied live.

    The ``fault`` Session preset builds one of these per task. Each sink
    firing calls :meth:`ingest` with the hosts' beats/step-times; the
    controller drives a :class:`HeartbeatTracker` and a
    :class:`StragglerMonitor` on the session's injected monotonic clock and
    *applies* :meth:`StragglerMonitor.mitigation` transitions:

      reduce_insitu_pi       shed in-situ load first — the session widens
                             every bound task's effective firing cadence
                             (:meth:`~repro_torch.core.session.Session.shed_insitu`)
      replace_at_checkpoint  the host joins ``replace_candidates``; the
                             operator (or the elastic-restore path) swaps it
                             out at the next checkpoint boundary

    A mitigation is applied once per *escalation* (none -> reduce ->
    replace), not per firing, so a persistently slow host does not widen
    cadences without bound on its own — sustained pressure is the
    time-budget ``Adaptive`` trigger's job.
    """

    def __init__(self, hosts: Sequence[int], *, grace_s: float = 30.0,
                 alpha: float = 0.2, factor: float = 1.5,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.hosts = list(hosts)
        self.grace_s = float(grace_s)
        self._clock = clock if clock is not None else time.monotonic
        self.heartbeats = HeartbeatTracker(self.hosts, self.grace_s,
                                           clock=self._clock)
        self.monitor = StragglerMonitor(alpha=alpha, factor=factor)
        self._session: Any = None
        self._own_task: Optional[str] = None
        self.mitigations: dict[int, str] = {}
        self.replace_candidates: set[int] = set()
        self.shed_events = 0
        self.widened: dict[str, int] = {}

    # -- session wiring -------------------------------------------------------

    def attach(self, session: Any, own_task: Optional[str] = None) -> None:
        """Adopt the session's clock and shedding surface (preset 'attach').

        Re-seeds the heartbeat tracker from the session clock so injected
        test clocks and ``time.monotonic`` behave identically.
        """
        self._session = session
        self._own_task = own_task
        self._clock = session.clock
        self.heartbeats = HeartbeatTracker(self.hosts, self.grace_s,
                                           clock=self._clock)

    def _shed(self) -> None:
        self.shed_events += 1
        if self._session is not None:
            exclude = (self._own_task,) if self._own_task else ()
            self.widened.update(self._session.shed_insitu(exclude=exclude))

    # -- ingest (the preset sink) --------------------------------------------

    @staticmethod
    def _beats_of(payload: Any) -> dict[int, Optional[float]]:
        """Normalize a health payload into {host: step_s-or-None}.

        Accepted forms: ``{"host": 0, "step_s": 0.12}`` (single host, time
        optional), ``{"hosts": {0: 0.12, 1: 0.3}}``, or a bare
        ``{host: step_s}`` mapping with integer keys.
        """
        if isinstance(payload, Mapping):
            if "host" in payload:
                step_s = payload.get("step_s")
                return {int(payload["host"]):
                        None if step_s is None else float(step_s)}
            if "hosts" in payload:
                return {int(h): None if v is None else float(v)
                        for h, v in dict(payload["hosts"]).items()}
            if payload and all(isinstance(k, int) for k in payload):
                return {int(h): None if v is None else float(v)
                        for h, v in payload.items()}
        raise ValueError(
            "fault payload must be {'host': h, 'step_s': s}, "
            "{'hosts': {h: s}}, or a {host: step_s} mapping; got "
            f"{type(payload).__name__}: {payload!r}")

    def ingest(self, step: int, payload: Any) -> dict:
        """One health firing: beat + observe, then evaluate/apply policy."""
        beats = self._beats_of(payload)
        now = self._clock()
        for host, step_s in beats.items():
            self.heartbeats.beat(host, now=now)
            if step_s is not None:
                self.monitor.observe(host, step_s)
        for host in sorted(self.monitor.ewma):
            decision = self.monitor.mitigation(host)
            prev = self.mitigations.get(host, "none")
            if decision == "none":
                self.mitigations.pop(host, None)
                continue
            self.mitigations[host] = decision
            if decision != prev:               # apply once per escalation
                self._shed()
                if decision == "replace_at_checkpoint":
                    self.replace_candidates.add(host)
        return {"step": step,
                "failed_hosts": self.heartbeats.failed_hosts(now=now),
                "stragglers": self.monitor.stragglers(),
                "mitigations": dict(self.mitigations)}

    # -- reporting ------------------------------------------------------------

    def failed_hosts(self) -> list[int]:
        return self.heartbeats.failed_hosts(now=self._clock())

    def report(self) -> dict:
        now = self._clock()
        return {"failed_hosts": self.heartbeats.failed_hosts(now=now),
                "alive_hosts": self.heartbeats.alive_hosts(now=now),
                "stragglers": self.monitor.stragglers(),
                "straggler_ewma": dict(self.monitor.ewma),
                "median_step_s": self.monitor.median(),
                "mitigations": dict(self.mitigations),
                "replace_at_checkpoint": sorted(self.replace_candidates),
                "shed_events": self.shed_events,
                "widened": dict(self.widened)}


@dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    dropped_hosts: list[int]
    # how each old TP shard index maps into the new model axis
    model_merge_factor: int

    @property
    def new_device_count(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n

    def shard_sources(self, new_index: int) -> range:
        """Old model-shard indices that merge into new shard ``new_index``."""
        f = self.model_merge_factor
        return range(new_index * f, (new_index + 1) * f)


def plan_elastic_remesh(old_shape: tuple, axis_names: tuple,
                        surviving_devices: int,
                        failed_hosts: Optional[list[int]] = None) -> RemeshPlan:
    """Largest (.., data', model') grid that fits the survivors.

    'model' may only *shrink by integer division* (TP shards merge cleanly:
    new shard j = concat of old shards j*f..j*f+f-1), for any divisor ``f``
    of the old model axis; 'data' absorbs the rest. The 'pod' axis, when
    present, only shrinks by whole pods. Ties are deterministic: at equal
    device count prefer keeping more pods, then the smallest merge factor
    (merging TP shards is the expensive move — it reshapes every
    tensor-parallel leaf — so it is chosen last).
    """
    sizes = dict(zip(axis_names, old_shape))
    old_model = sizes.get("model", 1)
    old_pod = sizes.get("pod", 1)
    factors = [f for f in range(1, old_model + 1) if old_model % f == 0]
    best = None           # maximize (device count, pods kept, -merge factor)
    for pod in range(old_pod, 0, -1):
        for f in factors:
            model = old_model // f
            data = surviving_devices // (pod * model)
            if data < 1:
                continue
            n = pod * data * model
            key = (n, pod, -f)
            if best is None or key > best[0]:
                best = (key, pod, data, model, f)
    if best is None:
        raise ValueError("no valid re-mesh for the surviving devices")
    _, pod, data, model, f = best
    if "pod" in sizes:
        new_shape = (pod, data, model)
    else:
        new_shape = (data, model)
    return RemeshPlan(tuple(old_shape), new_shape, tuple(axis_names),
                      failed_hosts or [], f)


def merge_model_shards(shards: Sequence[Any], merge_factor: int,
                       axis: int = 0) -> list[Any]:
    """Merge old TP shards into the shrunken model axis of a RemeshPlan.

    New shard ``j`` is the concatenation of old shards
    ``j*f .. j*f+f-1`` along ``axis`` (the dim the old mesh tensor-
    parallelized): ``torch.cat`` when the shards are tensors, else
    ``np.concatenate``. v2 checkpoints store every leaf logically complete,
    so the restore path never calls this — re-placement under the shrunken
    mesh's placements *is* the merge; this is the explicit-buffer path for
    assembling host-side state from per-device buffers (e.g. a streaming
    replica that held only its own slices).
    """
    f = int(merge_factor)
    if f < 1:
        raise ValueError(f"merge_factor must be >= 1, got {merge_factor}")
    if len(shards) % f:
        raise ValueError(
            f"cannot merge {len(shards)} shards by factor {f}: the old "
            "model axis must be an integer multiple of the merge factor")

    def cat(group: Sequence[Any]) -> Any:
        if all(isinstance(s, torch.Tensor) for s in group):
            return torch.cat(list(group), dim=axis)
        return np.concatenate([np.asarray(s) for s in group], axis=axis)

    return [cat(shards[j * f:(j + 1) * f]) for j in range(len(shards) // f)]


@dataclass(frozen=True)
class ElasticRestore:
    """What ``Session.restore(elastic=True)`` resolved: the remesh plan,
    the surviving devices' ``DeviceMesh``, and the checkpoint step
    resumed."""
    plan: RemeshPlan
    mesh: Any
    step: int
