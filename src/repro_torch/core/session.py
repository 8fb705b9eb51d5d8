"""The declarative in-situ API: ``InSituPlan`` + ``Session``.

In-situ tasks are *declared against* a running application, not
hand-wired into it. Every workflow is one *plan*:

  streams   named payload sources the application emits
            (``kv_pages``, ...)
  triggers  when a task fires: ``Every(n)`` steps, ``When(predicate)``,
            ``Interval(seconds)`` of wall clock, or ``Adaptive(n)``
            (backpressure- and, with ``budget_s=``, wall-clock-widened
            every-N)
  tasks     what runs: an explicit ``device_stage -> handoff ->
            host_stages -> sink`` chain, or a registered *preset*
            (``checkpoint``, ``grad_health``, ``spectra``,
            ``serve_snapshot``)

A plan is validated at construction (errors name the offending
stream/task) and is loadable from a plain dict, in the JAX package's
format::

    plan = InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {
            "kv_snapshot": {"stream": "kv_pages", "preset": "serve_snapshot",
                            "every": 4, "backpressure": "drop"},
        },
    })
    with Session(plan) as session:
        for step in range(n_steps):
            engine.step()
            session.emit("kv_pages", step, engine.snapshot_payload)
    print(session.report())

``Session`` owns ONE shared :class:`~repro_torch.core.runtime.PipelineRuntime`
(the paper's single p_o/p_i split), exposes :meth:`Session.emit` as the
*only* producer call, folds a
:class:`~repro_torch.checkpoint.CheckpointManager` in as the built-in
``checkpoint`` preset (save, restore, retention), and merges telemetry,
task results, errors and checkpoint statistics into one
:meth:`Session.report`.

A task's transport (``options={"to": url}``), a checkpoint mirror and a
snapshot store's mirror all land in one table; a ``tcp://`` one carries a
consumer's steering messages back, and :meth:`Session.poll_steering`
applies them mid-run.

Not ported yet, each refused with :class:`PlanError` naming its ROADMAP
item: the ``fault`` preset and elastic restore.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence, Union

from repro_torch.core import transport
from repro_torch.core.runtime import (BACKPRESSURE_POLICIES, PipelineRuntime,
                                      PipelineTask, Placement, Stage,
                                      default_handoff)
from repro_torch.core.telemetry import Telemetry

PyTree = Any


class PlanError(ValueError):
    """A plan failed validation; the message names the stream/task at fault."""


class InSituTaskError(RuntimeError):
    """A task raised during the run; re-raised by ``finish(raise_on_error=True)``.

    Carries the declarative context (``stream``, ``task``, ``step``) so a
    failure in an async worker is attributable without digging through
    ``session.errors``; the original exception is chained as ``__cause__``.
    """

    def __init__(self, task: str, stream: str, step: int,
                 original: BaseException) -> None:
        super().__init__(
            f"in-situ task {task!r} (stream {stream!r}) failed at step "
            f"{step}: {type(original).__name__}: {original}")
        self.task = task
        self.stream = stream
        self.step = step


# ---------------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Every:
    """Fire on every ``n``-th step (``step % n == 0``) — the paper's
    "image every 50 / every 10" cadence. ``n`` must be >= 1."""
    n: int = 1

    def to_dict(self) -> dict:
        return {"every": self.n}


@dataclass(frozen=True)
class Adaptive:
    """Backpressure-adaptive every-N: starts at ``n``; under sustained
    staging-ring pressure the runtime doubles the *effective* period (up to
    ``max_every``) instead of stalling the producer — the paper's F3
    mitigation as a trigger.

    ``budget_s`` adds the wall-clock flavor: when the loop-blocking cost of
    a firing (copy dispatch + blocking hand-off + sync in-situ work, as
    measured by the runtime's telemetry spans) stays over the budget for
    ``after`` consecutive firings, the effective period widens too — the
    straggler policy's "shed in-situ load before replacing the host" knob.
    """
    n: int = 1
    max_every: int = 64
    after: int = 2            # consecutive over-budget/full-ring firings
    budget_s: Optional[float] = None

    def to_dict(self) -> dict:
        d = {"kind": "adaptive", "n": self.n,
             "max_every": self.max_every, "after": self.after}
        if self.budget_s is not None:
            d["budget_s"] = self.budget_s
        return {"trigger": d}


@dataclass(frozen=True)
class When:
    """Fire when ``predicate(step)`` is true — e.g. loss spikes, phase
    boundaries. Session-gated; not dict-serializable (a predicate is code)."""
    predicate: Callable[[int], bool]

    def to_dict(self) -> dict:
        raise PlanError("When(predicate) triggers are code, not data — "
                        "they cannot round-trip through a plan dict")


@dataclass(frozen=True)
class Interval:
    """Fire at most once per ``seconds`` of wall clock (first emit always
    fires) — the "checkpoint every 10 minutes" cadence, step-rate
    independent. Reads the session's monotonic clock (``Session(...,
    clock=...)``), so trigger semantics are testable without sleeping;
    ``Every``/``Adaptive`` are step-counted and never consult it."""
    seconds: float

    def to_dict(self) -> dict:
        return {"trigger": {"kind": "interval", "seconds": self.seconds}}


Trigger = Union[Every, Adaptive, When, Interval]


def _trigger_from_dict(name: str, spec: Mapping[str, Any]) -> Trigger:
    kind = spec.get("kind")
    if kind == "every":
        return Every(int(spec.get("n", 1)))
    if kind == "adaptive":
        budget = spec.get("budget_s")
        return Adaptive(int(spec.get("n", 1)),
                        max_every=int(spec.get("max_every", 64)),
                        after=int(spec.get("after", 2)),
                        budget_s=None if budget is None else float(budget))
    if kind == "interval":
        return Interval(float(spec["seconds"]))
    raise PlanError(f"task {name!r}: unknown trigger kind {kind!r} "
                    "(expected 'every' | 'adaptive' | 'interval')")


# ---------------------------------------------------------------------------
# Streams and task bindings
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StreamSpec:
    """One named payload stream the application will ``emit`` into."""
    name: str
    description: str = ""


@dataclass
class TaskSpec:
    """One declared in-situ task bound to a stream.

    Exactly one of ``preset`` or ``sink`` must be given:

    ``preset``        name of a registered workflow preset
                      (``serve_snapshot``); ``options`` parameterize it.
    ``sink``          explicit terminal consumer ``sink(step, payload)``;
                      ``host_stages`` / ``device_stage`` / ``handoff``
                      complete the chain exactly as on
                      :class:`~repro_torch.core.runtime.PipelineTask`.

    ``trigger``       when the task fires (default ``Every(1)``).
    ``placement``     SYNC / ASYNC / HYBRID scheduling policy.
    ``backpressure``  'block' | 'drop' | 'adapt' ring-full policy
                      (an ``Adaptive`` trigger implies 'adapt').
    ``shards``        split each firing into N independent sub-items.
    ``pipelined``     two-phase hand-off (dispatch on the loop,
                      materialize on the pool); ``False`` restores the
                      blocking hand-off.
    ``snapshot``      device-side clone at dispatch (in-place-update proof).
    ``retries``       transient-sink-failure retry count (None = runtime
                      default); exhausted retries degrade the task instead
                      of raising (see ``PipelineTask.retries``).
    ``retry_backoff_s``  base of the capped exponential retry backoff.
    """
    name: str
    stream: str
    trigger: Trigger = field(default_factory=Every)
    placement: Placement = Placement.ASYNC
    preset: Optional[str] = None
    options: dict = field(default_factory=dict)
    sink: Optional[Callable[[int, Any], Any]] = None
    host_stages: Sequence[Stage] = ()
    device_stage: Optional[Callable[[int, Any], Any]] = None
    handoff: Callable[[Any], Any] = default_handoff
    backpressure: Optional[str] = None
    shards: int = 1
    pipelined: bool = True
    snapshot: bool = True
    retries: Optional[int] = None
    retry_backoff_s: Optional[float] = None

    def resolved_backpressure(self) -> str:
        if self.backpressure is not None:
            return self.backpressure
        return "adapt" if isinstance(self.trigger, Adaptive) else "block"

    def to_dict(self) -> dict:
        """Declarative dict form; only preset tasks are data (callables
        are code and raise :class:`PlanError`)."""
        if self.preset is None:
            raise PlanError(
                f"task {self.name!r}: explicit sink/stage chains are code — "
                "only preset tasks round-trip through a plan dict")
        d: dict[str, Any] = {"stream": self.stream, "preset": self.preset,
                             "placement": self.placement.value}
        d.update(self.trigger.to_dict())
        if self.options:
            d["options"] = dict(self.options)
        if self.backpressure is not None:
            d["backpressure"] = self.backpressure
        if self.shards != 1:
            d["shards"] = self.shards
        if not self.pipelined:
            d["pipelined"] = False
        if not self.snapshot:
            d["snapshot"] = False
        if self.retries is not None:
            d["retries"] = self.retries
        if self.retry_backoff_s is not None:
            d["retry_backoff_s"] = self.retry_backoff_s
        return d


def _task_from_dict(name: str, spec: Mapping[str, Any]) -> TaskSpec:
    spec = dict(spec)
    if "every" in spec and "trigger" in spec:
        raise PlanError(
            f"task {name!r}: conflicting triggers — give either "
            "'every' or 'trigger', not both")
    if "trigger" in spec:
        trigger = _trigger_from_dict(name, spec.pop("trigger"))
    else:
        trigger = Every(int(spec.pop("every", 1)))
    placement = spec.pop("placement", "async")
    if not isinstance(placement, Placement):
        try:
            placement = Placement(placement)
        except ValueError:
            raise PlanError(
                f"task {name!r}: unknown placement {placement!r} "
                f"(expected one of {[p.value for p in Placement]})") from None
    known = {"stream", "preset", "options", "backpressure", "shards",
             "pipelined", "snapshot", "retries", "retry_backoff_s"}
    unknown = set(spec) - known
    if unknown:
        raise PlanError(f"task {name!r}: unknown field(s) {sorted(unknown)}")
    if "stream" not in spec:
        raise PlanError(f"task {name!r}: missing required field 'stream'")
    retries = spec.get("retries")
    backoff = spec.get("retry_backoff_s")
    return TaskSpec(name=name, stream=spec["stream"], trigger=trigger,
                    placement=placement, preset=spec.get("preset"),
                    options=dict(spec.get("options", {})),
                    backpressure=spec.get("backpressure"),
                    shards=int(spec.get("shards", 1)),
                    pipelined=bool(spec.get("pipelined", True)),
                    snapshot=bool(spec.get("snapshot", True)),
                    retries=None if retries is None else int(retries),
                    retry_backoff_s=None if backoff is None
                    else float(backoff))


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# A preset maps (TaskSpec) -> chain pieces for the shared runtime:
#   {"sink": ..., "host_stages": ..., "device_stage": ..., "handoff": ...}
# The 'checkpoint' preset is special-cased by Session (it folds a whole
# CheckpointManager — save/restore/retention — into the plan).
_PRESETS: dict[str, Callable[[TaskSpec], dict]] = {}

# presets of the JAX package the port does not carry yet -> ROADMAP item
_NOT_PORTED = {
    "fault": "'Distribution and faults' (distributed/fault.py)",
}


def register_preset(name: str):
    """Register a workflow preset usable as ``TaskSpec(preset=name)``.

    The decorated factory takes the :class:`TaskSpec` and returns the chain
    pieces (``sink`` required; ``host_stages``/``device_stage``/``handoff``
    optional; a ``report`` zero-arg callable is merged into the task's
    entry of :meth:`Session.report`; a ``store`` object is exposed through
    :meth:`Session.snapshot_store`). Presets keep plans declarative: a dict
    plan can name them without shipping code.
    """
    def deco(factory: Callable[[TaskSpec], dict]):
        _PRESETS[name] = factory
        return factory
    return deco


def preset_names() -> list[str]:
    """Registered preset names (plus the Session-built-in 'checkpoint')."""
    return sorted(set(_PRESETS) | {"checkpoint"})


class _PresetSink(transport.Sink):
    """The one terminal every preset shares (this used to be four
    near-identical ``def sink(step, payload)`` closures): run the preset's
    *transform* — its whole identity — and, when the plan declared a
    transport (``options={"to": "tcp://…"}``), forward the result through
    it. The transform's return value stays the task's result in
    ``runtime.results``, so semantics match the old closures exactly.

    A forward failure that raises the runtime's ``TransientError`` out
    of ``write`` makes the task retry (re-running the transform, so
    transforms must tolerate replay) and degrade if it keeps failing.
    """

    def __init__(self, spec: TaskSpec, transform: Callable[[int, Any], Any],
                 forward_to: Optional[transport.Sink] = None) -> None:
        super().__init__(stream=spec.stream)
        self.transform = transform
        self.forward_to = forward_to

    def write(self, step: int, payload: Any, **_kw) -> Any:
        result = self.transform(step, payload)
        if self.forward_to is not None:
            self.forward_to.write(
                step, result if result is not None else payload)
        self.frames_written += 1
        return result

    def write_frame(self, frame: transport.Frame) -> None:  # pragma: no cover
        raise TypeError("_PresetSink is driven through write()")

    def close(self) -> None:
        if self.forward_to is not None:
            self.forward_to.close()
        super().close()


def _terminal_pieces(spec: TaskSpec, transform: Callable[[int, Any], Any],
                     *, known_options: Sequence[str] = (),
                     forward: bool = True, **extra: Any) -> dict:
    """Build a preset's chain pieces around the shared terminal.

    Validates ``spec.options`` against ``known_options`` (every preset
    accepts ``to`` — the plan-declared transport URL), connects the
    transport once, and wires it either into the sink's forward path
    (``forward=True``) or just hands it back for the preset to own
    (``forward=False`` — serve_snapshot attaches it as the store mirror
    instead). The transport rides the pieces dict under ``"transport"`` so
    the session can report and close it.
    """
    known = set(known_options) | {"to"}
    unknown = set(spec.options) - known
    if unknown:
        # a silently-ignored option would change semantics without a
        # diagnostic (the removed sample_elems taught us that)
        raise PlanError(
            f"task {spec.name!r}: unknown {spec.preset} option(s) "
            f"{sorted(unknown)} (known: {sorted(known)})")
    url = spec.options.get("to")
    tsink = (transport.connect(str(url), stream=spec.stream)
             if url else None)
    pieces: dict[str, Any] = {
        "sink": _PresetSink(spec, transform,
                            forward_to=tsink if forward else None),
        "transport": tsink,
    }
    pieces.update(extra)
    return pieces


@register_preset("grad_health")
def _grad_health_preset(spec: TaskSpec) -> dict:
    """Gradient-health roll-up artifact (global norm, norm sheet, NaN flags).
    Options: ``to`` (transport URL streaming each artifact to a consumer)."""
    from repro_torch.core import analysis

    def transform(step: int, payload: Any):
        return analysis.gradient_health(payload, step)

    return _terminal_pieces(spec, transform)


@register_preset("spectra")
def _spectra_preset(spec: TaskSpec) -> dict:
    """Per-tensor spectral/histogram/heatmap artifacts (the paper's
    "image generation" analog). Options: ``work`` (cost knob, default 1),
    ``to`` (transport URL streaming each artifact to a consumer)."""
    from repro_torch.core import analysis
    work = int(spec.options.get("work", 1))

    def transform(step: int, payload: Any):
        if isinstance(payload, Mapping):
            return analysis.summarize_tree(payload, step, work=work)
        return analysis.tensor_summary(spec.stream, payload, step, work=work)

    return _terminal_pieces(spec, transform, known_options=("work",))


@register_preset("serve_snapshot")
def _serve_snapshot_preset(spec: TaskSpec) -> dict:
    """Delta-encoded serving-state snapshots through a versioned
    :class:`~repro_torch.serving.snapshot.SnapshotStore`.

    Each firing publishes the payload as one frame of the stream's
    base+delta chain: every ``base_every``-th publish is a self-contained
    base, the rest are per-chunk XOR/COPY deltas against the previous
    snapshot, and a payload carrying an unchanged ``version`` hint (see
    ``PagedServingEngine.snapshot_payload``) short-circuits to a no-op
    frame. The sink result is the
    :class:`~repro_torch.serving.snapshot.SnapshotRecord`
    for the frame; :meth:`Session.report` merges the store's delta-ratio /
    chain-depth statistics into the task's entry.

    Options: ``codec`` (inner lossless codec, default 'zlib'),
    ``base_every`` (chain cadence, default 8), ``directory`` (persist
    frames crash-safely on disk; default in-memory), ``keep_chains``
    (retention — default 2, bounding a long-running serving loop's
    frame accumulation; None keeps everything), ``to`` (transport URL —
    attached as the store's *mirror*, forwarding every raw chain frame to
    a replica that rebuilds a bit-identical chain via
    ``SnapshotStore.ingest``)."""
    from repro_torch.serving.snapshot import SnapshotStore

    keep = spec.options.get("keep_chains", 2)
    store = SnapshotStore(
        spec.options.get("directory"),
        base_every=int(spec.options.get("base_every", 8)),
        codec=str(spec.options.get("codec", "zlib")),
        keep_chains=None if keep is None else int(keep))
    stream = spec.stream

    def transform(step: int, payload: Any):
        version = None
        tree = payload
        hints = None
        if (isinstance(payload, Mapping) and "cache" in payload
                and "version" in payload):
            version = int(payload["version"])
            tree = payload["cache"]
            # paged engines ship per-leaf chunk sizes so delta chunks
            # align to KV pages (untouched pages -> zero-payload COPY)
            hints = payload.get("chunk_hints")
        return store.publish(stream, step, tree, version=version,
                             chunk_hints=hints)

    # forward=False: the chain frames themselves are the wire product —
    # the store mirrors every written frame's raw bytes, which is what
    # makes the replica's restore bit-identical (a re-encoded
    # SnapshotRecord forward would carry only the record, not the chain)
    pieces = _terminal_pieces(
        spec, transform, forward=False,
        known_options=("codec", "base_every", "directory", "keep_chains"),
        report=lambda: store.stats(stream), store=store)
    if pieces["transport"] is not None:
        store.set_mirror(pieces["transport"])
    return pieces


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclass
class InSituPlan:
    """A validated, declarative description of every in-situ workflow.

    ``streams``           the payload streams the application will emit
                          (names or :class:`StreamSpec`).
    ``tasks``             the :class:`TaskSpec` bindings.
    ``workers``           p_i — worker threads of the shared runtime pool.
    ``staging_capacity``  bounded staging-ring depth (double-buffering /
                          backpressure horizon).

    Construction validates the whole plan and raises :class:`PlanError`
    naming the offending stream/task: unknown stream, duplicate task name,
    ``every < 1``, unknown or not-yet-ported preset, preset+sink
    conflicts, bad backpressure policy.
    """
    streams: Sequence[Union[str, StreamSpec]] = ()
    tasks: Sequence[TaskSpec] = ()
    workers: int = 2
    staging_capacity: int = 4

    def __post_init__(self) -> None:
        specs = [s if isinstance(s, StreamSpec) else StreamSpec(str(s))
                 for s in self.streams]
        names = [s.name for s in specs]
        for n in names:
            if names.count(n) > 1:
                raise PlanError(f"duplicate stream {n!r} in plan")
            if not n:
                raise PlanError("stream names must be non-empty")
        self.streams = tuple(specs)
        self.tasks = tuple(self.tasks)
        if self.workers < 1:
            raise PlanError(f"workers must be >= 1, got {self.workers}")
        if self.staging_capacity < 1:
            raise PlanError(
                f"staging_capacity must be >= 1, got {self.staging_capacity}")
        stream_names = set(names)
        seen: set[str] = set()
        n_ckpt = 0
        for t in self.tasks:
            if not t.name:
                raise PlanError("task names must be non-empty")
            if t.name in seen:
                raise PlanError(f"duplicate task {t.name!r} in plan")
            seen.add(t.name)
            if t.stream not in stream_names:
                raise PlanError(
                    f"task {t.name!r} binds unknown stream {t.stream!r} "
                    f"(declared streams: {sorted(stream_names)})")
            if isinstance(t.trigger, (Every, Adaptive)) and t.trigger.n < 1:
                raise PlanError(
                    f"task {t.name!r}: trigger period must be >= 1, "
                    f"got every={t.trigger.n}")
            if isinstance(t.trigger, Interval) and t.trigger.seconds <= 0:
                raise PlanError(
                    f"task {t.name!r}: Interval seconds must be > 0, "
                    f"got {t.trigger.seconds}")
            if (isinstance(t.trigger, Adaptive)
                    and t.trigger.budget_s is not None
                    and t.trigger.budget_s <= 0):
                raise PlanError(
                    f"task {t.name!r}: Adaptive budget_s must be > 0, "
                    f"got {t.trigger.budget_s}")
            if t.retries is not None and t.retries < 0:
                raise PlanError(
                    f"task {t.name!r}: retries must be >= 0, got {t.retries}")
            if t.retry_backoff_s is not None and t.retry_backoff_s < 0:
                raise PlanError(
                    f"task {t.name!r}: retry_backoff_s must be >= 0, "
                    f"got {t.retry_backoff_s}")
            if (isinstance(t.trigger, Adaptive) and t.backpressure is not None
                    and t.backpressure != "adapt"):
                raise PlanError(
                    f"task {t.name!r}: conflicting triggers — Adaptive "
                    f"requires backpressure 'adapt', got {t.backpressure!r}")
            if t.resolved_backpressure() not in BACKPRESSURE_POLICIES:
                raise PlanError(
                    f"task {t.name!r}: backpressure must be one of "
                    f"{BACKPRESSURE_POLICIES}, got {t.backpressure!r}")
            if t.preset is not None and t.sink is not None:
                raise PlanError(
                    f"task {t.name!r}: give either a preset or an explicit "
                    "sink chain, not both")
            if t.preset is None and t.sink is None:
                raise PlanError(
                    f"task {t.name!r}: needs a preset or a sink")
            if t.preset in _NOT_PORTED:
                raise PlanError(
                    f"task {t.name!r}: preset {t.preset!r} is not ported "
                    f"yet (ROADMAP.md: {_NOT_PORTED[t.preset]})")
            if t.preset == "checkpoint":
                n_ckpt += 1
                if n_ckpt > 1:
                    raise PlanError(
                        f"task {t.name!r}: a plan may declare at most one "
                        "checkpoint task")
                if not t.options.get("directory"):
                    raise PlanError(
                        f"task {t.name!r}: checkpoint preset requires "
                        "options={'directory': ...}")
                # the manager owns its pipeline's scheduling knobs; accept
                # only what is actually wired through
                if t.backpressure is not None:
                    raise PlanError(
                        f"task {t.name!r}: the checkpoint preset does not "
                        "take a backpressure policy (the manager's "
                        "pipeline uses 'block')")
                if isinstance(t.trigger, Adaptive):
                    raise PlanError(
                        f"task {t.name!r}: the checkpoint preset gates "
                        "saves session-side, so an Adaptive trigger would "
                        "never widen — use Every/When/Interval")
                if t.shards != 1 or not t.pipelined or not t.snapshot:
                    raise PlanError(
                        f"task {t.name!r}: checkpoint preset does not "
                        "accept shards/pipelined/snapshot overrides")
            elif t.preset is not None and t.preset not in _PRESETS:
                raise PlanError(
                    f"task {t.name!r}: unknown preset {t.preset!r} "
                    f"(registered: {preset_names()})")
            if t.shards < 1:
                raise PlanError(
                    f"task {t.name!r}: shards must be >= 1, got {t.shards}")

    # -- dict round-trip ------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "InSituPlan":
        """Build a plan from its plain-dict (TOML/JSON-loadable) form."""
        known = {"streams", "tasks", "workers", "staging_capacity"}
        unknown = set(d) - known
        if unknown:
            raise PlanError(f"unknown plan field(s) {sorted(unknown)}")
        tasks_in = d.get("tasks", {})
        if isinstance(tasks_in, Mapping):
            items = list(tasks_in.items())
        else:
            items = []
            for spec in tasks_in:
                spec = dict(spec)
                if "name" not in spec:
                    raise PlanError("list-form tasks need a 'name' field")
                items.append((spec.pop("name"), spec))
        tasks = [_task_from_dict(name, spec) for name, spec in items]
        return cls(streams=list(d.get("streams", [])), tasks=tasks,
                   workers=int(d.get("workers", 2)),
                   staging_capacity=int(d.get("staging_capacity", 4)))

    def to_dict(self) -> dict:
        """Plain-dict form (inverse of :meth:`from_dict`). Only declarative
        content survives; explicit callable chains raise :class:`PlanError`."""
        return {
            "streams": [s.name for s in self.streams],
            "tasks": {t.name: t.to_dict() for t in self.tasks},
            "workers": self.workers,
            "staging_capacity": self.staging_capacity,
        }


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

def _memoized(fn: Callable[[], Any]) -> Callable[[], Any]:
    """Evaluate-once wrapper for emit providers: several tasks firing on
    one stream share a single payload materialization. No lock — the
    runtime evaluates providers synchronously on the emitting thread."""
    sentinel = object()
    cache: list = [sentinel]

    def wrapper():
        if cache[0] is sentinel:
            cache[0] = fn()
        return cache[0]

    return wrapper


class _Binding:
    """One task wired into the live runtime (session-internal)."""

    __slots__ = ("spec", "source", "session_gated", "last_fire_t", "mgr")

    def __init__(self, spec: TaskSpec, source: str, session_gated: bool,
                 mgr: Any = None) -> None:
        self.spec = spec
        self.source = source
        self.session_gated = session_gated
        self.last_fire_t: Optional[float] = None
        self.mgr = mgr          # the CheckpointManager of a checkpoint task

    def due(self, step: int, now: float) -> bool:
        """Session-side gate. Every/Adaptive are runtime-gated (so the
        'adapt' policy can widen the effective period); When/Interval are
        evaluated here."""
        trig = self.spec.trigger
        if isinstance(trig, When):
            return bool(trig.predicate(step))
        if isinstance(trig, Interval):
            if (self.last_fire_t is None
                    or now - self.last_fire_t >= trig.seconds):
                self.last_fire_t = now
                return True
            return False
        return True          # Every/Adaptive: the runtime gates on its every


class Session:
    """A live in-situ session: one plan bound to one shared runtime.

    Use as a context manager; the application's only obligations are to
    ``emit(stream, step, payload)`` (payload may be a zero-arg callable —
    it is then only evaluated if some task actually fires) and to exit the
    context (or call :meth:`finish`)::

        with Session(plan) as session:
            for step in range(n):
                ...device step...
                session.emit("grads", step, lambda: grads)

    The session owns placement, triggers, backpressure and reporting;
    nothing else in the application knows how tasks run.
    """

    def __init__(self, plan: Union[InSituPlan, Mapping[str, Any]], *,
                 telemetry: Optional[Telemetry] = None,
                 runtime: Optional[PipelineRuntime] = None,
                 raise_on_error: bool = False,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if isinstance(plan, Mapping):
            plan = InSituPlan.from_dict(plan)
        self.plan = plan
        # the injected monotonic clock gates wall-clock (Interval) triggers;
        # tests drive it by hand instead of sleeping (Every/Adaptive are
        # step-counted and never read it)
        self._clock = clock if clock is not None else time.monotonic
        self._owns_runtime = runtime is None
        if runtime is None:
            runtime = PipelineRuntime(
                workers=plan.workers, staging_capacity=plan.staging_capacity,
                telemetry=telemetry)
        elif telemetry is not None and telemetry is not runtime.telemetry:
            raise ValueError("pass either a telemetry or a runtime (whose "
                             "telemetry is used), not two different objects")
        self.runtime = runtime
        self.checkpoint = None            # CheckpointManager, if declared
        self._raise_on_error = raise_on_error
        self._finished = False
        self._strict_streams = True       # legacy wrappers relax this
        self._steering: list[dict] = []   # applied steering commands
        self._steering_rejected = 0       # invalid commands refused
        self._ckpt_meta: Optional[dict] = None
        self._task_stream: dict[str, str] = {}
        self._reporters: dict[str, Callable[[], Mapping[str, Any]]] = {}
        self._stores: dict[str, Any] = {}
        self._transports: dict[str, transport.Sink] = {}
        self._by_stream: dict[str, list[_Binding]] = {
            s.name: [] for s in plan.streams}
        for spec in plan.tasks:
            self._bind(spec)

    # -- wiring ---------------------------------------------------------------

    def _bind(self, spec: TaskSpec) -> None:
        self._task_stream[spec.name] = spec.stream
        if spec.preset == "checkpoint":
            self._bind_checkpoint(spec)
            return
        if spec.preset is not None:
            pieces = _PRESETS[spec.preset](spec)
        else:
            pieces = {"sink": spec.sink, "host_stages": spec.host_stages,
                      "device_stage": spec.device_stage,
                      "handoff": spec.handoff}
        if pieces.get("report") is not None:
            self._reporters[spec.name] = pieces["report"]
        if pieces.get("store") is not None:
            self._stores[spec.name] = pieces["store"]
        if pieces.get("transport") is not None:
            # declared via options={"to": url}; the session reports and
            # closes it at finish
            self._transports[spec.name] = pieces["transport"]
        session_gated = isinstance(spec.trigger, (When, Interval))
        every = (spec.trigger.n
                 if isinstance(spec.trigger, (Every, Adaptive)) else 1)
        adapt = (spec.trigger if isinstance(spec.trigger, Adaptive)
                 else Adaptive())
        extra: dict[str, Any] = {}
        if spec.retries is not None:
            extra["retries"] = spec.retries
        if spec.retry_backoff_s is not None:
            extra["retry_backoff_s"] = spec.retry_backoff_s
        task = PipelineTask(
            name=spec.name,
            source=f"{spec.stream}::{spec.name}",
            sink=pieces["sink"],
            host_stages=tuple(pieces.get("host_stages") or ()),
            device_stage=pieces.get("device_stage"),
            handoff=pieces.get("handoff") or default_handoff,
            pipelined=spec.pipelined,
            snapshot=spec.snapshot,
            placement=spec.placement,
            every=every,
            shards=spec.shards,
            backpressure=spec.resolved_backpressure(),
            adapt_after=adapt.after,
            adapt_max_every=adapt.max_every,
            budget_s=adapt.budget_s,
            **extra,
        )
        self.runtime.register(task)
        self._by_stream[spec.stream].append(
            _Binding(spec, task.source, session_gated))

    def _bind_checkpoint(self, spec: TaskSpec) -> None:
        """Fold a CheckpointManager into the session as a declared task.

        Save/restore/retention semantics are the manager's; it registers
        its pipeline into the *shared* runtime, so checkpoint writes and
        analytics draw from the same worker pool. ``options`` are
        :class:`~repro_torch.checkpoint.CheckpointConfig` fields."""
        from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
        opts = dict(spec.options)
        every = (spec.trigger.n
                 if isinstance(spec.trigger, (Every, Adaptive)) else 1)
        try:
            cfg = CheckpointConfig(directory=opts.pop("directory"),
                                   mode=spec.placement, every=every, **opts)
        except TypeError as e:
            raise PlanError(f"task {spec.name!r}: bad checkpoint option: "
                            f"{e}") from None
        mgr = CheckpointManager(cfg, runtime=self.runtime)
        self.checkpoint = mgr
        if mgr._mirror is not None:
            self._transports[spec.name] = mgr._mirror
        self._by_stream[spec.stream].append(
            _Binding(spec, "ckpt_state", True, mgr=mgr))

    # -- producer side --------------------------------------------------------

    def emit(self, stream: str, step: int, payload: Any) -> None:
        """Offer one step's payload on a stream — the only producer call.

        ``payload`` may be the value itself or a zero-arg callable; a
        callable is evaluated at most once per emit — even when several
        bound tasks fire at the same step — and only if at least one task
        actually fires (lazy providers, exactly like the legacy engine's
        providers dict).
        """
        bindings = self._by_stream.get(stream)
        provider = (_memoized(payload) if callable(payload)
                    else (lambda: payload))
        if bindings is None:
            if not self._strict_streams:
                # legacy providers-dict contract: the loop offers every
                # source, tasks pick; an unmatched source is a no-op
                self.runtime.submit(step, {stream: provider})
                return
            raise PlanError(
                f"emit on unknown stream {stream!r} (declared: "
                f"{sorted(self._by_stream)})")
        if self._transports:
            # the consumer's steering back-channel
            self.poll_steering()
        now = self._clock()
        providers: dict[str, Callable[[], Any]] = {}
        for b in bindings:
            if b.session_gated and not b.due(step, now):
                continue
            if b.mgr is not None:
                # checkpoint: session-gated; the manager's registered
                # pipeline (every=1) does the save through the shared pool
                if isinstance(b.spec.trigger, (Every, Adaptive)):
                    if step % b.spec.trigger.n:
                        continue
                b.mgr.save(step, provider(), meta=self._ckpt_meta)
                continue
            providers[b.source] = provider
        if providers:
            self.runtime.submit(step, providers)

    # -- steering (the consumer's back-channel) -------------------------------

    def _binding(self, task: str) -> Optional[_Binding]:
        for b_list in self._by_stream.values():
            for b in b_list:
                if b.spec.name == task:
                    return b
        return None

    def poll_steering(self) -> list[dict]:
        """Drain steering messages from every transport back-channel and
        apply them to the live run (see :meth:`_apply_steering`): an
        in-situ consumer retunes the producer mid-run. Only ``tcp://``
        transports have a back-channel; the local ones return nothing.
        Applied commands accumulate in ``report()["steering"]``."""
        applied = []
        for via, tsink in self._transports.items():
            for msg in tsink.poll_control():
                if not isinstance(msg, dict):
                    continue
                rec = self._apply_steering(via, msg)
                self._steering.append(rec)
                applied.append(rec)
        return applied

    def _apply_steering(self, via: str, msg: Mapping[str, Any]) -> dict:
        """Validate-then-apply one steering message naming a task::

            {"task": "analytics", "every": 20}       # firing cadence
            {"task": "ckpt", "lossy_eps": 0.05}      # lossy threshold

        ``every`` retunes any bound task (checkpoint tasks via their
        session-side trigger); ``lossy_eps`` retunes the checkpoint codec's
        error bound for every *subsequent* save. Invalid values of known
        knobs are rejected (counted into
        ``report()["steering"]["steering_rejected"]``, never applied);
        unknown knobs are ignored.
        """
        import math

        task = str(msg.get("task", via))
        rec: dict[str, Any] = {"via": via, "task": task,
                               "applied": {}, "rejected": {}, "ignored": {}}
        binding = self._binding(task)

        def reject(key, val, why):
            rec["rejected"][key] = f"{val!r} ({why})"
            self._steering_rejected += 1

        for key, val in msg.items():
            if key == "task":
                continue
            if key == "every":
                try:
                    n = int(val)
                except (ValueError, TypeError) as e:
                    reject(key, val, e)
                    continue
                if n < 1:
                    reject(key, val, f"every must be >= 1, got {n}")
                    continue
                try:
                    if binding is not None and binding.mgr is not None:
                        binding.spec.trigger = Every(n)
                    else:
                        self.runtime.set_every(task, n)
                    rec["applied"]["every"] = n
                except (ValueError, KeyError) as e:
                    reject(key, val, e)
            elif key == "lossy_eps":
                try:
                    eps = float(val)
                except (ValueError, TypeError) as e:
                    reject(key, val, e)
                    continue
                # NaN fails isfinite, not the comparison
                if not math.isfinite(eps) or eps <= 0:
                    reject(key, val, "lossy_eps must be finite and > 0")
                    continue
                if self.checkpoint is None:
                    rec["ignored"][key] = eps     # valid, nothing to retune
                    continue
                self.checkpoint.cfg.lossy_eps = eps
                rec["applied"]["lossy_eps"] = eps
            else:
                rec["ignored"][key] = val
        return rec

    def transport_of(self, task: str) -> Optional[transport.Sink]:
        """The transport sink a task declared via ``options={"to": ...}``
        (None when the task has no transport)."""
        return self._transports.get(task)

    def step_span(self, step: int):
        """Span context for the application's device step (``step/compute``)
        so device/in-situ attribution in :meth:`report` is exact."""
        return self.runtime.telemetry.span("step/compute", step=step)

    def run(self, n_steps: int,
            app_step: Callable[[int], Mapping[str, Any]],
            finish: bool = True) -> Telemetry:
        """Drive ``n_steps`` of an application against this session.

        ``app_step(step)`` runs one device step inside a ``step/compute``
        span and returns ``{stream: payload-or-provider}``; every entry is
        emitted. The canonical workflow driver — the legacy
        ``run_pipeline``/``run_workflow`` are shims over it.
        """
        for step in range(n_steps):
            with self.step_span(step):
                payloads = app_step(step)
            for stream, payload in payloads.items():
                self.emit(stream, step, payload)
        if finish:
            self.finish()
        return self.telemetry

    # -- state ----------------------------------------------------------------

    @property
    def streams(self) -> frozenset:
        """The stream names this session accepts emits on — drivers with
        optional workloads gate their emits on membership here (a custom
        plan may declare only a subset of the default streams)."""
        return frozenset(self._by_stream)

    @property
    def clock(self) -> Callable[[], float]:
        """The session's monotonic clock (injected or ``time.monotonic``);
        Interval triggers read it."""
        return self._clock

    @property
    def telemetry(self) -> Telemetry:
        return self.runtime.telemetry

    @property
    def results(self):
        """All TaskResults so far."""
        return self.runtime.results

    def errors(self) -> list[tuple[str, int, BaseException]]:
        """Captured task failures as (task, step, exception)."""
        return list(self.runtime.errors)

    def snapshot_store(self, task: str) -> Any:
        """The SnapshotStore behind a ``serve_snapshot`` task (for restore
        / chain inspection); raises ``PlanError`` for other tasks."""
        if task not in self._stores:
            raise PlanError(
                f"task {task!r} has no snapshot store (declared stores: "
                f"{sorted(self._stores)})")
        return self._stores[task]

    def stream_of(self, task: str) -> Optional[str]:
        """The stream a task is bound to (None for tasks the plan doesn't
        know, e.g. registered directly on a passed-in runtime)."""
        if task == "checkpoint" and task not in self._task_stream:
            for b_list in self._by_stream.values():
                for b in b_list:
                    if b.mgr is not None:
                        return b.spec.stream
        return self._task_stream.get(task)

    # -- checkpoint passthrough ----------------------------------------------

    def set_checkpoint_meta(self, meta: Optional[Mapping[str, Any]] = None
                            ) -> None:
        """Attach run metadata to every subsequent checkpoint save."""
        self._ckpt_meta = dict(meta) if meta else None

    def restore(self, template: PyTree, step: Optional[int] = None, *,
                elastic: bool = False) -> tuple[int, PyTree]:
        """Restore from the plan's checkpoint task: ``(step, state)`` with
        the template's structure, dtypes and shapes, on the device the
        task's options name (the card by default). Elastic restore (a
        re-mesh onto surviving devices) is not ported yet."""
        if elastic:
            raise PlanError("elastic restore is not ported yet (ROADMAP.md: "
                            "'Distribution and faults')")
        if self.checkpoint is None:
            raise PlanError("plan declares no checkpoint task to restore from")
        return self.checkpoint.restore(template, step)

    def latest_checkpoint_step(self) -> Optional[int]:
        if self.checkpoint is None:
            return None
        return self.checkpoint.latest_step()

    # -- lifecycle ------------------------------------------------------------

    def wait_idle(self, timeout: float = 600.0) -> bool:
        """Block until every enqueued async firing has finished."""
        return self.runtime.wait_idle(timeout=timeout)

    def finish(self, timeout: float = 600.0,
               raise_on_error: Optional[bool] = None) -> None:
        """Drain the ring, join the pool (the non-overlapped tail), and —
        with ``raise_on_error=True`` — re-raise the first task failure as
        :class:`InSituTaskError` with stream/task/step context instead of
        leaving it silently in :meth:`errors`.

        ``raise_on_error=None`` uses the session's constructor default.
        Idempotent: later calls only re-check the error state.
        """
        if not self._finished:
            self._finished = True
            self.runtime.wait_idle(timeout=timeout)
            if self._owns_runtime:
                self.runtime.drain(timeout=timeout)
            # transports not owned by a task sink (snapshot mirrors) close
            # here; Sink.close is idempotent
            for tsink in self._transports.values():
                try:
                    tsink.close()
                except Exception:  # noqa: BLE001 - teardown must not raise
                    pass
            if self.checkpoint is not None:
                self.checkpoint.finish()
        raise_ = (self._raise_on_error if raise_on_error is None
                  else raise_on_error)
        if raise_ and self.runtime.errors:
            task, step, exc = self.runtime.errors[0]
            stream = self.stream_of(task) or "?"
            raise InSituTaskError(task, stream, step, exc) from exc

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # don't mask an in-flight application exception with a task error
        self.finish(raise_on_error=False if exc_type is not None else None)

    # -- reporting ------------------------------------------------------------

    def report(self) -> dict[str, Any]:
        """One merged report: telemetry overlap attribution, task results,
        errors and backpressure state."""
        rep = self.runtime.report()

        def _runtime_name(t: TaskSpec) -> str:
            # the checkpoint manager registers its pipeline under its own
            # name, whatever the plan called the binding
            return "checkpoint" if t.preset == "checkpoint" else t.name

        rep["tasks"] = {
            t.name: {"stream": t.stream,
                     "results": sum(1 for r in self.runtime.results
                                    if r.task == _runtime_name(t)),
                     "errors": sum(1 for (n, _, _) in self.runtime.errors
                                   if n == _runtime_name(t))}
            for t in self.plan.tasks}
        for name, reporter in self._reporters.items():
            # preset-contributed stats (e.g. serve_snapshot's delta ratio
            # and chain depth) ride the task's entry
            if name in rep["tasks"]:
                rep["tasks"][name].update(dict(reporter()))
        for name, entry in rep["tasks"].items():
            if name in rep.get("degraded", {}):
                entry["degraded"] = dict(rep["degraded"][name])
        for name, tsink in self._transports.items():
            stats = {"sink": type(tsink).__name__,
                     "frames": tsink.frames_written,
                     "bytes": tsink.bytes_written}
            if isinstance(tsink, transport.StreamSink):
                stats["reconnects"] = tsink.reconnects
            rep["tasks"].setdefault(name, {})["transport"] = stats
        if self._steering or self._steering_rejected:
            rep["steering"] = {
                "commands": [dict(s) for s in self._steering],
                "steering_rejected": self._steering_rejected,
            }
        rep["errors"] = [
            {"task": n, "stream": self.stream_of(n) or "?", "step": s,
             "error": f"{type(e).__name__}: {e}"}
            for (n, s, e) in self.runtime.errors]
        if self.checkpoint is not None:
            reports = list(self.checkpoint.reports)
            rep["checkpoint"] = {
                "saves": len(reports),
                "raw_bytes": sum(r.raw_bytes for r in reports),
                "stored_bytes": sum(r.stored_bytes for r in reports),
                # saves on several workers append in completion order
                "last_step": max((r.step for r in reports), default=None),
                "kept_steps": self.checkpoint.list_steps(),
            }
        return rep

    # -- legacy adapter --------------------------------------------------------

    @classmethod
    def over_runtime(cls, runtime: PipelineRuntime) -> "Session":
        """Wrap an already-wired :class:`PipelineRuntime` (legacy path).

        Streams mirror the registered tasks' ``source`` keys and gating is
        purely runtime-side; ``emit``/``run``/``report``/``finish`` behave
        identically. The session takes the runtime over: its ``finish``
        drains it (joins the workers) once. This is how the deprecation
        shims (``run_pipeline``/``InSituEngine``) ride on a Session.
        """
        sess = cls(InSituPlan(), runtime=runtime)
        sess._owns_runtime = True        # the shim transfers ownership
        sess._strict_streams = False
        for t in runtime.tasks:
            sess._task_stream.setdefault(t.name, t.source)
            sess._by_stream.setdefault(t.source, []).append(
                _Binding(TaskSpec(name=t.name, stream=t.source,
                                  sink=t.sink), t.source, False))
        return sess
