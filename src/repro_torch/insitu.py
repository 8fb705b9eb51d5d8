"""``repro_torch.insitu`` — the port's public in-situ API, one import.

Declare workflows with :class:`InSituPlan` (streams + triggers + task
bindings, loadable from a plain dict) and run them with :class:`Session`::

    from repro_torch import insitu

    plan = insitu.InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {
            "kv_snapshot": {"stream": "kv_pages", "preset": "serve_snapshot",
                            "every": 4, "backpressure": "drop"},
        },
    })
    with insitu.Session(plan) as session:
        for step in range(n_steps):
            engine.step()
            session.emit("kv_pages", step, engine.snapshot_payload)

See ``repro_torch/core/session.py`` for the full semantics and for what is
not ported yet.
"""
from repro_torch.core.runtime import (FanoutStage, Placement, Stage,
                                      TransientError)
from repro_torch.core.session import (Adaptive, Every, InSituPlan,
                                      InSituTaskError, Interval, PlanError,
                                      Session, StreamSpec, TaskSpec, Trigger,
                                      When, preset_names, register_preset)
from repro_torch.core.transport import (CallableSink, FileSink, FileSource,
                                        Frame, FrameCorruptError, MemorySink,
                                        Sink, Source, StreamGapError,
                                        TransportError, as_sink, connect,
                                        decode_frame_payload)

__all__ = [
    "Adaptive", "Every", "FanoutStage", "InSituPlan", "InSituTaskError",
    "Interval", "Placement", "PlanError", "Session", "Stage", "StreamSpec",
    "TaskSpec", "TransientError", "Trigger", "When", "preset_names",
    "register_preset",
    "CallableSink", "FileSink", "FileSource", "Frame", "FrameCorruptError",
    "MemorySink", "Sink", "Source", "StreamGapError", "TransportError",
    "as_sink", "connect", "decode_frame_payload",
]
