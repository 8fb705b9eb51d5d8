"""``repro_torch.insitu`` — the port's public in-situ API, one import.

Declare workflows with :class:`InSituPlan` (streams + triggers + task
bindings, loadable from a plain dict) and run them with :class:`Session`::

    from repro_torch import insitu

    plan = insitu.InSituPlan.from_dict({
        "streams": ["grads", "train_state"],
        "tasks": {
            "analytics": {"stream": "grads", "preset": "grad_health",
                          "every": 10},
            "ckpt": {"stream": "train_state", "preset": "checkpoint",
                     "every": 5, "placement": "hybrid",
                     "options": {"directory": "/tmp/ck"}},
        },
    })
    with insitu.Session(plan) as session:
        if session.latest_checkpoint_step() is not None:
            start, state = session.restore(state)
        for step in range(n_steps):
            state, grads = train_step(state)
            session.emit("grads", step, lambda: grads)
            session.emit("train_state", step, state)

Serving declares ``kv_pages`` with the ``serve_snapshot`` preset the
same way.

See ``repro_torch/core/session.py`` for the full semantics and for what is
not ported yet. The legacy entry points (``InSituEngine``,
``run_workflow``, ``run_pipeline``) remain as deprecation shims in
``repro_torch.core``.
"""
from repro_torch.checkpoint import (CheckpointConfig,
                                    CheckpointCorruptError,
                                    CheckpointManager)
from repro_torch.core.runtime import (FanoutStage, Placement, Stage,
                                      TransientError)
from repro_torch.core.session import (Adaptive, Every, InSituPlan,
                                      InSituTaskError, Interval, PlanError,
                                      Session, StreamSpec, TaskSpec, Trigger,
                                      When, preset_names, register_preset)
from repro_torch.core.transport import (CallableSink, FileSink, FileSource,
                                        Frame, FrameCorruptError, MemorySink,
                                        Sink, Source, StreamGapError,
                                        StreamSink, StreamSource,
                                        TransportError, as_sink, connect,
                                        decode_frame_payload, send_directory)
from repro_torch.distributed.fault import StragglerMonitor

__all__ = [
    "CheckpointConfig", "CheckpointCorruptError", "CheckpointManager",
    "StragglerMonitor", "send_directory",
    "Adaptive", "Every", "FanoutStage", "InSituPlan", "InSituTaskError",
    "Interval", "Placement", "PlanError", "Session", "Stage", "StreamSpec",
    "TaskSpec", "TransientError", "Trigger", "When", "preset_names",
    "register_preset",
    "CallableSink", "FileSink", "FileSource", "Frame", "FrameCorruptError",
    "MemorySink", "Sink", "Source", "StreamGapError", "StreamSink",
    "StreamSource", "TransportError", "as_sink", "connect",
    "decode_frame_payload",
]
