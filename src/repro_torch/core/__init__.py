"""The in-situ runtime (the paper's contribution), ported to PyTorch.

New code uses the declarative API (``repro_torch.insitu``, implemented in
``repro_torch.core.session``); ``InSituEngine``/``run_workflow``/
``run_pipeline`` are deprecation shims over it.
"""
from repro_torch.core.insitu import (InSituEngine, InSituMode, InSituTask,
                                     run_workflow)
from repro_torch.core.runtime import (FanoutStage, PipelineRuntime,
                                      PipelineTask, Placement, Stage,
                                      TaskResult, TransientError,
                                      run_pipeline, split_payload)
from repro_torch.core.session import (Adaptive, Every, InSituPlan,
                                      InSituTaskError, Interval, PlanError,
                                      Session, StreamSpec, TaskSpec, When,
                                      preset_names, register_preset)
from repro_torch.core.staging import PendingHandoff, StagedItem, StagingBuffer
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.transport import (CallableSink, FileSink, FileSource,
                                        Frame, FrameCorruptError, MemorySink,
                                        Sink, Source, StreamGapError,
                                        StreamSink, StreamSource,
                                        TransportError, as_sink, connect)

__all__ = ["InSituEngine", "InSituMode", "InSituTask", "run_workflow",
           "FanoutStage", "PipelineRuntime", "PipelineTask", "Placement",
           "Stage", "TaskResult", "TransientError", "run_pipeline",
           "split_payload",
           "Adaptive", "Every", "InSituPlan", "InSituTaskError", "Interval",
           "PlanError", "Session", "StreamSpec", "TaskSpec", "When",
           "preset_names", "register_preset",
           "PendingHandoff", "StagedItem", "StagingBuffer", "Telemetry",
           "CallableSink", "FileSink", "FileSource", "Frame",
           "FrameCorruptError", "MemorySink", "Sink", "Source",
           "StreamGapError", "StreamSink", "StreamSource", "TransportError",
           "as_sink", "connect"]
