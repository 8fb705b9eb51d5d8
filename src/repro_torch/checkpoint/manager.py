"""CheckpointManager: the checkpoint workload as ONE registered pipeline.

Checkpointing is the paper's motivating I/O problem (restart files written
every few steps for walltime/failure reasons). The manager registers a
single declarative pipeline into a
:class:`~repro_torch.core.runtime.PipelineRuntime`:

    DeviceStage  (HYBRID only) spectral-lossy on the moment leaves — ONE
                 fused dispatch of the Hopper kernels for the whole tree;
                 the hand-off then ships int8 coefficients + scales
    Handoff      two-phase: the loop only *dispatches* the D2H copies of a
                 device-side clone (the loop updates its state in place);
                 ``state_to_host`` + bf16-key bookkeeping materialize on the
                 consumer side, overlapped with the next steps
    HostStage    'encode': lossless framing of every leaf — a FanoutStage
                 whose per-leaf items are stolen by idle runtime workers,
                 each additionally chunk-parallel on the shared codec pool
    Sink         'write': packed shard files (v2 offset-table layout;
                 ``shard_count`` byte-balanced ``shard_NNN.bin``) or, with
                 ``format=1``, one file per leaf -> manifest -> crash-safe
                 directory publish, then lock-guarded retention, then the
                 optional mirror

``leaf_parallel=False`` replaces the fan-out with one serial 'encode'
stage that walks every leaf on the worker running the chain (each lossy
leaf still on that worker's own CUDA stream); ``chunk_parallel=False``
keeps the chunks of a large leaf off the shared codec pool, on save and
on restore. Neither changes a stored byte.

SYNC / ASYNC / HYBRID are scheduling policies of the shared runtime, not
manager code paths. Durability: blobs -> manifest -> atomic directory
rename; a reader never observes a partial checkpoint. Retention keeps the
newest K (guarded by the manager lock).
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import serialization as ser
from repro_torch.core import codecs, transport
from repro_torch.core.runtime import (FanoutStage, PipelineRuntime,
                                      PipelineTask, Placement, Stage,
                                      default_handoff)
from repro_torch.core.telemetry import Telemetry

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d{9})$")


def default_lossy_policy(key: str) -> bool:
    """Lossy only for optimizer moments (noise-dominated statistics)."""
    return (".mu" in key or ".nu" in key or "'mu'" in key or "'nu'" in key
            or "moment" in key)


@dataclass
class CheckpointConfig:
    directory: str
    mode: Placement = Placement.ASYNC
    every: int = 100
    keep: int = 3
    lossless: str = "zlib"
    lossy_eps: float = 1e-2
    lossy_moments: bool = True
    p_i: int = 2                      # workers for a manager-owned runtime
    staging_capacity: int = 2
    chunk_parallel: bool = True       # fan leaf chunks out on the codec pool
    format: int = ser.CHECKPOINT_FORMAT  # 2: packed shards; 1: file per leaf
    shard_count: int = 1              # v2: number of shard_NNN.bin files
    leaf_parallel: bool = True        # fan encode out per leaf on the pool
    mirror: Optional[str] = None      # transport URL replicating committed
                                      # steps (file:// | memory:// | tcp://)
    # where the lossy stage of the non-hybrid placements runs and where
    # restore decodes (HYBRID compresses where the state lives)
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.every < 1:
            raise ValueError(
                f"CheckpointConfig.every must be >= 1, got {self.every}: "
                "maybe_save gates on step % every; use save() directly for "
                "one-off checkpoints")
        if self.keep < 0:
            raise ValueError(
                f"CheckpointConfig.keep must be >= 0, got {self.keep}")
        if self.format not in (1, ser.CHECKPOINT_FORMAT):
            raise ValueError(
                f"CheckpointConfig.format must be 1 (per-leaf files) or "
                f"{ser.CHECKPOINT_FORMAT} (packed shards), got {self.format}")
        if self.shard_count < 1:
            raise ValueError(
                f"CheckpointConfig.shard_count must be >= 1, "
                f"got {self.shard_count}")


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig,
                 telemetry: Optional[Telemetry] = None,
                 runtime: Optional[PipelineRuntime] = None) -> None:
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        # crash recovery: drop unpublished tmp dirs from dead saves and
        # re-publish a copy stranded mid-commit (see ser.sweep_stale)
        ser.sweep_stale(cfg.directory)
        self.reports: list[ser.SaveReport] = []
        self.mirror_stats = {"steps": 0, "frames": 0, "failures": 0}
        self._mirror = (transport.connect(cfg.mirror, stream="checkpoint")
                        if cfg.mirror else None)
        self._lock = threading.Lock()
        self._owns_runtime = runtime is None
        if runtime is None:
            self.telemetry = telemetry or Telemetry()
            runtime = PipelineRuntime(
                workers=cfg.p_i, staging_capacity=cfg.staging_capacity,
                telemetry=self.telemetry)
        else:
            if telemetry is not None and telemetry is not runtime.telemetry:
                raise ValueError(
                    "pass either a telemetry or a runtime (whose telemetry "
                    "is used), not two different objects")
            self.telemetry = runtime.telemetry
        self.runtime = runtime
        device_stage = (self._device_lossy
                        if cfg.mode is Placement.HYBRID and cfg.lossy_moments
                        else None)
        encode = (FanoutStage("encode", split=self._encode_split,
                              fn=self._encode_leaf_item,
                              gather=self._encode_gather)
                  if cfg.leaf_parallel
                  else Stage("encode", self._encode_stage))
        self._task = self.runtime.register(PipelineTask(
            name="checkpoint",
            source="ckpt_state",
            placement=cfg.mode,
            every=1,                 # save()/maybe_save gate on cfg.every
            device_stage=device_stage,
            handoff=self._handoff,
            host_stages=(encode,),
            sink=self._write_sink,
        ))

    # -- pipeline stages ------------------------------------------------------

    def _lossy_policy(self) -> Optional[Callable[[str], bool]]:
        return default_lossy_policy if self.cfg.lossy_moments else None

    def _device_lossy(self, step: int, payload: tuple) -> tuple:
        """Device stage (HYBRID): spectral-lossy the moment leaves."""
        from repro_torch.kernels import ops as kops
        state, meta = payload
        state = kops.spectral_compress_tree(state, self.cfg.lossy_eps,
                                            default_lossy_policy)
        return state, meta

    def _handoff(self, payload: tuple) -> dict:
        """Device->host transfer (the runtime's copies) + bf16 bookkeeping
        (numpy has no bf16: those leaves travel as their bit pattern)."""
        state, meta = default_handoff(payload)
        return {"state": ser.state_to_host(state),
                "bf16_keys": ser.bf16_keys(state), "meta": meta or {}}

    def _codec_pool(self):
        return codecs.codec_pool() if self.cfg.chunk_parallel else None

    def _encode_kw(self) -> dict:
        return dict(lossless=self.cfg.lossless, eps=self.cfg.lossy_eps,
                    lossy_policy=self._lossy_policy(),
                    pool=self._codec_pool(), device=self.cfg.device)

    def _encode_stage(self, step: int, payload: dict) -> dict:
        """Serial host stage (``leaf_parallel=False``): walk every leaf."""
        encoded = ser.encode_blobs(payload["state"],
                                   bf16_keys=payload["bf16_keys"],
                                   **self._encode_kw())
        return {"encoded": encoded, "meta": payload["meta"]}

    # leaf-parallel encode: one work item per leaf, stolen by idle runtime
    # workers (FanoutStage), gathered before the sink so the commit protocol
    # (blobs -> manifest -> rename) is unchanged

    def _encode_split(self, step: int, payload: dict) -> list:
        bf16 = payload["bf16_keys"]
        return [(key, arr, bf16) for key, arr in payload["state"].items()]

    def _encode_leaf_item(self, step: int, item: tuple) -> tuple:
        key, arr, bf16 = item
        return key, ser.encode_leaf(key, arr, bf16_keys=bf16,
                                    **self._encode_kw())

    def _encode_gather(self, step: int, payload: dict, results: list) -> dict:
        return {"encoded": dict(results), "meta": payload["meta"]}

    def _write_sink(self, step: int, payload: dict) -> ser.SaveReport:
        """Sink: atomic write (blobs -> manifest -> rename) + retention."""
        tmp = os.path.join(self.cfg.directory, f".tmp_step_{step:09d}")
        final = os.path.join(self.cfg.directory, f"step_{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        if self.cfg.format >= ser.CHECKPOINT_FORMAT:
            entries = ser.write_encoded_shards(tmp, payload["encoded"],
                                               self.cfg.shard_count)
        else:
            entries = ser.write_encoded(tmp, payload["encoded"])
        ser.write_manifest(tmp, step, entries, payload["meta"])
        ser.commit(tmp, final)
        self._mirror_committed(step, final)
        raw = sum(e["raw_bytes"] for e in entries.values())
        stored = sum(e["bytes"] for e in entries.values())
        report = ser.SaveReport(step, raw, stored, len(entries),
                                sum(1 for e in entries.values() if e["lossy"]))
        with self._lock:
            self.reports.append(report)
            # retention under the lock: concurrent async workers would
            # otherwise interleave list_steps()/rmtree
            self._retain_locked()
        return report

    def _mirror_committed(self, step: int, final: str) -> None:
        """Replicate a committed step through the secondary transport, one
        file frame per file with the manifest last. Best-effort, strictly
        after the local commit: a dead replica counts a failure in
        ``mirror_stats`` instead of raising (a retry would re-commit an
        already-committed checkpoint)."""
        if self._mirror is None:
            return
        try:
            n = transport.send_directory(
                self._mirror, step, final,
                prefix=os.path.basename(final), stream="checkpoint")
            with self._lock:
                self.mirror_stats["steps"] += 1
                self.mirror_stats["frames"] += n
        except Exception:  # noqa: BLE001 - replication never blocks saves
            with self._lock:
                self.mirror_stats["failures"] += 1

    def _retain_locked(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.cfg.keep] if self.cfg.keep > 0 else []:
            shutil.rmtree(os.path.join(self.cfg.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- write path -----------------------------------------------------------

    def save(self, step: int, state: PyTree, meta: Optional[dict] = None) -> None:
        """Checkpoint one training state via the registered pipeline."""
        self.runtime.submit(step, {"ckpt_state": lambda: (state, meta)})

    def maybe_save(self, step: int, state: PyTree,
                   meta: Optional[dict] = None) -> bool:
        if step % self.cfg.every:
            return False
        self.save(step, state, meta)
        return True

    # -- read path ------------------------------------------------------------

    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.cfg.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.cfg.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: Optional[int] = None,
                device: Optional[str | torch.device] = None
                ) -> tuple[int, PyTree]:
        """Restore ``step`` (default: the newest) as tensors on ``device``
        (default: the config's, the card unless set)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.cfg.directory}")
        d = os.path.join(self.cfg.directory, f"step_{step:09d}")
        with self.telemetry.span("checkpoint/restore", step=step):
            state = ser.read_state(d, template,
                                   device if device is not None
                                   else self.cfg.device,
                                   pool=self._codec_pool())
        return step, state

    def read_meta(self, step: Optional[int] = None) -> dict:
        """The meta dict recorded with a checkpoint's manifest (latest step
        when ``step`` is None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.cfg.directory}")
        d = os.path.join(self.cfg.directory, f"step_{step:09d}")
        return dict(ser.read_manifest(d).get("meta") or {})

    # -- lifecycle ------------------------------------------------------------

    def finish(self) -> None:
        if self._owns_runtime:
            self.runtime.drain()
        if self._mirror is not None:
            try:
                self._mirror.close()
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass

    def wait_idle(self, timeout: float = 600.0) -> None:
        """Block until queued checkpoints are written."""
        self.runtime.wait_idle(timeout=timeout)
