"""Synthetic token pipeline with host prefetch + in-situ preprocessing hooks.

The paper's future-work section names "integrating pre-processing as an
in-situ task of AI training" — this pipeline is built that way: generation
(synthetic corpus), preprocessing (packing/shifting into (tokens, labels)),
and device transfer run on p_o host threads *ahead* of the device, via a
bounded prefetch queue (the same StagingBuffer semantics, direction
reversed). The training loop only ever blocks when the pipeline falls behind,
and that wait is telemetered (``data/wait``) like every other phase.

Synthetic corpus: deterministic per-step numpy PRNG token draws with a
Zipf-like marginal, the same batches the JAX package draws for a seed and
step, plus the frontend-embedding stand-ins for [vlm]/[audio] archs.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.telemetry import Telemetry


@dataclass(frozen=True)
class BatchSpec:
    batch: int
    seq_len: int
    vocab_size: int
    frontend_tokens: int = 0
    d_model: int = 0


def batch_spec_for(cfg: ModelConfig, shape: ShapeConfig) -> BatchSpec:
    return BatchSpec(shape.global_batch, shape.seq_len, cfg.vocab_size,
                     cfg.frontend_tokens if cfg.frontend else 0, cfg.d_model)


def synth_batch(spec: BatchSpec, step: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic synthetic batch for one step (host-side numpy)."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    # Zipf-ish skew via squared uniform — cheap and stationary
    u = rng.random((spec.batch, spec.seq_len + 1))
    toks = (u * u * spec.vocab_size).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if spec.frontend_tokens:
        batch["prefix"] = rng.standard_normal(
            (spec.batch, spec.frontend_tokens, spec.d_model)).astype(np.float32)
    return batch


class Prefetcher:
    """Background producer of preprocessed batches (p_o-side threads)."""

    def __init__(self, spec: BatchSpec, *, depth: int = 2, seed: int = 0,
                 n_threads: int = 1, telemetry: Optional[Telemetry] = None,
                 preprocess=None) -> None:
        self.spec = spec
        self.seed = seed
        self.preprocess = preprocess
        self._telemetry = telemetry
        self._q: "queue.Queue[tuple[int, dict]]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = 0
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._produce, name=f"data-{i}", daemon=True)
            for i in range(n_threads)]
        for t in self._threads:
            t.start()

    def _produce(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                step = self._next
                self._next += 1
            batch = synth_batch(self.spec, step, self.seed)
            if self.preprocess is not None:
                batch = self.preprocess(step, batch)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        step, batch = self._q.get()
        t1 = time.perf_counter()
        if self._telemetry is not None and t1 - t0 > 1e-5:
            self._telemetry.record("data/wait", t0, t1, step=step)
        return batch

    def close(self) -> None:
        self._stop.set()
        # unblock producers stuck on a full queue
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
