"""Replica hydration: bring a serving replica up from a snapshot chain.

A new (or crashed) replica has two ways to reach serving state: re-prefill
the live traffic — recomputing work the fleet already did — or replay the
producer's ``serve_snapshot`` base+delta chain and start decoding from the
exact page pool the producer had. This module is the second path, the
point where snapshot chains stop being an artifact and become the
scale-out/failover mechanism:

  * **local** — the chain is already on disk (a shared filesystem, or a
    ``SnapshotStore`` object handed over in-process): replay + rebuild.
  * **tcp** — the producer mirrors every frame to ``tcp://host:port``
    (``SnapshotStore.set_mirror`` / the ``serve_snapshot`` preset's
    ``to`` option). The hydrator *listens* there, ingests frames into a
    local replica store until the chain replays end to end, then rebuilds
    — mid-serve, without stopping the producer.

Either way the result is ``PagedServingEngine.from_snapshot``: page pool
(empty for the ssm family, whose chain holds state leaves only), per-row
state (the hybrid family's SWA rings and SSM state, the ssm family's
mLSTM/sLSTM state), page tables, allocator free list + refcounts,
in-flight requests, and
registered prefixes all restored bit-identically, so the replica's next
decoded token matches the producer's — no prefill at all. Cold-replica
time-to-first-token is then the restore plus one decode step instead of
one prefill per active request. On CUDA the engine captures its decode
step as it is built and the snapshot is written into the captured buffers
in place, so the first token is one replay. The chain may come from
either package: the snapshot format is shared.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.core import transport
from repro_torch.serving.snapshot import SnapshotStore

__all__ = ["ReplicaHydrator", "hydrate_serving_engine"]


class ReplicaHydrator:
    """Rebuild a ``PagedServingEngine`` from a snapshot chain.

    ``source`` names where the chain lives:

    - a :class:`SnapshotStore` — used as-is (in-process handover),
    - a directory path — a chain persisted by ``serve_snapshot``'s
      ``directory`` option (or mirrored to disk by a consumer),
    - ``tcp://host:port`` — an address to **listen** on; point the
      producer's snapshot mirror at it and hydration completes as soon
      as a replayable base(+delta) prefix has streamed in.

    Over ``tcp://`` a ``hydrate(detach=False)`` keeps the producer's
    connection open after the engine is built, and :meth:`follow` tails
    the rest of the chain into ``store`` until the producer closes it: a
    replica that stays attached costs the producer's best-effort mirror
    no failed sends.
    """

    def __init__(self, source: Union[SnapshotStore, str], *,
                 stream: str = "kv_pages") -> None:
        self.stream = stream
        self._listen: Optional[tuple[str, int]] = None
        self._source: Optional[transport.StreamSource] = None
        if isinstance(source, SnapshotStore):
            self.store = source
        elif isinstance(source, str) and "://" in source:
            scheme, rest = transport.parse_url(source)
            if scheme != "tcp":
                raise ValueError(
                    f"hydration source must be a store, a directory, or a "
                    f"tcp:// listen address, got {source!r}")
            host, _, port = rest.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"tcp hydration source needs host:port, got {source!r}")
            self._listen = (host, int(port))
            self.store = SnapshotStore()         # filled by ingest
        else:
            if not os.path.isdir(str(source)):
                raise FileNotFoundError(
                    f"snapshot chain directory {source!r} does not exist")
            self.store = SnapshotStore(str(source))

    # -- readiness -----------------------------------------------------------

    def ready(self) -> bool:
        """True when the chain currently replays end to end."""
        return self.store.restorable(self.stream)

    def _consume_until_ready(self, ready: Callable[[], bool],
                             idle_timeout_s: float,
                             start_grace_s: Optional[float],
                             detach: bool, log) -> dict:
        from repro_torch.launch import consume

        host, port = self._listen  # type: ignore[misc]
        self._source = transport.StreamSource(host=host, port=port)
        try:
            return consume.consume_loop(
                self._source, store=self.store,
                idle_timeout_s=idle_timeout_s, start_grace_s=start_grace_s,
                stop=lambda _report: ready(), log=log)
        finally:
            if detach:
                self.close()

    def follow(self, *, idle_timeout_s: float = 5.0, log=print) -> dict:
        """After ``hydrate(detach=False)``: ingest the producer's further
        chain frames into ``store`` until its stream drains, then close
        the listener. Returns the consumer report of those frames."""
        from repro_torch.launch import consume

        if self._source is None:
            raise RuntimeError("nothing to follow: hydrate(detach=False) "
                               "from a tcp:// source first")
        try:
            return consume.consume_loop(self._source, store=self.store,
                                        idle_timeout_s=idle_timeout_s,
                                        log=log)
        finally:
            self.close()

    def close(self) -> None:
        """Close the listener and the producer connections (tcp:// only)."""
        if self._source is not None:
            self._source.close()
            self._source = None

    # -- the hydration entry point -------------------------------------------

    def hydrate(self, cfg, params, *, upto: Optional[int] = None,
                ready: Optional[Callable[[], bool]] = None,
                idle_timeout_s: float = 10.0,
                start_grace_s: Optional[float] = None,
                device: str | torch.device = "cuda",
                cuda_graph: bool = True, detach: bool = True,
                log=print) -> tuple[Any, dict]:
        """-> (engine, info): a serving engine at the snapshot's state.

        For a ``tcp://`` source this first listens and ingests mirrored
        frames until ``ready()`` (default: the chain is restorable); for
        local sources the chain must already replay. ``ready`` can demand
        more — e.g. a smoke run waits for a snapshot with in-flight
        requests. ``info`` reports where the state came from and how long
        the replay + rebuild took (the cold-replica TTFT numerator).
        ``device`` and ``cuda_graph`` go to
        ``PagedServingEngine.from_snapshot``; ``params`` must live on
        ``device``. ``detach=False`` keeps a tcp:// producer attached for
        :meth:`follow`.
        """
        from repro_torch.serving.pages import PagedServingEngine

        ready = ready if ready is not None else self.ready
        info: dict[str, Any] = {"stream": self.stream,
                                "mode": "tcp" if self._listen else "local"}
        if self._listen is not None:
            t0 = time.perf_counter()
            report = self._consume_until_ready(ready, idle_timeout_s,
                                               start_grace_s, detach, log)
            info["ingest_s"] = time.perf_counter() - t0
            info["frames_ingested"] = report["snapshot_frames"]
            info["address"] = report["address"]
            if not ready():
                self.close()
                raise TimeoutError(
                    f"no restorable {self.stream!r} chain arrived on "
                    f"{report['address']} (ingested "
                    f"{report['snapshot_frames']} frame(s))")
        t0 = time.perf_counter()
        step, leaves = self.store.restore(self.stream, upto=upto)
        engine = PagedServingEngine.from_snapshot(
            cfg, params, leaves, device=device, cuda_graph=cuda_graph)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)   # the copies are queued
        info["restore_s"] = time.perf_counter() - t0
        info["step"] = step
        info["active_requests"] = sum(
            a is not None for a in engine.active)
        info["prefixes"] = len(engine.prefix)
        log(f"hydrated {self.stream!r} at step {step}: "
            f"{info['active_requests']} in-flight request(s), "
            f"{info['prefixes']} registered prefix(es), "
            f"{info['restore_s'] * 1e3:.1f} ms replay+rebuild")
        return engine, info


def hydrate_serving_engine(source: Union[SnapshotStore, str], cfg, params,
                           *, stream: str = "kv_pages",
                           **kw) -> tuple[Any, dict]:
    """One-call convenience over :class:`ReplicaHydrator`."""
    return ReplicaHydrator(source, stream=stream).hydrate(cfg, params, **kw)
