"""p_o/p_i resource allocator + online performance model.

Host-only numpy; the port keeps its own copy of the JAX package's
``core/allocator.py``, with the same model and the same plans.

Reproduces the paper's two allocation findings and packages its §V future
work (a performance model that *chooses* the in-situ configuration):

  * Table I / F1: with p_o + p_i = p_t fixed, the best asynchronous split
    puts the application and the in-situ task at roughly equal duration —
    and the optimal p_i grows with scale because the in-situ task scales
    worse than the application.
  * F6: when the task is cheap relative to the resources, SYNC wins (the
    async staging overhead is no longer amortized); ASYNC pays off for
    expensive or poorly-scaling tasks.

Both sides are modelled with Amdahl curves  t(p) = serial + parallel / p,
fitted online from telemetry observations (least squares in 1/p). The model
then answers: best split for ASYNC, and SYNC-vs-ASYNC mode choice given the
per-firing staging overhead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class AmdahlModel:
    """t(p) = serial + parallel/p, fitted from (p, t) observations."""
    serial: float = 0.0
    parallel: float = 1.0
    observations: list[tuple[int, float]] = field(default_factory=list)

    def observe(self, p: int, t: float) -> None:
        self.observations.append((int(p), float(t)))
        self._fit()

    def _fit(self) -> None:
        obs = self.observations
        if len(obs) == 1:
            p, t = obs[0]
            # single point: assume fully parallel (optimistic until contradicted)
            self.serial, self.parallel = 0.0, t * p
            return
        a = np.array([[1.0, 1.0 / p] for p, _ in obs])
        b = np.array([t for _, t in obs])
        (s, par), *_ = np.linalg.lstsq(a, b, rcond=None)
        self.serial = max(float(s), 0.0)
        self.parallel = max(float(par), 0.0)

    def predict(self, p: int) -> float:
        return self.serial + self.parallel / max(p, 1)


@dataclass
class Plan:
    mode: str            # 'sync' | 'async'
    p_app: int
    p_insitu: int
    predicted_total_s: float
    detail: dict = field(default_factory=dict)


class Allocator:
    """Chooses the in-situ mode and the p_o/p_i split for a workflow.

    ``handoff_s``: per-firing hand-off cost (device->host + enqueue) — the
    part of async that is *never* hidden (paper §III-A "small but unavoidable
    overhead").
    """

    def __init__(self, p_total: int, *, handoff_s: float = 0.0) -> None:
        self.p_total = p_total
        self.handoff_s = handoff_s
        self.app = AmdahlModel()
        self.task = AmdahlModel()

    # -- observations (fed from Telemetry aggregates) -----------------------------

    def observe_app(self, p_app: int, seconds_per_step: float) -> None:
        self.app.observe(p_app, seconds_per_step)

    def observe_task(self, p_insitu: int, seconds_per_firing: float) -> None:
        self.task.observe(p_insitu, seconds_per_firing)

    # -- planning -------------------------------------------------------------

    def plan(self, n_steps: int, every: int) -> Plan:
        """Best (mode, split) for a run of n_steps with a task every ``every``."""
        n_fire = max(1, n_steps // max(every, 1))
        # SYNC: all resources for both phases, serialized (Fig. 1a)
        t_sync = (n_steps * self.app.predict(self.p_total)
                  + n_fire * (self.task.predict(self.p_total) + self.handoff_s))
        best_async: Optional[Plan] = None
        for p_i in range(1, self.p_total):
            p_o = self.p_total - p_i
            app_total = n_steps * (self.app.predict(p_o)
                                   + self.handoff_s * n_fire / n_steps)
            task_total = n_fire * self.task.predict(p_i)
            # Fig. 1b: both sides run concurrently; the longer one dominates,
            # plus the non-overlapped first hand-off / last task tail.
            tail = self.task.predict(p_i)
            total = max(app_total, task_total) + min(app_total, task_total) * 0.0 + tail
            if best_async is None or total < best_async.predicted_total_s:
                best_async = Plan("async", p_o, p_i, total, {
                    "app_total_s": app_total, "task_total_s": task_total})
        assert best_async is not None
        if t_sync <= best_async.predicted_total_s:
            return Plan("sync", self.p_total, 0, t_sync,
                        {"async_alternative_s": best_async.predicted_total_s})
        best_async.detail["sync_alternative_s"] = t_sync
        return best_async

    def balance_quality(self, plan: Plan) -> float:
        """|app - task| / max(...): ~0 at the paper's optimum (Table I)."""
        if plan.mode != "async":
            return 1.0
        a = plan.detail["app_total_s"]
        t = plan.detail["task_total_s"]
        return abs(a - t) / max(a, t, 1e-12)
