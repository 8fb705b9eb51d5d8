"""Fault tolerance: the straggler monitor the training loop feeds.

``StragglerMonitor`` keeps a per-host step-time EWMA and flags hosts
slower than ``factor`` x median. Mitigation policy (documented; the
``fault`` preset of the JAX package applies it): flagged hosts get their
in-situ p_i budget reduced first (in-situ work is the elastic slack on a
node), and if still slow they are scheduled for replacement at the next
checkpoint boundary.

The rest of the JAX package's ``distributed/fault.py`` (heartbeats, the
``fault`` preset's controller, elastic re-mesh planning) is not ported yet
(ROADMAP.md, queue 1: 'Distribution and faults').
"""
from __future__ import annotations


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
