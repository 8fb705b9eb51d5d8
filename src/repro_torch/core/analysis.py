"""In-situ analytics tasks — the framework's "image generation".

The paper's first in-situ task renders images from the live simulation state
(ParaView Catalyst) instead of writing 8-26 GB VTK files per step. The ML
analog renders *small summaries of the live training state* instead of
dumping tensors: histograms, norm sheets, spectral energy profiles, and a
low-res "heatmap image" of weight matrices. Each artifact is O(KB) where the
raw state is O(GB) — the same I/O-avoidance argument.

These run on host CPU over numpy (which releases the GIL in its inner loops),
so async workers genuinely overlap with the device step. ``work`` is a knob
(spectral profile depth / histogram passes) so benchmarks can scale the task
cost the way the paper scales image frequency (F3) and resolution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

PyTree = Any


@dataclass
class Artifact:
    """One rendered summary (the "image"). Tiny by construction."""
    step: int
    name: str
    stats: dict[str, float] = field(default_factory=dict)
    tables: dict[str, np.ndarray] = field(default_factory=dict)

    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tables.values()) + 16 * len(self.stats)


def tensor_summary(name: str, arr: np.ndarray, step: int, *,
                   bins: int = 64, work: int = 1,
                   image_px: int = 64) -> Artifact:
    """Histogram + norms + spectral profile + low-res heatmap for one tensor."""
    a = np.asarray(arr, dtype=np.float32).reshape(-1)
    art = Artifact(step, name)
    art.stats["l2"] = float(np.linalg.norm(a))
    art.stats["linf"] = float(np.max(np.abs(a))) if a.size else 0.0
    art.stats["mean"] = float(a.mean()) if a.size else 0.0
    art.stats["std"] = float(a.std()) if a.size else 0.0
    art.stats["frac_zero"] = float(np.mean(a == 0)) if a.size else 0.0
    hist, edges = np.histogram(a, bins=bins)
    art.tables["hist"] = hist.astype(np.int64)
    art.tables["hist_edges"] = edges.astype(np.float32)
    # spectral energy profile: rFFT power in log-spaced bands; ``work`` repeats
    # the transform on shifted copies (cost knob, like image supersampling)
    n = min(a.size, 1 << 16)
    if n >= 16:
        prof = np.zeros(32, np.float32)
        for w in range(max(1, work)):
            seg = a[w * 17 % max(1, a.size - n) if a.size > n else 0:][:n]
            p = np.abs(np.fft.rfft(seg)) ** 2
            idx = np.minimum(
                (np.log1p(np.arange(p.size)) / math.log1p(p.size) * 31).astype(int),
                31)
            prof += np.bincount(idx, weights=p, minlength=32)[:32].astype(np.float32)
        art.tables["spectrum"] = prof / max(1, work)
    # the "image": a low-res mean-pooled heatmap of the 2D-folded tensor
    side = int(math.sqrt(a.size))
    if side >= image_px:
        m = a[: side * side].reshape(side, side)
        f = side // image_px
        img = m[: f * image_px, : f * image_px].reshape(
            image_px, f, image_px, f).mean(axis=(1, 3))
        art.tables["image"] = img.astype(np.float32)
    return art


def summarize_tree(tree_of_np: Mapping[str, np.ndarray], step: int, *,
                   work: int = 1) -> list[Artifact]:
    return [tensor_summary(k, v, step, work=work)
            for k, v in sorted(tree_of_np.items())]


def gradient_health(grads: Mapping[str, np.ndarray], step: int) -> Artifact:
    """Single roll-up artifact: global grad norm, per-tensor norm sheet, NaN flags."""
    art = Artifact(step, "grad_health")
    sq, names, norms = 0.0, [], []
    any_nan = False
    for k, v in sorted(grads.items()):
        a = np.asarray(v, np.float32)
        n2 = float(np.sum(a * a))
        sq += n2
        names.append(k)
        norms.append(math.sqrt(n2))
        any_nan |= bool(np.isnan(a).any())
    art.stats["global_norm"] = math.sqrt(sq)
    art.stats["any_nan"] = float(any_nan)
    art.tables["norm_sheet"] = np.asarray(norms, np.float32)
    return art
