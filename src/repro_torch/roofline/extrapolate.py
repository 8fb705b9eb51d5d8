"""Cost at full depth from lowerings of a few shallow variants.

The dry run (``launch/dryrun.py``) counts every operation of a cell at
full depth: the port's loops run in Python, so a lowering on fake tensors
issues each layer's, each chunk's and each time step's ops one by one
and nothing is counted once for many iterations. Where a full-depth
lowering would take too long, it lowers 2-3 variants of the config at a
few layers instead, fits the linear model

    cost = a + sum_t b_t * n_t        (t = block type: dense/moe/global/...)

and extrapolates to the full depth: 'a' is the depth-independent work
(embedding, unembedding and loss, the optimizer on leaves that are not
stacked, MTP), 'b_t' a block's, its collectives included. A test holds
the extrapolated count to the full-depth count.

The JAX package lowers its variants unrolled (``scan_layers=False``,
``unroll_scans=True``) because XLA's cost analysis counts a while loop's
body once, and it adds the sLSTM's per-token recurrent product
analytically (:func:`slstm_recurrent_flops`) for the one scan it keeps.
The port has neither knob (``_rep`` sets the depth only) and adds
nothing: its count already holds the recurrent ``bmm`` of every step.
:func:`slstm_recurrent_flops` stays as the check of that count.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _rep(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)


def depth_variants(cfg: ModelConfig):
    """[(variant_cfg, counts)], full_counts — linear-model sample points."""
    if cfg.family in ("dense", "audio", "vlm"):
        return ([(_rep(cfg, n_layers=1), {"L": 1}),
                 (_rep(cfg, n_layers=2), {"L": 2})],
                {"L": cfg.n_layers})
    if cfg.family == "moe":
        m = cfg.moe
        if m.first_dense:
            def mk(d, mm):
                return _rep(cfg, n_layers=d + mm,
                            moe=dataclasses.replace(m, first_dense=d))
            return ([(mk(1, 1), {"d": 1, "m": 1}),
                     (mk(1, 2), {"d": 1, "m": 2}),
                     (mk(2, 1), {"d": 2, "m": 1})],
                    {"d": m.first_dense, "m": cfg.n_layers - m.first_dense})
        return ([(_rep(cfg, n_layers=1), {"m": 1}),
                 (_rep(cfg, n_layers=2), {"m": 2})],
                {"m": cfg.n_layers})
    if cfg.family == "hybrid":
        def mk(g, s):
            return _rep(cfg, n_layers=g + s, n_global_layers=g)
        return ([(mk(1, 1), {"g": 1, "s": 1}),
                 (mk(1, 2), {"g": 1, "s": 2}),
                 (mk(2, 1), {"g": 2, "s": 1})],
                {"g": cfg.n_global_layers,
                 "s": cfg.n_layers - cfg.n_global_layers})
    if cfg.family == "ssm":
        e = cfg.xlstm.slstm_every
        return ([(_rep(cfg, n_layers=e), {"k": 1}),
                 (_rep(cfg, n_layers=2 * e), {"k": 2})],
                {"k": cfg.n_layers // e})
    raise ValueError(cfg.family)


def solve_and_extrapolate(samples: list[tuple[dict, float]],
                          full: dict) -> float:
    keys = sorted(full)
    a = np.array([[1.0] + [float(c.get(k, 0)) for k in keys]
                  for c, _ in samples])
    b = np.array([v for _, v in samples])
    coef, *_ = np.linalg.lstsq(a, b, rcond=None)
    val = coef[0] + sum(coef[1 + i] * full[k] for i, k in enumerate(keys))
    return float(max(val, 0.0))


def slstm_recurrent_flops(cfg: ModelConfig, shape: ShapeConfig,
                          train: bool) -> float:
    """The sLSTM recurrent product's FLOPs over a cell: 2 * 4 nh dh^2 a
    token and sLSTM layer forward, three times that with the backward
    (dh and dR)."""
    if cfg.family != "ssm":
        return 0.0
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    n_slstm = cfg.n_layers // cfg.xlstm.slstm_every
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    fwd = 2.0 * 4 * nh * dh * dh * tokens * n_slstm
    return fwd * (3.0 if train else 1.0)   # bwd ~ 2x fwd
