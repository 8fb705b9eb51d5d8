"""Hymba-style hybrid block: parallel attention + SSM heads, fused output.

Each block runs a (sliding-window or global) attention branch and a
Mamba-style SSM branch on the same normed input; the two branch outputs
are normalized and mean-fused with learned per-channel gains (the Hymba
fusion), then a SwiGLU FFN follows. hymba-1.5b's 32 layers are global at
0, 16 and 31 and sliding-window elsewhere, so a walk over the layers
meets runs of one kind (:func:`layer_runs`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamSpec


def global_layer_ids(cfg: ModelConfig) -> tuple:
    """First / middle / last layers are global-attention (Hymba placement)."""
    n = cfg.n_layers
    g = cfg.n_global_layers
    if g <= 0:
        return ()
    if g == 1:
        return (0,)
    if g == 2:
        return (0, n - 1)
    return (0, n // 2, n - 1) if g == 3 else tuple(
        round(i * (n - 1) / (g - 1)) for i in range(g))


def layer_runs(cfg: ModelConfig) -> list:
    """The layers in order as runs of one kind: ``(is_global, first,
    count)``, ``first`` the run's index into its kind's stack
    (``global_blocks`` or ``swa_blocks``). hymba-1.5b: g, s x 15, g,
    s x 14, g."""
    gids = set(global_layer_ids(cfg))
    runs, next_idx = [], {True: 0, False: 0}
    for i in range(cfg.n_layers):
        is_g = i in gids
        if runs and runs[-1][0] == is_g:
            runs[-1][2] += 1
        else:
            runs.append([is_g, next_idx[is_g], 1])
        next_idx[is_g] += 1
    return [tuple(r) for r in runs]


def fusion_spec(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    d = cfg.d_model

    def mk(shape, axes, **kw):
        if layers is not None:
            shape = (layers,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes, **kw)

    return {
        "attn_norm": mk((d,), ("embed",), dtype=torch.float32, init="ones"),
        "ssm_norm": mk((d,), ("embed",), dtype=torch.float32, init="ones"),
        "attn_gain": mk((d,), ("embed",), dtype=torch.float32, init="ones"),
        "ssm_gain": mk((d,), ("embed",), dtype=torch.float32, init="ones"),
    }


def fuse(pf, attn_out: torch.Tensor, ssm_out: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    a = rmsnorm({"scale": pf["attn_norm"]}, attn_out, cfg.norm_eps)
    s = rmsnorm({"scale": pf["ssm_norm"]}, ssm_out, cfg.norm_eps)
    out = 0.5 * (a.float() * pf["attn_gain"] + s.float() * pf["ssm_gain"])
    return out.to(attn_out.dtype)
