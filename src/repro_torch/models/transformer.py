"""Decoder-LM assembly, dense family: [GQA attn + SwiGLU] x N.

Layer parameters are stacked on a leading ``layers`` axis, as in the JAX
package, so a parameter tree crosses between the two packages unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_rope, embed_spec, mlp_spec,
                                       rmsnorm, rmsnorm_spec)
from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------------------
# GQA attention params + apply
# ---------------------------------------------------------------------------

def attn_spec(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    d, h, n, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def mk(shape, axes, **kw):
        if layers is not None:
            shape = (layers,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes, **kw)

    spec = {
        "wq": mk((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": mk((d, n, hd), ("embed", "kv_heads", "head_dim")),
        "wv": mk((d, n, hd), ("embed", "kv_heads", "head_dim")),
        "wo": mk((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = mk((h, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = mk((n, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = mk((n, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        spec["q_norm"] = mk((hd,), ("head_dim",), dtype=torch.float32,
                            init="ones")
        spec["k_norm"] = mk((hd,), ("head_dim",), dtype=torch.float32,
                            init="ones")
    return spec


def project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dnk->bsnk", x, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Param spec for the whole model
# ---------------------------------------------------------------------------

def _dense_block_spec(cfg: ModelConfig, layers: int, d_ff: int) -> dict:
    return {
        "ln1": rmsnorm_spec(cfg.d_model, layers),
        "ln2": rmsnorm_spec(cfg.d_model, layers),
        "mlp": mlp_spec(cfg.d_model, d_ff, layers),
        "attn": attn_spec(cfg, layers),
    }


def param_spec(cfg: ModelConfig) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1: "
            f"'Other model families')")
    return {
        "embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                            cfg.tie_embeddings),
        "blocks": _dense_block_spec(cfg, cfg.n_layers, cfg.d_ff),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
