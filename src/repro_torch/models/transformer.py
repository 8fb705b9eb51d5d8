"""Decoder-LM assembly, dense family: [GQA attn + SwiGLU] x N.

Layer parameters are stacked on a leading ``layers`` axis, as in the JAX
package, so a parameter tree crosses between the two packages unchanged.
The training forward walks the stack one block at a time (the JAX
package's ``lax.scan``), recomputing each block in the backward pass when
``cfg.remat`` (its ``jax.checkpoint``). Attention is the plain chunked
``flash_attention``: the training path has no TPU kernel to port, so
PyTorch autograd differentiates it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_rope, cross_entropy, embed,
                                       embed_spec, mlp, mlp_spec, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.params import ParamSpec

PyTree = Any


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


def gqa_attention(p, x: torch.Tensor, cfg: ModelConfig,
                  positions) -> torch.Tensor:
    q, k, v = project_qkv(p, x, cfg, positions)
    o = attn_lib.flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                 kv_chunk=cfg.kv_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


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


# ---------------------------------------------------------------------------
# Forward and train loss
# ---------------------------------------------------------------------------

def dense_block(p, x: torch.Tensor, cfg: ModelConfig,
                positions) -> torch.Tensor:
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + gqa_attention(p["attn"], xn, cfg, positions)
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], xn)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: (B, S) int. Returns (logits, aux_loss, loss_mask)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1: "
            f"'Other model families')")
    h = embed(params["embed"], tokens.long())
    loss_mask = torch.ones(tokens.shape, dtype=torch.float32,
                           device=tokens.device)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    for i in range(cfg.n_layers):
        p_i = tree_map(lambda t: t[i], params["blocks"])

        def body(x, p_i=p_i):
            return dense_block(p_i, x, cfg, positions)

        if cfg.remat and torch.is_grad_enabled():
            # the block draws no random numbers; saving the RNG state
            # would read the CUDA generator, which a graph capture refuses
            h = checkpoint(body, h, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = body(h)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return logits, aux, loss_mask


def train_loss(params: PyTree, cfg: ModelConfig,
               batch: dict) -> torch.Tensor:
    logits, aux, mask = forward(params, cfg, batch["tokens"])
    if "mask" in batch:
        mask = mask * batch["mask"]
    return cross_entropy(logits, batch["labels"], mask) + aux
