"""Decoder-LM assembly, dense, MoE, hybrid and ssm (xLSTM) families.

  dense  : [GQA attn + SwiGLU] x N
  moe    : [attn (MLA or GQA) + (dense | MoE) ffn], the leading
           ``first_dense`` layers dense; deepseek's MTP head in the loss
  hybrid : [parallel attn + SSM, fused + SwiGLU] x N (hymba), the
           global layers full attention and the rest a sliding window
  ssm    : [(slstm_every - 1) x mLSTM + sLSTM] super-blocks (xLSTM), the
           mLSTM leaves stacked (n_super, slstm_every - 1, ...) on two
           ``layers`` axes and the sLSTM leaves (n_super, ...)

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
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import hymba
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
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


def project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions,
                rope: Optional[tuple] = None):
    """q, k, v of ``x`` with rotary positions; ``rope`` is
    ``layers.rope_table`` of ``positions`` when the caller has it."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dnk->bsnk", x, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def gqa_attention(p, x: torch.Tensor, cfg: ModelConfig, positions, *,
                  window: int = 0) -> torch.Tensor:
    q, k, v = project_qkv(p, x, cfg, positions)
    o = attn_lib.flash_attention(q, k, v, causal=True, window=window,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# Param spec for the whole model
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, layers: int) -> dict:
    if cfg.mla is not None:
        return mla_lib.mla_spec(cfg, layers)
    return attn_spec(cfg, layers)


def _dense_block_spec(cfg: ModelConfig, layers: int, d_ff: int) -> dict:
    return {
        "ln1": rmsnorm_spec(cfg.d_model, layers),
        "ln2": rmsnorm_spec(cfg.d_model, layers),
        "mlp": mlp_spec(cfg.d_model, d_ff, layers),
        "attn": _attn_spec(cfg, layers),
    }


def _moe_block_spec(cfg: ModelConfig, layers: int) -> dict:
    return {
        "ln1": rmsnorm_spec(cfg.d_model, layers),
        "ln2": rmsnorm_spec(cfg.d_model, layers),
        "moe": moe_lib.moe_spec(cfg, layers),
        "attn": _attn_spec(cfg, layers),
    }


def _hybrid_block_spec(cfg: ModelConfig, layers: int) -> dict:
    return {
        "ln1": rmsnorm_spec(cfg.d_model, layers),
        "ln2": rmsnorm_spec(cfg.d_model, layers),
        "attn": attn_spec(cfg, layers),
        "ssm": ssm_lib.ssm_spec(cfg, layers),
        "fusion": hymba.fusion_spec(cfg, layers),
        "mlp": mlp_spec(cfg.d_model, cfg.d_ff, layers),
    }


def _xlstm_spec(cfg: ModelConfig) -> dict:
    """The super-block stack: mLSTM leaves (n_super, slstm_every - 1, ...),
    sLSTM leaves (n_super, ...)."""
    x = cfg.xlstm
    n_super = cfg.n_layers // x.slstm_every
    restack = lambda lead, tree: tree_map(
        lambda s: ParamSpec(lead + s.shape, ("layers",) * len(lead) + s.axes,
                            s.dtype, s.init, s.scale), tree)
    return {"mlstm": restack((n_super, x.slstm_every - 1),
                             xlstm_lib.mlstm_spec(cfg)),
            "slstm": restack((n_super,), xlstm_lib.slstm_spec(cfg))}


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not carry yet, naming the ROADMAP
    item that brings it."""
    if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1: "
            f"'Other model families')")


def param_spec(cfg: ModelConfig) -> dict:
    check_family(cfg)
    spec: dict = {"embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                      cfg.tie_embeddings)}
    if cfg.family == "dense":
        spec["blocks"] = _dense_block_spec(cfg, cfg.n_layers, cfg.d_ff)
    elif cfg.family == "hybrid":
        n_global = len(hymba.global_layer_ids(cfg))
        spec["global_blocks"] = _hybrid_block_spec(cfg, n_global)
        spec["swa_blocks"] = _hybrid_block_spec(cfg, cfg.n_layers - n_global)
    elif cfg.family == "ssm":
        spec["super"] = _xlstm_spec(cfg)
    else:
        m = cfg.moe
        if m.first_dense:
            spec["dense_blocks"] = _dense_block_spec(
                cfg, m.first_dense, m.dense_d_ff or cfg.d_ff)
        spec["moe_blocks"] = _moe_block_spec(cfg, cfg.n_layers - m.first_dense)
        if cfg.mtp_weight > 0:
            spec["mtp"] = {
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                  ("embed", "embed")),
                "block": _dense_block_spec(
                    cfg, 1, m.dense_d_ff or 4 * cfg.d_model),
                "ln": rmsnorm_spec(cfg.d_model),
            }
    spec["final_norm"] = rmsnorm_spec(cfg.d_model)
    return spec


# ---------------------------------------------------------------------------
# Forward and train loss
# ---------------------------------------------------------------------------

def _attn_branch(p, xn: torch.Tensor, cfg: ModelConfig,
                 positions) -> torch.Tensor:
    if cfg.mla is not None:
        return mla_lib.mla_attention(p, xn, cfg, positions)
    return gqa_attention(p, xn, cfg, positions)


def dense_block(p, x: torch.Tensor, cfg: ModelConfig,
                positions) -> torch.Tensor:
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + _attn_branch(p["attn"], xn, cfg, positions)
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], xn)


def moe_block(p, x: torch.Tensor, cfg: ModelConfig, positions):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + _attn_branch(p["attn"], xn, cfg, positions)
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    y, aux = moe_lib.moe_ffn(p["moe"], xn, cfg)
    return x + y, aux


def hybrid_block(p, x: torch.Tensor, cfg: ModelConfig, positions, *,
                 window: int = 0) -> torch.Tensor:
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a = gqa_attention(p["attn"], xn, cfg, positions, window=window)
    s = ssm_lib.ssm_mixer(p["ssm"], xn, cfg)
    x = x + hymba.fuse(p["fusion"], a, s, cfg)
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], xn)


def _run_blocks(stacked, h: torch.Tensor, cfg: ModelConfig, body, aux):
    """One block per layer of a stacked tree; ``body(x, p) -> (x, aux)``,
    ``aux`` None for a block that has none. Under grad with ``cfg.remat`` each block is recomputed in the backward
    pass (the JAX package's ``jax.checkpoint`` per block)."""
    n = leaves(stacked)[0].shape[0]
    for i in range(n):
        p_i = tree_map(lambda t: t[i], stacked)
        fn = lambda x, p_i=p_i: body(x, p_i)
        if cfg.remat and torch.is_grad_enabled():
            # the block draws no random numbers; saving the RNG state
            # would read the CUDA generator, which a graph capture refuses
            h, a = checkpoint(fn, h, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, a = fn(h)
        if a is not None:
            aux = aux + a
    return h, aux


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: (B, S) int. Returns (logits, aux_loss, loss_mask)."""
    check_family(cfg)
    h = embed(params["embed"], tokens.long())
    loss_mask = torch.ones(tokens.shape, dtype=torch.float32,
                           device=tokens.device)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    dense = lambda x, p: (dense_block(p, x, cfg, positions), None)
    if cfg.family == "dense":
        h, _ = _run_blocks(params["blocks"], h, cfg, dense, aux)
    elif cfg.family == "hybrid":
        h = _hybrid_forward(params, cfg, h, positions)
    elif cfg.family == "ssm":
        h = _xlstm_forward(params, cfg, h)
    else:
        if cfg.moe.first_dense:
            h, _ = _run_blocks(params["dense_blocks"], h, cfg, dense, aux)
        h, aux = _run_blocks(params["moe_blocks"], h, cfg,
                             lambda x, p: moe_block(p, x, cfg, positions),
                             aux)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg.vocab_size)
    return logits, aux, loss_mask


def _hybrid_forward(params: PyTree, cfg: ModelConfig, h: torch.Tensor,
                    positions) -> torch.Tensor:
    """Global (full-attention) and SWA blocks in layer order, a run of
    one kind at a time (``hymba.layer_runs``)."""
    for is_g, first, count in hymba.layer_runs(cfg):
        stacked = params["global_blocks" if is_g else "swa_blocks"]
        part = tree_map(lambda t: t[first:first + count], stacked)
        window = 0 if is_g else cfg.swa_window
        h, _ = _run_blocks(
            part, h, cfg,
            lambda x, p, window=window: (hybrid_block(
                p, x, cfg, positions, window=window), None), None)
    return h


def _xlstm_forward(params: PyTree, cfg: ModelConfig,
                   h: torch.Tensor) -> torch.Tensor:
    """Each super-block's mLSTM layers, then its sLSTM layer, each block
    recomputed in the backward pass under ``cfg.remat``."""
    sup = params["super"]
    mlstm = lambda x, p: (xlstm_lib.mlstm_mixer(p, x, cfg), None)
    slstm = lambda x, p: (xlstm_lib.slstm_mixer(p, x, cfg)[0], None)
    for i in range(leaves(sup["slstm"])[0].shape[0]):
        h, _ = _run_blocks(tree_map(lambda t: t[i], sup["mlstm"]), h, cfg,
                           mlstm, None)
        h, _ = _run_blocks(tree_map(lambda t: t[i:i + 1], sup["slstm"]), h,
                           cfg, slstm, None)
    return h


def train_loss(params: PyTree, cfg: ModelConfig,
               batch: dict) -> torch.Tensor:
    logits, aux, mask = forward(params, cfg, batch["tokens"])
    if "mask" in batch:
        mask = mask * batch["mask"]
    loss = cross_entropy(logits, batch["labels"], mask)
    if cfg.family == "moe" and cfg.mtp_weight > 0:
        loss = loss + cfg.mtp_weight * _mtp_loss(params, cfg, batch)
    return loss + aux


def _mtp_loss(params: PyTree, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """DeepSeek-style multi-token prediction: one extra block predicts t+2.

    The JAX package's simplified MTP module: concat(embedding of the
    current tokens, embedding of the labels) -> projection -> one dense
    block -> the shared unembed, against the labels shifted by one (the
    last position masked).
    """
    emb = embed(params["embed"], batch["labels"].long())
    cur = embed(params["embed"], batch["tokens"].long())
    h = torch.cat([cur, emb], dim=-1)
    h = torch.einsum("bse,ed->bsd", h, params["mtp"]["proj"])
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    blk = tree_map(lambda t: t[0], params["mtp"]["block"])
    h = dense_block(blk, h, cfg, positions)
    h = rmsnorm(params["mtp"]["ln"], h, cfg.norm_eps)
    logits2 = unembed(params["embed"], h, cfg.vocab_size)
    labels2 = torch.roll(batch["labels"], -1, dims=1)
    mask2 = torch.ones(labels2.shape, dtype=torch.float32, device=h.device)
    mask2[:, -1] = 0.0
    if "mask" in batch:
        mask2 = mask2 * batch["mask"]
    return cross_entropy(logits2, labels2, mask2)
