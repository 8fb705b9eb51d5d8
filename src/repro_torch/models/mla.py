"""Multi-head Latent Attention (DeepSeek-V3) with the absorbed decode path.

Training/prefill materializes per-head K/V from the shared ``kv_lora``
latent and runs the chunked ``flash_attention`` with Dk = nope + rope keys
and Dv-wide values. Decode uses the *absorbed* form: queries are projected
into latent space (W_UK folded in), attention runs against the cached
latent and the shared rope key, and W_UV folds into the output projection,
so the cache holds (kv_lora + qk_rope) values per token and layer. Decode
attention here is plain tensor code, as in the JAX package: no TPU kernel
stands behind it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.params import ParamSpec


def mla_spec(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    m = cfg.mla
    h, d = cfg.n_heads, cfg.d_model
    qk = m.qk_nope + m.qk_rope

    def mk(shape, axes, **kw):
        if layers is not None:
            shape = (layers,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes, **kw)

    return {
        "wq_a": mk((d, m.q_lora), ("embed", "lora")),
        "q_norm": mk((m.q_lora,), ("lora",), dtype=torch.float32,
                     init="ones"),
        "wq_b": mk((m.q_lora, h, qk), ("lora", "heads", "head_dim")),
        "wkv_a": mk((d, m.kv_lora + m.qk_rope), ("embed", "lora")),
        "kv_norm": mk((m.kv_lora,), ("lora",), dtype=torch.float32,
                      init="ones"),
        "wk_b": mk((m.kv_lora, h, m.qk_nope), ("lora", "heads", "head_dim")),
        "wv_b": mk((m.kv_lora, h, m.v_head), ("lora", "heads", "head_dim")),
        "wo": mk((h, m.v_head, d), ("heads", "head_dim", "embed")),
    }


def _project_q(p, x, cfg: ModelConfig, positions):
    m = cfg.mla
    q_lat = torch.einsum("bsd,dl->bsl", x, p["wq_a"])
    q_lat = rmsnorm({"scale": p["q_norm"]}, q_lat, cfg.norm_eps)
    q = torch.einsum("bsl,lhk->bshk", q_lat, p["wq_b"])
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(p, x, cfg: ModelConfig, positions):
    m = cfg.mla
    kv = torch.einsum("bsd,dl->bsl", x, p["wkv_a"])
    c_kv, k_rope = kv[..., :m.kv_lora], kv[..., m.kv_lora:]
    c_kv = rmsnorm({"scale": p["kv_norm"]}, c_kv, cfg.norm_eps)
    # shared (MQA-style) rope key: one head
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def per_head_kv(p, c_kv, k_rope, cfg: ModelConfig):
    """Per-head keys [W_UK c ; k_rope] and values W_UV c from a latent
    sequence (B, S, kv_lora) and its shared rope key (B, S, qk_rope)."""
    b, s, _ = c_kv.shape
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["wk_b"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["wv_b"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, cfg.n_heads, cfg.mla.qk_rope)], dim=-1)
    return k, v


def mla_attention(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Training/prefill path: materialized per-head K/V, chunked flash."""
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(p, x, cfg, positions)
    k, v = per_head_kv(p, c_kv, k_rope, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attn_lib.flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                 kv_chunk=cfg.kv_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def mla_decode(p, x, cfg: ModelConfig, cache_ckv, cache_krope,
               length) -> torch.Tensor:
    """Absorbed decode: attention in latent space over the compressed cache.

    cache_ckv:   (B, S, kv_lora)  — already contains the current token's entry.
    cache_krope: (B, S, qk_rope)
    length:      (B,) valid prefix length including the current token.
    """
    m = cfg.mla
    pos = (length - 1)[:, None]  # current absolute position, (B,1)
    q_nope, q_rope = _project_q(p, x, cfg, pos)
    # absorb W_UK: q_lat[h] = q_nope[h] @ W_UK[h]^T  -> latent-space query
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, p["wk_b"])
    scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
    s_lat = torch.einsum("bshl,btl->bhst", q_lat, cache_ckv)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, cache_krope)
    scores = (s_lat + s_rope).float() * scale  # (B,H,1,S)
    valid = (torch.arange(cache_ckv.shape[1], device=x.device)[None, :]
             < length[:, None])
    scores = torch.where(valid[:, None, None, :], scores, attn_lib.NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btl->bshl", pr.to(cache_ckv.dtype), cache_ckv)
    # absorb W_UV into the output projection
    o = torch.einsum("bshl,lhk->bshk", o_lat, p["wv_b"])
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def mla_new_cache_entry(p, x, cfg: ModelConfig, positions):
    """(c_kv, k_rope) for the token(s) in x — what decode appends to the cache."""
    return _project_kv_latent(p, x, cfg, positions)
