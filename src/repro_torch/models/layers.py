"""Shared layers: RMSNorm, SwiGLU MLP, embeddings, RoPE, cross-entropy."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_spec(dim: int, layers: Optional[int] = None) -> dict:
    shape = (dim,) if layers is None else (layers, dim)
    axes = ("embed",) if layers is None else ("layers", "embed")
    return {"scale": ParamSpec(shape, axes, torch.float32, init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_spec(d_model: int, d_ff: int, layers: Optional[int] = None) -> dict:
    def mk(shape, axes):
        if layers is not None:
            shape = (layers,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes)

    return {
        "w_gate": mk((d_model, d_ff), ("embed", "mlp")),
        "w_up": mk((d_model, d_ff), ("embed", "mlp")),
        "w_down": mk((d_ff, d_model), ("mlp", "embed")),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding (padded vocab; pad logits masked to the dtype min)
# ---------------------------------------------------------------------------

def embed_spec(padded_vocab: int, d_model: int, tie: bool) -> dict:
    out = {"embedding": ParamSpec((padded_vocab, d_model), ("vocab", "embed"),
                                  init="embed", scale=0.02)}
    if not tie:
        out["unembed"] = ParamSpec((d_model, padded_vocab), ("embed", "vocab"))
    return out


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params: dict, x: torch.Tensor, vocab_size: int) -> torch.Tensor:
    if "unembed" in params:
        logits = x @ params["unembed"]
    else:
        logits = x @ params["embedding"].T
    padded = logits.shape[-1]
    if padded != vocab_size:
        logits[..., vocab_size:] = torch.finfo(logits.dtype).min
    return logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles at ``positions`` (..., seq), each
    (..., seq, 1, head_dim // 2). A decode step computes them once and
    every layer's q and k reuse them (the same bits as computing them per
    call)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (half,)
    angles = positions[..., :, None].float() * freqs   # (..., seq, half)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               table: Optional[tuple] = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). ``table`` is
    :func:`rope_table` of the same positions, when the caller has it."""
    half = x.shape[-1] // 2
    cos, sin = (table if table is not None
                else rope_table(positions, x.shape[-1], theta))
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  gather_free: bool = False) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels < vocab_size always (pad
    columns carry the dtype minimum and never win).

    ``gather_free`` picks the gold logit by a compare and a sum over the
    vocabulary instead of a gather: the JAX package's formulation inside
    its partially-manual pod region, where XLA cannot partition a
    gather. One term of each sum is nonzero, so both give the same
    value; the sharded step's pod ring uses this one, as the JAX
    package's does."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if gather_free:
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(vocab == labels.long()[..., None],
                                     logits, 0.0), dim=-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
