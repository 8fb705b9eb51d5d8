"""Functional AdamW over trees of tensors.

Moments can be held in bf16 (``bf16_moments``) — halves optimizer-state
memory and checkpoint bytes; the update math still runs in f32. This is
also what makes the lossy-checkpoint policy sensible: moments are
noise-dominated statistics. ``update`` returns new tensors and leaves its
inputs as they were, as the JAX package's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.pytree import leaves, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    count: torch.Tensor       # () int32
    mu: PyTree                # first moment
    nu: PyTree                # second moment
    master: PyTree | None     # f32 master weights (None when params are f32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    bf16_moments: bool = True
    master_weights: bool = False   # keep f32 masters when params are bf16


def init(params: PyTree, cfg: AdamWConfig) -> AdamWState:
    mdt = torch.bfloat16 if cfg.bf16_moments else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    master = (tree_map(lambda p: p.to(torch.float32), params)
              if cfg.master_weights else None)
    dev = leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params),
                      master)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


@torch.no_grad()
def update(grads: PyTree, state: AdamWState, params: PyTree,
           cfg: AdamWConfig, lr: Optional[torch.Tensor] = None
           ) -> tuple[PyTree, AdamWState]:
    """Returns (new_params, new_state). ``lr`` overrides cfg.lr (schedules)."""
    lr = cfg.lr if lr is None else lr
    count = state.count + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
            if cfg.grad_clip > 0 else 1.0)
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, cf)
    c2 = 1.0 - torch.pow(cfg.b2, cf)

    def leaf(p, g, m, v, pm):
        g = g.to(torch.float32) * clip
        m32 = m.to(torch.float32) * cfg.b1 + g * (1.0 - cfg.b1)
        # max(v, 0): a lossy-restored second moment (error-bounded spectral
        # codec on checkpoint moments) may carry eps-scale negative values;
        # sqrt of those would poison the whole update with nan
        v32 = torch.clamp(v.to(torch.float32), min=0.0) * cfg.b2 \
            + g * g * (1.0 - cfg.b2)
        upd = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p32 = pm if pm is not None else p.to(torch.float32)
        if cfg.weight_decay > 0:
            upd = upd + cfg.weight_decay * p32
        p32_new = p32 - lr * upd
        return (p32_new.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype),
                p32_new)

    masters = state.master
    if masters is None:
        out = tree_map(lambda p, g, m, v: leaf(p, g, m, v, None),
                       params, grads, state.mu, state.nu)
    else:
        out = tree_map(leaf, params, grads, state.mu, state.nu, masters)
    pick = lambda i: _pick(out, params, i)
    return pick(0), AdamWState(count, pick(1), pick(2),
                               pick(3) if masters is not None else None)


def _pick(out: PyTree, like: PyTree, i: int) -> PyTree:
    """Field ``i`` of the per-leaf result tuples, in ``like``'s structure."""
    if isinstance(like, dict):
        return {k: _pick(out[k], v, i) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_pick(o, v, i) for o, v in zip(out, like))
    return out[i]
