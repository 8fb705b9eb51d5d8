"""Functional AdamW over trees of tensors.

Moments can be held in bf16 (``bf16_moments``) — halves optimizer-state
memory and checkpoint bytes; the update math still runs in f32. This is
also what makes the lossy-checkpoint policy sensible: moments are
noise-dominated statistics. ``update`` returns new tensors and leaves its
inputs as they were, as the JAX package's does; ``update_`` writes the
same bits into its inputs, leaf by leaf (the captured train step's
counterpart of the JAX package's donated buffers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.pytree import (flatten_with_path, keystr, leaves,
                                     tree_map, unflatten_like)

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


def layer_square_sums(x: torch.Tensor, depth: int = 0) -> list:
    """The f32 sum of squares of each slice of ``x`` along its leading
    ``depth`` (layer) axes, in row-major order; of all ``x`` at depth 0.
    The squares are taken over the whole leaf at once (one f32 leaf
    alive, as a whole-leaf sum has), then summed slice by slice."""
    sq = torch.square(x.to(torch.float32))
    if not depth:
        return [torch.sum(sq)]
    return [torch.sum(p) for p in
            sq.reshape((-1,) + tuple(x.shape[depth:])).unbind(0)]


def sum_squares(sums: list) -> torch.Tensor:
    """The total of per-leaf lists of :func:`layer_square_sums`, leaf by
    leaf in order, each leaf's slices in order: the one order in which
    the one-device and the sharded steps add them up."""
    return sum(sum(leaf) for leaf in sums)


def global_norm(tree: PyTree, depths: Optional[PyTree] = None
                ) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree``; ``depths`` (a tree of ints,
    ``transformer.layer_depths``) sums a stacked leaf slice by slice, layer
    by layer, as the sharded step sums a block's gradient."""
    xs = leaves(tree)
    ds = leaves(depths) if depths is not None else [0] * len(xs)
    return torch.sqrt(sum_squares([layer_square_sums(x, d)
                                   for x, d in zip(xs, ds)]))


def _leaf_update(cfg: AdamWConfig, clip, c1, c2, lr, p, g, m, v, pm):
    """One leaf's AdamW step: (new param, mu, nu, master or None)."""
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
    # the f32 parameter is kept only as the new master weight: without
    # master weights it is dropped here, not held for every leaf until
    # the whole tree is updated (4 bytes a parameter: 14.4 GB at
    # full-width xlstm-1.3b)
    return (p32_new.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype),
            p32_new if pm is not None else None)


def _scalars(grads: PyTree, state: AdamWState, cfg: AdamWConfig, lr,
             gnorm):
    """(lr, new count, clip, c1, c2) of one step."""
    lr = cfg.lr if lr is None else lr
    count = state.count + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
            if cfg.grad_clip > 0 else 1.0)
    cf = count.to(torch.float32)
    return (lr, count, clip, 1.0 - torch.pow(cfg.b1, cf),
            1.0 - torch.pow(cfg.b2, cf))


def _each_leaf(grads: PyTree, state: AdamWState, params: PyTree,
               cfg: AdamWConfig, lr, gnorm):
    """The new count, and an iterator over the leaves in flatten order:
    ``(key, (param, mu, nu, master or None), their new values)``, each
    leaf's update computed as it is drawn."""
    lr, count, clip, c1, c2 = _scalars(grads, state, cfg, lr, gnorm)
    flat = flatten_with_path(params)
    masters = (leaves(state.master) if state.master is not None
               else [None] * len(flat))

    def each():
        for (path, p), g, m, v, pm in zip(flat, leaves(grads),
                                          leaves(state.mu),
                                          leaves(state.nu), masters):
            yield keystr(path), (p, m, v, pm), _leaf_update(
                cfg, clip, c1, c2, lr, p, g, m, v, pm)

    return count, each()


@torch.no_grad()
def update(grads: PyTree, state: AdamWState, params: PyTree,
           cfg: AdamWConfig, lr: Optional[torch.Tensor] = None, *,
           gnorm: Optional[torch.Tensor] = None
           ) -> tuple[PyTree, AdamWState]:
    """Returns (new_params, new_state). ``lr`` overrides cfg.lr (schedules).
    ``gnorm`` is the global norm the clip uses where ``grads`` are one
    rank's shards of the gradient (the sharded step), by default
    ``global_norm(grads)``."""
    count, each = _each_leaf(grads, state, params, cfg, lr, gnorm)
    new = {key: n for key, _, n in each}
    field = lambda i, what: unflatten_like(
        params, {k: n[i] for k, n in new.items()}, what)
    return field(0, "params"), AdamWState(
        count, field(1, "mu"), field(2, "nu"),
        field(3, "master") if state.master is not None else None)


@torch.no_grad()
def update_(grads: PyTree, state: AdamWState, params: PyTree,
            cfg: AdamWConfig, lr: Optional[torch.Tensor] = None, *,
            gnorm: Optional[torch.Tensor] = None) -> None:
    """:func:`update` written into ``params``, ``state``'s moments, masters
    and count, one leaf at a time: the same bits, with one leaf's new
    tensors alive at a time where :func:`update` holds a whole new tree
    beside the old (the state's size again: 21.6 GB at full-width
    xlstm-1.3b)."""
    count, each = _each_leaf(grads, state, params, cfg, lr, gnorm)
    for _, old, new in each:
        for dst, src in zip(old, new):
            if dst is not None:
                dst.copy_(src)
        del new
    state.count.copy_(count)


@torch.no_grad()
def dry_update(grads: PyTree, state: AdamWState, params: PyTree,
               cfg: AdamWConfig, lr: Optional[torch.Tensor] = None, *,
               gnorm: Optional[torch.Tensor] = None) -> None:
    """:func:`update_`'s arithmetic, each leaf's new tensors dropped as
    they are made: nothing is written, and one leaf's new tensors are
    alive at a time (a captured step's warm-up, which must advance
    nothing, runs it in place of :func:`update`'s second state)."""
    _, each = _each_leaf(grads, state, params, cfg, lr, gnorm)
    for _ in each:
        pass
