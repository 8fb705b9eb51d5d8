"""Capacity-based top-k MoE (GShard-style dispatch and combine products).

Expert weights are stacked on an ``expert`` axis, as in the JAX package.
Token streams are processed in fixed-size chunks, so the (chunk, experts,
capacity) dispatch tensor is bounded whatever the batch.

Routing: softmax router in f32, top-k, per-chunk capacity
C = ceil(chunk*k/E * cf). A (token, slot)'s place in its expert's queue is
a running count over the chunk's flattened ``t*k + s`` order; places at or
past C drop, and the combine weights keep the top-k weights renormalized
over all k slots (a dropped slot just contributes nothing). The aux
load-balance and router-z losses come back for the train loss.

Everything is tensor arithmetic on fixed shapes (one-hots are comparisons
against ``arange(E)``, no ``nonzero`` or boolean indexing, no host read),
so a decode step that runs it stays capturable in a CUDA graph.

The JAX package's placement helpers ``_ep_constraint``,
``_mesh_axis_names``, ``_dp_constraint``, ``_dp_constraint4`` and
``_gep_constraint`` have no counterpart: they are XLA sharding hints
(experts over 'model', dispatch groups over the data axes), like
``sharding.constrain``. The port's sharded step places tensors itself: it
gathers the expert weights and runs this module on a rank's rows, whose
token chunks are the global token list's (``launch/train.py`` checks
that they coincide).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.params import ParamSpec


def moe_spec(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    m = cfg.moe
    d = cfg.d_model

    def mk(shape, axes, **kw):
        if layers is not None:
            shape = (layers,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes, **kw)

    spec = {
        "router": mk((d, m.n_experts), ("embed", "expert"),
                     dtype=torch.float32),
        "w_gate": mk((m.n_experts, d, m.d_expert), ("expert", "embed", "e_mlp")),
        "w_up": mk((m.n_experts, d, m.d_expert), ("expert", "embed", "e_mlp")),
        "w_down": mk((m.n_experts, m.d_expert, d), ("expert", "e_mlp", "embed")),
    }
    if m.n_shared_experts:
        ds = m.d_expert * m.n_shared_experts
        spec.update({
            "shared_gate": mk((d, ds), ("embed", "mlp")),
            "shared_up": mk((d, ds), ("embed", "mlp")),
            "shared_down": mk((ds, d), ("mlp", "embed")),
        })
    return spec


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over a fixed class count (capturable: no host read)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(g.float()).to(u.dtype) * u


def route(router_w, x, m: MoEConfig, with_aux: bool = True):
    """(top-k expert ids, renormalized top-k weights, aux losses) over the
    tokens of ``x`` (..., T, D); the aux means run over every token.
    Without ``with_aux`` the aux is None and none of its work is
    launched."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, m.top_k, dim=-1)       # (..., T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if not with_aux:
        return top_e, top_w, None
    e = m.n_experts
    lead = tuple(range(probs.dim() - 1))
    dispatch_frac = torch.mean(_one_hot(top_e[..., 0], e), dim=lead)
    prob_frac = torch.mean(probs, dim=lead)
    aux = e * torch.sum(dispatch_frac * prob_frac)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return top_e, top_w, aux * m.router_aux_weight + z * m.router_z_weight


def _capacity(tokens: int, m: MoEConfig) -> int:
    return max(1, math.ceil(tokens * m.top_k / m.n_experts
                            * m.capacity_factor))


def _dispatch_combine(top_e, top_w, m: MoEConfig, chunk: int):
    """(..., T, E, C) 0/1 dispatch, combine weights and the capacity C of
    ``chunk`` tokens, from (..., T, k) routing: each (token, slot)'s place
    in its expert queue is the count of earlier (token, slot)s in
    ``t*k + s`` order routed to that expert."""
    cap = _capacity(chunk, m)
    e, k = m.n_experts, m.top_k
    *lead, t, _ = top_e.shape
    onehot = (top_e[..., None] == torch.arange(e, device=top_e.device)
              ).to(torch.int32)                               # (..., T, k, E)
    flat = onehot.reshape(*lead, t * k, e)
    pos = torch.cumsum(flat, dim=-2) - flat                   # slots before
    pos = torch.sum(pos * flat, dim=-1).reshape(*lead, t, k)
    keep = pos < cap
    disp = onehot.float() * keep[..., None]                   # (..., T, k, E)
    pos_oh = _one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
    # a token reaches an expert through at most one of its k slots, so
    # each (t, e, c) below sums one nonzero term: exact in any order
    dispatch = disp.transpose(-1, -2) @ pos_oh                # (..., T, E, C)
    combine = (disp * top_w.float()[..., None]).transpose(-1, -2) @ pos_oh
    return dispatch, combine, cap


def _expert_ffn(p, x_d: torch.Tensor) -> torch.Tensor:
    """x_d: (..., E, C, D) -> (..., E, C, D), per-expert SwiGLU (a batched
    product over the expert axis)."""
    g = x_d @ p["w_gate"]
    u = x_d @ p["w_up"]
    return _swiglu(g, u) @ p["w_down"]


def _gather(dispatch: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., T, E, C) 0/1 dispatch, (..., T, D) tokens -> (..., E, C, D)."""
    *lead, t, e, c = dispatch.shape
    flat = dispatch.to(x.dtype).reshape(*lead, t, e * c).transpose(-1, -2)
    return (flat @ x).reshape(*lead, e, c, x.shape[-1])


def _scatter(combine: torch.Tensor, y_d: torch.Tensor) -> torch.Tensor:
    """(..., T, E, C) combine weights, (..., E, C, D) -> (..., T, D)."""
    *lead, t, e, c = combine.shape
    return combine.to(y_d.dtype).reshape(*lead, t, e * c) \
        @ y_d.reshape(*lead, e * c, y_d.shape[-1])


def _grouped_body(p, xc: torch.Tensor, cfg: ModelConfig, with_aux: bool):
    """Grouped dispatch: the chunk (T, D) reshapes to (G, T/G, D) and each
    group routes, places and dispatches its own tokens (capacity per
    group). On one device this is the JAX package's DP-local variant with
    its group axis unsharded."""
    m = cfg.moe
    t, d = xc.shape
    g = min(m.n_groups, t)
    while t % g:
        g -= 1
    gs = t // g
    xg = xc.reshape(g, gs, d)
    top_e, top_w, aux = route(p["router"], xg, m, with_aux)
    dispatch, combine, _ = _dispatch_combine(top_e, top_w, m, gs)
    yg = _scatter(combine, _expert_ffn(p, _gather(dispatch, xg)))
    return yg.reshape(t, d), aux


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, *, with_aux: bool = True):
    """x: (B, S, D) -> (y, aux_loss). The token stream runs in chunks of
    ``token_chunk`` (one chunk of every token when that does not divide).
    Serving passes ``with_aux=False``: the aux loss is then None and not
    computed (the JAX package's jitted steps drop it as dead code)."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    chunk = min(m.token_chunk, t)
    if t % chunk:
        chunk = t  # smoke shapes
    n_chunks = t // chunk
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else None)
    ys = []
    for i in range(n_chunks):
        xc = tokens[i * chunk:(i + 1) * chunk]
        if m.grouped_dispatch:
            yc, aux_c = _grouped_body(p, xc, cfg, with_aux)
        else:
            top_e, top_w, aux_c = route(p["router"], xc, m, with_aux)
            dispatch, combine, _ = _dispatch_combine(top_e, top_w, m, chunk)
            yc = _scatter(combine, _expert_ffn(p, _gather(dispatch, xc)))
        if with_aux:
            aux = aux + aux_c
        ys.append(yc)
    y = (torch.cat(ys) if n_chunks > 1 else ys[0]).reshape(b, s, d)
    if m.n_shared_experts:
        g = x @ p["shared_gate"]
        u = x @ p["shared_up"]
        y = y + _swiglu(g, u) @ p["shared_down"]
    return y, (aux / n_chunks if with_aux else None)


def moe_ffn_reference(p, x, cfg: ModelConfig) -> np.ndarray:
    """Per-token loop oracle with the same capacity/drop semantics (tests):
    numpy in f32 over the tokens in order, counting every attempt (dropped
    ones too) toward its expert's queue."""
    m = cfg.moe
    as_np = lambda t: (t.detach().float().cpu().numpy()
                       if isinstance(t, torch.Tensor)
                       else np.asarray(t, np.float32))
    xs = as_np(x)
    b, s, d = xs.shape
    tokens = xs.reshape(-1, d)
    t = tokens.shape[0]
    chunk = min(m.token_chunk, t)
    if t % chunk:
        chunk = t
    logits = tokens @ as_np(p["router"])
    w_gate, w_up, w_down = (as_np(p[k]) for k in ("w_gate", "w_up", "w_down"))
    out = np.zeros_like(tokens)
    e = m.n_experts
    cap = _capacity(chunk, m)
    for c0 in range(0, t, chunk):
        attempts = np.zeros(e, np.int64)
        for i in range(c0, c0 + chunk):
            lg = logits[i]
            probs = np.exp(lg - lg.max())
            probs /= probs.sum()
            top = np.argsort(-probs, kind="stable")[: m.top_k]
            w = probs[top] / max(probs[top].sum(), 1e-9)
            for ee, ww in zip(top, w):
                position = attempts[ee]
                attempts[ee] += 1
                if position >= cap:
                    continue
                g = tokens[i] @ w_gate[ee]
                u = tokens[i] @ w_up[ee]
                h = (g / (1 + np.exp(-g))) * u
                out[i] += ww * (h @ w_down[ee])
    y = out.reshape(b, s, d)
    if m.n_shared_experts:
        g = xs @ as_np(p["shared_gate"])
        u = xs @ as_np(p["shared_up"])
        h = (g / (1 + np.exp(-g))) * u
        y = y + h @ as_np(p["shared_down"])
    return y
