"""Selective SSM (Mamba-style) mixer: chunked parallel scan + O(1) decode.

Training and prefill cut the sequence into ``chunk``-sized pieces; within
a chunk the linear recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t

is evaluated as a log-depth inclusive scan over the chunk (the JAX
package's ``lax.associative_scan``, here written out as Hillis-Steele
doubling steps of whole-tensor ops), and one (d_inner, d_state) state is
carried across chunks. Decode is the exact single-step recurrence on the
carried state. The scan adds in another order than XLA's, so the two
packages agree to a tolerance, not bitwise.

Under grad with ``cfg.remat`` each chunk's scan is recomputed in the
backward pass (``torch.utils.checkpoint``, as ``transformer._run_blocks``
does per block): a chunk's doubling steps keep ~14 f32 tensors of
(B, chunk, d_inner, d_state) for its backward, 1.5 GB a chunk at
hymba-1.5b's width and 4 x 128 tokens, so one block's backward holds one
chunk's scan instead of all of them. The arithmetic and its order are
the same, so the loss and the gradients are the same bits.

Casts sit where the JAX package puts them: ``silu`` in f32, then back to
x's dtype; ``h`` and the scan in f32; the ``conv`` state in x's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec


def _dt_rank(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return s.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def ssm_spec(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = d_inner(cfg)
    r = _dt_rank(cfg)

    def mk(shape, axes, **kw):
        if layers is not None:
            shape = (layers,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes, **kw)

    return {
        "in_proj": mk((d, 2 * di), ("embed", "mlp")),
        "conv_w": mk((s.d_conv, di), ("conv", "mlp")),
        "conv_b": mk((di,), ("mlp",), init="zeros"),
        "x_proj": mk((di, r + 2 * s.d_state), ("mlp", "lora")),
        "dt_proj": mk((r, di), ("lora", "mlp")),
        "dt_bias": mk((di,), ("mlp",), dtype=torch.float32, init="zeros"),
        "a_log": mk((di, s.d_state), ("mlp", "state"), dtype=torch.float32,
                    init="embed", scale=0.5),
        "d_skip": mk((di,), ("mlp",), dtype=torch.float32, init="ones"),
        "out_proj": mk((di, d), ("mlp", "embed")),
    }


def _silu(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None):
    """x: (B,L,di); depthwise causal conv with kernel taps w: (K,di).
    Returns the output and the new conv state (the last K-1 inputs)."""
    k = w.shape[0]
    if init_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + b, xp[:, -(k - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    switch to ``x`` for large inputs (``F.softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_inputs(p, xc: torch.Tensor, cfg: ModelConfig):
    """Projections shared by the parallel and decode paths."""
    s = cfg.ssm
    r = _dt_rank(cfg)
    proj = xc @ p["x_proj"]
    dt_r, bmat, cmat = torch.split(proj, [r, s.d_state, s.d_state], dim=-1)
    dt = (dt_r @ p["dt_proj"]).float()
    dt = _softplus(dt + p["dt_bias"])                     # (..., di)
    a = -torch.exp(p["a_log"])                            # (di, S)
    return dt, bmat.float(), cmat.float(), a


def _linear_scan(da: torch.Tensor, db: torch.Tensor):
    """Inclusive scan of ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)`` over
    axis 1 in log2(L) doubling steps: ``(prod da, h)`` of
    ``h_t = da_t h_{t-1} + db_t`` from ``h = 0``."""
    a, b = da, db
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def _scan_chunk(h0, dt, bmat, cmat, a, xc):
    """One chunk of the selective scan. h0: (B,di,S); xc: (B,L,di)."""
    da = torch.exp(dt[..., None] * a)                     # (B,L,di,S)
    db = (dt * xc.float())[..., None] * bmat[:, :, None, :]
    cum_a, cum_b = _linear_scan(da, db)
    h = cum_a * h0[:, None] + cum_b                       # (B,L,di,S)
    y = torch.einsum("blds,bls->bld", h, cmat)
    return y, h[:, -1]


def ssm_mixer(p, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False):
    """x: (B, L, d_model) -> (B, L, d_model). Parallel (train/prefill) path;
    with ``return_state`` also the final ``{'h', 'conv'}``."""
    s = cfg.ssm
    b, l, _ = x.shape
    di = d_inner(cfg)
    xc, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xc, p["conv_w"], p["conv_b"])
    xc = _silu(xc, x.dtype)

    chunk = min(s.chunk, l)
    if l % chunk:
        chunk = l
    h = torch.zeros((b, di, s.d_state), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    ys = []
    for i in range(l // chunk):
        xck = xc[:, i * chunk:(i + 1) * chunk]
        dt, bmat, cmat, a = _ssm_inputs(p, xck, cfg)
        if remat:
            # no random numbers; saving the RNG state would read the CUDA
            # generator, which a graph capture refuses
            y_i, h = checkpoint(_scan_chunk, h, dt, bmat, cmat, a, xck,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            y_i, h = _scan_chunk(h, dt, bmat, cmat, a, xck)
        ys.append(y_i)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xc.float() * p["d_skip"]
    y = y.to(x.dtype) * _silu(z, x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"h": h, "conv": conv_state}
    return out


def ssm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    s = cfg.ssm
    di = d_inner(cfg)
    return {
        "h": (batch, di, s.d_state),
        "conv": (batch, s.d_conv - 1, di),
    }


def ssm_decode(p, x: torch.Tensor, cfg: ModelConfig, state):
    """Single-token recurrence. x: (B,1,d); state: {'h','conv'}. Returns
    the output and the new state as new tensors (the caller writes them
    where the state lives)."""
    xc, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xc, p["conv_w"], p["conv_b"],
                                  state["conv"])
    xc = _silu(xc, x.dtype)
    dt, bmat, cmat, a = _ssm_inputs(p, xc, cfg)
    da = torch.exp(dt[:, 0, :, None] * a)                 # (B,di,S)
    db = (dt[:, 0] * xc[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = da * state["h"] + db
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])[:, None]
    y = y + xc.float() * p["d_skip"]
    y = y.to(x.dtype) * _silu(z, x.dtype)
    return y @ p["out_proj"], {"h": h, "conv": conv_state}


def ssm_mixer_reference(p, x: torch.Tensor, cfg: ModelConfig):
    """Naive per-step recurrence oracle (tests)."""
    b, l, _ = x.shape
    xc, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, _ = _causal_conv(xc, p["conv_w"], p["conv_b"])
    xc = _silu(xc, x.dtype)
    dt, bmat, cmat, a = _ssm_inputs(p, xc, cfg)
    h = torch.zeros((b, d_inner(cfg), cfg.ssm.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(l):
        da = torch.exp(dt[:, t, :, None] * a)
        db = (dt[:, t] * xc[:, t].float())[..., None] * bmat[:, t, None, :]
        h = da * h + db
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1)
    y = y + xc.float() * p["d_skip"]
    y = y.to(x.dtype) * _silu(z, x.dtype)
    return y @ p["out_proj"]
