"""Serving building blocks: requests, prefill, and the layer loops.

``make_prefill`` builds the step that turns a whole prompt into a cache:

  prefill(params, tokens)  -> (logits, cache, lengths)

Cache convention: ``lengths`` counts tokens already *in* the cache. Decode
inserts the new token at slot ``lengths``, attends over ``lengths+1``
entries, and returns ``lengths+1``.

Where the JAX package scans one compiled block body over stacked layer
parameters, the port runs a Python loop over the leading ``layers`` axis
(PyTorch runs eagerly; the layer views cost no copy). The dense
``ServingEngine``/``make_decode`` baseline of the JAX package is not
ported yet; the paged engine in :mod:`repro_torch.serving.pages` is the
port's engine.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import embed, mlp, rmsnorm, unembed
from repro_torch.models.transformer import project_qkv

PyTree = Any


# ---------------------------------------------------------------------------
# layer loops
# ---------------------------------------------------------------------------

def _n_layers(xs: PyTree) -> int:
    return leaves(xs)[0].shape[0]


def _maybe_scan(step, carry, xs):
    """``lax.scan`` as a Python loop over the leading axis of ``xs``:
    ``step(carry, x_i) -> (carry, y_i)``; the ``y_i`` come back stacked."""
    ys = []
    for i in range(_n_layers(xs)):
        carry, y = step(carry, tree_map(lambda t: t[i], xs))
        ys.append(y)
    return carry, tree_map(lambda *ls: torch.stack(ls), ys[0], *ys[1:])


def _scan_decode(stacked_params, cache, h, body):
    """Run one block body per layer over (params, cache) stacks; returns
    (h, cache). ``body(h, p_layer, kv_layer)`` gets views into the cache
    and updates them **in place** (the pool is never copied per step), so
    the returned cache is the one passed in."""
    for i in range(_n_layers(stacked_params)):
        h, _ = body(h, tree_map(lambda t: t[i], stacked_params),
                    tree_map(lambda t: t[i], cache))
    return h, cache


# ---------------------------------------------------------------------------
# prefill (build the cache from a whole prompt)
# ---------------------------------------------------------------------------

def _gqa_prefill_attn(p, xn, cfg, positions, *, max_len):
    q, k, v = project_qkv(p, xn, cfg, positions)
    o = attn_lib.flash_attention(q, k, v, causal=True,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    pad = max_len - xn.shape[1]
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return out, {"k": k, "v": v}


def make_prefill(cfg: ModelConfig, max_len: int,
                 last_only: bool = False) -> Callable:
    """prefill(params, tokens (B,S)[, last_pos]) -> (logits, cache, lengths).

    ``last_only`` returns logits for the final position only — the serving
    path (avoids materializing (B,S,V)). ``last_pos`` selects position
    ``last_pos-1`` instead of ``-1`` — for callers that right-pad every
    prompt to one canonical width.
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1: "
            f"'Other model families')")

    def prefill(params, tokens, last_pos: Optional[int] = None):
        h = embed(params["embed"], tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)

        def block(x, p):
            xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
            a, kv = _gqa_prefill_attn(p["attn"], xn, cfg, positions,
                                      max_len=max_len)
            x = x + a
            xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
            return x + mlp(p["mlp"], xn), kv

        h, kv = _maybe_scan(block, h, params["blocks"])
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        if last_only:
            h = h[:, last_pos - 1:last_pos] if last_pos is not None \
                else h[:, -1:]
        logits = unembed(params["embed"], h, cfg.vocab_size)
        return logits, {"kv": kv}, lengths

    return prefill


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _checked_prompt(req: Request, prompt_len: int) -> np.ndarray:
    """Clip a prompt to the engine window, loudly.

    Dropping leading tokens changes the completion, so it must never happen
    silently — the warning names the request and both lengths so the caller
    can resize the window or chunk the prompt.
    """
    prompt = np.asarray(req.prompt)
    if prompt.shape[-1] > prompt_len:
        warnings.warn(
            f"request {req.rid}: prompt length {prompt.shape[-1]} exceeds "
            f"the engine prompt window ({prompt_len}); keeping only the "
            f"last {prompt_len} tokens", RuntimeWarning, stacklevel=3)
        prompt = prompt[-prompt_len:]
    return prompt
