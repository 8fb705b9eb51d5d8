"""Serving: requests, prefill, the decode step (dense, MoE, hybrid and
ssm families) and the fixed-slot baseline engine.

  prefill(params, tokens)                  -> (logits, cache, lengths)
  decode (params, cache, tokens, lengths)  -> (logits, cache, lengths+1)

Cache convention: ``lengths`` counts tokens already *in* the cache. Decode
inserts the new token at slot ``lengths`` (ring slot ``lengths % window``
for SWA layers), attends over ``lengths+1`` entries, and returns
``lengths+1``.

Where the JAX package scans one compiled block body over stacked layer
parameters, the port runs a Python loop over the leading ``layers`` axis
(the layer views cost no copy), and decode writes each new K/V row, the
hybrid family's SSM state and the ssm family's mLSTM/sLSTM state, into
the cache **in place** rather than returning a copy of it.

:class:`ServingEngine` is the JAX package's fixed-slot baseline: one
contiguous ``(layers, slots, max_len, ...)`` cache, every slot decoded by
one step. On CUDA that step is captured in a CUDA graph when the engine is
built (``core/graphs.py``), as the paged engine's is; the paged engine in
:mod:`repro_torch.serving.pages` is the port's main engine.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graphs import CapturedStep
from repro_torch.core.host import resolve_device
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import hymba as hymba_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (embed, mlp, rmsnorm, rope_table,
                                       unembed)
from repro_torch.models.transformer import check_family, project_qkv
from repro_torch.serving import kvcache

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
# dense decode (x: (B,1,d); kv leaves: (B,S,...))
# ---------------------------------------------------------------------------

def _insert_at(cache: torch.Tensor, new: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """cache (B,S,...) <- new (B,...) at per-batch slot idx (B,), in place.

    A slot past the cache's end is dropped, as JAX's out-of-bounds scatter
    drops it: an idle row's length keeps growing between admissions. The
    write then rewrites the last slot with its own value, with no host
    branch, so the step stays capturable."""
    b, s = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    slot = torch.clamp(idx, max=s - 1).long()
    keep = (idx < s).view(b, *([1] * (new.dim() - 1)))
    cache[rows, slot] = torch.where(keep, new.to(cache.dtype),
                                    cache[rows, slot])
    return cache


class StepAt:
    """What every layer of one decode step shares, computed once a step:
    the new token's rotary table (GQA) and, on the paged engine, where
    each row's token lands (``attention.token_slots``)."""

    def __init__(self, cfg: ModelConfig, lengths: torch.Tensor,
                 slots: Optional[tuple] = None) -> None:
        self.rope = (rope_table(lengths[:, None], cfg.resolved_head_dim,
                                cfg.rope_theta)
                     if cfg.mla is None else None)
        self.slots = slots


def _gqa_decode_attn(p, xn, cfg: ModelConfig, kv, lengths, at: StepAt, *,
                     window: int = 0):
    """kv: {'k','v'} (B,S,N,hd). Returns (attn_out, kv updated in place).
    A cache of ``window`` slots is a ring: the new token goes to slot
    ``lengths % window``, which stays in range for an idle row too."""
    ring = window > 0 and kv["k"].shape[1] == window
    pos = lengths[:, None]                       # rope position of new token
    q, k, v = project_qkv(p, xn, cfg, pos, at.rope)
    slot = lengths % window if ring else lengths
    kc = _insert_at(kv["k"], k[:, 0], slot)
    vc = _insert_at(kv["v"], v[:, 0], slot)
    o = attn_lib.decode_attention(q, kc, vc, lengths + 1, window=window,
                                  ring=ring)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), {"k": kc, "v": vc}


def _mla_decode_attn(p, xn, cfg: ModelConfig, kv, lengths):
    pos = lengths[:, None]
    ckv_new, krope_new = mla_lib.mla_new_cache_entry(p, xn, cfg, pos)
    ckv = _insert_at(kv["ckv"], ckv_new[:, 0], lengths)
    krope = _insert_at(kv["krope"], krope_new[:, 0], lengths)
    o = mla_lib.mla_decode(p, xn, cfg, ckv, krope, lengths + 1)
    return o, {"ckv": ckv, "krope": krope}


def _decode_attn(p, xn, cfg: ModelConfig, kv, lengths, at: StepAt):
    if cfg.mla is not None:
        return _mla_decode_attn(p, xn, cfg, kv, lengths)
    return _gqa_decode_attn(p, xn, cfg, kv, lengths, at)


def _dense_decode_block(p, x, cfg, kv, lengths, at: StepAt):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = _decode_attn(p["attn"], xn, cfg, kv, lengths, at)
    x = x + a
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], xn), kv


def _moe_decode_block(p, x, cfg, kv, lengths, at: StepAt):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = _decode_attn(p["attn"], xn, cfg, kv, lengths, at)
    x = x + a
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    y, _ = moe_lib.moe_ffn(p["moe"], xn, cfg, with_aux=False)
    return x + y, kv


def _hybrid_decode_block(p, x, cfg, ssm_state, attn):
    """One hybrid layer's decode: ``attn(p_attn, xn) -> (out, kv)`` is the
    layer's attention (its cache updated in place); the SSM state's new
    ``h`` and ``conv`` are written into ``ssm_state`` in place."""
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, _ = attn(p["attn"], xn)
    s, new = ssm_lib.ssm_decode(p["ssm"], xn, cfg, ssm_state)
    ssm_state["h"].copy_(new["h"])
    ssm_state["conv"].copy_(new["conv"])
    x = x + hymba_lib.fuse(p["fusion"], a, s, cfg)
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], xn)


def hybrid_layers(cfg: ModelConfig, params, kv_global, kv_swa, ssm_global,
                  ssm_swa):
    """A hybrid model's layers in order: ``(is_global, params, kv,
    ssm_state)`` of each, views into the stacks (in-place writes land in
    them)."""
    for is_g, first, count in hymba_lib.layer_runs(cfg):
        stacked = params["global_blocks" if is_g else "swa_blocks"]
        kv, st = (kv_global, ssm_global) if is_g else (kv_swa, ssm_swa)
        for i in range(first, first + count):
            at_i = lambda t: t[i]
            yield (is_g, tree_map(at_i, stacked), tree_map(at_i, kv),
                   tree_map(at_i, st))


def _copy_state(dst: dict, new: dict) -> None:
    for k, t in dst.items():
        t.copy_(new[k])


def xlstm_decode(params, cfg: ModelConfig, state, h: torch.Tensor
                 ) -> torch.Tensor:
    """One token through every super-block: its mLSTM layers (each the
    chunk at L = 1), then its sLSTM layer. Each layer's new ``c``, ``n``,
    ``m`` and ``conv`` (mLSTM) or ``c``, ``n``, ``m`` and ``h`` (sLSTM) are
    copied into its slice of ``state`` in place, so every buffer a replay
    reads keeps its address."""
    sup = params["super"]
    per = cfg.xlstm.slstm_every - 1
    for i in range(_n_layers(sup["slstm"])):
        for j in range(per):
            at = lambda t: t[i, j]
            st = tree_map(at, state["mlstm"])
            h, new = xlstm_lib.mlstm_decode(tree_map(at, sup["mlstm"]), h,
                                            cfg, st)
            _copy_state(st, new)
        st = tree_map(lambda t: t[i], state["slstm"])
        h, new = xlstm_lib.slstm_decode(tree_map(lambda t: t[i],
                                                 sup["slstm"]), h, cfg, st)
        _copy_state(st, new)
    return h


def split_layers(cfg: ModelConfig, kv: PyTree) -> tuple[PyTree, PyTree]:
    """An MoE model's cache stack as (leading dense layers, MoE layers):
    views, so in-place writes land in the one stack."""
    fd = cfg.moe.first_dense
    return tree_map(lambda a: a[:fd], kv), tree_map(lambda a: a[fd:], kv)


def make_decode(cfg: ModelConfig) -> Callable:
    """decode(params, cache, tokens (B,1), lengths (B,)) -> (logits, cache,
    lengths+1); ``cache`` is updated in place and returned. An MoE model
    decodes its ``first_dense`` dense layers, then its MoE layers, over
    the two parts of its one cache stack; a hybrid model its global and
    SWA layers in layer order; an ssm model its super-blocks
    (:func:`xlstm_decode`)."""
    check_family(cfg)

    def decode(params, cache, tokens, lengths):
        h = embed(params["embed"], tokens)
        at = StepAt(cfg, lengths)
        dense = lambda x, p, kv: _dense_decode_block(p, x, cfg, kv, lengths,
                                                     at)
        if cfg.family == "dense":
            h, _ = _scan_decode(params["blocks"], cache["kv"], h, dense)
        elif cfg.family == "hybrid":
            for is_g, p, kv, st in hybrid_layers(
                    cfg, params, cache["global_kv"], cache["swa_kv"],
                    cache["ssm_global"], cache["ssm_swa"]):
                window = 0 if is_g else cfg.swa_window
                h = _hybrid_decode_block(
                    p, h, cfg, st,
                    lambda pa, xn, kv=kv, window=window: _gqa_decode_attn(
                        pa, xn, cfg, kv, lengths, at, window=window))
        elif cfg.family == "ssm":
            h = xlstm_decode(params, cfg, cache, h)
        else:
            kv_d, kv_m = split_layers(cfg, cache["kv"])
            if cfg.moe.first_dense:
                h, _ = _scan_decode(params["dense_blocks"], kv_d, h, dense)
            h, _ = _scan_decode(
                params["moe_blocks"], kv_m, h,
                lambda x, p, kv: _moe_decode_block(p, x, cfg, kv, lengths,
                                                   at))
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = unembed(params["embed"], h, cfg.vocab_size)
        return logits, cache, lengths + 1

    return decode


# ---------------------------------------------------------------------------
# prefill (build the cache from a whole prompt)
# ---------------------------------------------------------------------------

def _gqa_prefill_attn(p, xn, cfg, positions, *, max_len, window=0):
    """Attention of a prompt and its K/V for the cache: padded to
    ``max_len``, or, for a ring of ``max_len == window`` slots, the last
    ``window`` tokens with token t at slot ``t % window``."""
    q, k, v = project_qkv(p, xn, cfg, positions)
    o = attn_lib.flash_attention(q, k, v, causal=True, window=window,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    s = xn.shape[1]
    if window and max_len == window:
        t0 = max(0, s - window)
        kr, vr = k[:, t0:], v[:, t0:]
        pad = window - kr.shape[1]
        if pad:
            kr = F.pad(kr, (0, 0, 0, 0, 0, pad))
            vr = F.pad(vr, (0, 0, 0, 0, 0, pad))
        shift = t0 % window
        return out, {"k": torch.roll(kr, shift, dims=1),
                     "v": torch.roll(vr, shift, dims=1)}
    pad = max_len - s
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return out, {"k": k, "v": v}


def _mla_prefill_attn(p, xn, cfg, positions, *, max_len):
    out = mla_lib.mla_attention(p, xn, cfg, positions)
    ckv, krope = mla_lib.mla_new_cache_entry(p, xn, cfg, positions)
    pad = max_len - xn.shape[1]
    if pad > 0:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        krope = F.pad(krope, (0, 0, 0, pad))
    return out, {"ckv": ckv, "krope": krope}


def _hybrid_prefill(params, cfg: ModelConfig, h, positions, max_len: int):
    """The hybrid layers in order over a whole prompt: the hidden state
    and the cache (``global_kv`` padded to ``max_len``; ``swa_kv`` a ring
    of ``min(swa_window, max_len)`` slots; each layer's final SSM
    state)."""
    win = min(cfg.swa_window, max_len)
    out = {True: [], False: []}
    for is_g, first, count in hymba_lib.layer_runs(cfg):
        stacked = params["global_blocks" if is_g else "swa_blocks"]
        for i in range(first, first + count):
            p = tree_map(lambda t: t[i], stacked)
            xn = rmsnorm(p["ln1"], h, cfg.norm_eps)
            a, kv = _gqa_prefill_attn(
                p["attn"], xn, cfg, positions,
                window=0 if is_g else cfg.swa_window,
                max_len=max_len if is_g else win)
            s_out, st = ssm_lib.ssm_mixer(p["ssm"], xn, cfg,
                                          return_state=True)
            h = h + hymba_lib.fuse(p["fusion"], a, s_out, cfg)
            h = h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps))
            out[is_g].append((kv, st))
    stack = lambda ys: tree_map(lambda *ls: torch.stack(ls), *ys)
    kv_g, ssm_g = stack(out[True]) if out[True] else ({}, {})
    kv_s, ssm_s = stack(out[False]) if out[False] else ({}, {})
    return h, {"global_kv": kv_g, "swa_kv": kv_s, "ssm_global": ssm_g,
               "ssm_swa": ssm_s}


def _xlstm_prefill(params, cfg: ModelConfig, h: torch.Tensor):
    """The super-blocks over a whole prompt: the hidden state and each
    layer's final state, stacked as ``kvcache.cache_layout`` lays it out
    (mLSTM leaves (n_super, per, B, ...), sLSTM leaves (n_super, B, ...))."""
    sup = params["super"]
    stack = lambda ys: tree_map(lambda *ls: torch.stack(ls), *ys)
    m_states, s_states = [], []
    for i in range(_n_layers(sup["slstm"])):
        layer = []
        for j in range(cfg.xlstm.slstm_every - 1):
            h, st = xlstm_lib.mlstm_mixer(
                tree_map(lambda t: t[i, j], sup["mlstm"]), h, cfg,
                return_state=True)
            layer.append(st)
        m_states.append(stack(layer))
        h, st = xlstm_lib.slstm_mixer(tree_map(lambda t: t[i], sup["slstm"]),
                                      h, cfg)
        s_states.append(st)
    return h, {"mlstm": stack(m_states), "slstm": stack(s_states)}


def stacks(cfg: ModelConfig, params) -> list:
    """The stacked block trees of a dense or MoE model in layer order (the
    hybrid and ssm families interleave block kinds and walk their own)."""
    if cfg.family == "dense":
        return [params["blocks"]]
    return ([params["dense_blocks"]] if cfg.moe.first_dense else []) \
        + [params["moe_blocks"]]


def make_prefill(cfg: ModelConfig, max_len: int,
                 last_only: bool = False) -> Callable:
    """prefill(params, tokens (B,S)[, last_pos]) -> (logits, cache, lengths).

    ``last_only`` returns logits for the final position only — the serving
    path (avoids materializing (B,S,V)). ``last_pos`` selects position
    ``last_pos-1`` instead of ``-1`` — for callers that right-pad every
    prompt to one canonical width.
    """
    check_family(cfg)

    def prefill(params, tokens, last_pos: Optional[int] = None):
        h = embed(params["embed"], tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)

        def block(x, p):
            xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if cfg.mla is not None:
                a, kv = _mla_prefill_attn(p["attn"], xn, cfg, positions,
                                          max_len=max_len)
            else:
                a, kv = _gqa_prefill_attn(p["attn"], xn, cfg, positions,
                                          max_len=max_len)
            x = x + a
            xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
            if "moe" in p:
                y, _ = moe_lib.moe_ffn(p["moe"], xn, cfg, with_aux=False)
            else:
                y = mlp(p["mlp"], xn)
            return x + y, kv

        if cfg.family == "hybrid":
            h, cache = _hybrid_prefill(params, cfg, h, positions, max_len)
        elif cfg.family == "ssm":
            h, cache = _xlstm_prefill(params, cfg, h)
        else:
            parts = []
            for stacked in stacks(cfg, params):
                h, kv = _maybe_scan(block, h, stacked)
                parts.append(kv)
            cache = {"kv": tree_map(lambda *xs: torch.cat(xs), *parts)
                     if len(parts) > 1 else parts[0]}
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        if last_only:
            h = h[:, last_pos - 1:last_pos] if last_pos is not None \
                else h[:, -1:]
        logits = unembed(params["embed"], h, cfg.vocab_size)
        return logits, cache, lengths

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


class ServingEngine:
    """Slot-based batched serving with greedy decode (the baseline).

    All slots share one decode step; prefill runs per request, at the
    prompt's own length. The cache, ``lengths`` and ``tokens`` keep their
    addresses for the engine's life: admission and completion write them
    in place between steps. On CUDA the step is captured in a CUDA graph as
    the engine is built and each ``step()`` replays it; ``cuda_graph=False``
    steps eagerly there, and the CPU always does. ``params`` must already
    live on ``device``.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 prompt_len: int = 64, max_len: int = 256,
                 device: str | torch.device = "cuda",
                 cuda_graph: bool = True) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.prompt_len = prompt_len
        self.max_len = max_len
        dev = self.device
        self.cache = kvcache.init_cache(cfg, slots, max_len, device=dev)
        self.lengths = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.active: list[Optional[Request]] = [None] * slots
        self.tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        self._decode = make_decode(cfg)
        self._prefill_one = make_prefill(cfg, max_len, last_only=True)
        # page-dirty hint for the snapshot store: every cache mutation
        # (admit prefill, decode step) bumps the version, so an idle
        # engine's unchanged snapshot short-circuits to a no-op frame
        self._state_version = 0
        self.logits: Optional[torch.Tensor] = None
        self._graph = (CapturedStep(self._step_inplace,
                                    warmup=self._decode_next, device=dev)
                       if cuda_graph and dev.type == "cuda" else None)

    def admit(self, req: Request) -> bool:
        for i, a in enumerate(self.active):
            if a is None:
                self.active[i] = req
                prompt = _checked_prompt(req, self.prompt_len)
                toks = torch.as_tensor(np.asarray(prompt, np.int32),
                                       device=self.device)[None, :]
                logits, cache1, _ = self._prefill_one(self.params, toks)
                # merge slot i of the batch cache from the single-row cache
                tree_map(lambda full, one: _set_batch_slot(full, one, i),
                         self.cache, cache1)
                self.lengths[i] = len(prompt)
                nxt = torch.argmax(logits[0, -1]).to(torch.int32)
                self.tokens[i, 0] = nxt
                req.out.append(int(nxt))
                self._state_version += 1
                return True
        return False

    def _decode_next(self):
        """The JAX engine's step on the engine's buffers: (logits, greedy
        next tokens, lengths + 1) as new tensors; the cache takes the
        step's K/V rows in place."""
        logits, _, lengths = self._decode(self.params, self.cache,
                                          self.tokens, self.lengths)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return logits, nxt, lengths

    def _step_inplace(self):
        """:meth:`_decode_next`, then the next tokens and lengths copied
        into the engine's own buffers (what a replay must rewrite)."""
        logits, nxt, lengths = self._decode_next()
        self.tokens.copy_(nxt[:, None])
        self.lengths.copy_(lengths)
        return logits, nxt

    def step(self) -> None:
        if self._graph is not None:
            self.logits, nxt = self._graph.replay()
        else:
            self.logits, nxt = self._step_inplace()
        self._state_version += 1
        nxt_host = nxt.cpu().numpy()   # ONE device->host transfer per step
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt_host[i]))
            if len(req.out) >= req.max_new:
                req.done = True
                self.active[i] = None
                self.lengths[i] = 0

    @property
    def state_version(self) -> int:
        """Monotonic cache-mutation counter (bumps on admit and decode)."""
        return self._state_version

    def snapshot_payload(self) -> dict[str, Any]:
        """The serve_snapshot payload: the KV slab plus its version hint,
        which lets an unchanged firing short-circuit to a no-op frame."""
        return {"cache": self.cache, "version": self._state_version}

    def run(self, requests: list[Request], max_steps: int = 512) -> None:
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            if not pending and all(a is None for a in self.active):
                return
            if any(a is not None for a in self.active):
                self.step()


def _set_batch_slot(full: torch.Tensor, one: torch.Tensor, i: int) -> None:
    """Write the batch row of a single-request cache into slot i, in place.

    The batch axis is the first axis where ``one`` has size 1 and ``full``
    does not (after the leading layer axis); with one slot the shapes are
    equal and the whole leaf is copied."""
    for ax in range(full.ndim):
        if one.shape[ax] == 1 and full.shape[ax] != one.shape[ax]:
            full.select(ax, i).copy_(one.select(ax, 0))
            return
    full.copy_(one)
