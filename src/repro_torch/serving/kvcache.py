"""Serving-state layouts, dense, MoE, hybrid and ssm (xLSTM) families.

  GQA : k/v (L, B, S, N, hd) — N = kv heads (GQA shrinks the cache by
        heads/N vs MHA).
  MLA : latent c_kv (L, B, S, kv_lora) + shared rope key (L, B, S, qk_rope)
        — (kv_lora + qk_rope) values per token and layer.
  SWA (hymba) : ring buffer (L, B, window, N, hd), bounded whatever the
        context; plus per-layer SSM state (h in f32, conv taps).
  ssm (xLSTM) : O(1) recurrent state per block: the mLSTM matrix memory
        ``c`` (n_super, per, B, nh, dh, dh), normalizer ``n``, stabilizer
        ``m`` and conv taps, and the sLSTM ``c``/``n``/``m``/``h``
        (n_super, B, nh, dh); the ``m`` leaves start at -1e30.

An MoE model's dense and MoE layers share one stack of ``n_layers``.

The paged engine turns every leaf whose sequence axis spans ``max_len``
into a block-indexed page pool ``(L, num_pages, page_size, N, hd)``; the
SWA rings and the recurrent state stay per-row slabs; the ssm family has
no pool at all.
``init_cache`` / ``init_paged_cache`` return concrete zeros on a device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_map
from repro_torch.models import hymba as hymba_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.transformer import check_family

PyTree = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _is_desc(x: Any) -> bool:
    return (isinstance(x, tuple) and len(x) in (3, 4)
            and isinstance(x[0], tuple))


def _gqa_kv(cfg: ModelConfig, layers: int, batch: int, seq: int):
    hd = cfg.resolved_head_dim
    shape = (layers, batch, seq, cfg.n_kv_heads, hd)
    axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": (shape, axes, cfg.dtype), "v": (shape, axes, cfg.dtype)}


def _mla_kv(cfg: ModelConfig, layers: int, batch: int, seq: int):
    m = cfg.mla
    return {
        "ckv": ((layers, batch, seq, m.kv_lora),
                ("layers", "batch", "seq", None), cfg.dtype),
        "krope": ((layers, batch, seq, m.qk_rope),
                  ("layers", "batch", "seq", None), cfg.dtype),
    }


def _ssm_state(cfg: ModelConfig, layers: int, batch: int):
    s = cfg.ssm
    di = ssm_lib.d_inner(cfg)
    return {
        "h": ((layers, batch, di, s.d_state),
              ("layers", "batch", "mlp", "state"), "float32"),
        "conv": ((layers, batch, s.d_conv - 1, di),
                 ("layers", "batch", "conv", "mlp"), cfg.dtype),
    }


def _xlstm_state(cfg: ModelConfig, batch: int):
    x = cfg.xlstm
    n_super = cfg.n_layers // x.slstm_every
    per = x.slstm_every - 1
    _, m_inner, nh, m_dh = xlstm_lib._dims(cfg)
    conv_k = x.conv_kernel
    s_dh = cfg.d_model // nh
    neg = xlstm_lib.NEG
    return {
        "mlstm": {
            "c": ((n_super, per, batch, nh, m_dh, m_dh),
                  ("layers", "layers", "batch", "heads", None, None),
                  "float32"),
            "n": ((n_super, per, batch, nh, m_dh),
                  ("layers", "layers", "batch", "heads", None), "float32"),
            "m": ((n_super, per, batch, nh),
                  ("layers", "layers", "batch", "heads"), "float32", neg),
            "conv": ((n_super, per, batch, conv_k - 1, m_inner),
                     ("layers", "layers", "batch", "conv", "mlp"), cfg.dtype),
        },
        "slstm": {
            "c": ((n_super, batch, nh, s_dh),
                  ("layers", "batch", "heads", None), "float32"),
            "n": ((n_super, batch, nh, s_dh),
                  ("layers", "batch", "heads", None), "float32"),
            "m": ((n_super, batch, nh, s_dh),
                  ("layers", "batch", "heads", None), "float32", neg),
            "h": ((n_super, batch, nh, s_dh),
                  ("layers", "batch", "heads", None), cfg.dtype),
        },
    }


def cache_layout(cfg: ModelConfig, batch: int, max_len: int) -> PyTree:
    """Tree of (shape, logical_axes, dtype) descriptors (a fourth entry,
    where there is one, is the leaf's fill value)."""
    check_family(cfg)
    if cfg.family == "ssm":
        return _xlstm_state(cfg, batch)
    if cfg.family == "hybrid":
        n_global = len(hymba_lib.global_layer_ids(cfg))
        n_swa = cfg.n_layers - n_global
        win = min(cfg.swa_window, max_len)
        return {
            "global_kv": _gqa_kv(cfg, n_global, batch, max_len),
            "swa_kv": _gqa_kv(cfg, n_swa, batch, win),
            "ssm_global": _ssm_state(cfg, n_global, batch),
            "ssm_swa": _ssm_state(cfg, n_swa, batch),
        }
    if cfg.mla is not None:
        return {"kv": _mla_kv(cfg, cfg.n_layers, batch, max_len)}
    return {"kv": _gqa_kv(cfg, cfg.n_layers, batch, max_len)}


def paged_cache_layout(cfg: ModelConfig, num_pages: int, page_size: int,
                       max_reqs: int, max_len: int) -> tuple[PyTree, PyTree]:
    """Split :func:`cache_layout` into (pool_layout, state_layout).

    Leaves whose sequence axis spans ``max_len`` become block-indexed page
    pools shared by every request: ``(layers, batch, max_len, ...)`` turns
    into ``(layers, num_pages, page_size, ...)``. Everything else — SWA
    ring buffers (bounded at ``window``), SSM state (O(1) per request) —
    stays a dense per-row slab with ``batch=max_reqs``. Either side may be
    ``{}``: the dense and MoE families have no state, the ssm family no
    pool.
    """
    def page_desc(d):
        shape, axes = d[0], d[1]
        if axes[:3] != ("layers", "batch", "seq"):
            raise ValueError(f"cannot page a leaf with axes {axes}")
        new_shape = (shape[0], num_pages, page_size) + shape[3:]
        new_axes = ("layers", "pages", "page_slot") + axes[3:]
        return (new_shape, new_axes) + d[2:]

    def split(node, in_ring):
        pool, state = {}, {}
        for k, v in node.items():
            # SWA ring buffers keep ring semantics (slot = t % window) even
            # when window == max_len, so they are state by name, not shape
            ring = in_ring or k == "swa_kv"
            if _is_desc(v):
                shape, axes = v[0], v[1]
                if (not ring and "seq" in axes
                        and shape[axes.index("seq")] == max_len):
                    pool[k] = page_desc(v)
                else:
                    state[k] = v
            else:
                p, s = split(v, ring)
                if p:
                    pool[k] = p
                if s:
                    state[k] = s
        return pool, state

    return split(cache_layout(cfg, max_reqs, max_len), False)


def _map_layout(layout: PyTree, fn) -> PyTree:
    if _is_desc(layout):
        return fn(layout)
    return {k: _map_layout(v, fn) for k, v in layout.items()}


def _zeros(device: torch.device):
    def mk(d):
        fill = d[3] if len(d) == 4 else 0.0
        return torch.full(d[0], fill, dtype=torch_dtype(d[2]), device=device)
    return mk


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str = "cpu") -> PyTree:
    return _map_layout(cache_layout(cfg, batch, max_len),
                       _zeros(torch.device(device)))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     max_reqs: int, max_len: int,
                     device: torch.device | str = "cpu"
                     ) -> tuple[PyTree, PyTree]:
    """Concrete zeros for (page pool, per-row state)."""
    pool_l, state_l = paged_cache_layout(cfg, num_pages, page_size,
                                         max_reqs, max_len)
    mk = _zeros(torch.device(device))
    return _map_layout(pool_l, mk), _map_layout(state_l, mk)


def chain_view(pool_kv: PyTree, page_ids: torch.Tensor) -> PyTree:
    """Gather one page chain back into token order.

    pool leaf ``(layers, num_pages, page_size, ...)`` -> view
    ``(layers, 1, n*page_size, ...)`` — the single-request prefill cache
    layout, so a continuation prefill can attend over a resident shared
    prefix.
    """
    def leaf(a):
        gathered = a[:, page_ids]                      # (L, n, ps, ...)
        return gathered.reshape(a.shape[0], -1, *a.shape[3:])[:, None]
    return tree_map(leaf, pool_kv)
