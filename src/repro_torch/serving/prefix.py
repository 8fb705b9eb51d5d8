"""Shared-prefix COW cache: prefill a common prompt prefix once, share it.

Serving traffic with a common system prompt re-prefills the same tokens for
every request — the exact "recompute what you already produced" pattern the
paper's in-situ thesis argues against. With paged KV (repro_torch.serving.pages)
the fix is structural, JetStream's ``ExistingPrefix``/``bulk_insert`` shape:

  * ``PagedServingEngine.register_prefix`` prefills the prefix ONCE and
    scatters it into a pinned page chain (one fused dispatch, the same
    ``_insert_pages`` machinery as normal admission).
  * ``PrefixCache`` (here) keys that chain by a hash of the prefix tokens
    and LRU-tracks it. ``admit`` consults :meth:`PrefixCache.match`; on a
    hit the chain is mapped **read-only** into the request's page table
    (allocator refcount +1 per page) and only the divergent suffix is
    prefilled — via :func:`make_continue_prefill` below — into freshly
    allocated pages.
  * Copy-on-write invariant: shared pages are written only at
    registration. Decode writes land at position ``lengths`` which is
    always past the shared prefix, i.e. in the request's own pages; frees
    drop refcounts and a page returns to the free list only at zero. The
    decode kernels read through the page table and never see the
    difference — sharing is purely a table-level concern, so decode stays
    bit-identical to the unshared path.
  * Under pool pressure ``evict_lru`` reclaims the least-recently-matched
    prefix whose pages nobody else references.

Sharing requires every cache leaf to live in the page pool, so it is
limited to ``SHAREABLE_FAMILIES``; hybrid/ssm keep per-row recurrent state
whose value at the prefix boundary depends on the row, not the pages.

The continuation prefill is numerically the tail of a full prefill: the
prefix KV is gathered from the pool (``kvcache.chain_view``) and suffix
queries attend over [prefix ; suffix] keys with ``q_offset=len(prefix)`` —
the same per-row online-softmax reductions the full prefill would compute
for those rows.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import embed, mlp, rmsnorm, unembed
from repro_torch.models.transformer import check_family, project_qkv
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache

#: Families whose entire serving cache pages (no per-row recurrent state);
#: of these the port carries the dense and MoE families so far.
SHAREABLE_FAMILIES = ("dense", "audio", "vlm", "moe")


def prefix_key(tokens: Any) -> str:
    """Stable content key for a token prefix (sha256 of the int32 bytes)."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


@dataclasses.dataclass
class PrefixEntry:
    key: str
    tokens: np.ndarray            # (p0,) int32, p0 a multiple of page_size
    pages: list[int]              # pinned chain, len p0 // page_size
    clock: int = 0                # LRU stamp (bumped on every match)

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])


class PrefixCache:
    """Registered prefixes + hit/miss accounting + LRU eviction.

    Pure host-side bookkeeping: the engine owns the device work (prefill,
    scatter); this class owns which chains exist, which one a prompt
    matches, and which one to give back under pool pressure. State is
    JSON-able (:meth:`state_dict`) so replica hydration restores it
    alongside the allocator.
    """

    def __init__(self) -> None:
        self._entries: dict[str, PrefixEntry] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def entries(self) -> list[PrefixEntry]:
        return list(self._entries.values())

    def get(self, key: str) -> Optional[PrefixEntry]:
        return self._entries.get(key)

    def add(self, entry: PrefixEntry) -> None:
        self._clock += 1
        entry.clock = self._clock
        self._entries[entry.key] = entry

    def match(self, prompt: np.ndarray) -> Optional[PrefixEntry]:
        """Longest registered prefix of ``prompt`` that leaves >= 1 token.

        Strictly-shorter matters: the continuation prefill needs at least
        one divergent token to produce the request's first logits, so a
        prompt equal to the prefix still prefills its last token normally.
        Counts a miss only when the cache is non-empty (an engine that
        never registered anything should report a 0/0 rate, not misses).
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        best: Optional[PrefixEntry] = None
        for e in self._entries.values():
            p0 = e.length
            if p0 >= prompt.shape[0]:
                continue
            if best is not None and p0 <= best.length:
                continue
            if np.array_equal(prompt[:p0], e.tokens):
                best = e
        if best is not None:
            self._clock += 1
            best.clock = self._clock
            self.hits += 1
        elif self._entries:
            self.misses += 1
        return best

    def evict_lru(self, allocator: Any) -> bool:
        """Free the LRU prefix whose pages only the cache still references
        (refcount exactly 1 on every page). True if something was evicted.
        """
        for e in sorted(self._entries.values(), key=lambda e: e.clock):
            if all(allocator.refcount(p) == 1 for p in e.pages):
                allocator.free(e.pages)
                del self._entries[e.key]
                self.evictions += 1
                return True
        return False

    def drop(self, key: str, allocator: Any) -> bool:
        """Unregister one prefix (frees its cache reference; shared users
        keep their refcounts and pages until they complete). Unknown keys
        are a no-op returning False."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        allocator.free(e.pages)
        return True

    def stats(self) -> dict[str, Any]:
        total = self.hits + self.misses
        return {
            "prefixes": len(self._entries),
            "prefix_pages": sum(len(e.pages) for e in
                                self._entries.values()),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
        }

    # -- hydration ------------------------------------------------------------

    def state_dict(self) -> dict[str, Any]:
        """JSON-able state, in the JAX package's layout (the engine's
        snapshot ``meta`` leaf carries it for replica hydration)."""
        return {
            "clock": self._clock,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "entries": [
                {"key": e.key, "tokens": e.tokens.tolist(),
                 "pages": list(e.pages), "clock": e.clock}
                for e in self._entries.values()],
        }

    def load_state(self, state: Mapping[str, Any]) -> None:
        """Restore :meth:`state_dict` output (replica hydration)."""
        self._clock = int(state["clock"])
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.evictions = int(state["evictions"])
        self._entries = {}
        for e in state["entries"]:
            self._entries[e["key"]] = PrefixEntry(
                key=e["key"], tokens=np.asarray(e["tokens"], np.int32),
                pages=[int(p) for p in e["pages"]], clock=int(e["clock"]))


# ---------------------------------------------------------------------------
# continuation prefill (suffix tokens against a resident page chain)
# ---------------------------------------------------------------------------

def _gqa_cont_attn(p, xn, cfg: ModelConfig, positions, pkv, p0):
    """Suffix flash attention over [shared prefix KV ; suffix KV]."""
    q, k, v = project_qkv(p, xn, cfg, positions)
    kf = torch.cat([pkv["k"].to(k.dtype), k], dim=1)
    vf = torch.cat([pkv["v"].to(v.dtype), v], dim=1)
    o = attn_lib.flash_attention(q, kf, vf, causal=True, q_offset=p0,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), {"k": k, "v": v}


def _mla_cont_attn(p, xn, cfg: ModelConfig, positions, pkv, p0):
    """MLA continuation: concat cached+new latents, then the same per-head
    K/V reconstruction as ``mla_attention``'s prefill path."""
    q_nope, q_rope = mla_lib._project_q(p, xn, cfg, positions)
    c_new, krope_new = mla_lib._project_kv_latent(p, xn, cfg, positions)
    ckv = torch.cat([pkv["ckv"].to(c_new.dtype), c_new], dim=1)
    krope = torch.cat([pkv["krope"].to(krope_new.dtype), krope_new], dim=1)
    k, v = mla_lib.per_head_kv(p, ckv, krope, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attn_lib.flash_attention(q, k, v, causal=True, q_offset=p0,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, {"ckv": c_new, "krope": krope_new}


def make_continue_prefill(cfg: ModelConfig, page_size: int):
    """cont(params, pool, page_ids, tokens (1,S)[, last_pos])
    -> (last-real-position logits, suffix kv).

    Prefills the divergent suffix of a prompt whose first
    ``page_ids.shape[0] * page_size`` tokens are already resident in the
    page pool as a shared chain. Only the suffix's own KV comes back
    (per-layer leaves ``(L, 1, S, ...)``) for scattering into the
    request's fresh pages. ``last_pos`` selects the logits of suffix
    position ``last_pos - 1`` instead of ``-1``, for callers that right-pad
    every suffix to one canonical width (causal attention keeps real
    positions independent of the zero-padded tail).
    """
    check_family(cfg)
    if cfg.family not in SHAREABLE_FAMILIES:
        raise ValueError(
            f"prefix sharing requires a fully paged cache; family "
            f"{cfg.family!r} keeps per-row recurrent state")

    def cont(params, pool, page_ids, tokens, last_pos=None):
        b, s = tokens.shape
        p0 = page_ids.shape[0] * page_size
        h = embed(params["embed"], tokens)
        positions = (p0 + torch.arange(s, dtype=torch.int32,
                                       device=tokens.device)).expand(b, s)
        prefix_kv = kvcache.chain_view(pool["kv"], page_ids)

        def block(x, xs):
            p, pkv = xs
            xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if cfg.mla is not None:
                a, kv = _mla_cont_attn(p["attn"], xn, cfg, positions, pkv, p0)
            else:
                a, kv = _gqa_cont_attn(p["attn"], xn, cfg, positions, pkv, p0)
            x = x + a
            xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
            if "moe" in p:
                y, _ = moe_lib.moe_ffn(p["moe"], xn, cfg, with_aux=False)
            else:
                y = mlp(p["mlp"], xn)
            return x + y, kv

        parts, first = [], 0
        for stacked in E.stacks(cfg, params):
            n = E._n_layers(stacked)
            pkv = tree_map(lambda a: a[first:first + n], prefix_kv)
            h, kv = E._maybe_scan(block, h, (stacked, pkv))
            parts.append(kv)
            first += n
        kv = (tree_map(lambda *xs: torch.cat(xs), *parts) if len(parts) > 1
              else parts[0])
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        h = h[:, last_pos - 1:last_pos] if last_pos is not None else h[:, -1:]
        logits = unembed(params["embed"], h, cfg.vocab_size)
        return logits, kv

    return cont
