"""Paged KV cache + continuous batching (the vLLM/JetStream serving shape).

KV memory is a shared pool of fixed-size pages per layer:

  pool leaf   (layers, num_pages, page_size, ...)   — block-indexed storage
  page_table  (max_reqs, pages_per_seq) int32       — per-request chains
  state leaf  (layers, max_reqs, ...)               — SWA rings / SSM state

A request is admitted whenever a batch row *and* enough free pages exist —
``ceil((prompt + max_new) / page_size)`` pages are reserved up front so a
mid-decode exhaustion can never corrupt a neighbour. Completion returns the
chain to the free list immediately (``free_resource``), so short requests
stop blocking long ones.

Lifecycle (JetStream's engine vocabulary):

  admit(req)      prefill the prompt, then insert
  _insert(...)    scatter the prefilled KV into the reserved pages and copy
                  recurrent state into the request's row
  step()          one batched decode for every row; page writes go through
                  the per-request page table
  free_resource() return pages, zero the table row

Page 0 is reserved as a scratch page: inactive rows' table entries point at
it, so their (masked, never-read) decode writes land harmlessly there.

Where the JAX package is functional, this engine updates its device state
**in place**: decode writes each new K/V row straight into the pool, and
admission scatters the prompt's KV into its pages without copying the pool.
The pool is the largest tensor of the serving state; a functional update
would copy it per layer per step. The hybrid family's per-row state (SWA
rings, SSM ``h`` and ``conv``) and the ssm family's (mLSTM ``c``, ``n``,
``m``, ``conv``; sLSTM ``c``, ``n``, ``m``, ``h``) are written in place the
same way. The ssm family's pool is empty: its pages are still reserved
per request, as in the JAX package, and hold nothing.

Attention over the pages is ``models.attention.paged_decode_attention``:
the hand-written Hopper kernel for CUDA tensors, its plain version (gather +
masked softmax) for CPU tensors.

The step is the JAX engine's jitted ``_step``: decode, the greedy argmax,
then the next tokens and ``lengths + 1``, written **into** the engine's
``tokens`` and ``lengths``. Every device buffer of the engine (pool,
state, page table, lengths, tokens) keeps its address for the engine's
life: admission, completion and prefix registration write them in place
between steps. On CUDA the step is captured once, when the engine is
built, in a CUDA graph (``core/graphs.py``) and each ``step()`` replays
it; its warm-up steps, with every row idle, write only the scratch page 0
and idle rows' state, which an admission overwrites whole;
``cuda_graph=False`` steps eagerly instead. On the CPU the step is always
eager: that path is the parity oracle.

Snapshots: ``snapshot_payload`` emits the pool plus per-page dirty versions
and per-leaf ``chunk_hints`` sized to one (layer, page) slab, so the
serve_snapshot delta chunks align to pages and untouched pages frame as
zero-payload COPY ops. ``from_snapshot`` hydrates a replica from a restored
chain (this package's or the JAX package's): it builds the engine at the
snapshot's geometry, which captures the graph, then writes the snapshot
into the engine's buffers in place, so the captured step decodes the
producer's in-flight requests with no prefill.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graphs import CapturedStep
from repro_torch.core import host
from repro_torch.core.host import resolve_device
from repro_torch.core.pytree import flatten_with_path, keystr, tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import embed, mlp, rmsnorm, unembed
from repro_torch.models.transformer import (DENSE_FAMILIES, check_family,
                                            project_qkv)
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache
from repro_torch.serving import prefix as prefix_lib
from repro_torch.serving.engine import Request, make_prefill

PyTree = Any


# ---------------------------------------------------------------------------
# paged decode blocks (x: (B,1,d); kv leaves: (num_pages, page_size, ...))
# ---------------------------------------------------------------------------

def _paged_gqa_attn(p, xn, cfg: ModelConfig, kv, table, lengths, ps, attend,
                    at):
    pos = lengths[:, None]                       # rope position of new token
    q, k, v = project_qkv(p, xn, cfg, pos, at.rope)
    kc = attn_lib.scatter_token(kv["k"], k[:, 0], table, lengths, ps, at.slots)
    vc = attn_lib.scatter_token(kv["v"], v[:, 0], table, lengths, ps, at.slots)
    o = attend(q, kc, vc, table, lengths + 1)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), {"k": kc, "v": vc}


def _paged_mla_attn(p, xn, cfg: ModelConfig, kv, table, lengths, ps, at):
    pos = lengths[:, None]
    ckv_new, krope_new = mla_lib.mla_new_cache_entry(p, xn, cfg, pos)
    ckv = attn_lib.scatter_token(kv["ckv"], ckv_new[:, 0], table, lengths, ps,
                                 at.slots)
    krope = attn_lib.scatter_token(kv["krope"], krope_new[:, 0], table,
                                   lengths, ps, at.slots)
    # MLA decode is a latent-space matmul over the whole prefix: gather the
    # chain into token order and reuse the dense path (masked identically)
    o = mla_lib.mla_decode(p, xn, cfg, attn_lib.gather_pages(ckv, table),
                           attn_lib.gather_pages(krope, table), lengths + 1)
    return o, {"ckv": ckv, "krope": krope}


def _paged_attn(p, xn, cfg, kv, table, lengths, ps, attend, at):
    if cfg.mla is not None:
        return _paged_mla_attn(p, xn, cfg, kv, table, lengths, ps, at)
    return _paged_gqa_attn(p, xn, cfg, kv, table, lengths, ps, attend, at)


def _paged_dense_block(p, x, cfg, kv, table, lengths, ps, attend, at):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = _paged_attn(p["attn"], xn, cfg, kv, table, lengths, ps, attend,
                        at)
    x = x + a
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], xn), kv


def _paged_moe_block(p, x, cfg, kv, table, lengths, ps, attend, at):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = _paged_attn(p["attn"], xn, cfg, kv, table, lengths, ps, attend,
                        at)
    x = x + a
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    y, _ = moe_lib.moe_ffn(p["moe"], xn, cfg, with_aux=False)
    return x + y, kv


def make_paged_decode(cfg: ModelConfig, page_size: int, *,
                      attend: Callable = attn_lib.paged_decode_attention
                      ) -> Callable:
    """decode(params, pool, state, page_table, tokens (B,1), lengths (B,))
    -> (logits, pool, state, lengths+1); ``pool`` is updated in place.

    ``attend`` is the paged attention of GQA layers (default: the kernel
    for CUDA tensors, its plain version for CPU ones); the on-card smoke
    passes the plain version to hold one full-width decode step against
    the kernel. An MoE model decodes its ``first_dense`` dense layers, then
    its MoE layers, over the two parts of its one pool stack; its MLA
    layers gather their chains and attend in plain tensor code, as the JAX
    package does. A hybrid model's global layers attend over the pool and
    its SWA layers over their per-row rings in ``state``; both update
    their SSM state in ``state`` in place. An ssm (xLSTM) model has an
    empty pool and no attention: its mLSTM and sLSTM layers update their
    per-row state in ``state`` in place, and ``attend`` is never called.
    """
    check_family(cfg)
    ps = page_size

    def decode(params, pool, state, page_table, tokens, lengths):
        h = embed(params["embed"], tokens)
        at = E.StepAt(cfg, lengths,
                      attn_lib.token_slots(page_table, lengths, ps))
        dense = lambda x, p, kv: _paged_dense_block(
            p, x, cfg, kv, page_table, lengths, ps, attend, at)
        if cfg.family in DENSE_FAMILIES:
            h, _ = E._scan_decode(params["blocks"], pool["kv"], h, dense)
        elif cfg.family == "hybrid":
            for is_g, p, kv, st in E.hybrid_layers(
                    cfg, params, pool["global_kv"], state["swa_kv"],
                    state["ssm_global"], state["ssm_swa"]):
                if is_g:
                    attn = lambda pa, xn, kv=kv: _paged_gqa_attn(
                        pa, xn, cfg, kv, page_table, lengths, ps, attend, at)
                else:
                    attn = lambda pa, xn, kv=kv: E._gqa_decode_attn(
                        pa, xn, cfg, kv, lengths, at, window=cfg.swa_window)
                h = E._hybrid_decode_block(p, h, cfg, st, attn)
        elif cfg.family == "ssm":
            h = E.xlstm_decode(params, cfg, state, h)
        else:
            kv_d, kv_m = E.split_layers(cfg, pool["kv"])
            if cfg.moe.first_dense:
                h, _ = E._scan_decode(params["dense_blocks"], kv_d, h, dense)
            h, _ = E._scan_decode(
                params["moe_blocks"], kv_m, h,
                lambda x, p, kv: _paged_moe_block(
                    p, x, cfg, kv, page_table, lengths, ps, attend, at))
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = unembed(params["embed"], h, cfg.vocab_size)
        return logits, pool, state, lengths + 1

    return decode


# ---------------------------------------------------------------------------
# page allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Host-side refcounted free list over page ids 1..num_pages-1 (0 is
    scratch).

    Whole chains are reserved at admission, so allocation can never fail
    mid-decode. Pages are reference-counted so one chain can back many
    requests (shared-prefix COW mapping): ``alloc`` hands out pages at
    refcount 1, ``share`` takes another reference on an already-live chain,
    and ``free`` drops one reference — a page returns to the free list only
    when its count reaches zero. Over-free and foreign-page frees raise
    instead of corrupting the list.
    """

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> 1, 2, ...
        self._refs: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = free or out of range)."""
        return self._refs.get(page, 0)

    def refcounts(self) -> dict[int, int]:
        """Snapshot of all live page refcounts (page id -> count)."""
        return dict(self._refs)

    def alloc(self, n: int) -> Optional[list[int]]:
        """Reserve n pages at refcount 1, or None if the pool can't cover
        them."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: list[int]) -> None:
        """Take one more reference on each page of a live chain."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} shared but not allocated")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; reclaim pages that hit zero."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} freed but not allocated")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)

    def state_dict(self) -> dict:
        """JSON-able exact state (free-list order preserved, so a restored
        allocator hands out the same pages in the same order)."""
        return {"num_pages": self.num_pages,
                "free": list(self._free),
                "refs": {str(p): c for p, c in sorted(self._refs.items())}}

    def load_state(self, state: Mapping[str, Any]) -> None:
        """Restore :meth:`state_dict` output bit-exactly."""
        if int(state["num_pages"]) != self.num_pages:
            raise ValueError(
                f"allocator size mismatch: snapshot has "
                f"{state['num_pages']} pages, this pool has {self.num_pages}")
        self._free = [int(p) for p in state["free"]]
        self._refs = {int(p): int(c) for p, c in state["refs"].items()}


# ---------------------------------------------------------------------------
# insert helpers (in place)
# ---------------------------------------------------------------------------

def _split_tree(tree: dict, pool_l: dict, state_l: dict):
    """Partition a prefill cache into (pool-side, state-side) subtrees
    following the ``paged_cache_layout`` split."""
    pool, state = {}, {}
    for k, v in tree.items():
        if k in pool_l and k in state_l:          # mixed subtree
            pool[k], state[k] = _split_tree(v, pool_l[k], state_l[k])
        elif k in pool_l:
            pool[k] = v
        else:
            state[k] = v
    return pool, state


def _insert_state(state: PyTree, state1: PyTree, row: int) -> None:
    """Copy a single-request prefill's per-row state (SWA rings, SSM
    state) into ``row`` of the engine's state, in place."""
    tree_map(lambda full, one: E._set_batch_slot(full, one, row),
             state, state1)


def _insert_pages(pool: PyTree, pool1: PyTree, page_ids: torch.Tensor,
                  ) -> None:
    """Scatter a single-request prefill cache into the reserved pages, in
    place: pool leaf (L, NP, PS, ...) <- pool1 leaf (L, 1, max_len, ...),
    the first n*PS prompt positions reshaped to n page slabs."""
    n = page_ids.shape[0]

    def leaf(full, one):
        layers, _, ps = full.shape[:3]
        chunk = one[:, 0, :n * ps].reshape(layers, n, ps, *one.shape[3:])
        full[:, page_ids] = chunk.to(full.dtype)

    tree_map(leaf, pool, pool1)


def _insert_suffix_pages(pool: PyTree, kv1: PyTree, new_ids: torch.Tensor,
                         page_size: int) -> None:
    """Scatter a shared-prefix admit's suffix KV into its fresh pages, in
    place. The suffix KV arrives at the canonical padded width, which may
    be narrower (zero-pad to the page budget; the new pages also cover
    decode slots) or wider (slice; the tail is never-attended pad) than
    ``n_new * page_size``."""
    n_new = new_ids.shape[0]

    def leaf(full, one):
        want = n_new * page_size
        chunk = one[:, 0, :want]
        pad = want - chunk.shape[1]
        if pad > 0:
            chunk = torch.cat([chunk, chunk.new_zeros(
                (chunk.shape[0], pad, *chunk.shape[2:]))], dim=1)
        chunk = chunk.reshape(one.shape[0], n_new, page_size, *one.shape[3:])
        full[:, new_ids] = chunk.to(full.dtype)

    tree_map(leaf, pool, kv1)


# ---------------------------------------------------------------------------
# continuous-batching engine
# ---------------------------------------------------------------------------

class PagedServingEngine:
    """Continuous batching over a paged KV pool.

    ``num_pages`` x ``page_size`` tokens of KV storage are shared by up to
    ``max_reqs`` concurrent rows; admission needs one free row plus the
    request's full page budget. Decode proceeds while new requests prefill
    into free pages between steps, and completed chains are reclaimed
    immediately. ``params`` must already live on ``device``.

    On CUDA the decode step is captured in a CUDA graph as the engine is
    built, with every row inactive (the table all scratch page 0), before
    any in-situ session exists; ``cuda_graph=False`` keeps the eager step
    there. On the CPU the step is eager whatever ``cuda_graph`` says.
    ``logits`` is the last step's (B, 1, V): under a graph its static
    output, which the next step overwrites.
    """

    def __init__(self, cfg: ModelConfig, params, *, num_pages: int = 65,
                 page_size: int = 16, max_reqs: int = 8,
                 prompt_len: int = 64, max_len: int = 256,
                 device: str | torch.device = "cuda",
                 cuda_graph: bool = True) -> None:
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_reqs = max_reqs
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.pages_per_seq = max_len // page_size

        dev = self.device
        self._pool_layout, self._state_layout = kvcache.paged_cache_layout(
            cfg, num_pages, page_size, max_reqs, max_len)
        self.pool, self.state = kvcache.init_paged_cache(
            cfg, num_pages, page_size, max_reqs, max_len, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.page_table = torch.zeros((max_reqs, self.pages_per_seq), **i32)
        self.lengths = torch.zeros((max_reqs,), **i32)
        self.tokens = torch.zeros((max_reqs, 1), **i32)
        self.active: list[Optional[Request]] = [None] * max_reqs
        self.allocator = PageAllocator(num_pages)
        self._chains: list[list[int]] = [[] for _ in range(max_reqs)]
        self._len_host = np.zeros(max_reqs, np.int64)   # device-sync-free
        self.prefix = prefix_lib.PrefixCache()
        self.prefill_tokens = 0    # tokens actually run through prefill
        self.shared_tokens = 0     # prompt tokens served from shared pages

        self._decode = make_paged_decode(cfg, page_size)
        self._prefill_one = make_prefill(cfg, max_len, last_only=True)
        # attention families right-pad every prompt to one canonical width
        # (prompt_len), as in the JAX package: a prefix a register_prefix
        # writes is then computed at the same shape as the KV an unshared
        # admit of the same tokens would write. Recurrent families (hybrid,
        # ssm) prefill at the prompt's exact length: pad tokens would
        # advance their per-row state past the real prompt.
        self._pad_prompts = cfg.family in prefix_lib.SHAREABLE_FAMILIES
        self._cont_prefill = (prefix_lib.make_continue_prefill(cfg, page_size)
                              if self._pad_prompts else None)

        self._state_version = 0
        self._page_versions = np.zeros(num_pages, np.int64)
        self._chunk_hints = {
            keystr(path): int(np.prod(leaf.shape[2:])) * leaf.element_size()
            for path, leaf in flatten_with_path({"pool": self.pool})}
        self.logits: Optional[torch.Tensor] = None
        self._graph = (CapturedStep(self._step_inplace,
                                    warmup=self._decode_next, device=dev)
                       if cuda_graph and dev.type == "cuda" else None)

    def _ids(self, ids: list[int]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    # -- lifecycle ----------------------------------------------------------

    def admit(self, req: Request) -> bool:
        """Prefill + insert; False when no row or not enough free pages.

        When the prompt starts with a registered prefix, the shared chain
        is mapped read-only into the row's page table (refcount +1 per
        page) and only the divergent suffix is prefilled into fresh pages.
        """
        row = next((i for i, a in enumerate(self.active) if a is None), None)
        if row is None:
            return False
        prompt = E._checked_prompt(req, self.prompt_len)
        s = len(prompt)
        if s + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({s}) + max_new ({req.max_new}) "
                f"exceeds max_len={self.max_len}")
        n_total = -(-(s + req.max_new) // self.page_size)
        entry = self.prefix.match(prompt) if self.prefix else None
        if entry is not None:
            # share before allocating: _alloc_pages evicts refcount-1
            # prefix chains under pool pressure, and the matched entry is
            # refcount-1 until this request references it
            self.allocator.share(entry.pages)
            new_pages = self._alloc_pages(n_total - len(entry.pages))
            if new_pages is None:
                self.allocator.free(entry.pages)   # roll the share back
                return False
            self._insert_shared(row, req, prompt, entry, new_pages)
            return True
        pages = self._alloc_pages(n_total)       # reserve the whole chain
        if pages is None:
            return False
        self._insert(row, req, prompt, pages)
        return True

    def _alloc_pages(self, n: int) -> Optional[list[int]]:
        """Allocate, evicting LRU unreferenced prefixes under pressure."""
        pages = self.allocator.alloc(n)
        while pages is None and self.prefix.evict_lru(self.allocator):
            pages = self.allocator.alloc(n)
        return pages

    def _prefill_prompt(self, prompt: np.ndarray):
        """Prefill at the canonical padded width (attention families) or
        the exact length (recurrent families); logits are for the last
        *real* position either way."""
        if not self._pad_prompts:
            toks = torch.from_numpy(np.asarray(prompt, np.int32)[None, :])
            return self._prefill_one(self.params, toks.to(self.device))
        padded = np.zeros((1, self.prompt_len), np.int32)
        padded[0, :len(prompt)] = prompt
        toks = torch.from_numpy(padded).to(self.device)
        return self._prefill_one(self.params, toks, len(prompt))

    def _set_row(self, row: int, chain: list[int], n_prompt: int,
                 logits: torch.Tensor) -> int:
        """Write the table row (unused slots stay on scratch page 0), the
        length and the first sampled token; returns that token (one device
        sync per admit)."""
        table_row = torch.zeros(self.pages_per_seq, dtype=torch.int32)
        table_row[:len(chain)] = torch.tensor(chain, dtype=torch.int32)
        self.page_table[row] = table_row.to(self.device)
        self.lengths[row] = n_prompt
        nxt = torch.argmax(logits[0, -1]).to(torch.int32)
        self.tokens[row, 0] = nxt
        return int(nxt)

    def _insert(self, row: int, req: Request, prompt: np.ndarray,
                pages: list[int]) -> None:
        logits, cache1, _ = self._prefill_prompt(prompt)
        pool1, state1 = _split_tree(cache1, self._pool_layout,
                                    self._state_layout)
        _insert_pages(self.pool, pool1, self._ids(pages))
        _insert_state(self.state, state1, row)
        req.out.append(self._set_row(row, pages, len(prompt), logits))
        self.active[row] = req
        self._chains[row] = list(pages)
        self._len_host[row] = len(prompt)
        self.prefill_tokens += len(prompt)
        self._state_version += 1
        self._page_versions[pages] = self._state_version

    def _insert_shared(self, row: int, req: Request, prompt: np.ndarray,
                       entry: prefix_lib.PrefixEntry,
                       new_pages: list[int]) -> None:
        """COW admit: continuation-prefill the suffix, scatter into fresh
        pages, map [shared chain ; fresh pages] into the row's table."""
        p0 = entry.length
        # suffixes right-pad to ONE canonical width — the longest suffix
        # any registered prefix can leave (prompt_len - page_size)
        suffix = prompt[p0:]
        padded = np.zeros((1, self.prompt_len - self.page_size), np.int32)
        padded[0, :len(suffix)] = suffix
        logits, kv1 = self._cont_prefill(
            self.params, self.pool, self._ids(entry.pages),
            torch.from_numpy(padded).to(self.device), len(suffix))
        _insert_suffix_pages(self.pool, {"kv": kv1}, self._ids(new_pages),
                             self.page_size)
        chain = list(entry.pages) + list(new_pages)
        req.out.append(self._set_row(row, chain, len(prompt), logits))
        self.active[row] = req
        self._chains[row] = chain
        self._len_host[row] = len(prompt)
        self.prefill_tokens += len(prompt) - p0
        self.shared_tokens += p0
        self._state_version += 1
        self._page_versions[new_pages] = self._state_version

    def register_prefix(self, tokens: Any) -> str:
        """Prefill a shared prompt prefix once and pin its page chain.

        The prefix is truncated to a whole number of pages (sharing is
        page-granular) that leaves room for at least one divergent prompt
        token inside the prompt window. Registering the same tokens twice
        is a no-op returning the same key. The chain is owned by the
        prefix cache at refcount 1; each matching admit adds a reference.
        """
        if self.cfg.family not in prefix_lib.SHAREABLE_FAMILIES:
            raise ValueError(
                f"prefix sharing needs every cache leaf in the page pool; "
                f"family {self.cfg.family!r} keeps per-row recurrent state "
                f"that cannot be shared read-only")
        toks = np.asarray(tokens, np.int32).reshape(-1)
        p0 = (min(len(toks), self.prompt_len - 1)
              // self.page_size * self.page_size)
        if p0 < self.page_size:
            raise ValueError(
                f"prefix of {len(toks)} tokens is shorter than one page "
                f"({self.page_size}) after truncation to the prompt "
                f"window ({self.prompt_len})")
        toks = np.ascontiguousarray(toks[:p0])
        key = prefix_lib.prefix_key(toks)
        if self.prefix.get(key) is not None:
            return key
        pages = self._alloc_pages(p0 // self.page_size)
        if pages is None:
            raise RuntimeError(
                f"cannot register prefix: {p0 // self.page_size} pages "
                f"needed, {self.allocator.free_pages} free")
        _, cache1, _ = self._prefill_prompt(toks)   # chain ends mid-prompt
        pool1, _ = _split_tree(cache1, self._pool_layout, self._state_layout)
        _insert_pages(self.pool, pool1, self._ids(pages))
        self.prefill_tokens += p0
        self._state_version += 1
        self._page_versions[pages] = self._state_version
        self.prefix.add(prefix_lib.PrefixEntry(key=key, tokens=toks,
                                               pages=list(pages)))
        return key

    def unregister_prefix(self, key: str) -> bool:
        """Drop a registered prefix (by the key ``register_prefix``
        returned): the cache's own reference is released and new admits
        stop matching it. In-flight requests that already map the chain
        keep their refcounts. Unknown keys return False.
        """
        return self.prefix.drop(key, self.allocator)

    def free_resource(self, row: int) -> None:
        """Return the chain to the pool and point the row at scratch."""
        self.allocator.free(self._chains[row])
        self._chains[row] = []
        self.active[row] = None
        self.page_table[row] = 0
        self.lengths[row] = 0
        self._len_host[row] = 0

    def _decode_next(self):
        """The JAX engine's ``_step`` on the engine's buffers: (logits,
        greedy next tokens, lengths + 1) as new tensors; the pool takes
        the step's K/V rows in place."""
        logits, _, _, lengths = self._decode(
            self.params, self.pool, self.state, self.page_table,
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
        nxt_host = nxt.cpu().numpy()             # one device->host transfer
        for r, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt_host[r]))
            pos = self._len_host[r]              # slot this decode wrote
            self._page_versions[self._chains[r][pos // self.page_size]] = \
                self._state_version
            self._len_host[r] += 1
            if len(req.out) >= req.max_new:
                req.done = True
                self.free_resource(r)

    def run(self, requests: list[Request], max_steps: int = 512) -> None:
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            if not pending and all(a is None for a in self.active):
                return
            if any(a is not None for a in self.active):
                self.step()

    # -- introspection / in-situ --------------------------------------------

    @property
    def state_version(self) -> int:
        return self._state_version

    def page_stats(self) -> dict[str, float]:
        used = (self.num_pages - 1) - self.allocator.free_pages
        refs = self.allocator.refcounts()
        return {
            "num_pages": self.num_pages,
            "free_pages": self.allocator.free_pages,
            "used_pages": used,
            "page_utilization": used / max(1, self.num_pages - 1),
            "active_requests": sum(a is not None for a in self.active),
            "occupancy": (sum(a is not None for a in self.active)
                          / self.max_reqs),
            "shared_pages": sum(1 for c in refs.values() if c > 1),
        }

    def prefix_stats(self) -> dict[str, Any]:
        """Prefix-cache effectiveness: hit rate, sharing, tokens saved."""
        refs = self.allocator.refcounts()
        st = self.prefix.stats()
        st.update({
            "shared_pages": sum(1 for c in refs.values() if c > 1),
            "pages_saved": sum(c - 1 for c in refs.values()),
            "prefill_tokens": self.prefill_tokens,
            "shared_tokens": self.shared_tokens,
        })
        return st

    def snapshot_payload(self) -> dict[str, Any]:
        """serve_snapshot payload: pool + state + tables + host metadata.

        ``chunk_hints`` sizes each pool leaf's delta chunks to one
        (layer, page) slab and ``page_versions`` records which pages moved,
        so unchanged pages frame as zero-payload COPY ops in the store. The
        ``meta`` leaf is the host-side engine state as JSON bytes, in the
        JAX package's layout, so a chain hydrates a replica of either.
        The tensors are the live ones: the in-situ runtime snapshots them
        (device ``clone``) before the next step writes the pool.
        """
        meta = {
            "engine": {"num_pages": self.num_pages,
                       "page_size": self.page_size,
                       "max_reqs": self.max_reqs,
                       "prompt_len": self.prompt_len,
                       "max_len": self.max_len},
            "allocator": self.allocator.state_dict(),
            "chains": [list(c) for c in self._chains],
            "len_host": self._len_host.tolist(),
            "active": [None if a is None else
                       {"rid": a.rid,
                        "prompt": np.asarray(a.prompt).tolist(),
                        "max_new": a.max_new, "out": list(a.out)}
                       for a in self.active],
            "prefix": self.prefix.state_dict(),
            "counters": {"prefill_tokens": self.prefill_tokens,
                         "shared_tokens": self.shared_tokens},
            "version": self._state_version,
            "page_versions": self._page_versions.tolist(),
        }
        meta_leaf = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        cache = {"pool": self.pool, "state": self.state,
                 "page_table": self.page_table, "lengths": self.lengths,
                 "tokens": self.tokens, "meta": meta_leaf}
        return {"cache": cache, "version": self._state_version,
                "page_versions": self._page_versions.copy(),
                "chunk_hints": dict(self._chunk_hints)}

    # -- replica hydration --------------------------------------------------

    @classmethod
    def from_snapshot(cls, cfg: ModelConfig, params,
                      leaves: Mapping[str, np.ndarray], *,
                      device: str | torch.device = "cuda",
                      cuda_graph: bool = True) -> "PagedServingEngine":
        """Rebuild an engine from a restored ``kv_pages`` snapshot.

        ``leaves`` is ``SnapshotStore.restore``'s flattened-key mapping
        (of either package's chain). The ``meta`` leaf fixes the engine
        geometry and the host state; the array leaves refill the device
        buffers bit-exactly. The engine is built first — on CUDA that
        captures its decode step — and the snapshot is then written into
        the captured buffers in place. The result decodes in lockstep with
        the producer at snapshot time: same page pool, same tables, same
        in-flight requests, same registered prefixes — first token without
        any prefill. ``params`` must already live on ``device``.
        """
        try:
            meta_leaf = leaves["['meta']"]
        except KeyError:
            raise KeyError(
                "snapshot has no 'meta' leaf — it was published by an "
                "engine without hydration metadata (pre-prefix-sharing "
                "chain); re-publish from a current engine") from None
        meta = json.loads(np.asarray(meta_leaf, np.uint8).tobytes())
        eng = cls(cfg, params, device=device, cuda_graph=cuda_graph,
                  **{k: int(v) for k, v in meta["engine"].items()})
        eng._apply_snapshot(leaves, meta)
        return eng

    def load_snapshot(self, leaves: Mapping[str, np.ndarray]) -> None:
        """Re-hydrate *this* engine in place from a restored snapshot.

        Same effect as :meth:`from_snapshot` but keeps the engine's
        captured step — the warm path for repeated catch-up from a newer
        chain point, and what time-to-first-token benchmarks time so they
        measure restore work rather than a capture.
        """
        meta = json.loads(np.asarray(leaves["['meta']"], np.uint8).tobytes())
        geo = {k: int(v) for k, v in meta["engine"].items()}
        mine = {"num_pages": self.num_pages, "page_size": self.page_size,
                "max_reqs": self.max_reqs, "prompt_len": self.prompt_len,
                "max_len": self.max_len}
        if geo != mine:
            raise ValueError(f"snapshot geometry {geo} does not match "
                             f"this engine {mine}; use from_snapshot()")
        self._apply_snapshot(leaves, meta)

    def _apply_snapshot(self, leaves: Mapping[str, np.ndarray],
                        meta: Mapping[str, Any]) -> None:
        """Write the snapshot into the engine's buffers with ``copy_``:
        they keep their addresses, which the captured step reads and
        writes. bf16 leaves arrive as tagged ``uint16`` (this package's
        chains) or ``ml_dtypes`` arrays (the JAX package's);
        ``host.to_tensor`` takes either to ``torch.bfloat16``."""
        template = {"pool": self.pool, "state": self.state,
                    "page_table": self.page_table, "lengths": self.lengths,
                    "tokens": self.tokens}
        flat = flatten_with_path(template)
        for path, buf in flat:
            key = keystr(path)
            if key not in leaves:
                raise KeyError(f"snapshot is missing leaf {key} "
                               f"(engine geometry drifted since publish)")
            src = host.to_tensor(leaves[key])
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(
                    f"snapshot leaf {key} has shape {tuple(src.shape)}, "
                    f"this engine's buffer {tuple(buf.shape)}")
            buf.copy_(src.to(buf.dtype))
        self.allocator.load_state(meta["allocator"])
        self._chains = [[int(p) for p in c] for c in meta["chains"]]
        self._len_host = np.asarray(meta["len_host"], np.int64)
        self.active = [
            None if a is None else Request(
                rid=int(a["rid"]),
                prompt=np.asarray(a["prompt"], np.int32),
                max_new=int(a["max_new"]),
                out=[int(t) for t in a["out"]])
            for a in meta["active"]]
        self.prefix.load_state(meta["prefix"])
        self.prefill_tokens = int(meta["counters"]["prefill_tokens"])
        self.shared_tokens = int(meta["counters"]["shared_tokens"])
        self._state_version = int(meta["version"])
        self._page_versions = np.asarray(meta["page_versions"], np.int64)
