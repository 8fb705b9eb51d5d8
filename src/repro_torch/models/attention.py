"""Chunked (flash-style) attention in plain PyTorch, GQA + decode paths.

Why chunked: long prefills would otherwise materialize S x S score tensors
per head. The online-softmax recurrence over KV chunks bounds live memory
to (q_chunk x kv_chunk) per head group. Causality is flop-exact: the loop
for q-chunk i only runs over the kv-chunks it can see.

GQA never materializes repeated KV heads: scores are computed in grouped
layout (batch, kv_head, group, q, k). Layouts at the public functions are
the JAX package's — (B, S, heads, D) — so the parity tests compare like
with like.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,N,G,D) with N=kv heads, G=Hq//N."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _chunk_scores(q5: torch.Tensor, k: torch.Tensor,
                  scale: float) -> torch.Tensor:
    # q5: (B,Sq,N,G,D), k: (B,Sk,N,D) -> (B,N,G,Sq,Sk) fp32
    return torch.einsum("bsngd,btnd->bngst", q5, k).float() * scale


def flash_attention(
    q: torch.Tensor,       # (B, Sq, Hq, D)
    k: torch.Tensor,       # (B, Sk, N, D)
    v: torch.Tensor,       # (B, Sk, N, Dv)
    *,
    causal: bool = True,
    q_offset: int = 0,     # absolute position of q[0] (prefill continuation)
    window: int = 0,       # 0 = full; else sliding window (causal only)
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, sk, n_kv, dv = v.shape
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        # one chunk when shapes don't tile (smoke configs)
        q_chunk, kv_chunk = sq, sk

    g = hq // n_kv
    dev = q.device
    out = []
    for i in range(sq // q_chunk):
        qs = i * q_chunk                       # chunk start (relative)
        q_abs = q_offset + qs                  # absolute start
        qi = _grouped(q[:, qs:qs + q_chunk], n_kv)
        # visible kv range for this q chunk
        hi = min(sk, q_abs + q_chunk) if causal else sk
        lo = 0
        if window:
            # earliest key visible to the FIRST q row of this chunk
            lo = max(0, q_abs - (window - 1))
            lo = (lo // kv_chunk) * kv_chunk   # align down to chunk grid
        n_kv_chunks = max(1, math.ceil((hi - lo) / kv_chunk))
        q_pos = q_abs + torch.arange(q_chunk, device=dev)

        m = torch.full((b, n_kv, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, n_kv, g, q_chunk), device=dev)
        acc = torch.zeros((b, n_kv, g, q_chunk, dv), device=dev)
        for j in range(n_kv_chunks):
            start = lo + j * kv_chunk
            kj = k[:, start:start + kv_chunk]
            vj = v[:, start:start + kv_chunk]
            s = _chunk_scores(qi, kj, scale)   # (B,N,G,Sq,KV)
            kv_pos = start + torch.arange(kv_chunk, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= kv_pos[None, :]
            if window:
                mask &= q_pos[:, None] - kv_pos[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bngst,btnd->bngsd", p.to(vj.dtype), vj)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-37)
        # (B,N,G,Sq,Dv) -> (B,Sq,Hq,Dv)
        o = o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq, dv)
        out.append(o.to(v.dtype))
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]


def decode_attention(
    q: torch.Tensor,          # (B, 1, Hq, D)
    k_cache: torch.Tensor,    # (B, S, N, D)
    v_cache: torch.Tensor,    # (B, S, N, Dv)
    length: torch.Tensor,     # (B,) valid prefix length (after current insert)
    *,
    window: int = 0,
    ring: bool = False,       # cache is a ring buffer (SWA): all slots valid
) -> torch.Tensor:
    """Single-token attention over a (possibly ring) KV cache. Positions
    >= length are masked to NEG_INF, and with ``window`` those before
    ``length - window``; a ring cache holds ``min(length, S)`` valid
    slots in ring order."""
    b, s, n_kv, dv = v_cache.shape
    hq = q.shape[2]
    g = hq // n_kv
    scale = 1.0 / math.sqrt(q.shape[-1])
    q5 = q.reshape(b, 1, n_kv, g, -1)
    scores = torch.einsum("bsngd,btnd->bngst", q5, k_cache).float()
    scores = scores * scale                       # (B,N,G,1,S)
    pos = torch.arange(s, device=q.device)
    if ring:
        valid = pos[None, :] < torch.clamp(length, max=s)[:, None]
    else:
        valid = pos[None, :] < length[:, None]
        if window:
            valid &= pos[None, :] >= (length[:, None] - window)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bngst,btnd->bngsd", p.to(v_cache.dtype), v_cache)
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, dv)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Materialize per-request sequences from a block-indexed page pool.

    ``pages``: (num_pages, page_size, ...) — one pool shared by every
    request; ``page_table``: (B, P) int32 page ids (unused entries point at
    the reserved scratch page 0 and are masked by ``length`` downstream).
    Returns (B, P*page_size, ...) in token order: position ``t`` of row
    ``b`` lives in page ``page_table[b, t // page_size]`` at offset
    ``t % page_size``.
    """
    b, p = page_table.shape
    g = pages[page_table]                 # (B, P, page_size, ...)
    return g.reshape(b, p * pages.shape[1], *pages.shape[2:])


def token_slots(page_table: torch.Tensor, lengths: torch.Tensor,
                page_size: int) -> tuple:
    """Where :func:`scatter_token` writes each row's token: (page, slot,
    the row whose values land there). One decode step computes them once
    for every layer and leaf."""
    b, p = page_table.shape
    rows = torch.arange(b, device=page_table.device)
    idx = torch.clamp(lengths // page_size, max=p - 1).long()
    page = page_table[rows, idx].long()
    slot = (lengths % page_size).long()
    target = page * page_size + slot
    same = target[:, None] == target[None, :]                # (B, B)
    last = torch.amax(torch.where(same, rows[None, :], -1), dim=1)
    return page, slot, last


def scatter_token(pages: torch.Tensor, new: torch.Tensor,
                  page_table: torch.Tensor, lengths: torch.Tensor,
                  page_size: int, slots: Optional[tuple] = None
                  ) -> torch.Tensor:
    """Write one new token per row into its page: position ``lengths[b]``.

    Updates ``pages`` **in place** (and returns it): the pool is the
    largest tensor of the serving state, and the JAX package's functional
    ``.at[].set`` would copy it once per layer per step.

    ``new``: (B, ...) — the freshly projected k/v rows. Rows whose length
    exceeds the table (inactive/finished requests) clamp to their last
    table entry, which the engine keeps pointed at the scratch page 0.
    Inactive rows can write the same scratch slot; the last such row wins,
    as in the JAX package's scatter on the CPU. Every row of a duplicate
    writes the last one's values, so the result does not depend on the
    order in which the card's threads land. It matters: an inactive row
    attends over page 0, and in the MoE family its routing competes with
    the active rows' for expert capacity. ``slots`` is
    :func:`token_slots` of the same table and lengths, when the caller
    has it.
    """
    page, slot, last = (slots if slots is not None
                        else token_slots(page_table, lengths, page_size))
    pages[page, slot] = new[last].to(pages.dtype)
    return pages


def paged_decode_attention(
    q: torch.Tensor,          # (B, 1, Hq, D)
    k_pages: torch.Tensor,    # (num_pages, page_size, N, D)
    v_pages: torch.Tensor,    # (num_pages, page_size, N, Dv)
    page_table: torch.Tensor,  # (B, P) int32
    length: torch.Tensor,     # (B,) valid prefix length (after insert)
) -> torch.Tensor:
    """Single-token attention over a paged KV cache.

    Dispatches on the tensors' device: CUDA tensors go to the hand-written
    Hopper kernel in :mod:`repro_torch.kernels.paged_attention`, CPU tensors
    to its plain version (gather the row's pages, then
    :func:`decode_attention`). There is no fallback between the two.
    """
    from repro_torch.kernels import paged_attention as PK
    return PK.paged_decode_attention(q, k_pages, v_pages, page_table, length)


def reference_attention(q, k, v, *, causal=True, q_offset=0, window=0):
    """O(S^2) oracle used by tests."""
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    q5 = _grouped(q, n_kv)
    s = _chunk_scores(q5, k, 1.0 / math.sqrt(d))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngst,btnd->bngsd", p.to(v.dtype), v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, v.shape[-1])
