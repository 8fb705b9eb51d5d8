"""Split-K over the page table, as the card's paged decode-attention kernel
runs it, checked on the CPU.

* ``split_plan`` (the wrapper's choice of splits, from shapes alone) covers
  every page of a table once, in order, at every width 1..300 and the card
  tests' page sizes.
* A torch reference of the kernel's arithmetic, written here: each split's
  (m, l, acc) over its own pages, a split wholly past a nonzero length
  reading nothing and weighing 0, then the combine in split order with
  weights exp(m_s - max_s m_s). It is held against the Pallas kernel in
  interpret mode and against ``paged_decode_attention_plain`` for every
  split layout the plan gives at the table's width, at lengths 0 (every
  score NEG_INF: the whole table weighed uniformly), 1, a page and one
  past it, full, half and one short of full, and on and beside a split's
  edge. f32 at rtol/atol 1e-5: the splits only change the order of the
  softmax's sums.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as JPK
from repro_torch.kernels import paged_attention as PK

F32_TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
PAGE_SIZES = (5, 8, 16)          # tests/test_torch_paged_attention_card.py


@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_split_plan_covers_every_page_once_in_order(page_size):
    for width in range(1, 301):
        for b in (1, 6, 8, 33, 300):
            for n_kv in (1, 3, 8):
                n, per = PK.split_plan(width, page_size, b, n_kv)
                assert 1 <= per <= min(width, PK.MAX_SPLIT_PAGES)
                pages = [p for s in range(n)
                         for p in range(s * per, min((s + 1) * per, width))]
                assert pages == list(range(width)), (width, b, n_kv)
                assert (n - 1) * per < width       # no empty split


def test_long_context_fills_the_card_from_shapes_alone():
    """The smoke's long shape (B=8, 3 kv heads, a 256-page table of 16
    tokens): at least B * N * 2 CTAs, where one per (row, kv head) gave
    B * N; and the plan takes no length."""
    n, per = PK.split_plan(256, 16, 8, 3)
    assert 8 * n >= 8 * 3 * 2 and n * per >= 256
    assert list(inspect.signature(PK.split_plan).parameters) == [
        "width", "page_size", "b", "n_kv"]


def test_wrapper_reads_nothing_from_the_device():
    """No host read of length or the table: the call stays capturable in a
    CUDA graph and never syncs."""
    src = inspect.getsource(PK.paged_decode_attention)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(length",
                 "synchronize("):
        assert call not in src, call


def split_reference(q, k_pages, v_pages, table, length, n_splits, per):
    """f32: per split, (m, l, acc) over its pages; the splits combined in
    order."""
    b, _, hq, d_k = q.shape
    _, ps, n_kv, _ = k_pages.shape
    d_v = v_pages.shape[3]
    group, width = hq // n_kv, table.shape[1]
    out = torch.empty((b, 1, hq, d_v))
    for r in range(b):
        n = int(length[r])
        n_pages = min(width, -(-n // ps)) if n > 0 else width
        parts = []
        for s in range(n_splits):
            pages = list(range(s * per, min((s + 1) * per, n_pages)))
            if not pages:                   # past the length: weight 0
                parts.append((torch.full((hq,), NEG_INF), torch.zeros(hq),
                              torch.zeros(hq, d_v)))
                continue
            ids = table[r, pages].long()
            k = k_pages[ids].reshape(-1, n_kv, d_k).repeat_interleave(
                group, dim=1)                               # (T, Hq, Dk)
            v = v_pages[ids].reshape(-1, n_kv, d_v).repeat_interleave(
                group, dim=1)
            pos = torch.arange(pages[0] * ps, (pages[-1] + 1) * ps)
            sc = torch.einsum("hd,thd->ht", q[r, 0], k) / math.sqrt(d_k)
            sc = torch.where(pos[None] < n, sc, NEG_INF)
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("ht,thd->hd", p, v)))
        big_m = torch.stack([m for m, _, _ in parts]).max(0).values
        l_sum, acc = torch.zeros(hq), torch.zeros(hq, d_v)
        for m, l_s, a_s in parts:                  # in split order
            w = torch.exp(m - big_m)
            l_sum = l_sum + w * l_s
            acc = acc + w[:, None] * a_s
        out[r, 0] = acc / torch.clamp(l_sum, min=1e-37)[:, None]
    return out


@pytest.mark.parametrize("group,ps,d_k,d_v", [
    (1, 8, 16, 16),
    (3, 16, 16, 8),
    (2, 5, 24, 40),
])
def test_split_combine_matches_pallas_and_plain(group, ps, d_k, d_v):
    n_kv, width = 3, 64
    full = ps * width
    lengths = [0, 1, ps, ps + 1, full, full // 2 + 3, full - 1]
    b = len(lengths) + 2
    _, per = PK.split_plan(width, ps, b, n_kv)
    lengths += [per * ps, per * ps + 1]          # on and beside a split edge
    rng = np.random.default_rng(group * 1000 + ps * 10 + d_k)
    num_pages = b * width + 1
    k = rng.standard_normal((num_pages, ps, n_kv, d_k)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, n_kv, d_v)).astype(np.float32)
    q = rng.standard_normal((b, 1, n_kv * group, d_k)).astype(np.float32)
    table = (1 + rng.permutation(b * width)).reshape(b, width).astype(
        np.int32)
    ln = np.asarray(lengths, np.int32)
    targs = tuple(map(torch.from_numpy, (q, k, v, table, ln)))
    pallas = np.asarray(JPK.paged_decode_attention(
        *map(jnp.asarray, (q, k, v, table, ln)), interpret=True))
    plain = PK.paged_decode_attention_plain(*targs).numpy()
    layouts = sorted({PK.split_plan(width, ps, bb, nn)
                      for bb in range(1, 301) for nn in (1, 2, 3, 4, 8)})
    assert len({n for n, _ in layouts}) > 1
    for n_splits, per in layouts:
        got = split_reference(*targs, n_splits, per).numpy()
        np.testing.assert_allclose(got, pallas, **F32_TOL,
                                   err_msg=f"{n_splits} splits of {per}")
        np.testing.assert_allclose(got, plain, **F32_TOL,
                                   err_msg=f"{n_splits} splits of {per}")
