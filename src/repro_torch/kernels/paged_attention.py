"""Paged decode attention: the hand-written Hopper kernel and its plain
version.

Replaces ``src/repro/kernels/paged_attention.py::_decode_kernel``, the
Pallas TPU kernel that walks each request row's page chain with an online
softmax instead of gathering the whole logical cache every decode step.

* CUDA tensors launch ``csrc/paged_attention.cu`` (CUDA C++ for
  ``sm_90a``, built by ``_build`` on first use and bound with ``ctypes``):
  split-K over each row's page table (:func:`split_plan`), the kv heads
  in groups when all of them do not fit a CTA's shared memory
  (:func:`head_group`), page copies in flight, and a fixed-order combine
  of the splits. The source's header
  says what bounds it (bytes: the pages a call must read) and what its
  design does about that.
* CPU tensors take :func:`paged_decode_attention_plain`: gather the rows'
  pages into token order and run the masked softmax of
  ``models.attention.decode_attention``.

The choice is the tensors' device and nothing else: a CUDA call launches
the kernel or raises, it never falls back to the plain version. Every
launch adds one to :attr:`paged_decode_attention.launches`, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448          # H100: 227 KB of dynamic shared memory
SMEM_TWO_CTAS = 113 * 1024       # two CTAs on one SM
ROUND_TOKENS = 32                # a round of pages: at most a lane a token
TARGET_CTAS = 264                # two CTAs on each of an H100's 132 SMs
MIN_SPLIT_KEYS = 384             # (token, kv head) pairs a split reads
MAX_SPLIT_PAGES = 256            # page ids a CTA keeps in shared memory


def split_plan(width: int, page_size: int, b: int, n_kv: int
               ) -> tuple[int, int]:
    """``(splits, pages per split)`` of a ``(b, width)`` page table.

    Split ``s`` of a row takes its pages ``[s * per, min((s + 1) * per,
    width))``. The plan comes from shapes alone, never from ``length``
    (which lives on the card: reading it would sync the host and break the
    capture of a decode step in a CUDA graph). Enough splits that ``b``
    rows fill about ``TARGET_CTAS`` CTAs, each reading at least
    ``MIN_SPLIT_KEYS`` (token, kv head) pairs, so that its fixed cost
    (q, page ids, the first copies' latency, its partial row) stays small
    beside its pages, and at most ``MAX_SPLIT_PAGES`` pages."""
    least = -(-MIN_SPLIT_KEYS // (page_size * n_kv))
    per = max(least, -(-width // max(1, TARGET_CTAS // b)))
    per = min(per, MAX_SPLIT_PAGES, width)
    return -(-width // per), per


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def _layout_bytes(rp: int, nbuf: int, n_h: int, group: int, d_k: int,
                  d_v: int, page_size: int, elem: int, per: int) -> int:
    """Bytes of ``csrc/paged_attention.cu``'s ``layout``: nbuf round
    buffers of rp pages of the CTA's n_h kv heads, then q, acc, p, m, l of
    its query heads in f32 and the split's page ids."""
    hc = n_h * group
    buf = rp * page_size * n_h * (d_k + d_v) * elem
    p_stride = (rp * page_size + 3) & ~3
    return (nbuf * buf + _pad16(hc * d_k * 4) + _pad16(hc * d_v * 4)
            + _pad16(hc * p_stride * 4) + 2 * _pad16(hc * 4)
            + _pad16(per * 4))


def staging(n_h: int, group: int, d_k: int, d_v: int, page_size: int,
            elem: int, per: int) -> tuple[int, int, int]:
    """``(pages a round, round buffers, bytes)`` of one CTA that stages
    ``n_h`` kv heads: the source's ``plan`` (the first layout that lets
    two CTAs share an SM, else one that fits 227 KB, over rounds of up to
    ROUND_TOKENS tokens and 4 down to 2 round buffers), repeated here so
    that the head-group choice is a function of shapes the CPU tests can
    hold. The card's tests hold the bytes against the source's
    ``paged_decode_attention_smem_bytes``. A round is one step of the
    online softmax, so two stagings with the same pages a round give the
    same output bits."""
    rp = 1 if page_size >= ROUND_TOKENS else ROUND_TOKENS // page_size
    rp = min(rp, per)
    for cap in (SMEM_TWO_CTAS, MAX_SMEM_BYTES):
        r = rp
        while r >= 1:
            rounds = -(-per // r)
            for nb in range(max(2, min(rounds + 1, 4)), 1, -1):
                total = _layout_bytes(r, nb, n_h, group, d_k, d_v, page_size,
                                      elem, per)
                if total <= cap:
                    return r, nb, total
            r = (r + 1) // 2 if r > 1 else 0
    return 1, 2, _layout_bytes(1, 2, n_h, group, d_k, d_v, page_size, elem,
                               per)


def smem_bytes(n_h: int, group: int, d_k: int, d_v: int, page_size: int,
               elem: int, per: int) -> int:
    """Shared memory of one CTA that stages ``n_h`` kv heads
    (:func:`staging`)."""
    return staging(n_h, group, d_k, d_v, page_size, elem, per)[2]


def head_group(n_kv: int, group: int, d_k: int, d_v: int, page_size: int,
               elem: int, per: int) -> int:
    """Kv heads a CTA of the split kernel takes (a divisor of ``n_kv``),
    from shapes alone. All of them when their staging fits a CTA (one
    group: the plan of every shape that fit before groups existed), else
    the largest divisor whose staging lets two CTAs share an SM, else the
    largest whose staging fits one. Raises ``ValueError`` naming the shape
    when no divisor fits."""
    fits = [n for n in range(n_kv, 0, -1) if n_kv % n == 0 and smem_bytes(
        n, group, d_k, d_v, page_size, elem, per) <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(
            f"paged_decode_attention: two ({page_size} x 1 x {d_k}+{d_v}) "
            f"pages of {elem}-byte elements with {group} query heads per kv "
            f"head do not fit shared memory ({n_kv} kv heads, splits of "
            f"{per} pages)")
    if fits[0] == n_kv:
        return n_kv
    two = [n for n in fits if smem_bytes(n, group, d_k, d_v, page_size,
                                         elem, per) <= SMEM_TWO_CTAS]
    return two[0] if two else fits[0]


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, length):
    """Gather each row's pages, then masked-softmax decode attention.

    Positions >= ``length`` are NEG_INF; at length 0 every score is
    NEG_INF and the softmax weighs the whole table uniformly.
    """
    from repro_torch.models import attention as attn_lib

    k = attn_lib.gather_pages(k_pages, page_table)
    v = attn_lib.gather_pages(v_pages, page_table)
    return attn_lib.decode_attention(q, k, v, length)


_SIGNATURES = {
    "paged_decode_attention": (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "paged_decode_attention_smem_bytes": ([ctypes.c_int] * 7,
                                          ctypes.c_size_t),
}


def _entry():
    lib = _build.load("paged_attention", _SIGNATURES)
    return lib.paged_decode_attention, lib.paged_decode_attention_smem_bytes


def check_args(q, k_pages, v_pages, page_table, length) -> None:
    """What the kernel takes; raises ``ValueError``/``TypeError`` on
    anything else (device, dtype, contiguity, shape)."""
    ts = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
          "page_table": page_table, "length": length}
    devs = {t.device for t in ts.values()}
    if len(devs) != 1:
        raise ValueError(f"paged_decode_attention: tensors on several "
                         f"devices {sorted(map(str, devs))}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention: q dtype {q.dtype} "
                        f"(kernel takes float32 or bfloat16)")
    for name in ("k_pages", "v_pages"):
        if ts[name].dtype != q.dtype:
            raise TypeError(f"paged_decode_attention: {name} dtype "
                            f"{ts[name].dtype} != q dtype {q.dtype}")
    for name in ("page_table", "length"):
        if ts[name].dtype != torch.int32:
            raise TypeError(f"paged_decode_attention: {name} dtype "
                            f"{ts[name].dtype} (kernel takes int32)")
    for name, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} is not "
                             f"contiguous")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: q shape {tuple(q.shape)} "
                         f"(expected (B, 1, Hq, Dk))")
    b, _, hq, d_k = q.shape
    if k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("paged_decode_attention: pages must be "
                         "(num_pages, page_size, N, D)")
    num_pages, page_size, n_kv, kd = k_pages.shape
    if kd != d_k:
        raise ValueError(f"paged_decode_attention: k head dim {kd} != q "
                         f"head dim {d_k}")
    if v_pages.shape[:3] != k_pages.shape[:3]:
        raise ValueError(f"paged_decode_attention: v_pages "
                         f"{tuple(v_pages.shape)} and k_pages "
                         f"{tuple(k_pages.shape)} disagree")
    if n_kv < 1 or hq % n_kv:
        raise ValueError(f"paged_decode_attention: {hq} query heads do not "
                         f"group over {n_kv} kv heads")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] < 1:
        raise ValueError(f"paged_decode_attention: page_table shape "
                         f"{tuple(page_table.shape)} (expected ({b}, P>=1))")
    if tuple(length.shape) != (b,):
        raise ValueError(f"paged_decode_attention: length shape "
                         f"{tuple(length.shape)} (expected ({b},))")
    if min(b, num_pages, page_size, d_k, v_pages.shape[3]) < 1:
        raise ValueError("paged_decode_attention: empty dimension")
    # pages are copied and read in 16-byte pieces: every head's row and
    # the pools' starts must fall on 16 bytes (every model and test shape
    # does: head dims are multiples of 8)
    for name, d in (("k", d_k), ("v", v_pages.shape[3])):
        if d * q.element_size() % 16:
            raise ValueError(f"paged_decode_attention: {name} head dim {d} "
                             f"x {q.element_size()} bytes is not a multiple "
                             f"of 16 bytes")
    for name in ("k_pages", "v_pages"):
        if ts[name].data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} is not "
                             f"16-byte aligned")


def paged_decode_attention(q, k_pages, v_pages, page_table, length, *,
                           n_h=None):
    """(B,1,Hq,Dk) query over (num_pages, ps, N, Dk/Dv) pages -> (B,1,Hq,Dv)
    in q's dtype. CUDA tensors launch the kernel; CPU tensors take the
    plain version. ``n_h`` overrides :func:`head_group`'s choice of kv
    heads a CTA takes (a divisor of N whose staging fits; the card tests
    hold that one with the same pages a round gives the same bits)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            length)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    check_args(q, k_pages, v_pages, page_table, length)
    b, _, hq, d_k = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    d_v = v_pages.shape[3]
    group = hq // n_kv
    width = page_table.shape[1]
    n_splits, per = split_plan(width, page_size, b, n_kv)
    fn, smem_bytes = _entry()
    if n_h is None:
        n_h = head_group(n_kv, group, d_k, d_v, page_size, q.element_size(),
                         per)
    elif n_h < 1 or n_kv % n_h or smem_bytes(
            n_h, group, d_k, d_v, page_size, q.element_size(),
            per) > MAX_SMEM_BYTES:
        raise ValueError(f"paged_decode_attention: {n_h} kv heads a CTA "
                         f"do not divide {n_kv} or do not fit shared memory")
    out = torch.empty((b, 1, hq, d_v), dtype=q.dtype, device=q.device)
    # each split's (m, l) per head and its f32 accumulator row
    part = (torch.empty(b * n_splits * hq * (2 + d_v), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    with torch.cuda.device(q.device):     # the C side launches on the
        stream = torch.cuda.current_stream().cuda_stream  # current device
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                 v_pages.data_ptr(), page_table.data_ptr(),
                 length.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), b, n_kv, n_h,
                 group, d_k, d_v, page_size, width, n_splits, per,
                 1.0 / math.sqrt(d_k), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed "
                           f"with CUDA error {err}")
    _build.count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
