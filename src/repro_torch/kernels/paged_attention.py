"""Paged decode attention: the hand-written Hopper kernel and its plain
version.

Replaces ``src/repro/kernels/paged_attention.py::_decode_kernel``, the
Pallas TPU kernel that walks each request row's page chain with an online
softmax instead of gathering the whole logical cache every decode step.

* CUDA tensors launch ``csrc/paged_attention.cu`` (CUDA C++ for
  ``sm_90a``, built by ``_build`` on first use and bound with ``ctypes``).
  The source's header says what bounds it (memory: the pages a call must
  read) and what its design does about that.
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
import functools
import math

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448          # H100: 227 KB of dynamic shared memory


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, length):
    """Gather each row's pages, then masked-softmax decode attention.

    Positions >= ``length`` are NEG_INF; at length 0 every score is
    NEG_INF and the softmax weighs the whole table uniformly.
    """
    from repro_torch.models import attention as attn_lib

    k = attn_lib.gather_pages(k_pages, page_table)
    v = attn_lib.gather_pages(v_pages, page_table)
    return attn_lib.decode_attention(q, k, v, length)


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.paged_decode_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_size_t
    return fn, smem


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


def paged_decode_attention(q, k_pages, v_pages, page_table, length):
    """(B,1,Hq,Dk) query over (num_pages, ps, N, Dk/Dv) pages -> (B,1,Hq,Dv)
    in q's dtype. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
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
    fn, smem_bytes = _entry()
    if smem_bytes(group, d_k, d_v, page_size) > MAX_SMEM_BYTES:
        raise ValueError(
            f"paged_decode_attention: a ({page_size} x {d_k}+{d_v}) page "
            f"with {group} query heads per kv head does not fit shared memory")
    out = torch.empty((b, 1, hq, d_v), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):     # the C side launches on the
        stream = torch.cuda.current_stream().cuda_stream  # current device
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                 v_pages.data_ptr(), page_table.data_ptr(),
                 length.data_ptr(), out.data_ptr(), b, n_kv, group, d_k,
                 d_v, page_size, page_table.shape[1], 1.0 / math.sqrt(d_k),
                 stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed "
                           f"with CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
