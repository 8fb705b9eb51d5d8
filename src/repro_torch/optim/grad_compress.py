"""Cross-pod gradient compression: the collective half over
``torch.distributed``, and the int8 wire codec (``int8-ef``) for the
host.

The multi-pod mesh's 'pod' axis rides the slow inter-pod link, so the
cross-pod gradient all-reduce is the collective-bound term of multi-pod
training. This module shrinks its wire bytes:

  none  : a mean over the pod group in the leaf's own dtype
  bf16  : a mean of bf16 operands, cast back (2x fewer bytes than f32)
  int8  : the error-feedback int8 ring — one MAX all-reduce of ``|x|``
          gives a shared scale, each pod's gradient is quantized to int8,
          and n - 1 ring hops to the next pod carry *int8* payloads (4x
          fewer wire bytes than f32), accumulated locally in f32.

The sharded train step (``launch/train.py``) computes each pod's gradient
exactly within the pod and hands it to :func:`tree_reduce` over the pod
group (``DeviceMesh.get_group("pod")``); only the slow axis is
compressed. The quantization residual is carried for error feedback
(:func:`ef_pre` / :func:`ef_post`: compression error is delayed, not
dropped). A method that is ``none``, or a pod group of one, never enters
the ring. :data:`wire` counts the payload bytes of each call; the
collectives themselves are ``distributed/sharding.py``'s, which stage
through host buffers on a gloo group.

:func:`int8_ring_mean_plain` is the ring's plain version over a stacked
``(n, ...)`` tensor: equal to the ring bit for bit (its sums are of
integers, exact in f32 in any order).

The codec is host-only numpy: the same global-amax scale and int8
quantization framed for storage (gradient snapshots, wire-byte
accounting). Its frames are the JAX package's byte for byte: an f64
scale, then a zlib v2 codec frame of the int8 array.
"""
from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import codecs
from repro_torch.core import compression as _compression
from repro_torch.core.pytree import tree_map
from repro_torch.distributed import sharding

PyTree = Any

METHODS = ("none", "bf16", "int8")

#: f32(1/127): the JAX package's ``amax / 127.0`` as XLA compiles it
_INV127 = float(np.float32(1.0 / 127.0))


def pod_size(mesh, axis: str = "pod") -> int:
    """The size of ``mesh``'s ``axis`` (a ``DeviceMesh`` or a
    ``MeshShape``); 1 where the mesh has no such axis."""
    sizes, names = sharding.mesh_geometry(mesh)
    return dict(zip(names, sizes)).get(axis, 1)


#: payload bytes this process put on the wire in this module's reductions,
#: by method (``amax``: the int8 ring's f32 scalar). Under ``int8`` a call
#: adds (n - 1) x numel (one byte an element, each hop); under ``none`` /
#: ``bf16`` the all-reduce's operand bytes
wire = sharding.WireStats(METHODS + ("amax",))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-30) * _INV127


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int8_ring_mean(x: torch.Tensor, group, n: int, *,
                   amax_group=None) -> torch.Tensor:
    """Mean of ``x`` (f32) over the ``n`` ranks of ``group``, int8 on the
    wire: one MAX all-reduce of ``|x|.max()`` over ``amax_group``
    (default ``group``; the whole world where ``x`` is this rank's shard
    of a leaf sharded over the other mesh axes), ``scale = max(amax,
    1e-30) / 127``, ``q = clip(round(x / scale), +-127)`` as int8, then
    n - 1 hops of the int8 payload to group rank ``(i + 1) % n``, each
    added to an f32 accumulator. Returns ``acc * (scale / n)``."""
    x = x.float()
    amax = (torch.amax(torch.abs(x)) if x.numel()
            else torch.zeros((), dtype=torch.float32, device=x.device))
    amax = sharding.all_reduce(amax, "max",
                               group if amax_group is None else amax_group)
    scale = _scale(amax)
    q = _quantize(x, scale)
    acc = q.to(torch.float32)
    buf = q
    for _ in range(n - 1):
        buf = sharding.ring_shift(buf, group)          # int8 on the wire
        acc = acc + buf.to(torch.float32)
    wire.add("int8", (n - 1) * q.numel())
    wire.add("amax", amax.element_size())
    return acc * (scale / n)


def int8_ring_mean_plain(xs: torch.Tensor,
                         amax: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The ring's plain version: ``xs`` stacks the n ranks' inputs on a
    leading axis; ``amax`` is the all-reduced one where the inputs are
    shards (default ``|xs|.max()``). Equals every rank's
    :func:`int8_ring_mean` bit for bit."""
    xs = xs.float()
    n = xs.shape[0]
    if amax is None:
        amax = (torch.amax(torch.abs(xs)) if xs.numel() else
                torch.zeros((), dtype=torch.float32, device=xs.device))
    scale = _scale(amax)
    acc = _quantize(xs, scale).to(torch.float32).sum(0)
    return acc * (scale / n)


def reduce_leaf(g: torch.Tensor, *, method: str, group, n: int,
                amax_group=None) -> torch.Tensor:
    """Cross-pod mean of one gradient leaf over the pod ``group`` of
    ``n`` ranks, in ``g``'s dtype."""
    if method == "none" or n <= 1:
        if n <= 1:
            return g
        wire.add("none", g.numel() * g.element_size())
        return sharding.all_reduce(g, "sum", group) / n
    if method == "bf16":
        b = g.to(torch.bfloat16)
        wire.add("bf16", b.numel() * b.element_size())
        return (sharding.all_reduce(b, "sum", group) / n).to(g.dtype)
    if method == "int8":
        return int8_ring_mean(g.float(), group, n,
                              amax_group=amax_group).to(g.dtype)
    raise ValueError(f"unknown grad-compression method {method!r}")


def tree_reduce(grads: PyTree, *, method: str, group, n: int,
                amax_group=None) -> PyTree:
    """:func:`reduce_leaf` of every leaf, in the tree's flatten order on
    every rank."""
    return tree_map(lambda g: reduce_leaf(g, method=method, group=group,
                                          n=n, amax_group=amax_group),
                    grads)


# -- error feedback ------------------------------------------------------------

def ef_init(params: PyTree) -> PyTree:
    """Residual buffer, bf16 (it stores already-small quantization
    leftovers)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device), params)


def ef_pre(grads: PyTree, residual: PyTree) -> PyTree:
    """Add the carried residual before compression."""
    return tree_map(lambda g, r: g + r.to(g.dtype), grads, residual)


def ef_post(grads_pre: PyTree, grads_reduced: PyTree) -> PyTree:
    """New residual = what the compressed reduction lost this step."""
    return tree_map(lambda a, b: (a.to(torch.float32) - b.to(torch.float32))
                    .to(torch.bfloat16), grads_pre, grads_reduced)


# ---------------------------------------------------------------------------
# registry adapter: the int8 ring's wire format as a host-side codec
# ---------------------------------------------------------------------------

class Int8WireCodec:
    lossy = True
    name = "int8-ef"

    def encode(self, arr: np.ndarray) -> bytes:
        arr = np.asarray(arr, np.float32)
        amax = float(np.max(np.abs(arr))) if arr.size else 0.0
        scale = max(amax, 1e-30) / 127.0
        q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        framed, _ = codecs.encode(q, "zlib")
        return struct.pack("<d", scale) + framed

    def decode(self, blob: bytes) -> np.ndarray:
        (scale,) = struct.unpack_from("<d", blob, 0)
        return codecs.decode(blob[8:]).astype(np.float32) * scale

    def error_bound(self) -> float:
        # max abs error is scale/2 = amax/254 per element; for any signal
        # with amax <= ~8 sigma that is rel-L2 <= 8/254 — round up.
        return 0.05


_compression.register(Int8WireCodec())
