"""The int8 error-feedback wire codec (``int8-ef``) of the cross-pod
gradient path, as a host-side registry codec.

The JAX package's ``optim/grad_compress.py`` holds two halves: the int8
ring all-reduce over the mesh's slow 'pod' axis (a ``shard_map`` with
int8 ``ppermute`` payloads and error feedback), and this codec — the same
global-amax scale and int8 quantization that ride the ring, framed for
storage (gradient snapshots, wire-byte accounting). The codec is host-only
numpy and lands here; the ring waits for the port's distributed slice
(ROADMAP.md, queue 1: 'Distribution and faults').

Frames are the JAX package's byte for byte: an f64 scale, then a zlib v2
codec frame of the int8 array.
"""
from __future__ import annotations

import struct

import numpy as np

from repro_torch.core import codecs
from repro_torch.core import compression as _compression


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
