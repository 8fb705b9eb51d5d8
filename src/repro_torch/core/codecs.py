"""Host-side lossless codecs + chunked tensor framing (the paper's Table II
layer).

The paper evaluates Bzip2 / LZ4 / LZ4HC / ZLIB / ZSTD on raw floating-point
simulation output (Table II) and finds plain lossless compression removes only
1.5-10 % — which is exactly why the lossy+lossless *hybrid* pipeline exists.
We reproduce that comparison on training-state tensors (bf16/f32 weights,
moments) in ``benchmarks/tab2_codecs.py``.

Framing (v2): every compressed tensor is self-describing —
  MAGIC | version | codec id | dtype | ndim | shape | raw nbytes
        | chunk size | n_chunks | per-chunk compressed sizes | payloads
Each chunk is an *independently* compressed ``memoryview`` slice of the
array's buffer (stream codecs over the view — the raw bytes are never
copied into an intermediate ``tobytes()`` string, and the final frame is
assembled with a single ``join``). Independent chunks are what make the
codec chunk-parallel: encode and decode both fan chunks out across a thread
pool (stdlib codecs release the GIL, so this is real parallelism), and a
decoder can stream-decode without out-of-band metadata. v1 frames (single
stream, pre-chunking) still decode — old checkpoints restore unchanged.

All stdlib codecs (zlib/bz2/lzma) release the GIL during (de)compression, so
async in-situ workers genuinely overlap with the host-side training loop —
this is what makes the in-process analog of the paper's MPMD split honest.
"""
from __future__ import annotations

import bz2
import lzma
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core import host

MAGIC = b"RPRC"
_VERSION = 2
_V1 = 1
DEFAULT_CHUNK = 1 << 20        # 1 MiB raw bytes per independently-coded chunk


def _stream(factory) -> Callable[[bytes], bytes]:
    """One-shot wrapper over a compressobj factory; accepts any buffer
    (memoryview slices included) without copying it to bytes first."""
    def comp(data):
        c = factory()
        head = c.compress(data)
        tail = c.flush()
        return head + tail if head else tail
    return comp


# codec registry: name -> (id, compress, decompress); both sides take
# bytes-like buffers (bytes, memoryview) — never force a copy on the caller.
_COMPRESSORS: dict[str, tuple[int, Callable[[bytes], bytes],
                              Callable[[bytes], bytes]]] = {
    "none": (0, lambda b: b, lambda b: b),
    "zlib": (1, _stream(lambda: zlib.compressobj(6)), zlib.decompress),
    "zlib1": (2, _stream(lambda: zlib.compressobj(1)), zlib.decompress),
    "zlib9": (3, _stream(lambda: zlib.compressobj(9)), zlib.decompress),
    "bz2": (4, _stream(lambda: bz2.BZ2Compressor(9)), bz2.decompress),
    "lzma": (5, _stream(lambda: lzma.LZMACompressor(preset=1)),
             lzma.decompress),
}

try:  # optional, mirrors the paper's ZSTD/LZ4 rows when available
    import zstandard  # type: ignore

    _COMPRESSORS["zstd"] = (
        6,
        lambda b: zstandard.ZstdCompressor(level=3).compress(bytes(b)),
        lambda b: zstandard.ZstdDecompressor().decompress(bytes(b)),
    )
except ImportError:
    pass

try:
    import lz4.frame  # type: ignore

    _COMPRESSORS["lz4"] = (7, lambda b: lz4.frame.compress(bytes(b)),
                           lambda b: lz4.frame.decompress(bytes(b)))
except ImportError:
    pass

_BY_ID = {cid: (name, c, d) for name, (cid, c, d) in _COMPRESSORS.items()}


def available() -> list[str]:
    return sorted(_COMPRESSORS)


def compressor(codec: str) -> tuple[int, Callable[[bytes], bytes],
                                    Callable[[bytes], bytes]]:
    """(codec id, compress, decompress) for ``codec`` — the hook streamed
    framing paths use to compress chunk buffers they produced themselves
    (e.g. device-sliced int8 chunks) while keeping the frame format
    identical to ``encode``."""
    if codec not in _COMPRESSORS:
        raise KeyError(f"unknown codec {codec!r}; available: {available()}")
    return _COMPRESSORS[codec]


# ---------------------------------------------------------------------------
# shared chunk pool: one lazily-created executor the checkpoint encode stage
# and restore path fan chunk (de)compression out on. GIL-released stdlib
# codecs make this real parallelism without forking the process.
# ---------------------------------------------------------------------------

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def codec_pool() -> ThreadPoolExecutor:
    """Process-wide chunk-compression pool (lazily created)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=max(2, os.cpu_count() or 2),
                thread_name_prefix="codec")
        return _pool


@dataclass(frozen=True)
class CompressionStats:
    codec: str
    raw_bytes: int
    compressed_bytes: int

    @property
    def ratio(self) -> float:
        """Paper Eq. (1): CR = (original - compressed) / original."""
        if self.raw_bytes == 0:
            return 0.0
        return (self.raw_bytes - self.compressed_bytes) / self.raw_bytes


def _dtype_token(dtype: np.dtype) -> bytes:
    """Self-describing dtype token. bf16 — the port's tagged uint16 host
    arrays (:data:`repro_torch.core.host.BF16`) and ``ml_dtypes`` arrays
    alike — is recorded by its logical name ``bfloat16``, as the JAX
    package writes it; every other dtype by its invertible ``.str``. The
    delta framing shares these helpers."""
    name = host.logical_name(dtype)
    if name is not None:
        return name.encode()
    return np.dtype(dtype).str.encode()


def _dtype_from_token(token: str) -> np.dtype:
    """Inverse of :func:`_dtype_token`; ``bfloat16`` decodes to the tagged
    uint16 host dtype (a torch bf16 view away from a tensor), so reading a
    frame never needs ``ml_dtypes``."""
    if token == "bfloat16":
        return host.BF16
    return np.dtype(token)


def _byte_view(arr: np.ndarray) -> memoryview:
    """Zero-copy byte view of a contiguous array (no ``tobytes()``).

    Goes through a uint8 view rather than ``memoryview(...).cast`` because
    extension dtypes (``ml_dtypes`` bfloat16) have no buffer-protocol
    format.
    """
    return memoryview(arr.reshape(-1).view(np.uint8))


def _chunk_views(arr: np.ndarray, chunk_bytes: int) -> list[memoryview]:
    if arr.nbytes == 0:
        return []
    mv = _byte_view(arr)
    return [mv[off:off + chunk_bytes]
            for off in range(0, len(mv), chunk_bytes)]


def assemble_frame(codec: str, dtype, shape, raw_nbytes: int,
                   chunk_bytes: int, payloads: list[bytes]) -> bytes:
    """Assemble a v2 frame from already-compressed chunk payloads.

    Byte-identical to ``encode()`` of the same logical array — streamed
    producers (per-chunk D2H + compress) share the exact frame layout."""
    cid, _, _ = compressor(codec)
    dt = _dtype_token(np.dtype(dtype))
    ndim = len(shape)
    parts = [
        MAGIC,
        struct.pack("<BBB", _VERSION, cid, len(dt)), dt,
        struct.pack("<B", ndim),
        struct.pack(f"<{ndim}q", *shape),
        struct.pack("<qqI", raw_nbytes, int(chunk_bytes), len(payloads)),
        struct.pack(f"<{len(payloads)}I", *(len(p) for p in payloads)),
        *payloads,
    ]
    return b"".join(parts)


def encode(arr: np.ndarray, codec: str = "zlib", *,
           chunk_bytes: int = DEFAULT_CHUNK,
           pool: Optional[ThreadPoolExecutor] = None
           ) -> tuple[bytes, CompressionStats]:
    """Frame + losslessly compress one ndarray, chunk by chunk.

    ``pool`` (e.g. ``codec_pool()``) compresses the chunks of a multi-chunk
    array concurrently; the frame layout is identical either way.
    """
    _, comp, _ = compressor(codec)
    arr = np.ascontiguousarray(arr)
    views = _chunk_views(arr, int(chunk_bytes))
    if pool is not None and len(views) > 1:
        payloads = list(pool.map(comp, views))
    else:
        payloads = [comp(v) for v in views]
    blob = assemble_frame(codec, arr.dtype, arr.shape, arr.nbytes,
                          int(chunk_bytes), payloads)
    return blob, CompressionStats(codec, arr.nbytes, len(blob))


def decode(blob: bytes, *,
           pool: Optional[ThreadPoolExecutor] = None) -> np.ndarray:
    """Decode a framed tensor (v2 chunked, or a legacy v1 single-stream).

    v2 chunks are independent, so ``pool`` fans the decompression out; each
    chunk lands at its offset in one preallocated buffer (no concat copy).
    """
    if bytes(blob[:4]) != MAGIC:
        raise ValueError("bad frame magic")
    view = memoryview(blob)
    version, cid, dtlen = struct.unpack_from("<BBB", blob, 4)
    off = 7
    dtype = _dtype_from_token(bytes(view[off:off + dtlen]).decode())
    off += dtlen
    (ndim,) = struct.unpack_from("<B", blob, off)
    off += 1
    shape = struct.unpack_from(f"<{ndim}q", blob, off)
    off += 8 * ndim
    _, _, decomp = _BY_ID[cid]
    if version == _V1:
        # legacy single-stream frame: payload is one compressed run of the
        # whole raw buffer (old checkpoints restore through this path).
        (raw_nbytes,) = struct.unpack_from("<q", blob, off)
        off += 8
        raw = decomp(view[off:])
        if len(raw) != raw_nbytes:
            raise ValueError(
                f"frame length mismatch: {len(raw)} != {raw_nbytes}")
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    if version != _VERSION:
        raise ValueError(f"unsupported frame version {version}")
    raw_nbytes, chunk_bytes, n_chunks = struct.unpack_from("<qqI", blob, off)
    off += 20
    if chunk_bytes < 1 or raw_nbytes < 0:
        raise ValueError("corrupt chunk header")
    want_chunks = -(-raw_nbytes // chunk_bytes)   # ceil; 0 for empty arrays
    if n_chunks != want_chunks:
        # v1 raised on a short payload; the chunk table must cover the raw
        # buffer exactly or the tail would silently decode as zeros.
        raise ValueError(
            f"chunk table mismatch: {n_chunks} chunks cannot cover "
            f"{raw_nbytes} raw bytes at {chunk_bytes} per chunk")
    sizes = struct.unpack_from(f"<{n_chunks}I", blob, off)
    off += 4 * n_chunks
    out = bytearray(raw_nbytes)

    jobs = []
    in_off = off
    for i, size in enumerate(sizes):
        jobs.append((in_off, size, i * chunk_bytes))
        in_off += size

    def _one(job: tuple[int, int, int]) -> None:
        src, size, dst = job
        raw = decomp(view[src:src + size])
        want = min(chunk_bytes, raw_nbytes - dst)
        if len(raw) != want:
            raise ValueError(f"chunk length mismatch: {len(raw)} != {want}")
        out[dst:dst + len(raw)] = raw

    if pool is not None and len(jobs) > 1:
        list(pool.map(_one, jobs))
    else:
        for job in jobs:
            _one(job)
    if raw_nbytes == 0:
        return np.empty(shape, dtype=dtype)
    return np.frombuffer(out, dtype=dtype).reshape(shape)


def compression_ratio(arr: np.ndarray, codec: str) -> CompressionStats:
    """Measure-only path (paper Table II): no framing overhead included."""
    _, comp, _ = _COMPRESSORS[codec]
    arr = np.ascontiguousarray(arr)
    return CompressionStats(codec, arr.nbytes, len(comp(_byte_view(arr))))


# ---------------------------------------------------------------------------
# registry adapter: every framed lossless codec is a repro_torch.core.compression
# Codec (exact roundtrip, self-describing frame).
# ---------------------------------------------------------------------------

from repro_torch.core import compression as _compression  # noqa: E402


class FramedLosslessCodec:
    lossy = False

    def __init__(self, name: str) -> None:
        self.name = name

    def encode(self, arr: np.ndarray) -> bytes:
        return encode(arr, self.name)[0]

    def decode(self, blob: bytes) -> np.ndarray:
        return decode(blob)


for _name in list(_COMPRESSORS):
    _compression.register(FramedLosslessCodec(_name))
