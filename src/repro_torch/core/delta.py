"""Delta encoding against a base snapshot (the serving-snapshot codec).

Huebl et al. show that at scale the *reduction ratio* — not raw IO
bandwidth — becomes the binding constraint, and the serving KV slab is
append-mostly: between two snapshot firings most pages are byte-identical
and only the freshly decoded tokens differ. Compressing the full slab with
a plain lossless codec re-pays for every unchanged byte on every firing;
delta encoding against the previous snapshot pays only for what changed.

Frame layout (``DMAGIC``, version 1): the array is split into the same
fixed-size chunks the lossless layer uses, and every chunk independently
picks the cheapest of three ops against the base bytes at its offset:

  COPY   the chunk is byte-identical to the base chunk — zero payload.
  XOR    payload is ``inner_codec(chunk XOR base_chunk)`` — append-mostly
         pages XOR to near-all-zeros, which zlib removes almost entirely.
  SELF   payload is ``inner_codec(chunk)`` — self-contained; chosen when
         the delta doesn't win (changed-beyond-recognition pages, or no
         base at all).

A frame encoded without a base is all-SELF and decodes standalone; a frame
with any COPY/XOR chunk records the base's byte length and refuses to
decode against a missing or wrong-sized base (``DeltaBaseMismatch``).
Chunks are independent, so encode and decode both ride the shared
chunk-parallel ``codecs.codec_pool``.

The ``delta`` name in the ``repro_torch.core.compression`` registry is the
self-contained adapter (``encode(arr)`` == all-SELF frame); the base-aware
``encode``/``decode`` overloads are what :class:`repro_torch.serving.snapshot.
SnapshotStore` chains.
"""
from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import codecs

DMAGIC = b"RPRD"
_VERSION = 1

OP_COPY = 0
OP_XOR = 1
OP_SELF = 2

_FLAG_HAS_BASE = 1


class DeltaBaseMismatch(ValueError):
    """A delta frame references a base the caller didn't (correctly) supply."""


@dataclass(frozen=True)
class DeltaStats:
    raw_bytes: int
    stored_bytes: int
    n_copy: int
    n_xor: int
    n_self: int

    @property
    def ratio(self) -> float:
        """Paper Eq. (1): CR = (original - stored) / original."""
        if self.raw_bytes == 0:
            return 0.0
        return (self.raw_bytes - self.stored_bytes) / self.raw_bytes


def _encode_chunk(comp, target: memoryview,
                  base: Optional[memoryview]) -> tuple[int, bytes]:
    """Pick the cheapest op for one chunk; returns (op, payload).

    ``base`` is always chunk-length-matched: ``encode`` discards a base
    whose byte length differs from the target array, so both sides chunk
    identically (including the short tail chunk).
    """
    if base is None:
        return OP_SELF, comp(target)
    # vectorized compare: python-level memoryview equality is ~30x slower,
    # and on the append-mostly hot path unchanged chunks make this check
    # the entire encode cost
    t = np.frombuffer(target, np.uint8)
    b = np.frombuffer(base, np.uint8)
    if np.array_equal(t, b):
        return OP_COPY, b""
    # XOR first: on the append-mostly hot path the delta compresses to
    # almost nothing, and paying comp() twice per changed chunk would
    # double the publish CPU. Only a delta that barely compressed (the
    # page changed beyond recognition) is worth racing against SELF.
    xor_payload = comp(memoryview(np.bitwise_xor(t, b).data))
    if len(xor_payload) < (len(target) >> 3):        # clear delta win
        return OP_XOR, xor_payload
    self_payload = comp(target)
    if len(xor_payload) < len(self_payload):
        return OP_XOR, xor_payload
    return OP_SELF, self_payload


def encode(arr: np.ndarray, base: Optional[np.ndarray] = None, *,
           codec: str = "zlib", chunk_bytes: int = codecs.DEFAULT_CHUNK,
           pool: Optional[ThreadPoolExecutor] = None
           ) -> tuple[bytes, DeltaStats]:
    """Frame ``arr`` as a delta against ``base`` (None => self-contained).

    A base with a different byte length than ``arr`` is ignored (the frame
    falls back to self-contained): chunk offsets would not line up, so an
    XOR against it carries no signal.
    """
    if codec not in codecs._COMPRESSORS:
        raise KeyError(
            f"unknown inner codec {codec!r}; available: {codecs.available()}")
    cid, comp, _ = codecs._COMPRESSORS[codec]
    arr = np.ascontiguousarray(arr)
    if base is not None:
        base = np.ascontiguousarray(base)
        if base.nbytes != arr.nbytes:
            base = None
    views = codecs._chunk_views(arr, int(chunk_bytes))
    base_views: list[Optional[memoryview]]
    if base is None:
        base_views = [None] * len(views)
    else:
        base_views = list(codecs._chunk_views(base, int(chunk_bytes)))

    def one(i: int) -> tuple[int, bytes]:
        return _encode_chunk(comp, views[i], base_views[i])

    if pool is not None and len(views) > 1:
        coded = list(pool.map(one, range(len(views))))
    else:
        coded = [one(i) for i in range(len(views))]
    ops = bytes(op for op, _ in coded)
    payloads = [p for _, p in coded]
    has_base = any(op != OP_SELF for op in ops)
    dt = codecs._dtype_token(arr.dtype)
    parts = [
        DMAGIC,
        struct.pack("<BBBB", _VERSION, _FLAG_HAS_BASE if has_base else 0,
                    cid, len(dt)), dt,
        struct.pack("<B", arr.ndim),
        struct.pack(f"<{arr.ndim}q", *arr.shape),
        struct.pack("<qqqI", arr.nbytes,
                    base.nbytes if has_base else 0,
                    int(chunk_bytes), len(payloads)),
        ops,
        struct.pack(f"<{len(payloads)}I", *(len(p) for p in payloads)),
        *payloads,
    ]
    blob = b"".join(parts)
    n_copy = ops.count(OP_COPY)
    n_xor = ops.count(OP_XOR)
    return blob, DeltaStats(arr.nbytes, len(blob), n_copy, n_xor,
                            len(ops) - n_copy - n_xor)


def is_delta_frame(blob: bytes) -> bool:
    return bytes(blob[:4]) == DMAGIC


def frame_needs_base(blob: bytes) -> bool:
    """True when the frame has COPY/XOR chunks (cannot decode standalone)."""
    if not is_delta_frame(blob) or len(blob) < 6:
        raise ValueError("not a delta frame")
    return bool(blob[5] & _FLAG_HAS_BASE)


def decode(blob: bytes, base: Optional[np.ndarray] = None, *,
           pool: Optional[ThreadPoolExecutor] = None) -> np.ndarray:
    """Decode a delta frame, applying COPY/XOR chunks against ``base``."""
    if bytes(blob[:4]) != DMAGIC:
        raise ValueError("bad delta frame magic")
    view = memoryview(blob)
    version, flags, cid, dtlen = struct.unpack_from("<BBBB", blob, 4)
    if version != _VERSION:
        raise ValueError(f"unsupported delta frame version {version}")
    off = 8
    dtype = codecs._dtype_from_token(bytes(view[off:off + dtlen]).decode())
    off += dtlen
    (ndim,) = struct.unpack_from("<B", blob, off)
    off += 1
    shape = struct.unpack_from(f"<{ndim}q", blob, off)
    off += 8 * ndim
    raw_nbytes, base_nbytes, chunk_bytes, n_chunks = struct.unpack_from(
        "<qqqI", blob, off)
    off += 28
    if chunk_bytes < 1 or raw_nbytes < 0:
        raise ValueError("corrupt delta frame header")
    want_chunks = -(-raw_nbytes // chunk_bytes)   # ceil; 0 for empty arrays
    if n_chunks != want_chunks:
        raise ValueError(
            f"delta chunk table mismatch: {n_chunks} chunks cannot cover "
            f"{raw_nbytes} raw bytes at {chunk_bytes} per chunk")
    ops = bytes(view[off:off + n_chunks])
    off += n_chunks
    sizes = struct.unpack_from(f"<{n_chunks}I", blob, off)
    off += 4 * n_chunks
    has_base = bool(flags & _FLAG_HAS_BASE)
    base_mv: Optional[memoryview] = None
    if has_base:
        if base is None:
            raise DeltaBaseMismatch(
                f"delta frame requires a base of {base_nbytes} bytes, "
                "got none")
        base = np.ascontiguousarray(base)
        if base.nbytes != base_nbytes:
            raise DeltaBaseMismatch(
                f"delta frame requires a base of {base_nbytes} bytes, "
                f"got {base.nbytes}")
        base_mv = codecs._byte_view(base)
    _, _, decomp = codecs._BY_ID[cid]
    out = bytearray(raw_nbytes)

    jobs = []
    in_off = off
    for i in range(n_chunks):
        jobs.append((in_off, sizes[i], i * chunk_bytes, ops[i]))
        in_off += sizes[i]
    if in_off > len(blob):
        raise ValueError("truncated delta frame payload")

    def _one(job: tuple[int, int, int, int]) -> None:
        src, size, dst, op = job
        want = min(chunk_bytes, raw_nbytes - dst)
        if op == OP_COPY:
            if size:
                raise ValueError("COPY chunk with payload")
            out[dst:dst + want] = base_mv[dst:dst + want]
            return
        raw = decomp(view[src:src + size])
        if len(raw) != want:
            raise ValueError(
                f"delta chunk length mismatch: {len(raw)} != {want}")
        if op == OP_XOR:
            # base_nbytes == raw_nbytes (validated above), so the base
            # slice is exactly chunk-length-matched
            t = np.frombuffer(raw, np.uint8)
            b = np.frombuffer(base_mv[dst:dst + want], np.uint8)
            out[dst:dst + want] = np.bitwise_xor(t, b).tobytes()
        elif op == OP_SELF:
            out[dst:dst + want] = raw
        else:
            raise ValueError(f"unknown delta chunk op {op}")

    if pool is not None and len(jobs) > 1:
        list(pool.map(_one, jobs))
    else:
        for job in jobs:
            _one(job)
    if raw_nbytes == 0:
        return np.empty(shape, dtype=dtype)
    return np.frombuffer(out, dtype=dtype).reshape(shape)


# ---------------------------------------------------------------------------
# registry adapter: 'delta' is a lossless Codec; without a base it emits a
# self-contained (all-SELF) frame, so the plain registry contract holds.
# ---------------------------------------------------------------------------

from repro_torch.core import compression as _compression  # noqa: E402


class DeltaCodec:
    lossy = False
    name = "delta"

    def encode(self, arr: np.ndarray,
               base: Optional[np.ndarray] = None) -> bytes:
        return encode(arr, base)[0]

    def decode(self, blob: bytes,
               base: Optional[np.ndarray] = None) -> np.ndarray:
        return decode(blob, base)


_compression.register(DeltaCodec())
