"""One transport layer for every sink: the ``Sink``/``Source`` protocol.

A :class:`Sink` is the uniform terminal stage of an in-situ pipeline:

    open() -> write_frame(Frame) ... -> flush() -> close()

Every frame carries *step + stream + seq + codec* metadata, and payloads
ride the v2 chunk-parallel framing from :mod:`repro_torch.core.codecs`
(arrays are framed leaves; trees keep their structure in a JSON skeleton).
The wire and frame formats are the JAX package's, byte for byte, so either
package reads what the other writes. Two backends:

  ``FileSink``    one atomically-published file per frame
                  (write tmp -> fsync -> rename -> fsync dir — the protocol
                  the snapshot writer shares through
                  :func:`atomic_write_bytes`).
  ``MemorySink``  frames in a list (in-process probes, tests).

The consumer side mirrors it: ``MemorySink.frames`` / ``FileSource`` yield
the same :class:`Frame` objects, and :func:`unpack_payload` decodes them.

Plan options declare transports as URLs::

    "file:///var/run/artifacts"   FileSink rooted at that directory
    "memory://"                   MemorySink

The JAX package's ``tcp://`` stream transport (``StreamSink`` /
``StreamSource``, with its steering back-channel) is not ported yet
(ROADMAP.md); :func:`connect` says so.

Wire format (one frame)::

    u32 body_len | body
    body: TMAGIC | u8 version | u8 kind | u16 stream_len | u8 codec_len
          | u32 seq | i64 step | u32 payload_len | u32 crc32
          | stream | codec | payload

``crc32`` covers the whole body except itself; ``seq`` increments per
stream on the writing sink, so a reader detects lost frames as a typed
:class:`StreamGapError` naming the stream and step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import codecs, host

TMAGIC = b"RPTF"
_VERSION = 1

KIND_DATA = 0
KIND_CONTROL = 1
KIND_BYE = 2
_KIND_NAMES = {KIND_DATA: "data", KIND_CONTROL: "control", KIND_BYE: "bye"}

# body: version kind stream_len codec_len seq step payload_len crc
_HEADER = "<BBHBIqII"
_HEADER_SIZE = 4 + struct.calcsize(_HEADER)
_MAX_FRAME = 1 << 31            # sanity bound on a declared body length

# payload codecs (Frame.codec): how Frame.payload decodes
CODEC_TREE = "tree"             # pack_payload/unpack_payload pytree framing
CODEC_JSON = "json"             # plain JSON bytes (control frames)
CODEC_RAW = "raw"               # opaque bytes (e.g. snapshot-chain frames)
CODEC_FILE = "file"             # pack_file/unpack_file (path, bytes) pairs


# ---------------------------------------------------------------------------
# typed errors — every one names the stream/step it can know
# ---------------------------------------------------------------------------

class TransportError(RuntimeError):
    """Base for transport-layer failures."""


class FrameCorruptError(TransportError):
    """A frame failed structural validation (magic/crc/truncation). Names
    the stream and step when the header survived well enough to read them."""

    def __init__(self, reason: str, *, stream: Optional[str] = None,
                 step: Optional[int] = None) -> None:
        at = (f"stream {stream!r}" if stream is not None else "stream ?")
        at += f", step {step}" if step is not None else ", step ?"
        super().__init__(f"transport frame ({at}): {reason}")
        self.stream = stream
        self.step = step


class StreamGapError(TransportError):
    """Per-stream frame seqs are contiguous by construction; a gap means
    frames were lost."""

    def __init__(self, stream: str, step: int, expected: int,
                 got: int) -> None:
        super().__init__(
            f"stream {stream!r}, step {step}: frame seq gap — expected "
            f"{expected}, got {got} ({got - expected} frame(s) lost)")
        self.stream = stream
        self.step = step
        self.expected = expected
        self.got = got


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Frame:
    """One transport frame: step + stream + codec metadata, opaque payload."""
    stream: str
    step: int
    seq: int
    codec: str
    payload: bytes
    kind: int = KIND_DATA

    @property
    def kind_name(self) -> str:
        return _KIND_NAMES.get(self.kind, f"kind{self.kind}")


def pack_frame(frame: Frame) -> bytes:
    """Frame -> wire bytes (length prefix + crc-covered body)."""
    sb = frame.stream.encode()
    cb = frame.codec.encode()
    if len(sb) > 0xFFFF or len(cb) > 0xFF:
        raise ValueError("stream/codec name too long for the frame header")
    prefix = struct.pack("<BBHBIqI", _VERSION, frame.kind, len(sb), len(cb),
                         frame.seq, frame.step, len(frame.payload))
    crc = zlib.crc32(prefix + sb + cb + frame.payload)
    body = (TMAGIC + prefix + struct.pack("<I", crc) + sb + cb
            + frame.payload)
    return struct.pack("<I", len(body)) + body


def parse_body(body: bytes) -> Frame:
    """Wire body (past the length prefix) -> Frame; raises
    :class:`FrameCorruptError` naming stream/step where readable."""
    if len(body) < _HEADER_SIZE:
        raise FrameCorruptError(
            f"truncated frame header ({len(body)} bytes)")
    if body[:4] != TMAGIC:
        raise FrameCorruptError("bad frame magic")
    version, kind, slen, clen, seq, step, plen, crc = struct.unpack_from(
        _HEADER, body, 4)
    if version != _VERSION:
        raise FrameCorruptError(f"unsupported frame version {version}")
    # best-effort stream/step for the error message even when the crc fails:
    # the reader deserves to know *which* stream broke
    stream = codec = None
    if len(body) >= _HEADER_SIZE + slen + clen:
        stream = body[_HEADER_SIZE:_HEADER_SIZE + slen].decode(
            errors="replace")
        codec = body[_HEADER_SIZE + slen:_HEADER_SIZE + slen + clen].decode(
            errors="replace")
    if len(body) != _HEADER_SIZE + slen + clen + plen:
        raise FrameCorruptError(
            f"truncated frame body ({len(body)} of "
            f"{_HEADER_SIZE + slen + clen + plen} bytes)",
            stream=stream, step=step)
    if zlib.crc32(body[4:_HEADER_SIZE - 4] + body[_HEADER_SIZE:]) != crc:
        raise FrameCorruptError("frame crc mismatch (bit flip or tear)",
                                stream=stream, step=step)
    payload = body[_HEADER_SIZE + slen + clen:]
    return Frame(stream, step, seq, codec, payload, kind=kind)


# ---------------------------------------------------------------------------
# payload packing: pytrees over the v2 chunk-parallel codec framing
# ---------------------------------------------------------------------------

def pack_payload(obj: Any, *, codec: str = "zlib",
                 parallel: bool = True) -> bytes:
    """Pack a pytree payload into one self-describing byte string.

    The tree *structure* (dicts, lists, scalars, dataclass field names)
    becomes a JSON skeleton; every array leaf is framed by the shared
    chunk-parallel :func:`repro_torch.core.codecs.encode` (so big leaves
    compress with the same v2 layout checkpoints use), and raw
    ``bytes`` leaves ship verbatim. Tuples flatten to lists and
    dataclasses to ``{"__dataclass__": name, "fields": {...}}`` — the
    consumer gets plain data, which is the point of a wire format.
    """
    blobs: list[bytes] = []
    pool = codecs.codec_pool() if parallel else None

    def strip(x: Any) -> Any:
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        if isinstance(x, np.generic):
            return x.item()
        if isinstance(x, (bytes, bytearray, memoryview)):
            blobs.append(bytes(x))
            return {"__bytes__": len(blobs) - 1}
        if isinstance(x, torch.Tensor):
            x = host.to_numpy(x.cpu())
        if hasattr(x, "dtype") and hasattr(x, "shape"):
            blobs.append(codecs.encode(np.asarray(x), codec, pool=pool)[0])
            return {"__tensor__": len(blobs) - 1}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return {"__dataclass__": type(x).__name__,
                    "fields": {f.name: strip(getattr(x, f.name))
                               for f in dataclasses.fields(x)}}
        if isinstance(x, dict):
            return {str(k): strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [strip(v) for v in x]
        raise TypeError(
            f"cannot pack payload leaf of type {type(x).__name__} "
            "(supported: scalars, str, bytes, arrays, dict/list/tuple, "
            "dataclasses)")

    skeleton = json.dumps(strip(obj)).encode()
    parts = [struct.pack("<II", len(skeleton), len(blobs)), skeleton,
             struct.pack(f"<{len(blobs)}q", *(len(b) for b in blobs))]
    parts.extend(blobs)
    return b"".join(parts)


def unpack_payload(data: bytes, *, parallel: bool = True) -> Any:
    """Inverse of :func:`pack_payload` (array leaves decode bit-exactly)."""
    jlen, nblobs = struct.unpack_from("<II", data, 0)
    off = 8
    skeleton = json.loads(bytes(data[off:off + jlen]).decode())
    off += jlen
    sizes = struct.unpack_from(f"<{nblobs}q", data, off)
    off += 8 * nblobs
    blobs: list[bytes] = []
    view = memoryview(data)
    for size in sizes:
        blobs.append(bytes(view[off:off + size]))
        off += size
    pool = codecs.codec_pool() if parallel else None

    def build(x: Any) -> Any:
        if isinstance(x, dict):
            if "__tensor__" in x and len(x) == 1:
                return codecs.decode(blobs[x["__tensor__"]], pool=pool)
            if "__bytes__" in x and len(x) == 1:
                return blobs[x["__bytes__"]]
            if "__dataclass__" in x and "fields" in x:
                return {"__dataclass__": x["__dataclass__"],
                        "fields": build(x["fields"])}
            return {k: build(v) for k, v in x.items()}
        if isinstance(x, list):
            return [build(v) for v in x]
        return x

    return build(skeleton)


# ---------------------------------------------------------------------------
# atomic file publish — the one tmp -> fsync -> rename implementation
# ---------------------------------------------------------------------------

def pack_file(relpath: str, data: bytes) -> bytes:
    """(relative path, file bytes) -> CODEC_FILE payload (no base64 bloat)."""
    pb = relpath.encode()
    return struct.pack("<H", len(pb)) + pb + bytes(data)


def unpack_file(payload: bytes) -> tuple[str, bytes]:
    (plen,) = struct.unpack_from("<H", payload, 0)
    return payload[2:2 + plen].decode(), bytes(payload[2 + plen:])


def send_directory(sink: "Sink", step: int, directory: str, *,
                   prefix: str = "", stream: Optional[str] = None) -> int:
    """Replicate a committed directory through a sink, one ``CODEC_FILE``
    frame per file, ``manifest.json`` last (so a consumer materializing
    files in arrival order reproduces the publish-manifest-last crash
    protocol). Returns the number of frames sent."""
    names = []
    for root, _, files in os.walk(directory):
        for name in files:
            names.append(os.path.relpath(os.path.join(root, name), directory))
    names.sort(key=lambda n: (os.path.basename(n) == "manifest.json", n))
    for rel in names:
        with open(os.path.join(directory, rel), "rb") as f:
            data = f.read()
        sink.write(step, pack_file(os.path.join(prefix, rel), data),
                   stream=stream, codec=CODEC_FILE)
    return len(names)


def atomic_write_bytes(path: str, data: bytes, *,
                       fsync_dir: bool = True) -> None:
    """Crash-safe single-file publish: write a same-directory tmp, fsync,
    rename over ``path``, then fsync the directory — a reader can never
    observe a torn file. (Shared by ``FileSink``, the ``SnapshotStore``
    frame writer, and anything else that publishes one file at a time.)"""
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".tmp_{os.path.basename(path)}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync_dir:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


# ---------------------------------------------------------------------------
# the Sink protocol + local backends
# ---------------------------------------------------------------------------

class Sink:
    """Uniform terminal stage: ``open / write_frame / flush / close``.

    ``write(step, payload)`` is the convenience layer every pipeline uses:
    it packs the payload (``CODEC_TREE`` by default), assigns the
    per-stream seq, and hands the frame to the backend's ``write_frame``.
    Sinks are callable — ``sink(step, payload)`` == ``sink.write(...)`` —
    so a ``Sink`` drops in anywhere a legacy sink callable was accepted.
    """

    def __init__(self, *, stream: str = "default",
                 payload_codec: str = "zlib") -> None:
        self.stream = stream
        self.payload_codec = payload_codec
        self._seq: dict[str, int] = {}
        self._seq_lock = threading.Lock()
        self.frames_written = 0
        self.bytes_written = 0
        self.closed = False

    # -- backend interface ----------------------------------------------------

    def open(self) -> "Sink":
        return self

    def write_frame(self, frame: Frame) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.closed = True

    # -- convenience layer ----------------------------------------------------

    def _next_seq(self, stream: str) -> int:
        with self._seq_lock:
            seq = self._seq.get(stream, 0)
            self._seq[stream] = seq + 1
            return seq

    def _rollback_seq(self, stream: str, seq: int) -> None:
        # a failed write must not burn the seq, or the retry (same frame,
        # next attempt) would open a gap the reader rejects
        with self._seq_lock:
            if self._seq.get(stream, 0) == seq + 1:
                self._seq[stream] = seq

    def write(self, step: int, payload: Any, *,
              stream: Optional[str] = None, codec: Optional[str] = None,
              kind: int = KIND_DATA) -> dict:
        """Pack + send one payload; returns a small record (the runtime
        stores it in ``results``). ``codec`` overrides the payload framing:
        ``CODEC_RAW`` and ``CODEC_FILE`` ship ``payload`` bytes verbatim,
        anything else packs
        the pytree through :func:`pack_payload`."""
        stream = stream if stream is not None else self.stream
        if codec == CODEC_RAW or codec == CODEC_FILE:
            body, codec_name = bytes(payload), codec
        elif codec == CODEC_JSON:
            body, codec_name = json.dumps(payload).encode(), CODEC_JSON
        else:
            body = pack_payload(payload, codec=self.payload_codec)
            codec_name = CODEC_TREE
        seq = self._next_seq(stream)
        frame = Frame(stream, step, seq, codec_name, body, kind=kind)
        try:
            self.write_frame(frame)
        except BaseException:
            self._rollback_seq(stream, seq)
            raise
        self.frames_written += 1
        self.bytes_written += len(body)
        return {"stream": stream, "step": step, "seq": seq,
                "bytes": len(body), "sink": type(self).__name__}

    def __call__(self, step: int, payload: Any) -> Any:
        # a Sink drops in anywhere a legacy sink callable was expected
        return self.write(step, payload)

    def poll_control(self) -> list[dict]:
        """Steering messages received from a consumer (stream transports
        only); the local backends have no back-channel."""
        return []

    def __enter__(self) -> "Sink":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()


class CallableSink(Sink):
    """Compatibility shim: a legacy ``sink(step, payload)`` callable worn
    as a :class:`Sink`. ``write`` forwards and returns the callable's
    result unchanged, so registered pipelines keep their exact semantics."""

    def __init__(self, fn: Callable[[int, Any], Any],
                 *, stream: str = "default") -> None:
        super().__init__(stream=stream)
        self.fn = fn

    def write(self, step: int, payload: Any, **_kw) -> Any:
        result = self.fn(step, payload)
        self.frames_written += 1
        return result

    def write_frame(self, frame: Frame) -> None:  # pragma: no cover
        raise TypeError("CallableSink carries a legacy callable; use write()")


def as_sink(obj: Any) -> Sink:
    """Normalize a terminal stage: Sink objects pass through, callables get
    the :class:`CallableSink` shim."""
    if isinstance(obj, Sink):
        return obj
    if callable(obj):
        return CallableSink(obj)
    raise TypeError(
        f"sink must be a transport.Sink or a callable, got "
        f"{type(obj).__name__}")


class MemorySink(Sink):
    """Frames in a list — in-process probes and tests."""

    def __init__(self, *, stream: str = "default",
                 payload_codec: str = "zlib") -> None:
        super().__init__(stream=stream, payload_codec=payload_codec)
        self.frames: list[Frame] = []
        self._lock = threading.Lock()

    def write_frame(self, frame: Frame) -> None:
        if self.closed:
            raise TransportError("memory sink is closed")
        with self._lock:
            self.frames.append(frame)

    def payloads(self) -> list[tuple[str, int, Any]]:
        """Decoded (stream, step, payload) triples of the data frames."""
        out = []
        for f in self.frames:
            if f.kind != KIND_DATA:
                continue
            out.append((f.stream, f.step, decode_frame_payload(f)))
        return out


class FileSink(Sink):
    """One atomically-published file per frame: ``<dir>/<stream>/
    frame_<seq>.tfr`` via :func:`atomic_write_bytes` — the file-based
    staging baseline every streaming benchmark compares against."""

    def __init__(self, directory: str, *, stream: str = "default",
                 payload_codec: str = "zlib", fsync: bool = True) -> None:
        super().__init__(stream=stream, payload_codec=payload_codec)
        self.directory = directory
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)

    def write_frame(self, frame: Frame) -> None:
        if self.closed:
            raise TransportError("file sink is closed")
        d = os.path.join(self.directory, frame.stream)
        os.makedirs(d, exist_ok=True)
        atomic_write_bytes(
            os.path.join(d, f"frame_{frame.seq:08d}.tfr"),
            pack_frame(frame), fsync_dir=self.fsync)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

def decode_frame_payload(frame: Frame) -> Any:
    """Decode one frame's payload by its declared codec (shared registry
    path for arrays via :func:`unpack_payload`)."""
    if frame.codec == CODEC_TREE:
        return unpack_payload(frame.payload)
    if frame.codec == CODEC_JSON:
        return json.loads(frame.payload.decode())
    if frame.codec == CODEC_FILE:
        return unpack_file(frame.payload)
    return frame.payload               # CODEC_RAW and unknown: opaque bytes


class Source:
    """Uniform reader: iterate :class:`Frame` objects in publish order."""

    def frames(self) -> Iterator[Frame]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "Source":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FileSource(Source):
    """Read a ``FileSink`` directory back, seq order, crc-validated."""

    def __init__(self, directory: str, *,
                 stream: Optional[str] = None) -> None:
        self.directory = directory
        self.stream = stream

    def _stream_dirs(self) -> list[str]:
        if self.stream is not None:
            return [self.stream]
        if not os.path.isdir(self.directory):
            return []
        return sorted(n for n in os.listdir(self.directory)
                      if os.path.isdir(os.path.join(self.directory, n)))

    def frames(self) -> Iterator[Frame]:
        for stream in self._stream_dirs():
            d = os.path.join(self.directory, stream)
            if not os.path.isdir(d):
                continue
            expect = None
            for name in sorted(os.listdir(d)):
                if not (name.startswith("frame_") and name.endswith(".tfr")):
                    continue
                with open(os.path.join(d, name), "rb") as f:
                    wire = f.read()
                if len(wire) < 4:
                    raise FrameCorruptError(
                        f"truncated frame file {name}", stream=stream)
                (blen,) = struct.unpack_from("<I", wire, 0)
                if len(wire) - 4 != blen:
                    raise FrameCorruptError(
                        f"frame file {name} length mismatch "
                        f"({len(wire) - 4} != {blen})", stream=stream)
                frame = parse_body(wire[4:])
                if expect is not None and frame.seq != expect:
                    raise StreamGapError(frame.stream, frame.step, expect,
                                         frame.seq)
                expect = frame.seq + 1
                yield frame


# ---------------------------------------------------------------------------
# URL scheme: how plans declare transports
# ---------------------------------------------------------------------------

def parse_url(url: str) -> tuple[str, str]:
    """'scheme://rest' -> (scheme, rest); raises ValueError on junk."""
    if "://" not in url:
        raise ValueError(
            f"transport URL {url!r} needs a scheme "
            "(file://dir | memory://)")
    scheme, rest = url.split("://", 1)
    return scheme, rest


def connect(url: str, *, stream: str = "default",
            payload_codec: str = "zlib") -> Sink:
    """Build the Sink a transport URL names.

    ``file:///path/to/dir`` -> :class:`FileSink`, ``memory://`` ->
    :class:`MemorySink`. ``tcp://host:port`` raises: the stream transport
    is not ported yet.
    """
    scheme, rest = parse_url(url)
    if scheme == "file":
        if not rest:
            raise ValueError(f"file transport needs a directory: {url!r}")
        return FileSink(rest, stream=stream, payload_codec=payload_codec)
    if scheme == "memory":
        return MemorySink(stream=stream, payload_codec=payload_codec)
    if scheme == "tcp":
        raise NotImplementedError(
            f"{url!r}: the tcp:// stream transport is not ported yet "
            f"(ROADMAP.md, 'left waiting by the serving slice')")
    raise ValueError(f"unknown transport scheme {scheme!r} in {url!r} "
                     "(known: file, memory)")
