"""One transport layer for every sink: the ``Sink``/``Source`` protocol.

A :class:`Sink` is the uniform terminal stage of an in-situ pipeline:

    open() -> write_frame(Frame) ... -> flush() -> close()

Every frame carries *step + stream + seq + codec* metadata, and payloads
ride the v2 chunk-parallel framing from :mod:`repro_torch.core.codecs`
(arrays are framed leaves; trees keep their structure in a JSON skeleton).
The wire and frame formats are the JAX package's, byte for byte, so either
package reads what the other writes. Three backends:

  ``FileSink``    one atomically-published file per frame
                  (write tmp -> fsync -> rename -> fsync dir — the protocol
                  the snapshot writer shares through
                  :func:`atomic_write_bytes`).
  ``MemorySink``  frames in a list (in-process probes, tests).
  ``StreamSink``  length-prefixed crc-checked frames over a TCP socket —
                  in-situ across processes. A broken or timed-out send
                  raises the runtime's ``TransientError``, so the
                  retry/backoff/degrade path covers the network, and the
                  bounded staging ring upstream turns a slow consumer into
                  backpressure instead of a stalled loop. The socket is
                  bidirectional: the consumer pushes steering frames back.

The consumer side mirrors it: ``MemorySink.frames`` / ``FileSource`` /
``StreamSource`` yield the same :class:`Frame` objects, and
:func:`unpack_payload` decodes them.

Plan options declare transports as URLs::

    "file:///var/run/artifacts"   FileSink rooted at that directory
    "memory://"                   MemorySink
    "tcp://10.0.0.7:5555"         StreamSink to a listening StreamSource

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
import select
import socket
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


def _transient(msg: str) -> Exception:
    """A network failure the runtime should retry (lazy import: runtime
    imports this module at top level, so the reverse edge must be lazy)."""
    from repro_torch.core.runtime import TransientError
    return TransientError(msg)


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
    skeleton = json.dumps(_strip(obj, blobs, codec, pool)).encode()
    parts = [struct.pack("<II", len(skeleton), len(blobs)), skeleton,
             struct.pack(f"<{len(blobs)}q", *(len(b) for b in blobs))]
    parts.extend(blobs)
    return b"".join(parts)


# The payload walks recurse through module-level functions: a nested
# function that calls itself is a reference cycle (it holds its own
# closure cell), which would keep a frame's blobs alive until the garbage
# collector runs.

def _strip(x: Any, blobs: list, codec: str, pool) -> Any:
    """``x`` as JSON-able skeleton, its array and bytes leaves appended to
    ``blobs`` (arrays framed with ``codec``)."""
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
                "fields": {f.name: _strip(getattr(x, f.name), blobs, codec,
                                          pool)
                           for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {str(k): _strip(v, blobs, codec, pool) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_strip(v, blobs, codec, pool) for v in x]
    raise TypeError(
        f"cannot pack payload leaf of type {type(x).__name__} "
        "(supported: scalars, str, bytes, arrays, dict/list/tuple, "
        "dataclasses)")


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
    return _rebuild(skeleton, blobs, pool)


def _rebuild(x: Any, blobs: list, pool) -> Any:
    """The payload tree of skeleton ``x`` over ``blobs``."""
    if isinstance(x, dict):
        if "__tensor__" in x and len(x) == 1:
            return codecs.decode(blobs[x["__tensor__"]], pool=pool)
        if "__bytes__" in x and len(x) == 1:
            return blobs[x["__bytes__"]]
        if "__dataclass__" in x and "fields" in x:
            return {"__dataclass__": x["__dataclass__"],
                    "fields": _rebuild(x["fields"], blobs, pool)}
        return {k: _rebuild(v, blobs, pool) for k, v in x.items()}
    if isinstance(x, list):
        return [_rebuild(v, blobs, pool) for v in x]
    return x


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
# the streaming backend: TCP, length-prefixed, crc-checked, steerable
# ---------------------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes; b'' on clean EOF at a boundary; raises
    FrameCorruptError on EOF mid-read (a torn frame)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return b""
            raise FrameCorruptError(
                f"connection dropped mid-frame ({len(buf)} of {n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def _recv_wire_frame(sock: socket.socket) -> Optional[Frame]:
    """One length-prefixed frame off a socket; None on clean EOF."""
    head = _read_exact(sock, 4)
    if not head:
        return None
    (blen,) = struct.unpack("<I", head)
    if blen < _HEADER_SIZE or blen > _MAX_FRAME:
        raise FrameCorruptError(f"implausible frame length {blen}")
    return parse_body(_read_exact(sock, blen))


class StreamSink(Sink):
    """Length-prefixed crc-checked frames over a TCP socket.

    Failure semantics are what lets the runtime's retry machinery cover the
    network: a connect/send failure (or timeout — a wedged consumer) closes
    the socket and raises :class:`~repro_torch.core.runtime.TransientError`, so
    the task retries with backoff (reconnecting on the next attempt) and
    degrades to counted drops if the consumer stays gone — the train loop
    never crashes and, with the ``drop``/``adapt`` backpressure policies,
    never stalls. Frame seqs are assigned per stream and rolled back on a
    failed send, so a retry reuses the seq and the reader sees a contiguous
    stream; frames lost to degradation surface on the consumer as a typed
    :class:`StreamGapError`.

    The socket is bidirectional: :meth:`poll_control` drains steering
    frames the consumer pushed back (non-blocking), which
    ``Session.poll_steering`` applies to live tasks.
    """

    def __init__(self, host: str, port: int, *, stream: str = "default",
                 payload_codec: str = "zlib", connect_timeout_s: float = 5.0,
                 send_timeout_s: float = 10.0) -> None:
        super().__init__(stream=stream, payload_codec=payload_codec)
        self.host = host
        self.port = port
        self.connect_timeout_s = connect_timeout_s
        self.send_timeout_s = send_timeout_s
        self.reconnects = 0
        self._sock: Optional[socket.socket] = None
        self._io_lock = threading.Lock()

    @classmethod
    def over_socket(cls, sock: socket.socket, *, stream: str = "default",
                    payload_codec: str = "zlib") -> "StreamSink":
        """Wrap an already-connected socket (tests: socketpair)."""
        sink = cls("", -1, stream=stream, payload_codec=payload_codec)
        sink._sock = sock
        return sink

    # -- connection management ------------------------------------------------

    def _connect_locked(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        if self.port < 0:
            raise _transient("stream sink socket was dropped "
                             "(socket-wrapped sink cannot reconnect)")
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.connect_timeout_s)
        except OSError as e:
            raise _transient(
                f"stream sink cannot reach {self.host}:{self.port}: "
                f"{e}") from e
        sock.settimeout(self.send_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self.reconnects += 1
        return sock

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def drop_connection(self) -> None:
        """Sever the connection (fault drills: the next write must
        reconnect or raise TransientError into the retry path)."""
        with self._io_lock:
            self._drop_locked()

    def open(self) -> "StreamSink":
        with self._io_lock:
            self._connect_locked()
        return self

    # -- frame IO -------------------------------------------------------------

    def write_frame(self, frame: Frame) -> None:
        if self.closed:
            raise TransportError("stream sink is closed")
        wire = pack_frame(frame)
        with self._io_lock:
            sock = self._connect_locked()
            try:
                sock.sendall(wire)
            except OSError as e:
                # a torn send poisons the connection; drop it so the retry
                # reconnects and the reader's parser starts clean
                self._drop_locked()
                raise _transient(
                    f"stream sink send to {self.host}:{self.port} failed "
                    f"(stream {frame.stream!r}, step {frame.step}): "
                    f"{e}") from e

    def poll_control(self) -> list[dict]:
        """Drain steering frames the consumer sent back; non-blocking —
        an idle or absent back-channel costs one select(0)."""
        out: list[dict] = []
        with self._io_lock:
            sock = self._sock
            if sock is None:
                return out
            while True:
                try:
                    r, _, _ = select.select([sock], [], [], 0)
                except (OSError, ValueError):
                    break
                if not r:
                    break
                try:
                    frame = _recv_wire_frame(sock)
                except (TransportError, OSError):
                    self._drop_locked()
                    break
                if frame is None:         # consumer went away
                    self._drop_locked()
                    break
                if frame.kind == KIND_CONTROL:
                    try:
                        out.append(json.loads(frame.payload.decode()))
                    except ValueError:
                        continue
        return out

    def flush(self) -> None:
        pass                              # sendall already drained userspace

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        with self._io_lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(pack_frame(
                        Frame(self.stream, -1, 0, CODEC_JSON, b"{}",
                              kind=KIND_BYE)))
                except OSError:
                    pass
                self._drop_locked()


class StreamSource(Source):
    """The consumer side: accept producer connections, yield frames.

    Listens on ``host:port`` (the producer's ``StreamSink`` connects in);
    multiple producers — one per transport-declared task — multiplex via
    ``select``, each connection with its own parser state, so a torn frame
    on one connection cannot desynchronize another. Per-stream seq
    continuity is enforced across connections: a reconnecting producer
    that lost frames surfaces as :class:`StreamGapError` naming the
    stream/step (pass ``check_gaps=False`` to tail best-effort streams).

    :meth:`send_control` pushes a steering message back up every live
    connection — the producer's session polls and applies it mid-run.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 check_gaps: bool = True, listen: bool = True) -> None:
        self.check_gaps = check_gaps
        self._listener: Optional[socket.socket] = None
        self._conns: list[socket.socket] = []
        self._expect: dict[str, int] = {}
        self._lock = threading.Lock()
        self.frames_read = 0
        self.connections_accepted = 0
        self.port = port
        if listen:
            lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind((host, port))
            lst.listen(16)
            self._listener = lst
            self.port = lst.getsockname()[1]

    @classmethod
    def over_socket(cls, sock: socket.socket, *,
                    check_gaps: bool = True) -> "StreamSource":
        """Wrap an already-connected socket (tests: socketpair)."""
        src = cls(listen=False, check_gaps=check_gaps)
        src._conns.append(sock)
        src.connections_accepted = 1
        return src

    @property
    def address(self) -> str:
        return f"tcp://127.0.0.1:{self.port}"

    def _check_seq(self, frame: Frame) -> None:
        expect = self._expect.get(frame.stream)
        if expect is not None and frame.seq != expect:
            self._expect[frame.stream] = frame.seq + 1
            if self.check_gaps:
                raise StreamGapError(frame.stream, frame.step, expect,
                                     frame.seq)
            return
        self._expect[frame.stream] = frame.seq + 1

    def recv_frame(self, timeout: Optional[float] = None
                   ) -> Optional[Frame]:
        """Next data frame from any connection; None when ``timeout``
        expires with no data frame. New connections are accepted and
        BYE/EOF drained *within* the timeout budget — an accept never eats
        the caller's whole wait."""
        import time as _time
        deadline = (None if timeout is None
                    else _time.monotonic() + timeout)
        with self._lock:
            while True:
                socks = ([self._listener] if self._listener else []) + \
                    list(self._conns)
                if not socks:
                    return None
                if deadline is None:
                    remaining = None
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining < 0:
                        return None
                try:
                    r, _, _ = select.select(socks, [], [], remaining)
                except OSError:
                    return None
                if not r:
                    return None
                for sock in r:
                    if sock is self._listener:
                        conn, _ = sock.accept()
                        conn.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                        self._conns.append(conn)
                        self.connections_accepted += 1
                        continue
                    try:
                        frame = _recv_wire_frame(sock)
                    except TransportError:
                        self._drop(sock)
                        raise
                    except OSError as e:
                        self._drop(sock)
                        raise FrameCorruptError(
                            f"connection read failed: {e}") from e
                    if frame is None or frame.kind == KIND_BYE:
                        self._drop(sock)
                        continue
                    if frame.kind != KIND_DATA:
                        continue
                    self._check_seq(frame)
                    self.frames_read += 1
                    return frame

    def frames(self, *, idle_timeout_s: float = 5.0,
               max_frames: Optional[int] = None,
               start_grace_s: Optional[float] = None) -> Iterator[Frame]:
        """Yield frames until ``idle_timeout_s`` passes with no traffic and
        no live connections (a drained stream), or ``max_frames`` arrive.
        ``start_grace_s`` extends the wait for the *first* connection
        (default: ``idle_timeout_s``) — a producer with a long warm-up
        (a graph capture) connects late, but once it has come and gone the
        drain exit stays prompt."""
        n = 0
        import time as _time
        started = _time.monotonic()
        idle_since = started
        grace = idle_timeout_s if start_grace_s is None else start_grace_s
        while max_frames is None or n < max_frames:
            frame = self.recv_frame(timeout=0.2)
            if frame is None:
                now = _time.monotonic()
                if (not self._conns and self.connections_accepted == 0
                        and now - started <= grace):
                    continue
                if (not self._conns
                        and now - idle_since > idle_timeout_s):
                    return
                if self._conns:
                    idle_since = now
                continue
            idle_since = _time.monotonic()
            n += 1
            yield frame

    def send_control(self, message: dict) -> int:
        """Push one steering message up every live connection; returns the
        number of producers it reached."""
        wire = pack_frame(Frame("control", -1, 0, CODEC_JSON,
                                json.dumps(message).encode(),
                                kind=KIND_CONTROL))
        sent = 0
        with self._lock:
            for sock in list(self._conns):
                try:
                    sock.sendall(wire)
                    sent += 1
                except OSError:
                    self._drop(sock)
        return sent

    def _drop(self, sock: socket.socket) -> None:
        if sock in self._conns:
            self._conns.remove(sock)
        try:
            sock.close()
        except OSError:
            pass

    @property
    def connections(self) -> int:
        return len(self._conns)

    def close(self) -> None:
        with self._lock:
            for sock in self._conns:
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()
            if self._listener is not None:
                try:
                    self._listener.close()
                except OSError:
                    pass
                self._listener = None


# ---------------------------------------------------------------------------
# URL scheme: how plans declare transports
# ---------------------------------------------------------------------------

def parse_url(url: str) -> tuple[str, str]:
    """'scheme://rest' -> (scheme, rest); raises ValueError on junk."""
    if "://" not in url:
        raise ValueError(
            f"transport URL {url!r} needs a scheme "
            "(file://dir | memory:// | tcp://host:port)")
    scheme, rest = url.split("://", 1)
    return scheme, rest


def connect(url: str, *, stream: str = "default",
            payload_codec: str = "zlib") -> Sink:
    """Build the Sink a transport URL names.

    ``file:///path/to/dir`` -> :class:`FileSink`, ``memory://`` ->
    :class:`MemorySink`, ``tcp://host:port`` -> :class:`StreamSink`.
    """
    scheme, rest = parse_url(url)
    if scheme == "file":
        if not rest:
            raise ValueError(f"file transport needs a directory: {url!r}")
        return FileSink(rest, stream=stream, payload_codec=payload_codec)
    if scheme == "memory":
        return MemorySink(stream=stream, payload_codec=payload_codec)
    if scheme == "tcp":
        host, _, port = rest.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"tcp transport needs host:port, got {url!r}")
        return StreamSink(host, int(port), stream=stream,
                          payload_codec=payload_codec)
    raise ValueError(f"unknown transport scheme {scheme!r} in {url!r} "
                     "(known: file, memory, tcp)")


def materialize_file(frame: Frame, root: str) -> str:
    """Write one ``CODEC_FILE`` frame under ``root`` (path-sanitized,
    atomic publish); returns the absolute path written."""
    rel, data = unpack_file(frame.payload)
    rel = os.path.normpath(rel)
    if rel.startswith("..") or os.path.isabs(rel):
        raise TransportError(
            f"refusing to materialize path {rel!r} outside {root!r}")
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path) or root, exist_ok=True)
    atomic_write_bytes(path, data)
    return path
