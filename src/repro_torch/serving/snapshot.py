"""Versioned serving snapshots: a base+delta chain per stream.

The serving loop used to compress the **full** KV slab on every
``serve_snapshot`` firing, even though decode mutates the slab
append-mostly (a few slots gain one token per step; everything else is
byte-identical). This module is the openPMD/ADIOS2 "chain incremental
updates through a versioned store" pattern for that path:

  * ``SnapshotStore`` keeps the last published snapshot per stream and
    encodes each new one as a *delta frame* against it
    (:mod:`repro_torch.core.delta`: per-chunk XOR/COPY/SELF, riding the shared
    chunk-parallel codec pool).
  * Every ``base_every``-th publish writes a self-contained **base** frame;
    the frames between are **deltas** — restore replays base → deltas.
    Bounded chains bound both restore cost and the corruption blast radius.
  * A publish whose payload ``version`` hint is unchanged (see
    ``PagedServingEngine.snapshot_payload``) short-circuits to a **no-op**
    frame — a ~30-byte marker, no slab walk at all — even past the base
    cadence (an idle engine never re-encodes; the next *changed* publish
    writes the due base).
  * Publishes are kept step-monotonic per stream: a late out-of-order
    firing (concurrent pool workers) is skipped as ``stale`` rather than
    regressing the chain tip to an older slab.
  * ``keep_chains=N`` retention prunes frames behind the N-th newest base
    when a base publishes (replay never needs them); ``None`` keeps every
    frame for arbitrary-prefix restores.
  * Chains are validated on restore: a truncated, corrupted, or missing
    frame raises :class:`SnapshotCorruptError` naming the chain position.

Frames live in memory (``directory=None`` — the in-process probe the
serving preset uses by default) or on disk, one file per frame, published
crash-safely (write tmp → fsync → rename → fsync dir, the checkpoint
protocol): a reader never observes a torn frame, and any published prefix
of the chain restores.

Frame file layout (``SNAP_MAGIC``, version 1)::

  magic | version | kind (base/delta/noop) | seq | chain_pos | step
        | n_leaves | body crc32
  body: per leaf  key_len | key | blob_len | delta-frame blob

``seq`` is the stream-global frame index (file order); ``chain_pos`` is
the distance to the owning base frame — restore checks it is contiguous,
so a deleted frame in the middle of a chain is detected, not silently
skipped.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import codecs, delta, host, pytree, transport

PyTree = Any

SNAP_MAGIC = b"RPSS"
_VERSION = 1
_HEADER_PREFIX = "<BBIIqI"      # version kind seq chain_pos step n_leaves
_HEADER = _HEADER_PREFIX + "I"  # ... + crc32(prefix + body)
_HEADER_SIZE = 4 + struct.calcsize(_HEADER)

KIND_BASE = 0
KIND_DELTA = 1
KIND_NOOP = 2
_KIND_NAMES = {KIND_BASE: "base", KIND_DELTA: "delta", KIND_NOOP: "noop"}


class SnapshotCorruptError(RuntimeError):
    """A snapshot chain failed validation; names the stream and the chain
    position (frame ``seq``) at fault."""

    def __init__(self, stream: str, position: Optional[int],
                 reason: str) -> None:
        at = ("chain position ?" if position is None
              else f"chain position {position}")
        super().__init__(f"snapshot stream {stream!r}, {at}: {reason}")
        self.stream = stream
        self.position = position


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    """Stable key -> contiguous host array mapping for one payload tree,
    keyed and ordered as ``jax.tree_util`` flattens it (so frames are
    byte-identical to the JAX package's). Tensor leaves come to the host
    (bf16 as the tagged uint16 dtype).

    Always copies: the store retains these arrays as the next publish's
    delta base, so it must own the bytes — callers (the serving loop, the
    benchmarks) mutate their slab in place between firings.
    """
    out: dict[str, np.ndarray] = {}
    for path, leaf in pytree.flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = host.to_numpy(leaf.cpu())
        out[pytree.keystr(path)] = np.array(np.asarray(leaf), order="C")
    return out


@dataclass
class SnapshotRecord:
    """What one ``publish`` did (the serve_snapshot task's sink result)."""
    stream: str
    step: int
    seq: int
    kind: str
    chain_pos: int
    raw_bytes: int
    stored_bytes: int

    @property
    def ratio(self) -> float:
        """Paper Eq. (1) for this frame alone."""
        if self.raw_bytes == 0:
            return 0.0
        return (self.raw_bytes - self.stored_bytes) / self.raw_bytes


@dataclass
class _StreamState:
    seq: int = 0                 # next frame index
    frames_since_base: int = -1  # -1: no base yet
    last_leaves: Optional[dict[str, np.ndarray]] = None
    last_version: Optional[int] = None
    last_raw: int = 0            # raw bytes of the last encoded publish
    last_step: Optional[int] = None
    last_kind: Optional[int] = None
    mem_frames: list[tuple[int, bytes]] = field(default_factory=list)
    publishes: int = 0
    bases: int = 0
    deltas: int = 0
    noops: int = 0
    stale: int = 0               # out-of-order publishes skipped
    raw_bytes: int = 0
    stored_bytes: int = 0


class SnapshotStore:
    """The versioned per-stream snapshot store (base+delta chains)."""

    def __init__(self, directory: Optional[str] = None, *,
                 base_every: int = 8, codec: str = "zlib",
                 chunk_bytes: int = codecs.DEFAULT_CHUNK,
                 parallel: bool = True,
                 keep_chains: Optional[int] = None,
                 mirror: Optional[Any] = None) -> None:
        if base_every < 1:
            raise ValueError(f"base_every must be >= 1, got {base_every}")
        if keep_chains is not None and keep_chains < 1:
            raise ValueError(f"keep_chains must be >= 1, got {keep_chains}")
        if codec not in codecs.available():
            raise KeyError(f"unknown inner codec {codec!r}; "
                           f"available: {codecs.available()}")
        self.directory = directory
        self.base_every = int(base_every)
        self.codec = codec
        self.chunk_bytes = int(chunk_bytes)
        self.parallel = parallel
        # retention: frames behind the keep_chains-th newest base are dead
        # weight (replay starts at the newest base) and are pruned when a
        # new base publishes. None keeps everything — archival stores and
        # the crash/bench suites that restore arbitrary prefixes.
        self.keep_chains = keep_chains
        self._streams: dict[str, _StreamState] = {}
        self._lock = threading.Lock()
        self._mirror: Optional[transport.Sink] = None
        self.mirror_frames = 0
        self.mirror_failures = 0
        if mirror is not None:
            self.set_mirror(mirror)
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    def set_mirror(self, sink: Any) -> None:
        """Attach a transport-backed publish target: every written frame's
        raw bytes are forwarded as a ``CODEC_RAW`` transport frame, so a
        remote replica can tail the delta chain live (``ingest`` on the
        consumer side rebuilds a bit-identical chain). Accepts a
        :class:`~repro_torch.core.transport.Sink` or a transport URL. Mirroring
        is best-effort: a dead consumer counts ``mirror_failures`` instead
        of failing the local publish."""
        self._mirror = (transport.connect(sink) if isinstance(sink, str)
                        else sink)

    def close_mirror(self) -> None:
        if self._mirror is not None:
            try:
                self._mirror.close()
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass
            self._mirror = None

    # -- frame packing --------------------------------------------------------

    def _pack_frame(self, kind: int, seq: int, chain_pos: int, step: int,
                    blobs: Mapping[str, bytes]) -> bytes:
        body_parts = []
        for key, blob in blobs.items():
            kb = key.encode()
            body_parts.append(struct.pack("<H", len(kb)))
            body_parts.append(kb)
            body_parts.append(struct.pack("<q", len(blob)))
            body_parts.append(blob)
        # the crc covers the header fields too (a flipped step/n_leaves
        # byte must not validate), so it is computed over prefix+body and
        # appended as the header's last field. It runs over the parts in
        # turn and the frame is joined once: a frame can hold GBs of
        # state, and each whole-frame copy costs seconds
        prefix = struct.pack(_HEADER_PREFIX, _VERSION, kind, seq, chain_pos,
                             step, len(blobs))
        crc = zlib.crc32(prefix)
        for part in body_parts:
            crc = zlib.crc32(part, crc)
        return b"".join([SNAP_MAGIC, prefix, struct.pack("<I", crc),
                         *body_parts])

    def _unpack_frame(self, stream: str, seq_hint: Optional[int],
                      raw: bytes) -> tuple[int, int, int, int,
                                           dict[str, memoryview]]:
        """-> (kind, seq, chain_pos, step, {key: blob}); raises
        SnapshotCorruptError on any structural problem. The blobs are
        views into ``raw`` (no copy of a GB-sized frame)."""
        def bad(reason: str) -> SnapshotCorruptError:
            return SnapshotCorruptError(stream, seq_hint, reason)

        if len(raw) < _HEADER_SIZE:
            raise bad(f"truncated frame header ({len(raw)} bytes)")
        if raw[:4] != SNAP_MAGIC:
            raise bad("bad frame magic")
        version, kind, seq, chain_pos, step, n_leaves, crc = \
            struct.unpack_from(_HEADER, raw, 4)
        if version != _VERSION:
            raise bad(f"unsupported frame version {version}")
        view = memoryview(raw)
        body = view[_HEADER_SIZE:]
        if zlib.crc32(body, zlib.crc32(view[4:_HEADER_SIZE - 4])) != crc:
            raise bad("frame crc mismatch (truncated or corrupted)")
        blobs: dict[str, memoryview] = {}
        off = 0
        try:
            for _ in range(n_leaves):
                (klen,) = struct.unpack_from("<H", body, off)
                off += 2
                key = bytes(body[off:off + klen]).decode()
                off += klen
                (blen,) = struct.unpack_from("<q", body, off)
                off += 8
                if off + blen > len(body):
                    raise bad(f"truncated leaf blob {key!r}")
                blobs[key] = body[off:off + blen]
                off += blen
        except struct.error:
            raise bad("truncated frame body") from None
        return kind, seq, chain_pos, step, blobs

    # -- frame IO -------------------------------------------------------------

    def _stream_dir(self, stream: str) -> str:
        assert self.directory is not None
        return os.path.join(self.directory, stream)

    def _frame_path(self, stream: str, seq: int) -> str:
        return os.path.join(self._stream_dir(stream), f"frame_{seq:08d}.snap")

    def _write_frame(self, st: _StreamState, stream: str,
                     frame: bytes) -> None:
        if self.directory is None:
            st.mem_frames.append((st.seq, frame))
        else:
            d = self._stream_dir(stream)
            os.makedirs(d, exist_ok=True)
            transport.atomic_write_bytes(
                self._frame_path(stream, st.seq), frame)
        self._forward_frame(stream, frame)

    def _forward_frame(self, stream: str, frame: bytes) -> None:
        """Best-effort mirror of one raw snapshot frame. The transport
        frame's step comes from the snapshot header; the raw bytes ship
        verbatim (``CODEC_RAW``) so the replica's chain — crcs and all —
        is bit-identical to the local one. A noop-collapse rewrite reuses
        its seq, which :meth:`ingest` resolves by replacement."""
        if self._mirror is None:
            return
        step = struct.unpack_from(_HEADER, frame, 4)[4]
        try:
            self._mirror.write(int(step), frame, stream=stream,
                               codec=transport.CODEC_RAW)
            self.mirror_frames += 1
        except Exception:  # noqa: BLE001 - replication never blocks publish
            self.mirror_failures += 1

    def _list_frames(self, stream: str) -> list[tuple[int, str]]:
        """Published (seq, path) pairs on disk, sorted by seq."""
        d = self._stream_dir(stream)
        if not os.path.isdir(d):
            return []
        out = []
        for name in os.listdir(d):
            if name.startswith("frame_") and name.endswith(".snap"):
                try:
                    out.append((int(name[len("frame_"):-len(".snap")]),
                                os.path.join(d, name)))
                except ValueError:
                    continue
        return sorted(out)

    def _frame_sources(self, stream: str) -> list[tuple[int, Any]]:
        """(seq, source) pairs, sorted; source is raw bytes (memory) or a
        file path (disk) — load lazily via :meth:`_head` / :meth:`_load`,
        so chain scans read 30-byte headers, not whole frame bodies."""
        if self.directory is None:
            st = self._streams.get(stream)
            return list(st.mem_frames) if st else []
        return self._list_frames(stream)

    def _head(self, source: Any) -> bytes:
        if isinstance(source, bytes):
            return source
        try:
            with open(source, "rb") as f:
                return f.read(_HEADER_SIZE)
        except OSError:
            # listed but gone (another writer's retention pruned it
            # between listdir and open): an unreadable header — never a
            # base candidate, and harmless behind the newest base
            return b""

    def _load(self, source: Any) -> bytes:
        if isinstance(source, bytes):
            return source
        with open(source, "rb") as f:
            return f.read()

    def _frame_kind(self, head: bytes) -> Optional[int]:
        """Lenient header peek; None when the header is unreadable."""
        if (len(head) >= _HEADER_SIZE and head[:4] == SNAP_MAGIC
                and head[4] == _VERSION):
            return struct.unpack_from(_HEADER, head, 4)[1]
        return None

    def _prune(self, st: _StreamState, stream: str) -> None:
        """Drop frames behind the ``keep_chains``-th newest base."""
        if self.keep_chains is None:
            return
        entries = self._frame_sources(stream)
        base_seqs = [seq for seq, src in entries
                     if self._frame_kind(self._head(src)) == KIND_BASE]
        if len(base_seqs) <= self.keep_chains:
            return
        cutoff = base_seqs[-self.keep_chains]
        if self.directory is None:
            st.mem_frames = [(s, r) for s, r in st.mem_frames if s >= cutoff]
            return
        for seq, path in entries:
            if seq < cutoff:
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- producer side --------------------------------------------------------

    def _state(self, stream: str) -> _StreamState:
        st = self._streams.get(stream)
        if st is None:
            st = _StreamState()
            if self.directory is not None:
                # a restarted store appends to the existing chain when it
                # can reconstruct the last snapshot, and rebases otherwise
                frames = self._list_frames(stream)
                if frames:
                    st.seq = frames[-1][0] + 1
                    try:
                        step, leaves, chain_pos = self._replay(stream)
                        st.last_leaves = leaves
                        st.frames_since_base = chain_pos
                        # seed the monotonic-step guard too, or a stale
                        # queued firing could regress a restarted chain
                        st.last_step = step
                    except SnapshotCorruptError:
                        st.last_leaves = None    # next publish: fresh base
                        st.frames_since_base = -1
            self._streams[stream] = st
        return st

    def publish(self, stream: str, step: int, tree: PyTree, *,
                version: Optional[int] = None,
                chunk_hints: Optional[Mapping[str, int]] = None
                ) -> SnapshotRecord:
        """Encode + publish one snapshot of ``tree`` on ``stream``.

        ``version`` is the producer's cheap mutation counter (e.g.
        ``PagedServingEngine.state_version``): when it matches the previously
        published version, the slab is untouched and the publish
        short-circuits to a no-op frame without walking the payload.

        ``chunk_hints`` maps flattened leaf keys to a per-leaf chunk size,
        overriding the store-wide ``chunk_bytes`` for those leaves. The
        paged serving engine passes one (layer, page) slab per chunk, so
        delta chunks align to KV pages and every untouched page frames as
        a zero-payload COPY op. Pass the same hints on every publish of a
        stream — chunk boundaries must line up with the retained base for
        the per-chunk comparison to detect unchanged pages.
        """
        with self._lock:
            st = self._state(stream)
            if st.last_step is not None and step < st.last_step:
                # a late out-of-order firing (concurrent workers draining
                # the ring) must not become the chain tip: publishing an
                # older slab as the newest frame would silently regress
                # restore(). Skip it; nothing is written.
                st.stale += 1
                return SnapshotRecord(stream, step, st.seq, "stale", -1,
                                      0, 0)
            st.last_step = step
            if (version is not None and st.last_version is not None
                    and version == st.last_version
                    and st.last_leaves is not None):
                # unchanged slab: always a no-op frame, even when the base
                # cadence has expired — an idle engine must not pay a full
                # re-encode; the next *changed* publish writes the base
                # (noop replay is a header parse, so restore stays cheap).
                # Consecutive no-ops COLLAPSE into the tip frame (rewritten
                # in place through the same tmp->rename protocol), so an
                # idle stream holds ONE noop marker, not one per firing —
                # chain length and frame count stay bounded.
                collapse = st.last_kind == KIND_NOOP
                seq = st.seq - 1 if collapse else st.seq
                pos = (st.frames_since_base if collapse
                       else st.frames_since_base + 1)
                frame = self._pack_frame(KIND_NOOP, seq, pos, step, {})
                if collapse:
                    if self.directory is None:
                        st.mem_frames[-1] = (seq, frame)
                        self._forward_frame(stream, frame)
                    else:
                        prev = st.seq           # _write_frame targets st.seq
                        st.seq = seq
                        try:
                            self._write_frame(st, stream, frame)
                        finally:
                            st.seq = prev
                else:
                    self._write_frame(st, stream, frame)
                    st.seq += 1
                    st.frames_since_base += 1
                    st.stored_bytes += len(frame)
                # a no-op frame still *represents* the full slab — count
                # its raw bytes so the effective ratio reflects what each
                # firing snapshotted, not just what it re-encoded
                rec = SnapshotRecord(stream, step, seq, "noop", pos,
                                     st.last_raw, len(frame))
                st.last_kind = KIND_NOOP
                st.publishes += 1
                st.noops += 1
                st.raw_bytes += st.last_raw
                return rec
            base_due = (st.last_leaves is None
                        or st.frames_since_base + 1 >= self.base_every)
            leaves = _flatten(tree)
            pool = codecs.codec_pool() if self.parallel else None
            blobs: dict[str, bytes] = {}
            raw = 0
            hints = chunk_hints or {}
            for key, arr in leaves.items():
                base = None if base_due else (st.last_leaves or {}).get(key)
                blob, stats = delta.encode(
                    arr, base, codec=self.codec,
                    chunk_bytes=int(hints.get(key, self.chunk_bytes)),
                    pool=pool)
                blobs[key] = blob
                raw += stats.raw_bytes
            kind = KIND_BASE if base_due else KIND_DELTA
            chain_pos = 0 if base_due else st.frames_since_base + 1
            frame = self._pack_frame(kind, st.seq, chain_pos, step, blobs)
            self._write_frame(st, stream, frame)
            rec = SnapshotRecord(stream, step, st.seq, _KIND_NAMES[kind],
                                 chain_pos, raw, len(frame))
            st.seq += 1
            st.frames_since_base = chain_pos
            st.last_leaves = leaves
            st.last_version = version
            st.last_raw = raw
            st.last_kind = kind
            st.publishes += 1
            st.raw_bytes += raw
            st.stored_bytes += len(frame)
            if kind == KIND_BASE:
                st.bases += 1
                self._prune(st, stream)
            else:
                st.deltas += 1
            return rec

    # -- consumer side --------------------------------------------------------

    def ingest(self, stream: str, raw: bytes) -> dict:
        """Place one mirrored frame (raw bytes off a transport) into this
        store's chain — the replica half of :meth:`set_mirror`.

        The frame's own header says where it goes: frames land by their
        embedded seq, and a frame re-arriving with an existing seq
        *replaces* it (that is how producer-side noop collapse — which
        rewrites the tip frame in place — reaches the replica). Validates
        magic/crc up front, so a corrupted frame raises the usual typed
        :class:`SnapshotCorruptError` instead of poisoning the chain.
        """
        raw = bytes(raw)
        kind, seq, chain_pos, step, _ = self._unpack_frame(stream, None, raw)
        with self._lock:
            st = self._state(stream)
            if self.directory is None:
                st.mem_frames = [(s, b) for s, b in st.mem_frames if s != seq]
                st.mem_frames.append((seq, raw))
                st.mem_frames.sort(key=lambda e: e[0])
            else:
                d = self._stream_dir(stream)
                os.makedirs(d, exist_ok=True)
                transport.atomic_write_bytes(self._frame_path(stream, seq),
                                             raw)
            st.seq = max(st.seq, seq + 1)
            # the replica must not treat replayed frames as local publishes
            # (its own stats stay producer-truthful), but the monotonic
            # guard still advances so a later local publish can't regress
            if st.last_step is None or step >= st.last_step:
                st.last_step = step
        return {"stream": stream, "seq": seq, "step": step,
                "kind": _KIND_NAMES.get(kind, str(kind)),
                "chain_pos": chain_pos}

    def _replay(self, stream: str, upto: Optional[int] = None
                ) -> tuple[int, dict[str, np.ndarray], int]:
        """Replay base -> deltas; -> (step, leaves, chain_pos of last)."""
        frames = self._frame_sources(stream)
        if upto is not None:
            frames = [(s, x) for s, x in frames if s <= upto]
        if not frames:
            raise KeyError(f"no published snapshots for stream {stream!r}")
        # pass 1 (lenient): find the newest base from the 30-byte headers
        # alone — no frame body is read. Frames *behind* that base are dead
        # weight: damage there must not block restoring the live chain, and
        # their bytes are never loaded; the replayed suffix is validated
        # strictly (crc + contiguity + decode) in pass 2.
        kinds = [self._frame_kind(self._head(x)) for _, x in frames]
        base_idx = max((i for i, k in enumerate(kinds) if k == KIND_BASE),
                       default=None)
        if base_idx is None:
            raise SnapshotCorruptError(
                stream, frames[0][0], "chain has no base frame")
        parsed = []
        for seq, src in frames[base_idx:]:
            try:
                raw = self._load(src)
            except OSError as e:
                # the file vanished after listing — a concurrent writer
                # published a newer base and pruned this chain; keep the
                # typed-error contract (callers may re-list and retry)
                raise SnapshotCorruptError(
                    stream, seq,
                    f"frame file disappeared during replay ({e})") from e
            kind, fseq, chain_pos, step, blobs = self._unpack_frame(
                stream, seq, raw)
            if fseq != seq:
                raise SnapshotCorruptError(
                    stream, seq, f"frame claims seq {fseq}")
            parsed.append((seq, kind, chain_pos, step, blobs))
        pool = codecs.codec_pool() if self.parallel else None
        base_seq = parsed[0][0]
        leaves: dict[str, np.ndarray] = {}
        step_out, chain_pos_out = parsed[0][3], 0
        expect = base_seq
        for seq, kind, chain_pos, step, blobs in parsed:
            if seq != expect:
                # a frame between the base and here was never published
                # (or was deleted): the chain cannot be replayed past it
                raise SnapshotCorruptError(
                    stream, expect,
                    f"chain gap: frame seq {expect} is missing "
                    f"(next published frame is seq {seq})")
            if chain_pos != seq - base_seq:
                raise SnapshotCorruptError(
                    stream, seq,
                    f"inconsistent chain: frame declares chain_pos "
                    f"{chain_pos}, expected {seq - base_seq}")
            expect += 1
            if kind == KIND_NOOP:
                step_out, chain_pos_out = step, chain_pos
                continue
            new_leaves: dict[str, np.ndarray] = {}
            for key, blob in blobs.items():
                try:
                    new_leaves[key] = delta.decode(
                        blob, leaves.get(key), pool=pool)
                except (ValueError, KeyError, struct.error) as e:
                    raise SnapshotCorruptError(
                        stream, seq,
                        f"leaf {key!r} failed to decode: {e}") from e
            leaves = new_leaves
            step_out, chain_pos_out = step, chain_pos
        return step_out, leaves, chain_pos_out

    def restore(self, stream: str, *, upto: Optional[int] = None,
                template: Optional[PyTree] = None
                ) -> tuple[int, Any]:
        """Rebuild the newest snapshot with frame seq <= ``upto`` (or the
        newest published) by replaying its base → delta chain.

        Returns ``(step, leaves)`` where leaves maps flattened tree paths to
        host arrays (bf16 as the tagged uint16 dtype); with ``template``,
        the leaves are unflattened into the template's structure instead (a
        template leaf missing from the snapshot raises ``KeyError`` naming
        it — tree-shape drift, same contract as checkpoint restore).
        """
        with self._lock:
            step, leaves, _ = self._replay(stream, upto)
        if template is None:
            return step, leaves
        return step, pytree.unflatten_like(
            template, leaves,
            what="snapshot (tree shape drifted since publish)")

    def restorable(self, stream: str) -> bool:
        """True when the stream's chain currently replays end to end.

        The replica-hydration loop polls this while frames stream in over
        a mirror: a chain whose base hasn't arrived yet (the consumer may
        attach mid-chain) is simply not restorable *yet*, not corrupt.
        """
        with self._lock:
            try:
                self._replay(stream)
                return True
            except (KeyError, SnapshotCorruptError):
                return False

    # -- introspection --------------------------------------------------------

    def chain_depth(self, stream: str) -> int:
        """Frames since the owning base of the newest snapshot (0 = base)."""
        with self._lock:
            st = self._streams.get(stream)
            return max(st.frames_since_base, 0) if st else 0

    def published(self, stream: str) -> list[int]:
        """Seqs of the published frames (any prefix of these restores)."""
        with self._lock:
            return [seq for seq, _ in self._frame_sources(stream)]

    def stats(self, stream: str) -> dict[str, Any]:
        """Delta-chain statistics for :meth:`Session.report`."""
        with self._lock:
            st = self._streams.get(stream) or _StreamState()
            eq1 = ((st.raw_bytes - st.stored_bytes) / st.raw_bytes
                   if st.raw_bytes else 0.0)
            return {
                "publishes": st.publishes,
                "bases": st.bases,
                "deltas": st.deltas,
                "noops": st.noops,
                "stale_skipped": st.stale,
                "raw_bytes": st.raw_bytes,
                "stored_bytes": st.stored_bytes,
                "delta_ratio": eq1,                      # paper Eq. (1)
                "effective_compression_x": (
                    st.raw_bytes / st.stored_bytes if st.stored_bytes
                    else 0.0),
                "chain_depth": max(st.frames_since_base, 0),
                "base_every": self.base_every,
                "keep_chains": self.keep_chains,
                "codec": self.codec,
                "mirror_frames": self.mirror_frames,
                "mirror_failures": self.mirror_failures,
            }
