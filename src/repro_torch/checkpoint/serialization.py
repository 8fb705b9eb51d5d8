"""Checkpoint serialization: framed tensors + shard manifest.

Every leaf of the training state becomes one self-describing framed blob
(lossless via :mod:`repro_torch.core.codecs`, or lossy via
:mod:`repro_torch.core.lossy` for leaves the policy allows — optimizer
moments by default). A JSON manifest binds the tree structure
(``jax.tree_util.keystr``-style keys) to stored bytes. The bytes are the
JAX package's: a checkpoint written by either package restores in the
other.

Layout v2 (packed shards — the default):
    <dir>/step_000123/
        manifest.json        {step, format: 2, leaves: {key: {file, offset,
                              bytes, raw_bytes, lossy, bf16}}, meta}
        shard_000.bin        concatenated framed blobs, offset-addressed
        [shard_NNN.bin ...]  byte-balanced when shard_count > 1
All leaf blobs are packed into few large files bound by the manifest's
offset table, so save cost is IO bandwidth, not per-leaf open/write/fsync
metadata pressure, and restore can readahead each shard sequentially.

Layout v1 (legacy, one file per leaf) is still written by format=1 configs
and always restored: entries without an ``offset`` name a per-leaf
``<key-hash>.bin`` file. Both layouts, shard boundaries and file names
included, are the JAX package's byte for byte.

bf16 leaves are stored as their raw 16-bit pattern (a plain uint16 frame)
with ``bf16: true`` in the manifest, as the JAX package stores them.

Commit/durability protocol (both layouts):
  1. blobs written and **fsynced** (per shard file / per leaf file),
  2. manifest written to a tmp name, fsynced, renamed into the tmp dir,
  3. the tmp dir is atomically published by ``commit``: any existing final
     dir is first moved *aside* (sibling rename — never deleted while it is
     the only copy), the tmp dir is renamed into place, the parent directory
     is fsynced, and only then is the old copy removed. A checkpoint without
     a manifest is invisible to discovery, so readers never observe partial
     state, and a crash at any point leaves either the old or the new
     checkpoint restorable. ``sweep_stale`` (run on manager init) removes
     crashed tmp dirs and re-publishes a copy stranded mid-commit.
"""
from __future__ import annotations

import hashlib
import json
import mmap
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import codecs, host, lossy, pytree
from repro_torch.kernels.ref import Compressed

PyTree = Any

CHECKPOINT_FORMAT = 2
_SHARD_FMT = "shard_{:03d}.bin"
_TMP_RE = re.compile(r"^\.tmp_step_\d{9}$")
_OLD_RE = re.compile(r"^\.old_(step_\d{9})$")


class CheckpointCorruptError(RuntimeError):
    """A stored blob does not match its manifest entry (truncation/corruption)."""


def _fname(key: str) -> str:
    """A v1 leaf file's name: the JAX package's, so a v1 directory of
    either package has the same files."""
    return hashlib.sha1(key.encode()).hexdigest()[:16] + ".bin"


def _fsync_dir(path: str) -> None:
    """Durably record directory-entry changes (renames) under ``path``."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass                       # not all filesystems support dir fsync
    finally:
        os.close(fd)


@dataclass
class SaveReport:
    step: int
    raw_bytes: int
    stored_bytes: int
    n_leaves: int
    lossy_leaves: int

    @property
    def ratio(self) -> float:
        if self.raw_bytes == 0:
            return 0.0
        return (self.raw_bytes - self.stored_bytes) / self.raw_bytes


def _is_compressed(x: Any) -> bool:
    return isinstance(x, Compressed)


def bf16_keys(state: PyTree) -> set[str]:
    """Keys of the bf16 leaves (tensors, or tagged host arrays)."""
    out = set()
    for path, leaf in pytree.flatten_with_path(state, _is_compressed):
        dt = getattr(leaf, "dtype", None)
        if dt is torch.bfloat16 or (isinstance(leaf, np.ndarray)
                                    and host.logical_name(dt) == "bfloat16"):
            out.add(pytree.keystr(path))
    return out


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return host.to_numpy(x.detach().cpu())
    return np.asarray(x)


def state_to_host(state: PyTree) -> dict[str, np.ndarray | Compressed]:
    """Device->host hand-off: every leaf as host numpy, ``Compressed``
    leaves with host q and scale, bf16 as its plain uint16 bit pattern."""
    out: dict[str, Any] = {}
    for path, leaf in pytree.flatten_with_path(state, _is_compressed):
        key = pytree.keystr(path)
        if isinstance(leaf, Compressed):
            out[key] = leaf._replace(q=_host_array(leaf.q),
                                     scale=_host_array(leaf.scale))
            continue
        arr = _host_array(leaf)
        if host.logical_name(arr.dtype) == "bfloat16":
            arr = arr.view(np.uint16)      # the raw 16-bit pattern, untagged
        out[key] = arr
    return out


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def encode_leaf(key: str, arr, *, lossless: str = "zlib", eps: float = 1e-2,
                lossy_policy: Optional[Callable[[str], bool]] = None,
                bf16_keys: Optional[set] = None, pool=None,
                device: str | torch.device = "cuda") -> tuple[bytes, dict]:
    """Encode ONE leaf -> (framed blob, manifest entry sans file).

    Pure compute, no I/O: the unit the checkpoint pipeline fans out across
    its workers. A ``Compressed`` leaf (the hybrid path: the lossy stage
    already ran on the device) only gets its lossless stage; a lossy leaf
    of the other placements runs its lossy stage on ``device``."""
    if isinstance(arr, Compressed):
        blob, st = lossy.frame_compressed(arr, lossless, pool)
        is_lossy, raw_bytes, is_bf16 = True, st.raw_bytes, False
    else:
        is_lossy = bool(lossy_policy and lossy_policy(key))
        is_bf16 = bool(bf16_keys and key in bf16_keys)
        raw_bytes = int(arr.nbytes)
        if is_lossy:
            # the lossy path needs real float values: bf16 bits go via f32
            a = _bf16_bits_to_f32(arr.view(np.uint16)) if is_bf16 else arr
            blob, _ = lossy.compress_tensor(a, eps=eps, lossless=lossless,
                                            pool=pool, device=device)
        else:
            blob, _ = codecs.encode(arr, lossless, pool=pool)
    return blob, {"bytes": len(blob), "lossy": is_lossy,
                  "raw_bytes": raw_bytes, "bf16": is_bf16}


def encode_blobs(host_state: dict[str, np.ndarray | Compressed], *,
                 lossless: str = "zlib", eps: float = 1e-2,
                 lossy_policy: Optional[Callable[[str], bool]] = None,
                 bf16_keys: Optional[set] = None, pool=None,
                 device: str | torch.device = "cuda"
                 ) -> dict[str, tuple[bytes, dict]]:
    """Serial leaf walk over ``encode_leaf`` (the pipeline fans leaves out)."""
    return {key: encode_leaf(key, arr, lossless=lossless, eps=eps,
                             lossy_policy=lossy_policy, bf16_keys=bf16_keys,
                             pool=pool, device=device)
            for key, arr in host_state.items()}


def write_encoded(directory: str,
                  encoded: dict[str, tuple[bytes, dict]]) -> dict[str, dict]:
    """v1 write stage: one fsynced file per leaf; returns manifest entries."""
    os.makedirs(directory, exist_ok=True)
    entries: dict[str, dict] = {}
    for key, (blob, ent) in encoded.items():
        fn = _fname(key)
        with open(os.path.join(directory, fn), "wb") as f:
            f.write(blob)
            f.flush()
            # a published manifest must never point at unwritten blob bytes
            os.fsync(f.fileno())
        entries[key] = {"file": fn, **ent}
    return entries


def write_encoded_shards(directory: str,
                         encoded: dict[str, tuple[bytes, dict]],
                         shard_count: int = 1) -> dict[str, dict]:
    """v2 write stage: pack every blob into ``shard_count`` fsynced files.

    One open/write/fsync per *shard* — independent of leaf count — with the
    manifest's offset table binding each leaf to (file, offset, bytes).
    Leaves pack sequentially in dict order; when ``shard_count > 1`` the
    stream rolls over at byte-balanced boundaries: a shard closes once it
    holds ``ceil(total / shard_count)`` bytes (``shard_count`` is an upper
    bound, clamped to the number of leaves: a few large leaves may fill
    the budget in fewer files).
    """
    os.makedirs(directory, exist_ok=True)
    items = list(encoded.items())
    entries: dict[str, dict] = {}
    if not items:
        return entries
    total = sum(len(blob) for _, (blob, _) in items)
    shard_count = max(1, min(int(shard_count), len(items)))
    target = max(1, -(-total // shard_count))          # ceil(total/shards)
    si, offset, f = 0, 0, None
    try:
        for key, (blob, ent) in items:
            if f is None:
                fn = _SHARD_FMT.format(si)
                f = open(os.path.join(directory, fn), "wb")
                offset = 0
            entries[key] = {"file": fn, "offset": offset, **ent}
            f.write(blob)
            offset += len(blob)
            if offset >= target and si < shard_count - 1:
                f.flush()
                os.fsync(f.fileno())
                f.close()
                f, si = None, si + 1
        if f is not None:
            f.flush()
            os.fsync(f.fileno())
            f.close()
            f = None
    finally:
        if f is not None:
            f.close()
    return entries


def write_blobs(host_state: dict[str, np.ndarray | Compressed],
                directory: str, *, lossless: str = "zlib", eps: float = 1e-2,
                lossy_policy: Optional[Callable[[str], bool]] = None,
                bf16_keys: Optional[set] = None, shard_count: int = 1,
                device: str | torch.device = "cuda") -> dict[str, dict]:
    """Encode + write in one call (the pipeline splits the two stages)."""
    return write_encoded_shards(directory, encode_blobs(
        host_state, lossless=lossless, eps=eps, lossy_policy=lossy_policy,
        bf16_keys=bf16_keys, device=device), shard_count)


def write_manifest(directory: str, step: int, entries: dict[str, dict],
                   meta: Optional[dict] = None) -> None:
    fmt = (CHECKPOINT_FORMAT
           if any("offset" in e for e in entries.values()) else 1)
    manifest = {"step": step, "format": fmt, "leaves": entries,
                "meta": meta or {}}
    tmp = os.path.join(directory, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, "manifest.json"))
    # durably record the step dir's own entries: commit() only fsyncs the
    # *parent*
    _fsync_dir(directory)


# serializes commit's aside/publish rename pair against sweep_stale's
# recovery renames (in-process only — sharing one checkpoint directory
# across processes is out of scope, as for retention)
_commit_lock = threading.Lock()


def commit(tmp_dir: str, final_dir: str) -> None:
    """Atomic publish that never destroys the only copy of a step (see the
    module docstring)."""
    parent = os.path.dirname(os.path.abspath(final_dir))
    old = os.path.join(parent, ".old_" + os.path.basename(final_dir))
    with _commit_lock:
        displaced = False
        if os.path.exists(final_dir):
            if os.path.exists(old):
                shutil.rmtree(old)
            os.replace(final_dir, old)
            displaced = True
        os.replace(tmp_dir, final_dir)
        _fsync_dir(parent)
        if displaced:
            shutil.rmtree(old, ignore_errors=True)


def _latest_mtime(path: str) -> float:
    """Newest mtime of a dir or anything directly inside it (a writer
    streaming into an open shard advances the *file's* mtime)."""
    try:
        newest = os.path.getmtime(path)
        for entry in os.scandir(path):
            try:
                newest = max(newest, entry.stat().st_mtime)
            except OSError:
                pass
    except OSError:
        return 0.0
    return newest


def sweep_stale(directory: str, tmp_grace_s: float = 60.0) -> None:
    """Crash recovery at startup: clear the commit protocol's debris.

    * ``.tmp_step_*`` dirs are unpublished partial saves — removed, unless
      modified within ``tmp_grace_s`` seconds (a live writer's);
    * ``.old_step_N`` with ``step_N`` present — removed;
    * ``.old_step_N`` *without* ``step_N`` (a crash between the aside and
      publish renames) — moved back so the step is visible again.
    """
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return
    now = time.time()
    with _commit_lock:
        for name in names:
            path = os.path.join(directory, name)
            if _TMP_RE.match(name):
                if now - _latest_mtime(path) >= tmp_grace_s:
                    shutil.rmtree(path, ignore_errors=True)
                continue
            m = _OLD_RE.match(name)
            if m:
                final = os.path.join(directory, m.group(1))
                if os.path.exists(final):
                    shutil.rmtree(path, ignore_errors=True)
                elif os.path.exists(path):
                    os.replace(path, final)
        _fsync_dir(directory)


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


def _load_shard(path: str):
    """Readahead one shard: mmap (sequential-advised) or a full read."""
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):       # empty file / no-mmap fs
            f.seek(0)
            return f.read()
    if hasattr(mm, "madvise") and hasattr(mmap, "MADV_SEQUENTIAL"):
        try:
            mm.madvise(mmap.MADV_SEQUENTIAL)
        except OSError:
            pass
    return mm


def _fetch_blob(directory: str, key: str, ent: dict, shards: dict) -> bytes:
    """One leaf's stored bytes, validated against the manifest entry."""
    want = int(ent["bytes"])
    if "offset" in ent:                      # v2: slice the packed shard
        off = int(ent["offset"])
        blob = bytes(shards[ent["file"]][off:off + want])
    else:                                    # v1: per-leaf blob file
        try:
            with open(os.path.join(directory, ent["file"]), "rb") as f:
                blob = f.read()
        except FileNotFoundError as e:
            raise CheckpointCorruptError(
                f"checkpoint {directory}: leaf {key!r} names missing blob "
                f"file {ent['file']!r}") from e
    if len(blob) != want:
        raise CheckpointCorruptError(
            f"checkpoint {directory}: leaf {key!r} expected {want} stored "
            f"bytes, found {len(blob)} (truncated "
            f"{'shard' if 'offset' in ent else 'blob'} file {ent['file']!r})")
    return blob


def read_state(directory: str, template: PyTree,
               device: str | torch.device = "cuda", pool=None) -> PyTree:
    """Restore a tree shaped like ``template`` as tensors on ``device``
    (the card by default), in the template leaves' dtypes and shapes.

    v2 checkpoints are read with one sequential-readahead mmap per shard
    file and the per-leaf decode fanned out on ``pool`` (the shared codec
    executor); lossy leaves dequantize on ``device`` (the dequantise +
    inverse DCT kernel on the card, on each pool thread's own stream).
    Truncated/corrupt stored bytes raise ``CheckpointCorruptError``; a
    template leaf missing from the manifest raises ``KeyError`` naming
    the leaf.
    """
    dev = host.resolve_device(device)
    manifest = read_manifest(directory)
    entries = manifest["leaves"]
    flat = pytree.flatten_with_path(template)
    shards = {}
    for fn in sorted({e["file"] for e in entries.values() if "offset" in e}):
        try:
            shards[fn] = _load_shard(os.path.join(directory, fn))
        except FileNotFoundError as e:
            raise CheckpointCorruptError(
                f"checkpoint {directory}: manifest references missing shard "
                f"file {fn!r}") from e
    jobs = []
    for path, leaf in flat:
        key = pytree.keystr(path)
        ent = entries.get(key)
        if ent is None:
            raise KeyError(
                f"checkpoint {directory} has no entry for template leaf "
                f"{key!r} — the template's tree shape drifted since this "
                f"checkpoint was written ({len(entries)} stored leaves)")
        jobs.append((key, ent, leaf))

    fan_leaves = pool is not None and len(jobs) > 1
    # the leaves are decoded on pool threads, each on its own side stream;
    # what they make is handed to this thread's stream
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def _restore_one(job: tuple):
        key, ent, leaf = job
        blob = _fetch_blob(directory, key, ent, shards)
        with host.worker_stream(dev):
            # chunk-level fan-out only when leaves decode serially: nesting
            # both levels on one executor would have leaf jobs block on
            # chunk jobs that cannot be scheduled behind them
            arr = lossy.decompress_blob(blob, None if fan_leaves else pool,
                                        device=dev)
            if not isinstance(arr, torch.Tensor):
                if ent.get("bf16") and not ent["lossy"]:
                    arr = np.ascontiguousarray(arr).view(host.BF16)
                arr = host.to_device(arr, dev)
            t = arr.to(getattr(leaf, "dtype", arr.dtype)).reshape(
                tuple(getattr(leaf, "shape", arr.shape)))
        if caller is not None:
            t.record_stream(caller)
        return key, t

    if fan_leaves:
        restored = dict(pool.map(_restore_one, jobs))
    else:
        restored = dict(_restore_one(j) for j in jobs)
    return pytree.unflatten_like(template, restored, "checkpoint")
