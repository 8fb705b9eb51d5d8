"""Crash consistency of the snapshot chain, through both packages (CPU).

The reference's kill-point and corruption cases
(``tests/test_snapshot_crash.py``) with the chain written by either
package and restored, damaged and continued by either. The publish
protocol is frame bytes -> tmp file (fsynced) -> rename in -> dir fsync,
one file per frame, and the frame bytes are the same in both packages
(``tests/test_torch_snapshot.py``), so each case reconstructs the on-disk
debris of a crash at one stage and asserts what the reference asserts:
restore replays the published prefix bit for bit, or raises the reader's
``SnapshotCorruptError`` naming the chain position. A restarted writer
continues a healthy chain and opens a fresh one over a corrupt chain.

bf16 leaves: the port restores them as its tagged ``uint16`` dtype
(``core/host.py``; it never needs ``ml_dtypes``), so its case holds the
bits and the logical dtype name, where the reference holds the
``ml_dtypes`` dtype.
"""
import os

import ml_dtypes
import numpy as np
import pytest

from repro.serving import snapshot as JSNAP
from repro_torch.core import host
from repro_torch.serving import snapshot as TSNAP

PACKAGES = {"jax": JSNAP, "port": TSNAP}
PAIRS = [(w, r) for w in PACKAGES for r in PACKAGES]
BASE_EVERY = 3
N_FRAMES = 8          # bases at seq 0, 3, 6


def _store(pkg, directory, **kw):
    return PACKAGES[pkg].SnapshotStore(str(directory), base_every=BASE_EVERY,
                                       **kw)


def _corrupt(pkg):
    return PACKAGES[pkg].SnapshotCorruptError


def _publish_chain(pkg, directory, n=N_FRAMES, seed=0):
    """Publish an append-mostly chain; returns the per-seq snapshots."""
    rng = np.random.default_rng(seed)
    slab = {"k": rng.standard_normal(20000).astype(np.float32),
            "v": rng.standard_normal(20000).astype(np.float32)}
    store = _store(pkg, directory, chunk_bytes=1 << 12)
    snaps = []
    for i in range(n):
        at = int(rng.integers(0, 19000))
        for arr in slab.values():
            arr[at:at + 1000] = rng.standard_normal(1000)
        store.publish("kv", i, slab)
        snaps.append({k: a.copy() for k, a in slab.items()})
    return snaps


def _frames(directory):
    d = os.path.join(str(directory), "kv")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".snap"))


def _assert_restores(pkg, directory, want, upto=None):
    step, leaves = _store(pkg, directory).restore("kv", upto=upto)
    for key, arr in want.items():
        np.testing.assert_array_equal(leaves[f"['{key}']"], arr)
    return step


def _flip_bit(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _truncate(path):
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])


def test_both_packages_write_the_same_frame_files(tmp_path):
    for pkg in PACKAGES:
        _publish_chain(pkg, tmp_path / pkg)
    names = [os.path.basename(f) for f in _frames(tmp_path / "jax")]
    assert names == [os.path.basename(f) for f in _frames(tmp_path / "port")]
    assert len(names) == N_FRAMES
    for name in names:
        assert (tmp_path / "jax" / "kv" / name).read_bytes() == \
            (tmp_path / "port" / "kv" / name).read_bytes(), name


# -- kill point 1: crash between publishes (any prefix is a valid chain) ------

@pytest.mark.parametrize("writer,reader", PAIRS)
def test_restore_succeeds_from_every_published_prefix(tmp_path, writer,
                                                      reader):
    snaps = _publish_chain(writer, tmp_path)
    files = _frames(tmp_path)
    assert len(files) == N_FRAMES
    for k in reversed(range(N_FRAMES)):
        for f in files[k + 1:]:
            if os.path.exists(f):
                os.remove(f)
        assert _assert_restores(reader, tmp_path, snaps[k]) == k


# -- kill point 2: crash mid-write, tmp file never renamed in -----------------

@pytest.mark.parametrize("writer,reader", PAIRS)
def test_unrenamed_tmp_frame_is_invisible(tmp_path, writer, reader):
    snaps = _publish_chain(writer, tmp_path)
    d = os.path.join(str(tmp_path), "kv")
    with open(os.path.join(d, f".tmp_frame_{N_FRAMES:08d}"), "wb") as f:
        f.write(b"RPSS\x01garbage-that-never-got-renamed")
    assert _assert_restores(reader, tmp_path, snaps[-1]) == N_FRAMES - 1
    # a restarted writer (the reader's package) appends past the debris
    store = _store(reader, tmp_path, chunk_bytes=1 << 12)
    store.publish("kv", 99, snaps[-1])
    step, _ = store.restore("kv")
    assert step == 99


# -- corruption: truncated / bit-flipped / missing frames ---------------------

@pytest.mark.parametrize("writer,reader", PAIRS)
def test_truncated_tail_frame_names_chain_position(tmp_path, writer, reader):
    _publish_chain(writer, tmp_path)
    _truncate(_frames(tmp_path)[-1])            # seq 7, a delta
    with pytest.raises(_corrupt(reader), match=r"chain position 7.*crc"):
        _store(reader, tmp_path).restore("kv")


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_bitflipped_delta_names_chain_position(tmp_path, writer, reader):
    snaps = _publish_chain(writer, tmp_path)    # bases at seqs 0, 3, 6
    _flip_bit(_frames(tmp_path)[7])             # a delta of the live chain
    with pytest.raises(_corrupt(reader), match="chain position 7"):
        _store(reader, tmp_path).restore("kv")
    _assert_restores(reader, tmp_path, snaps[6], upto=6)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_damage_behind_the_live_base_does_not_block_restore(tmp_path, writer,
                                                           reader):
    snaps = _publish_chain(writer, tmp_path)    # live chain: base 6, delta 7
    _flip_bit(_frames(tmp_path)[4])
    assert _assert_restores(reader, tmp_path, snaps[-1]) == N_FRAMES - 1
    with pytest.raises(_corrupt(reader), match="chain position 4"):
        _store(reader, tmp_path).restore("kv", upto=5)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_missing_middle_delta_is_a_chain_gap(tmp_path, writer, reader):
    _publish_chain(writer, tmp_path)            # bases at seqs 0, 3, 6
    files = _frames(tmp_path)
    os.remove(files[7])
    step, _ = _store(reader, tmp_path).restore("kv")
    assert step == 6
    os.remove(files[6])
    os.remove(files[4])
    with pytest.raises(_corrupt(reader), match=r"chain position 4.*missing"):
        _store(reader, tmp_path).restore("kv")


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_chain_without_base_raises(tmp_path, writer, reader):
    _publish_chain(writer, tmp_path, n=3)       # base at 0, deltas 1-2
    os.remove(_frames(tmp_path)[0])
    with pytest.raises(_corrupt(reader), match="no base frame"):
        _store(reader, tmp_path).restore("kv")


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_bitflipped_header_field_is_detected(tmp_path, writer, reader):
    """The crc covers the header too: a flipped bit in the step field must
    not validate."""
    _publish_chain(writer, tmp_path, n=2)
    victim = _frames(tmp_path)[1]
    blob = bytearray(open(victim, "rb").read())
    blob[15] ^= 0x01                            # inside the step field
    with open(victim, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(_corrupt(reader), match=r"chain position 1.*crc"):
        _store(reader, tmp_path).restore("kv")


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_wrong_magic_frame_is_corrupt(tmp_path, writer, reader):
    _publish_chain(writer, tmp_path, n=2)
    victim = _frames(tmp_path)[1]
    blob = bytearray(open(victim, "rb").read())
    blob[:4] = b"XXXX"
    with open(victim, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(_corrupt(reader), match="magic"):
        _store(reader, tmp_path).restore("kv")


# -- writer restart over damaged chains ---------------------------------------

@pytest.mark.parametrize("writer,reader", PAIRS)
def test_restarted_writer_rebases_over_a_corrupt_chain(tmp_path, writer,
                                                       reader):
    """A writer (the reader's package) that cannot rebuild the previous
    snapshot from disk opens a fresh chain: its next publish is a base,
    and restore goes through it whatever lies behind."""
    snaps = _publish_chain(writer, tmp_path)
    _truncate(_frames(tmp_path)[-1])
    store = _store(reader, tmp_path, chunk_bytes=1 << 12)
    rec = store.publish("kv", 100, snaps[-1])
    assert rec.kind == "base"
    for pkg in PACKAGES:
        step, leaves = _store(pkg, tmp_path).restore("kv")
        assert step == 100
        for key, arr in snaps[-1].items():
            np.testing.assert_array_equal(leaves[f"['{key}']"], arr)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_restarted_writer_continues_a_healthy_chain(tmp_path, writer, reader):
    snaps = _publish_chain(writer, tmp_path, n=4)   # base 0, d1, d2, base 3
    store = _store(reader, tmp_path, chunk_bytes=1 << 12)
    mutated = {k: a.copy() for k, a in snaps[-1].items()}
    mutated["k"][:100] = 0.0
    rec = store.publish("kv", 4, mutated)
    assert rec.kind == "delta" and rec.chain_pos == 1
    for pkg in PACKAGES:
        step, leaves = _store(pkg, tmp_path).restore("kv")
        assert step == 4
        np.testing.assert_array_equal(leaves["['k']"], mutated["k"])


# -- bf16 leaves --------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", PAIRS)
def test_bfloat16_leaves_roundtrip(tmp_path, writer, reader):
    """The serving KV cache is bf16: the delta frame's dtype token carries
    it across packages. The port's reader returns its tagged uint16
    (logical name ``bfloat16``), the reference's the ``ml_dtypes``
    dtype; the bits are the same."""
    rng = np.random.default_rng(11)
    bits = rng.standard_normal(4096).astype(ml_dtypes.bfloat16).view(
        np.uint16)
    as_pkg = {"jax": lambda b: b.view(ml_dtypes.bfloat16),
              "port": lambda b: b.view(host.BF16)}
    store = PACKAGES[writer].SnapshotStore(str(tmp_path), base_every=2)
    for i in range(3):
        bits[i * 100:(i + 1) * 100] = rng.standard_normal(100).astype(
            ml_dtypes.bfloat16).view(np.uint16)
        store.publish("kv", i, {"k": as_pkg[writer](bits.copy())})
    template = {"k": as_pkg[reader](bits.copy())}
    step, tree = PACKAGES[reader].SnapshotStore(
        str(tmp_path), base_every=2).restore("kv", template=template)
    assert step == 2
    got = tree["k"]
    assert host.logical_name(got.dtype) == "bfloat16"
    if reader == "jax":
        assert got.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(got).view(np.uint16), bits)
