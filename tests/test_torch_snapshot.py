"""Byte formats shared by the port and the JAX package (CPU).

Codec v2 frames, delta frames and snapshot-chain frame files must be
byte-identical for the same input, bf16 leaves included (the JAX package
writes ``ml_dtypes`` bf16, the port a uint16 array tagged ``bfloat16``),
and each package must restore what the other published, bit for bit.
"""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core import delta as jdelta
from repro.serving.snapshot import SnapshotStore as JStore
from repro_torch.core import codecs as tcodecs
from repro_torch.core import delta as tdelta
from repro_torch.core import host
from repro_torch.serving.snapshot import SnapshotStore as TStore


def _arrays(seed=0):
    """name -> (jax-package host array, port host array), same bits."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((6, 40)).astype(np.float32)
    bf = f.astype(ml_dtypes.bfloat16)
    return {
        "f32": (f, f),
        "bf16": (bf, bf.view(np.uint16).view(host.BF16)),
        "i32": (rng.integers(-5, 5, (7, 3)).astype(np.int32),) * 2,
        "u8": (rng.integers(0, 255, 33).astype(np.uint8),) * 2,
        "empty": (np.zeros((0, 4), np.float32),) * 2,
    }


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("codec", ["zlib", "none", "bz2", "lzma"])
@pytest.mark.parametrize("name", list(_arrays()))
def test_codec_frames_byte_identical_and_cross_decode(codec, name):
    ja, ta = _arrays()[name]
    for chunk in (64, 1 << 20):
        jb, _ = jcodecs.encode(ja, codec, chunk_bytes=chunk)
        tb, _ = tcodecs.encode(ta, codec, chunk_bytes=chunk)
        assert tb == jb
        back_t = tcodecs.decode(jb)          # port reads the JAX frame
        back_j = jcodecs.decode(tb)          # and the other way round
        assert back_t.shape == ja.shape and back_j.shape == ja.shape
        assert host.logical_name(back_t.dtype) == host.logical_name(ja.dtype)
        np.testing.assert_array_equal(_bits(back_t), _bits(ja))
        np.testing.assert_array_equal(_bits(back_j), _bits(ja))


def test_bf16_frame_decodes_to_a_torch_bf16_view():
    ja, _ = _arrays()["bf16"]
    blob, _ = jcodecs.encode(ja, "zlib")
    t = host.to_tensor(tcodecs.decode(blob))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), ja.astype(np.float32))


@pytest.mark.parametrize("name", ["f32", "bf16", "u8"])
def test_delta_frames_byte_identical(name):
    ja, ta = _arrays()[name]
    jbase, tbase = ja.copy(), ta.copy()
    # change one region so chunks split into COPY / XOR / SELF ops
    flat_j, flat_t = _bits(ja).copy(), _bits(ta).copy()
    flat_j[:7] ^= 0xFF
    flat_t[:7] ^= 0xFF
    jnew = flat_j.view(ja.dtype).reshape(ja.shape)
    tnew = flat_t.view(ta.dtype).reshape(ta.shape)
    for base_j, base_t in ((None, None), (jbase, tbase)):
        jb, js = jdelta.encode(jnew, base_j, chunk_bytes=32)
        tb, ts = tdelta.encode(tnew, base_t, chunk_bytes=32)
        assert tb == jb
        assert (ts.n_copy, ts.n_xor, ts.n_self) == (js.n_copy, js.n_xor,
                                                     js.n_self)
        np.testing.assert_array_equal(_bits(tdelta.decode(jb, base_t)),
                                      _bits(jnew))
        np.testing.assert_array_equal(_bits(jdelta.decode(tb, base_j)),
                                      _bits(jnew))


def _payloads(n=5):
    """A serving-shaped payload sequence: bf16 pool pages that fill in
    step by step, an int32 table, a uint8 meta leaf that changes size."""
    rng = np.random.default_rng(1)
    pool = np.zeros((2, 5, 4, 1, 8), np.float32)
    out = []
    for i in range(n):
        pool[:, 1 + i % 4, i % 4] = rng.standard_normal((2, 1, 8))
        meta = np.frombuffer(f'{{"version": {i * 11}}}'.encode(), np.uint8)
        table = np.full((2, 3), i, np.int32)
        out.append((pool.astype(ml_dtypes.bfloat16), table, meta.copy()))
    return out


def _jtree(pool, table, meta):
    return {"pool": {"kv": {"k": jnp.asarray(pool), "v": jnp.asarray(pool)}},
            "state": {}, "page_table": jnp.asarray(table), "meta": meta}


def _ttree(pool, table, meta):
    t = host.to_tensor(pool)
    return {"pool": {"kv": {"k": t, "v": t.clone()}}, "state": {},
            "page_table": torch.from_numpy(table), "meta": meta}


HINTS = {"['pool']['kv']['k']": 4 * 8 * 2, "['pool']['kv']['v']": 4 * 8 * 2}


def _publish(store, mk):
    for i, (pool, table, meta) in enumerate(_payloads()):
        store.publish("kv", i, mk(pool, table, meta), version=i,
                      chunk_hints=HINTS)
    store.publish("kv", 5, mk(*_payloads()[-1]), version=4,   # a no-op
                  chunk_hints=HINTS)


def test_chain_frame_files_byte_identical(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _publish(JStore(str(jdir), base_every=3, keep_chains=None), _jtree)
    _publish(TStore(str(tdir), base_every=3, keep_chains=None), _ttree)
    names = sorted(os.listdir(jdir / "kv"))
    assert names == sorted(os.listdir(tdir / "kv")) and len(names) == 6
    for name in names:
        assert (jdir / "kv" / name).read_bytes() == \
            (tdir / "kv" / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chain_restores_bit_identically_across_packages(tmp_path, writer):
    d = str(tmp_path)
    if writer == "jax":
        _publish(JStore(d, base_every=3), _jtree)
        reader = TStore(d)
    else:
        _publish(TStore(d, base_every=3), _ttree)
        reader = JStore(d)
    step, leaves = reader.restore("kv")
    pool, table, meta = _payloads()[-1]
    assert step == 5
    assert list(leaves) == ["['meta']", "['page_table']",
                            "['pool']['kv']['k']", "['pool']['kv']['v']"]
    np.testing.assert_array_equal(_bits(leaves["['pool']['kv']['k']"]),
                                  _bits(pool))
    np.testing.assert_array_equal(leaves["['page_table']"], table)
    np.testing.assert_array_equal(leaves["['meta']"], meta)
    # an older point of the chain restores too
    step, leaves = reader.restore("kv", upto=2)
    np.testing.assert_array_equal(_bits(leaves["['pool']['kv']['v']"]),
                                  _bits(_payloads()[2][0]))
