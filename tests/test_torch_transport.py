"""The port's ``tcp://`` stream transport against the JAX package's (CPU).

Two layers:

  * the reference's socketpair and listener cases, run on the port's
    ``StreamSink``/``StreamSource``: round trip, interleaved streams, torn
    and flipped frames, implausible lengths, reconnects with and without
    loss, an unreachable consumer, the steering back-channel and the bye
    frame; plus hypothesis sequences;
  * cross-package cases over ``socket.socketpair()``: one package's sink
    writes, the other's source reads. The wire bytes are equal, the
    decoded payloads are equal, and steering frames cross both ways.
"""
import socket
import struct

import numpy as np
import pytest
import torch
from _hyp import given, settings, st   # optional-hypothesis shim

from repro.core import transport as JT
from repro_torch.core import transport as TT
from repro_torch.core.runtime import TransientError
from repro_torch.core.transport import (CODEC_FILE, CODEC_RAW, Frame,
                                        FrameCorruptError, StreamGapError,
                                        StreamSink, StreamSource,
                                        TransportError, connect, pack_file,
                                        pack_frame)


def _pair(stream="grads", check_gaps=True):
    a, b = socket.socketpair()
    return (StreamSink.over_socket(a, stream=stream),
            StreamSource.over_socket(b, check_gaps=check_gaps))


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "ints": np.arange(13, dtype=np.int32),
            "meta": {"step": 7, "tag": "x", "ok": True, "none": None},
            "blob": b"\x00\x01raw", "list": [1.5, "two", [3]]}


# ---------------------------------------------------------------------------
# the reference's socketpair and listener cases, on the port
# ---------------------------------------------------------------------------

def test_socketpair_round_trip():
    sink, source = _pair()
    try:
        for step in (0, 1, 2):
            sink.write(step, {"step": step,
                              "w": torch.arange(6) + step})
        got = [source.recv_frame(timeout=2.0) for _ in range(3)]
        assert [f.step for f in got] == [0, 1, 2]
        assert [f.seq for f in got] == [0, 1, 2]
        out = TT.decode_frame_payload(got[1])
        np.testing.assert_array_equal(out["w"], np.arange(6) + 1)
    finally:
        sink.close(), source.close()


def test_socketpair_interleaved_streams():
    sink, source = _pair()
    try:
        sink.write(0, {"a": 1}, stream="grads")
        sink.write(0, {"b": 2}, stream="spectra")
        sink.write(1, {"a": 3}, stream="grads")
        sink.write(1, {"b": 4}, stream="spectra")
        got = [source.recv_frame(timeout=2.0) for _ in range(4)]
        assert [(f.stream, f.seq) for f in got] == [
            ("grads", 0), ("spectra", 0), ("grads", 1), ("spectra", 1)]
    finally:
        sink.close(), source.close()


def test_socketpair_truncated_frame_is_typed():
    a, b = socket.socketpair()
    source = StreamSource.over_socket(b)
    try:
        wire = pack_frame(Frame("grads", 11, 0, CODEC_RAW, b"0123456789"))
        a.sendall(wire[:len(wire) - 4])
        a.close()
        with pytest.raises(FrameCorruptError, match="mid-frame"):
            source.recv_frame(timeout=2.0)
    finally:
        source.close()


def test_socketpair_bit_flip_is_typed_with_stream():
    a, b = socket.socketpair()
    source = StreamSource.over_socket(b)
    try:
        wire = bytearray(pack_frame(Frame("grads", 23, 0, CODEC_RAW,
                                          b"payloadpayload")))
        wire[-2] ^= 0x10
        a.sendall(bytes(wire))
        with pytest.raises(FrameCorruptError, match="crc mismatch") as ei:
            source.recv_frame(timeout=2.0)
        assert ei.value.stream == "grads" and ei.value.step == 23
    finally:
        a.close(), source.close()


def test_socketpair_implausible_length_is_typed():
    a, b = socket.socketpair()
    source = StreamSource.over_socket(b)
    try:
        a.sendall(struct.pack("<I", 0xFFFFFFFF))
        with pytest.raises(FrameCorruptError, match="implausible"):
            source.recv_frame(timeout=2.0)
    finally:
        a.close(), source.close()


def test_reconnect_gap_detected_and_named():
    listener = StreamSource(port=0)
    sink = connect(listener.address, stream="grads")
    try:
        assert isinstance(sink, StreamSink)
        sink.write(0, {"a": 0})
        assert listener.recv_frame(timeout=2.0).seq == 0
        sink._next_seq("grads")               # frames lost while away
        sink._next_seq("grads")
        sink.drop_connection()
        sink.write(5, {"a": 5})               # reconnects, seq 3
        with pytest.raises(StreamGapError) as ei:
            listener.recv_frame(timeout=2.0)
        assert ei.value.stream == "grads"
        assert (ei.value.expected, ei.value.got) == (1, 3)
        assert "2 frame(s) lost" in str(ei.value)
        assert sink.reconnects == 2
    finally:
        sink.close(), listener.close()


def test_reconnect_without_loss_is_clean():
    listener = StreamSource(port=0)
    sink = connect(listener.address, stream="grads")
    try:
        sink.write(0, {"a": 0})
        sink.drop_connection()
        sink.write(1, {"a": 1})
        assert [listener.recv_frame(timeout=2.0).seq for _ in range(2)] \
            == [0, 1]
        assert sink.reconnects == 2
    finally:
        sink.close(), listener.close()


def test_unreachable_consumer_is_transient():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    port = lst.getsockname()[1]
    lst.close()
    sink = StreamSink("127.0.0.1", port, connect_timeout_s=0.2)
    with pytest.raises(TransientError, match="cannot reach"):
        sink.write(0, {"a": 1})
    assert sink._seq.get("default", 0) == 0   # the seq rolled back


def test_steering_back_channel():
    sink, source = _pair()
    try:
        sink.write(0, {"a": 1})
        assert source.recv_frame(timeout=2.0) is not None
        assert source.send_control({"task": "gh", "every": 4}) == 1
        assert sink.poll_control() == [{"task": "gh", "every": 4}]
        assert sink.poll_control() == []
    finally:
        sink.close(), source.close()


def test_bye_frame_closes_cleanly():
    listener = StreamSource(port=0)
    sink = connect(listener.address, stream="s")
    try:
        sink.write(0, {"a": 1})
        assert listener.recv_frame(timeout=2.0) is not None
        sink.close()
        assert listener.recv_frame(timeout=0.5) is None
        assert listener.connections == 0
    finally:
        listener.close()


def test_frames_drains_and_stops_at_max():
    listener = StreamSource(port=0)
    sink = connect(listener.address, stream="s")
    try:
        for step in range(4):
            sink.write(step, {"v": step})
        got = list(listener.frames(idle_timeout_s=1.0, max_frames=3))
        assert [f.step for f in got] == [0, 1, 2]
        sink.close()
        rest = list(listener.frames(idle_timeout_s=0.3))
        assert [f.step for f in rest] == [3]
    finally:
        listener.close()


@pytest.mark.parametrize("url,match", [("tcp://nohost", "host:port"),
                                       ("tcp://h:x", "host:port"),
                                       ("ftp://x", "unknown transport")])
def test_connect_rejects_bad_tcp_urls(url, match):
    with pytest.raises(ValueError, match=match):
        connect(url)


def test_materialize_file_publishes_and_rejects_escapes(tmp_path):
    ok = Frame("checkpoint", 2, 0, CODEC_FILE,
               pack_file("step_2/shard.bin", b"bytes"))
    path = TT.materialize_file(ok, str(tmp_path))
    assert open(path, "rb").read() == b"bytes"
    assert path == str(tmp_path / "step_2" / "shard.bin")
    for bad in ("../x", "/etc/passwd"):
        f = Frame("checkpoint", 2, 0, CODEC_FILE, pack_file(bad, b"x"))
        with pytest.raises(TransportError, match="refusing"):
            TT.materialize_file(f, str(tmp_path))


@settings(max_examples=20, deadline=None)
@given(steps=st.lists(st.integers(0, 1000), min_size=1, max_size=20))
def test_hyp_socketpair_sequences(steps):
    sink, source = _pair(stream="s")
    try:
        for step in steps:
            sink.write(step, {"v": step})
        got = [source.recv_frame(timeout=2.0) for _ in steps]
        assert [f.step for f in got] == steps
        assert [f.seq for f in got] == list(range(len(steps)))
    finally:
        sink.close(), source.close()


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["a", "b", "c"]),
                              st.integers(0, 10**6)),
                    min_size=1, max_size=24))
def test_hyp_interleaved_streams_keep_per_stream_seqs(ops):
    sink, source = _pair()
    try:
        for stream, step in ops:
            sink.write(step, {"v": step}, stream=stream)
        got = [source.recv_frame(timeout=2.0) for _ in ops]
        seen: dict[str, int] = {}
        for (stream, step), f in zip(ops, got):
            assert (f.stream, f.step) == (stream, step)
            assert f.seq == seen.get(stream, 0)
            seen[stream] = f.seq + 1
    finally:
        sink.close(), source.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _wire_of(pkg, payload, *, codec=None, stream="grads"):
    """The bytes one package's StreamSink puts on a socket for three
    writes of ``payload`` (steps 0..2)."""
    a, b = socket.socketpair()
    sink = pkg.StreamSink.over_socket(a, stream=stream)
    for step in range(3):
        sink.write(step, payload, codec=codec)
    a.shutdown(socket.SHUT_WR)
    wire = b""
    while chunk := b.recv(1 << 16):
        wire += chunk
    a.close(), b.close()
    return wire


@pytest.mark.parametrize("codec", [None, TT.CODEC_JSON, TT.CODEC_RAW])
def test_wire_bytes_equal_across_packages(codec):
    if codec is None:
        jp, tp = _tree(), _tree()
        tp["w"] = torch.from_numpy(tp["w"])
    elif codec == TT.CODEC_JSON:
        jp = tp = {"task": "ckpt", "every": 3}
    else:
        jp = tp = bytes(range(256)) * 3
    assert _wire_of(TT, tp, codec=codec) == _wire_of(JT, jp, codec=codec)


def test_bf16_leaf_wire_equal_across_packages():
    import ml_dtypes

    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    j = x.astype(ml_dtypes.bfloat16)
    assert _wire_of(TT, {"x": t}) == _wire_of(JT, {"x": j})


@pytest.mark.parametrize("parallel", [False, True])
def test_a_dropped_payload_frees_its_leaves_without_the_collector(parallel):
    """A packed and unpacked payload leaves no reference cycle behind: with
    the garbage collector off, the unpacked arrays die with the payload,
    and a collection afterwards finds nothing that the round trip left
    (a walk that calls itself through its own closure keeps the frame's
    blobs until the collector runs). After one round trip first: the
    codec pool's threads start on the first."""
    import gc
    import weakref

    tree = dict(_tree(), t=torch.arange(64, dtype=torch.float32))
    TT.unpack_payload(TT.pack_payload(tree, parallel=parallel),
                      parallel=parallel)
    gc.collect()
    gc.disable()
    try:
        data = TT.pack_payload(tree, parallel=parallel)
        got = TT.unpack_payload(data, parallel=parallel)
        refs = [weakref.ref(got[k]) for k in ("w", "ints", "t")]
        np.testing.assert_array_equal(got["t"], tree["t"].numpy())
        del got, data
        assert [r for r in refs if r() is not None] == []
        assert gc.collect() == 0
    finally:
        gc.enable()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frames_and_control_cross_packages(direction):
    """One package's sink, the other's source: payloads decode equal, the
    source's steering reaches the sink, and the bye frame ends cleanly."""
    sink_pkg, src_pkg = (TT, JT) if direction == "port_to_jax" else (JT, TT)
    a, b = socket.socketpair()
    sink = sink_pkg.StreamSink.over_socket(a, stream="grads")
    source = src_pkg.StreamSource.over_socket(b)
    try:
        tree = _tree(1)
        sink.write(4, tree)
        sink.write(5, b"chain-frame", stream="kv", codec=TT.CODEC_RAW)
        sink.write(6, pack_file("ck/manifest.json", b"{}"),
                   stream="checkpoint", codec=TT.CODEC_FILE)
        got = [source.recv_frame(timeout=2.0) for _ in range(3)]
        assert [(f.stream, f.step, f.seq, f.codec) for f in got] == [
            ("grads", 4, 0, "tree"), ("kv", 5, 0, "raw"),
            ("checkpoint", 6, 0, "file")]
        out = src_pkg.decode_frame_payload(got[0])
        np.testing.assert_array_equal(out["w"], tree["w"])
        np.testing.assert_array_equal(out["ints"], tree["ints"])
        assert out["meta"] == tree["meta"] and out["blob"] == tree["blob"]
        assert src_pkg.decode_frame_payload(got[1]) == b"chain-frame"
        assert src_pkg.decode_frame_payload(got[2]) == (
            "ck/manifest.json", b"{}")
        assert source.send_control({"task": "ckpt", "every": 3}) == 1
        assert source.send_control({"task": "ckpt", "lossy_eps": 0.05}) == 1
        msgs = []
        for _ in range(50):
            msgs += sink.poll_control()
            if len(msgs) == 2:
                break
            source.recv_frame(timeout=0.01)
        assert msgs == [{"task": "ckpt", "every": 3},
                        {"task": "ckpt", "lossy_eps": 0.05}]
        sink.close()
        assert source.recv_frame(timeout=0.5) is None
        assert source.connections == 0
    finally:
        sink.close(), source.close()
