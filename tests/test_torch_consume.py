"""The port's consumer (``launch/consume.py``) and the steering
back-channel, against the JAX package's (CPU).

* ``consume_loop`` routes ``raw`` chain frames into a replica store,
  materializes ``file`` frames and decodes ``tree``/``json`` artifacts;
* ``restore_report`` of the same mirrored chain gives the JAX consumer's
  digest, bf16 pool included;
* a consumer of either package steers a producer session of the other
  over ``tcp://``: the message is applied and the task's cadence follows;
* a checkpoint that a port ``train_loop`` mirrors over ``tcp://`` lands
  byte-equal under the consumer's ``out_dir`` and restores bitwise through
  the JAX package's ``read_state``.
"""
import hashlib
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import session as JS
from repro.launch import consume as JC
from repro_torch.configs import base as tbase
from repro_torch.core import session as TS
from repro_torch.core import pytree
from repro_torch.core import transport as TT
from repro_torch.launch import consume as TC
from repro_torch.models import params as TP
from repro_torch.models import transformer as TMT
from repro_torch.serving import engine as TE
from repro_torch.serving import pages as TPG
from repro_torch.serving.snapshot import SnapshotStore

ARCH = "smollm-135m"
QUIET = dict(log=lambda *_: None)


def _chain_frames(n_steps=5):
    """Raw frames of a bf16 paged engine's snapshot chain, as the store
    mirrors them, plus the producer store's newest restore."""
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(1),
                         TMT.param_spec(cfg), "cpu")
    eng = TPG.PagedServingEngine(cfg, prm, num_pages=9, page_size=16,
                                 max_reqs=2, prompt_len=16, max_len=64,
                                 device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        assert eng.admit(TE.Request(i, rng.integers(0, cfg.vocab_size, 12),
                                    max_new=20))
    mirror = TT.MemorySink()
    store = SnapshotStore(base_every=3, mirror=mirror)
    for step in range(n_steps):
        eng.step()
        pay = eng.snapshot_payload()
        store.publish("kv_pages", step, pay["cache"],
                      version=pay["version"],
                      chunk_hints=pay["chunk_hints"])
    return mirror.frames, store.restore("kv_pages")


def _feed(pkg, frames, extra=()):
    """A connected (sink of ``pkg``, source of the other package's pair)
    socket pair with ``frames`` (and ``extra`` writes) already sent."""
    a, b = socket.socketpair()
    sink = pkg.StreamSink.over_socket(a, stream="kv_pages")
    for f in frames:
        sink.write(f.step, f.payload, stream=f.stream, codec=f.codec)
    for args, kw in extra:
        sink.write(*args, **kw)
    sink.close()
    return b


def test_consume_loop_routes_raw_file_and_tree_frames(tmp_path):
    frames, (step, want) = _chain_frames()
    shard = os.urandom(3000)
    extra = [((7, TT.pack_file("step_000000007/shard_0.bin", shard)),
              dict(stream="checkpoint", codec=TT.CODEC_FILE)),
             ((7, TT.pack_file("step_000000007/manifest.json", b"{}")),
              dict(stream="checkpoint", codec=TT.CODEC_FILE)),
             ((8, {"global_norm": 1.5, "hist": np.arange(4.0)}),
              dict(stream="gh")),
             ((9, {"task": "x", "every": 2}),
              dict(stream="ctl", codec=TT.CODEC_JSON))]
    b = _feed(TT, frames, extra)
    src = TT.StreamSource.over_socket(b)
    rep = TC.consume_loop(src, out_dir=str(tmp_path / "out"),
                          idle_timeout_s=0.3, **QUIET)
    src.close()
    assert rep["frames"] == len(frames) + 4
    assert rep["snapshot_frames"] == len(frames)
    assert rep["by_codec"] == {"raw": len(frames), "file": 2, "tree": 1,
                               "json": 1}
    assert rep["errors"] == []
    got_step, got = rep["store"].restore("kv_pages")
    assert got_step == step and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)
    out = tmp_path / "out" / "step_000000007"
    assert (out / "shard_0.bin").read_bytes() == shard
    assert rep["files"][-1].endswith("manifest.json")
    art = rep["artifacts"]["gh"]
    assert art["step"] == 8 and art["value"]["global_norm"] == 1.5
    np.testing.assert_array_equal(art["value"]["hist"], np.arange(4.0))
    assert rep["artifacts"]["ctl"]["value"] == {"task": "x", "every": 2}


def test_consume_loop_stop_predicate_ends_early():
    frames, _ = _chain_frames()
    b = _feed(TT, frames)
    src = TT.StreamSource.over_socket(b)
    rep = TC.consume_loop(src, idle_timeout_s=5.0,
                          stop=lambda r: r["snapshot_frames"] >= 2, **QUIET)
    src.close()
    assert rep["frames"] == 2


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_restore_report_digest_equals_jax(sender):
    """The same mirrored chain, consumed by each package: the newest
    snapshot's digest is one and the same."""
    from repro.core import transport as JT
    frames, _ = _chain_frames()
    pkg = TT if sender == "port" else JT
    reports = []
    for consume, trans in ((TC, TT), (JC, JT)):
        src = trans.StreamSource.over_socket(_feed(pkg, frames))
        rep = consume.consume_loop(src, idle_timeout_s=0.3, **QUIET)
        src.close()
        reports.append(consume.restore_report(rep))
    assert reports[0] == reports[1]
    assert reports[0]["n_leaves"] == 6


def _steer_run(producer, consumer_mod, steps=9):
    """A producer session of one package with a ``grad_health`` task
    streaming to ``tcp://``; the other package's ``consume_loop`` listens
    (on a port the OS picks) and steers it to every=3 after one frame.
    The producer waits after step 0 until the message has arrived."""
    S = TS if producer == "port" else JS
    address, bound, out = {}, threading.Event(), {}

    def log(msg):
        if "listening on" in msg:
            address["url"] = msg.split()[-1]
            bound.set()

    def consume():
        out["report"] = consumer_mod.consume_loop(
            steer=[{"task": "gh", "every": 3}], idle_timeout_s=1.0,
            start_grace_s=30.0, log=log)

    t = threading.Thread(target=consume)
    t.start()
    assert bound.wait(30)
    plan = S.InSituPlan.from_dict({
        "streams": ["grads"],
        "tasks": {"gh": {"stream": "grads", "preset": "grad_health",
                         "every": 2, "placement": "sync",
                         "options": {"to": address["url"]}}}})
    rng = np.random.default_rng(0)
    g = rng.standard_normal(64).astype(np.float32)
    with S.Session(plan, raise_on_error=True) as session:
        for step in range(steps):
            pay = {"params": torch.from_numpy(g + step)
                   if producer == "port" else g + step}
            session.emit("grads", step, pay)
            if step == 0:
                deadline = time.monotonic() + 20
                while not session.poll_steering():
                    assert time.monotonic() < deadline, "no steering came"
                    time.sleep(0.01)
    t.join(30)
    assert not t.is_alive()
    fired = [r.step for r in session.results if r.task == "gh"]
    return session.report(), fired, out["report"]


@pytest.mark.parametrize("producer,consumer", [("port", "jax"),
                                               ("jax", "port")])
def test_steering_crosses_packages(producer, consumer):
    rep, fired, crep = _steer_run(producer, JC if consumer == "jax" else TC)
    cmds = rep["steering"]["commands"]
    assert cmds == [{"via": "gh", "task": "gh", "applied": {"every": 3},
                     "rejected": {}, "ignored": {}}]
    assert fired == [0, 3, 6]             # every=2 until step 0, then 3
    assert crep["steering_sent"] == [{"message": {"task": "gh", "every": 3},
                                      "reached": 1}]
    assert crep["frames"] == 3 and crep["by_codec"] == {"tree": 3}


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_mirrored_checkpoint_restores_bitwise_through_jax(tmp_path):
    from repro.checkpoint import serialization as JSer
    from repro.models import params as JP
    from repro.models import transformer as JT
    from repro.optim import adamw as JO
    from repro_torch.launch import train as TRAIN

    address, bound, out = {}, threading.Event(), {}

    def log(msg):
        if "listening on" in msg:
            address["url"] = msg.split()[-1]
            bound.set()

    consumed = tmp_path / "consumed"

    def consume():
        out["report"] = TC.consume_loop(out_dir=str(consumed),
                                        idle_timeout_s=1.0,
                                        start_grace_s=60.0, log=log)

    t = threading.Thread(target=consume)
    t.start()
    assert bound.wait(30)
    ck = tmp_path / "ck"
    plan = TRAIN.default_train_plan(insitu_mode="hybrid", ckpt_dir=str(ck),
                                    ckpt_every=2, device="cpu")
    plan["tasks"]["checkpoint"]["options"]["mirror"] = address["url"]
    res = TRAIN.train_loop(ARCH, steps=5, plan=plan, device="cpu", **QUIET)
    t.join(60)
    assert not t.is_alive()
    rep = res["session_report"]
    assert rep["checkpoint"]["kept_steps"] == [0, 2, 4]
    crep = out["report"]
    assert crep["by_stream"] == {"checkpoint": crep["frames"]}
    assert crep["errors"] == []
    for step in (0, 2, 4):
        name = f"step_{step:09d}"
        mine = sorted(os.listdir(ck / name))
        assert sorted(os.listdir(consumed / name)) == mine
        for f in mine:
            assert _sha(ck / name / f) == _sha(consumed / name / f), f
    # the consumed copy, read by the JAX package, against the producer's
    # own directory read by the port: params bitwise; the lossy moments
    # through the JAX decoder are bitwise its read of the producer's file
    from repro.configs import base as jbase
    from repro_torch.checkpoint import serialization as TSer
    jcfg = jbase.get(ARCH, smoke=True)
    params = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(jcfg))
    ost = JO.init(params, JO.AdamWConfig())
    template = {"params": params, "mu": ost.mu, "nu": ost.nu,
                "count": ost.count}
    newest = "step_000000004"
    got = JSer.read_state(str(consumed / newest), template)
    mine = JSer.read_state(str(ck / newest), template)
    port = TSer.read_state(str(ck / newest), TRAIN.init_state(
        tbase.get(ARCH, smoke=True), 0, TRAIN.StepConfig().opt,
        device="cpu"), "cpu")
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(mine)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8))
    tparams = {pytree.keystr(p): t for p, t in
               pytree.flatten_with_path(port["params"])}
    n = 0
    for path, x in jax.tree_util.tree_flatten_with_path(got["params"])[0]:
        t = tparams[jax.tree_util.keystr(path)]
        bits = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        np.testing.assert_array_equal(
            np.asarray(x).reshape(-1).view(np.uint8),
            bits.numpy().reshape(-1).view(np.uint8))
        n += 1
    assert n == len(tparams) and int(got["count"]) == 5
