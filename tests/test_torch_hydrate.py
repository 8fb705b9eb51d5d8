"""Replica hydration across the packages (CPU).

A producer's ``serve_snapshot`` chain — published to a directory, or
mirrored over ``tcp://`` loopback to a listening ``ReplicaHydrator`` —
rebuilds a replica engine that decodes the producer's in-flight requests
with no prefill. The chain format is shared, so each direction is run:

  * the JAX package's producer, a port replica;
  * a port producer, the JAX package's replica (``repro.launch.hydrate``);
  * port to port.

Producer and replica start from the same weights, cast to f32 on both
sides, where greedy token streams of the two packages are equal (as in
``test_torch_serving.py``); the replica's continuation must equal the
producer's token for token. Port to port runs the materialized bf16
weights, where both sides are the same code and the same bits.
"""
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import session as JS
from repro.launch import hydrate as JH
from repro.models import params as JP
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro.serving import pages as JPG
from repro_torch.configs import base as tbase
from repro_torch.core import session as TS
from repro_torch.launch import hydrate as TH
from repro_torch.launch.serve import default_serve_plan, serve_loop
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import pages as TPG
from repro_torch.serving.snapshot import SnapshotStore

ARCH = "smollm-135m"
GEOMETRY = dict(num_pages=17, page_size=16, max_reqs=4, prompt_len=24,
                max_len=64)
STEPS = 3            # producer steps before the snapshot the replica takes


@pytest.fixture(scope="module")
def f32():
    """(jax cfg, jax params, port cfg, port params), all f32."""
    jcfg = jbase.get(ARCH, smoke=True)
    jprm = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(jcfg))
    tprm = TP.from_numpy_tree(jax.device_get(jprm), "cpu")
    return (dataclasses.replace(jcfg, dtype="float32"),
            JP.cast_tree(jprm, jnp.float32),
            dataclasses.replace(tbase.get(ARCH, smoke=True),
                                dtype="float32"),
            TP.cast_tree(tprm, torch.float32))


def _requests(cls, vocab, prefix):
    rng = np.random.default_rng(11)
    return [cls(i, np.concatenate(
        [prefix, rng.integers(0, vocab, size=4)]).astype(np.int32),
        max_new=10) for i in range(3)]


def _prefix(vocab):
    return np.random.default_rng(7).integers(0, vocab, 16).astype(np.int32)


def _engine(pkg, cfg, prm):
    if pkg == "jax":
        return JPG.PagedServingEngine(cfg, prm, **GEOMETRY)
    return TPG.PagedServingEngine(cfg, prm, device="cpu", **GEOMETRY)


def _produce(pkg, cfg, prm, *, directory=None, to=None):
    """Admit three requests behind a registered prefix, decode STEPS
    steps with a snapshot after each; returns (engine, requests)."""
    S = JS if pkg == "jax" else TS
    Req = JE.Request if pkg == "jax" else TE.Request
    opts = {"base_every": 2}
    if directory is not None:
        opts["directory"] = directory
    if to is not None:
        opts["to"] = to
    plan = S.InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {"kv_snapshot": {"stream": "kv_pages",
                                  "preset": "serve_snapshot", "every": 1,
                                  "placement": "sync", "options": opts}}})
    eng = _engine(pkg, cfg, prm)
    prefix = _prefix(cfg.vocab_size)
    eng.register_prefix(prefix)
    reqs = _requests(Req, cfg.vocab_size, prefix)
    for r in reqs:
        assert eng.admit(r)
    with S.Session(plan, raise_on_error=True) as session:
        for step in range(STEPS):
            eng.step()
            session.emit("kv_pages", step, eng.snapshot_payload)
    rep = session.report()["tasks"]["kv_snapshot"]
    assert rep.get("publishes", STEPS) == STEPS
    return eng, reqs


def _hydrator(pkg, source):
    return (JH.ReplicaHydrator(source) if pkg == "jax"
            else TH.ReplicaHydrator(source))


def _hydrate(pkg, hyd, cfg, prm, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return hyd.hydrate(cfg, prm, log=kw.pop("log", lambda *_: None), **kw)


def _over_tcp(producer, replica, cfg_p, prm_p, cfg_r, prm_r):
    """The replica listens on a port the OS picks; the producer mirrors to
    it. The replica waits for the snapshot of the producer's last step."""
    hyd = _hydrator(replica, "tcp://127.0.0.1:0")
    address = {}
    bound = threading.Event()
    out = {}

    def log(msg):
        if "listening on" in msg:
            address["url"] = msg.split()[-1]
            bound.set()

    def ready():
        return (hyd.store.restorable("kv_pages")
                and hyd.store.restore("kv_pages")[0] == STEPS - 1)

    def run():
        try:
            out["result"] = _hydrate(replica, hyd, cfg_r, prm_r, ready=ready,
                                     idle_timeout_s=20.0,
                                     start_grace_s=60.0, log=log)
        except BaseException as e:    # noqa: BLE001 - surfaced below
            out["error"] = e
            bound.set()

    t = threading.Thread(target=run)
    t.start()
    assert bound.wait(60) and "error" not in out, out.get("error")
    eng, reqs = _produce(producer, cfg_p, prm_p, to=address["url"])
    t.join(120)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return eng, reqs, out["result"]


def _assert_lockstep(producer, reqs, replica, info):
    """The replica restored the producer's state at its last snapshot and
    decodes the same continuation with no prefill."""
    assert info["step"] == STEPS - 1
    assert info["active_requests"] == 3 and info["prefixes"] == 1
    assert replica.allocator.state_dict() == producer.allocator.state_dict()
    assert replica.prefix.state_dict() == producer.prefix.state_dict()
    assert replica._chains == producer._chains
    live = [a for a in replica.active if a is not None]
    assert [r.rid for r in live] == [r.rid for r in reqs]
    for a, b in zip(reqs, live):
        assert a.out == b.out and np.array_equal(a.prompt, b.prompt)
    pre = replica.prefill_tokens
    for _ in range(20):
        if any(a is not None for a in producer.active):
            producer.step()
        if any(a is not None for a in replica.active):
            replica.step()
    for a, b in zip(reqs, live):
        assert a.done and b.done
        assert a.out == b.out, f"replica diverged on request {a.rid}"
    assert replica.prefill_tokens == pre


@pytest.mark.parametrize("route", ["dir", "tcp"])
@pytest.mark.parametrize("producer,replica", [("jax", "torch"),
                                              ("torch", "jax")])
def test_chain_hydrates_replica_across_packages(f32, tmp_path, producer,
                                                replica, route):
    jcfg, jprm, tcfg, tprm = f32
    side = {"jax": (jcfg, jprm), "torch": (tcfg, tprm)}
    if route == "dir":
        d = str(tmp_path / "chain")
        eng, reqs = _produce(producer, *side[producer], directory=d)
        rep, info = _hydrate(replica, _hydrator(replica, d),
                             *side[replica])
        assert info["mode"] == "local"
    else:
        eng, reqs, (rep, info) = _over_tcp(producer, replica,
                                           *side[producer], *side[replica])
        assert info["mode"] == "tcp" and info["frames_ingested"] >= STEPS
        assert info["ingest_s"] > 0
    assert info["restore_s"] > 0
    _assert_lockstep(eng, reqs, rep, info)


@pytest.mark.parametrize("route", ["dir", "tcp"])
def test_port_chain_hydrates_port_replica_bf16(tmp_path, route):
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(3),
                         TT.param_spec(cfg), "cpu")
    if route == "dir":
        d = str(tmp_path / "chain")
        eng, reqs = _produce("torch", cfg, prm, directory=d)
        rep, info = TH.hydrate_serving_engine(d, cfg, prm, device="cpu",
                                              log=lambda *_: None)
    else:
        eng, reqs, (rep, info) = _over_tcp("torch", "torch", cfg, prm,
                                           cfg, prm)
    assert rep.pool["kv"]["k"].dtype == torch.bfloat16
    _assert_lockstep(eng, reqs, rep, info)


def test_load_snapshot_writes_buffers_in_place(tmp_path):
    """``load_snapshot`` keeps every buffer's address (what a captured
    step reads) and leaves the engine equal to a ``from_snapshot`` one."""
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(3),
                         TT.param_spec(cfg), "cpu")
    d = str(tmp_path / "chain")
    _produce("torch", cfg, prm, directory=d)
    _, leaves = SnapshotStore(d).restore("kv_pages")
    eng = _engine("torch", cfg, prm)
    bufs = [eng.pool["kv"]["k"], eng.pool["kv"]["v"], eng.page_table,
            eng.lengths, eng.tokens]
    ptrs = [b.data_ptr() for b in bufs]
    eng.load_snapshot(leaves)
    assert [b.data_ptr() for b in (eng.pool["kv"]["k"], eng.pool["kv"]["v"],
                                   eng.page_table, eng.lengths,
                                   eng.tokens)] == ptrs
    ref = TPG.PagedServingEngine.from_snapshot(cfg, prm, leaves,
                                               device="cpu")
    for a, b in zip(bufs, (ref.pool["kv"]["k"], ref.pool["kv"]["v"],
                           ref.page_table, ref.lengths, ref.tokens)):
        assert torch.equal(a, b)
    assert eng.allocator.state_dict() == ref.allocator.state_dict()
    assert eng._len_host.tolist() == ref._len_host.tolist()


def test_from_snapshot_requires_meta_leaf(tmp_path):
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(3),
                         TT.param_spec(cfg), "cpu")
    d = str(tmp_path / "chain")
    _produce("torch", cfg, prm, directory=d)
    _, leaves = SnapshotStore(d).restore("kv_pages")
    leaves = {k: v for k, v in leaves.items() if k != "['meta']"}
    with pytest.raises(KeyError, match="no 'meta' leaf"):
        TPG.PagedServingEngine.from_snapshot(cfg, prm, leaves, device="cpu")


def test_load_snapshot_refuses_other_geometry(tmp_path):
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(3),
                         TT.param_spec(cfg), "cpu")
    d = str(tmp_path / "chain")
    _produce("torch", cfg, prm, directory=d)
    _, leaves = SnapshotStore(d).restore("kv_pages")
    other = TPG.PagedServingEngine(cfg, prm, device="cpu",
                                   **{**GEOMETRY, "num_pages": 9})
    with pytest.raises(ValueError, match="does not match"):
        other.load_snapshot(leaves)


def test_from_snapshot_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device exists")
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(3),
                         TT.param_spec(cfg), "cpu")
    d = str(tmp_path / "chain")
    _produce("torch", cfg, prm, directory=d)
    _, leaves = SnapshotStore(d).restore("kv_pages")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPG.PagedServingEngine.from_snapshot(cfg, prm, leaves)


def test_hydrator_rejects_bad_sources(tmp_path):
    with pytest.raises(ValueError, match="tcp:// listen address"):
        TH.ReplicaHydrator("file:///x")
    with pytest.raises(ValueError, match="host:port"):
        TH.ReplicaHydrator("tcp://nohost")
    with pytest.raises(FileNotFoundError):
        TH.ReplicaHydrator(str(tmp_path / "missing"))


def test_serve_loop_hydrates_and_carries_in_flight_requests(tmp_path):
    """``serve_loop(hydrate_from=dir)`` rebuilds the engine from a chain a
    port producer left mid-flight (same seed, so the same weights), drains
    the carried requests to the producer's own tokens and serves its own."""
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(0),
                         TT.param_spec(cfg), "cpu")
    d = str(tmp_path / "chain")
    eng, reqs = _produce("torch", cfg, prm, directory=d)
    # serve_loop's geometry for max_new=8 is the producer's GEOMETRY only
    # through the snapshot: hydration takes the chain's own
    out = serve_loop(ARCH, n_requests=2, max_new=8, hydrate_from=d,
                     plan=default_serve_plan(insitu_mode="sync"),
                     device="cpu", log=lambda *_: None)
    info = out["hydrate_info"]
    assert info["step"] == STEPS - 1 and info["active_requests"] == 3
    carried = out["requests"][:3]
    assert [r.rid for r in carried] == [r.rid for r in reqs]
    eng.run([], max_steps=20)
    for a, b in zip(reqs, carried):
        assert b.done and a.out == b.out
    assert all(r.done for r in out["requests"])
    assert len(out["requests"]) == 5


def test_serve_loop_dense_refuses_hydration(tmp_path):
    with pytest.raises(ValueError, match="paged engine"):
        serve_loop(ARCH, engine_kind="dense", hydrate_from=str(tmp_path),
                   device="cpu", log=lambda *_: None)


def test_snapshot_meta_is_jax_layout(f32, tmp_path):
    """The port's ``meta`` leaf decodes to the JAX engine's keys."""
    _, _, tcfg, tprm = f32
    d = str(tmp_path / "chain")
    _produce("torch", tcfg, tprm, directory=d)
    _, leaves = SnapshotStore(d).restore("kv_pages")
    meta = json.loads(np.asarray(leaves["['meta']"], np.uint8).tobytes())
    assert sorted(meta) == sorted(["engine", "allocator", "chains",
                                   "len_host", "active", "prefix",
                                   "counters", "version", "page_versions"])


def test_attached_replica_follows_the_chain_with_no_failed_sends():
    """``hydrate(detach=False)`` then ``follow()``: the replica hydrates
    from the first restorable snapshot, keeps ingesting the producer's
    later frames, and the producer's mirror counts no failure."""
    cfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(3),
                         TT.param_spec(cfg), "cpu")
    hyd = TH.ReplicaHydrator("tcp://127.0.0.1:0")
    address, bound, out = {}, threading.Event(), {}

    def log(msg):
        if "listening on" in msg:
            address["url"] = msg.split()[-1]
            bound.set()

    def run():
        out["hydrated"] = hyd.hydrate(cfg, prm, device="cpu", detach=False,
                                      idle_timeout_s=20.0,
                                      start_grace_s=60.0, log=log)
        out["follow"] = hyd.follow(idle_timeout_s=1.0, log=lambda *_: None)

    t = threading.Thread(target=run)
    t.start()
    assert bound.wait(60)
    plan = TS.InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {"kv_snapshot": {"stream": "kv_pages",
                                  "preset": "serve_snapshot", "every": 1,
                                  "placement": "sync",
                                  "options": {"base_every": 2,
                                              "to": address["url"]}}}})
    eng = _engine("torch", cfg, prm)
    for r in _requests(TE.Request, cfg.vocab_size, _prefix(cfg.vocab_size)):
        assert eng.admit(r)
    with TS.Session(plan, raise_on_error=True) as session:
        for step in range(6):
            eng.step()
            session.emit("kv_pages", step, eng.snapshot_payload)
            if step == 0:
                # let the replica hydrate mid-run, while frames still come
                deadline = time.monotonic() + 60
                while "hydrated" not in out:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
        store = session.snapshot_store("kv_snapshot")
        failures = store.mirror_failures
    t.join(60)
    assert not t.is_alive()
    assert failures == 0
    _, info = out["hydrated"]
    assert info["step"] == 0
    assert out["follow"]["snapshot_frames"] == 5
    assert hyd.store.restore("kv_pages")[0] == 5


def test_state_only_chain_hydrates_a_replica(tmp_path):
    """An xlstm chain holds no pool leaf (its pool is empty) and only
    per-row ``state``: the hydrator rebuilds a port replica from the
    directory, which carries the in-flight requests and decodes them to
    the producer's tokens with no prefill."""
    cfg = tbase.get("xlstm-1.3b", smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(3),
                         TT.param_spec(cfg), "cpu")
    d = str(tmp_path / "chain")
    plan = TS.InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {"kv_snapshot": {
            "stream": "kv_pages", "preset": "serve_snapshot", "every": 1,
            "placement": "sync",
            "options": {"base_every": 2, "directory": d}}}})
    eng = _engine("torch", cfg, prm)
    assert eng.pool == {}
    rng = np.random.default_rng(5)
    reqs = [TE.Request(i, rng.integers(0, cfg.vocab_size, 9 + i), max_new=10)
            for i in range(3)]
    for r in reqs:
        assert eng.admit(r)
    with TS.Session(plan, raise_on_error=True) as session:
        for step in range(STEPS):
            eng.step()
            session.emit("kv_pages", step, eng.snapshot_payload)
    _, leaves = SnapshotStore(d).restore("kv_pages")
    assert not any(k.startswith("['pool']") for k in leaves)
    rep, info = TH.hydrate_serving_engine(d, cfg, prm, device="cpu",
                                          log=lambda *_: None)
    assert info["mode"] == "local" and info["step"] == STEPS - 1
    live = [a for a in rep.active if a is not None]
    assert [r.out for r in live] == [r.out for r in reqs]
    pre = rep.prefill_tokens
    eng.run([], max_steps=20)
    rep.run([], max_steps=20)
    for a, b in zip(reqs, live):
        assert a.done and b.done and a.out == b.out
    assert rep.prefill_tokens == pre
