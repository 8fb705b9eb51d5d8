"""The port's PipelineRuntime against the JAX package's, case for case
with ``tests/test_runtime.py`` (CPU).

Every case drives the same scenario through both packages' runtimes —
``repro.core.runtime`` and ``repro_torch.core.runtime`` — on the same
inputs, holds each to the reference test's own contract (with its own
margins), and compares what both report: results in order, result
values, span and counter counts, drops, effective periods, staging
puts. Device payloads are ``jax.numpy`` arrays on one side and torch
tensors on the other; host payloads are the same numpy arrays.

  * one scheduler — SYNC / ASYNC / HYBRID are policies, sharded SYNC work
    rides the shared pool (no transient executors)
  * two-phase hand-off — the loop pays only ``handoff/dispatch``; pending
    transfers materialize FIFO on the consumers and fully drain
  * backpressure policies: block (staging/wait), drop (counted), adapt
    (the effective firing period lengthens under sustained pressure)
  * declarative stage chains get per-stage telemetry spans
  * every codec in the unified registry round-trips (exactly, or within
    its declared error bound) and decodes the other package's blob
"""
import copy
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import runtime as JR
from repro.core.telemetry import Telemetry as JTelemetry
from repro_torch.core import compression as TC
from repro_torch.core import runtime as TR
from repro_torch.core.telemetry import Telemetry as TTelemetry

PKGS = (JR, TR)
# a device array of each package (host numpy in, the package's tensor out)
DEVICE = {JR: jnp.asarray, TR: torch.as_tensor}


def _loop(R, runtime, n, step_s=0.0, payload=None):
    payload = payload if payload is not None else np.zeros(8)

    def app_step(i):
        if step_s:
            time.sleep(step_s)   # device step: host-idle wait
        return {"x": lambda: payload}

    return R.run_pipeline(n, app_step, runtime)


def _span_counts(rt, *names):
    return [len(rt.telemetry.spans(n)) for n in names]


# -- placement scheduling -----------------------------------------------------

def test_sync_sharded_firings_reuse_the_shared_pool():
    """Sharded SYNC work runs on the persistent insitu-* workers."""
    for R in PKGS:
        seen = []

        def work(step, piece):
            seen.append(threading.current_thread().name)
            return piece.sum()

        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=work, placement=R.Placement.SYNC,
                            shards=4)],
            workers=2)
        _loop(R, rt, 3, payload=np.ones(64))
        assert len(seen) == 12, R.__name__           # 3 firings x 4 shards
        assert all(name.startswith("insitu-") for name in seen)
        assert len(set(seen)) <= 2                   # the pool, not new threads
        # the loop still observed each firing as one blocking (sync) result
        assert len(rt.results) == 3
        assert [r.result for r in rt.results] == [[16.0] * 4] * 3
        assert rt.telemetry.total("insitu-sync/") > 0
        before = threading.active_count()
        _loop(R, rt, 0)                              # no thread growth after
        assert threading.active_count() == before


def test_sync_sharded_results_preserve_shard_order():
    got = []
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, pc: float(pc[0]),
                            placement=R.Placement.SYNC, shards=3)],
            workers=2)
        _loop(R, rt, 1,
              payload=np.asarray([0.0] * 10 + [1.0] * 10 + [2.0] * 10))
        got.append(rt.results[0].result)
    assert got[0] == got[1] == [0.0, 1.0, 2.0]


def test_host_stage_chain_runs_in_order_with_spans():
    for R in PKGS:
        order = []

        def stage_a(step, p):
            order.append("a")
            return p + 1

        def stage_b(step, p):
            order.append("b")
            return p * 10

        rt = R.PipelineRuntime(
            [R.PipelineTask("chain", "x",
                            host_stages=(R.Stage("add", stage_a),
                                         R.Stage("mul", stage_b)),
                            sink=lambda s, p: order.append("sink") or p,
                            placement=R.Placement.ASYNC)],
            workers=1)
        _loop(R, rt, 1, payload=np.asarray(2.0))
        assert order == ["a", "b", "sink"]
        assert rt.results[0].result == 30.0
        assert _span_counts(rt, "stage/chain/add", "stage/chain/mul") == [1, 1]


def test_device_stage_runs_before_handoff():
    for R in PKGS:
        events = []
        rt = R.PipelineRuntime(
            [R.PipelineTask("hy", "x",
                            device_stage=lambda s, p: events.append(
                                "device") or p,
                            handoff=lambda p: events.append("handoff") or p,
                            sink=lambda s, p: events.append("sink") or None,
                            placement=R.Placement.HYBRID)],
            workers=1)
        _loop(R, rt, 1)
        rt.wait_idle()
        assert events == ["device", "handoff", "sink"]
        assert rt.telemetry.total("insitu-device/hy") > 0


# -- two-phase (pipelined) hand-off -------------------------------------------

def test_pipelined_handoff_dispatches_on_loop_materializes_on_worker():
    """ASYNC: loop records only handoff/dispatch; the worker drains the
    transfer (handoff/materialize) and results arrive FIFO, fully drained."""
    outs = []
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, p: float(p.sum()))],
            workers=1)
        payloads = {i: DEVICE[R](np.arange(8.0, dtype=np.float32) + i)
                    for i in range(4)}
        R.run_pipeline(4, lambda i: {"x": lambda: payloads[i]}, rt)
        assert [r.step for r in rt.results] == [0, 1, 2, 3]   # FIFO, drained
        assert not rt.errors
        dispatch = rt.telemetry.spans("handoff/dispatch")
        materialize = rt.telemetry.spans("handoff/materialize")
        assert len(dispatch) == 4 and len(materialize) == 4
        assert all(s.thread == threading.main_thread().name
                   for s in dispatch)
        assert all(s.thread.startswith("insitu-") for s in materialize)
        # nothing blocked the loop beyond the dispatch
        assert rt.telemetry.spans("step/handoff") == []
        rep = rt.report()
        assert rep["handoff_s"] == pytest.approx(rep["handoff_dispatch_s"])
        outs.append([r.result for r in rt.results])
    assert outs[0] == outs[1] == [28.0, 36.0, 44.0, 52.0]


def test_pipelined_hybrid_custom_handoff_runs_on_worker_after_device():
    for R in PKGS:
        events = []

        def handoff(p):
            events.append(("handoff", threading.current_thread().name))
            return p * 2

        rt = R.PipelineRuntime(
            [R.PipelineTask(
                "hy", "x",
                device_stage=lambda s, p: events.append(
                    ("device", threading.current_thread().name)) or p,
                handoff=handoff,
                sink=lambda s, p: float(p.sum()),
                placement=R.Placement.HYBRID)],
            workers=1)
        R.run_pipeline(1, lambda i: {"x": lambda: np.ones(4)}, rt)
        assert [e[0] for e in events] == ["device", "handoff"]
        assert events[0][1] == threading.main_thread().name   # device on loop
        assert events[1][1].startswith("insitu-")             # handoff on pool
        assert rt.results[0].result == 8.0


def test_non_pipelined_task_keeps_blocking_handoff():
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, p: p.sum(),
                            pipelined=False)],
            workers=1)
        R.run_pipeline(3, lambda i: {"x": lambda: np.ones(4)}, rt)
        blocking = rt.telemetry.spans("step/handoff")
        assert len(blocking) == 3
        assert all(s.thread == threading.main_thread().name
                   for s in blocking)
        assert rt.telemetry.spans("handoff/dispatch") == []
        assert [float(r.result) for r in rt.results] == [4.0] * 3


def test_pipelined_handoff_survives_buffer_donation():
    """The dispatch snapshot detaches tokens from the application's
    buffers: JAX donates the input of its next step, PyTorch updates the
    tensor in place — neither may change a pending transfer."""
    import functools

    @functools.partial(jax.jit, donate_argnums=0)
    def train_step(x):
        return x + 1.0

    def torch_step(x):
        return x.add_(1.0)           # in place: the same storage

    outs = []
    for R, step, x in ((JR, train_step, jnp.ones(8)),
                       (TR, torch_step, torch.ones(8))):
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, p: float(p.sum()))],
            workers=1, staging_capacity=4)
        for i in range(4):
            rt.submit(i, {"x": lambda x=x: x})
            x = step(x)              # donates / overwrites what the token read
        rt.drain()
        assert not rt.errors, rt.errors[:1]
        outs.append([r.result for r in rt.results])
    assert outs[0] == outs[1] == [8.0, 16.0, 24.0, 32.0]


def test_drain_semantics_pending_transfers_all_materialize():
    """A slow consumer + drain: every dispatched transfer still lands."""
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x",
                            sink=lambda s, p: time.sleep(0.01) or float(p[0]))],
            workers=1, staging_capacity=2)
        R.run_pipeline(6, lambda i: {"x": lambda: DEVICE[R](
            np.full((4,), float(i), np.float32))}, rt)
        assert sorted(r.result for r in rt.results) == [0.0, 1.0, 2.0, 3.0,
                                                        4.0, 5.0]
        assert rt.staging.gets == rt.staging.puts == 6


# -- fan-out host stages ------------------------------------------------------

def _fanout_task(R, fn, *, placement=None, sink=None):
    stage = R.FanoutStage(
        "enc",
        split=lambda s, p: [(i, v) for i, v in enumerate(p)],
        fn=fn,
        gather=lambda s, p, results: {"orig": p, "results": results})
    return R.PipelineTask("t", "x", host_stages=(stage,),
                          sink=sink or (lambda s, p: p),
                          placement=placement or R.Placement.ASYNC)


def test_fanout_stage_spreads_items_across_pool_and_orders_results():
    """Items of one firing are stolen by idle workers; gather sees the
    original payload plus results in split order (the barrier contract)."""
    outs = []
    for R in PKGS:
        threads = set()
        # rendezvous makes the two-thread assertion deterministic: whichever
        # thread takes item 0 blocks until a *different* thread reaches
        # item 1, so the coordinator cannot self-drain everything
        both = threading.Barrier(2, timeout=20)

        def work(step, item):
            i, v = item
            threads.add(threading.current_thread().name)
            if i < 2:
                both.wait()
            return i * 10 + v

        rt = R.PipelineRuntime([_fanout_task(R, work)], workers=2)
        payload = list(range(8))
        # submit + wait (not run_pipeline): drain would close the ring
        # before the stage runs, and tokens cannot go on a closed ring
        rt.submit(0, {"x": lambda: payload})
        assert rt.wait_idle(timeout=30.0)
        rt.drain()
        assert not rt.errors, rt.errors[:1]
        out = rt.results[0].result
        assert out["orig"] == payload
        assert len(threads) == 2         # coordinator + a stealing worker
        assert len(rt.telemetry.spans("stage/t/enc/item")) == 8
        assert sum(s.name == "stage/t/enc"
                   for s in rt.telemetry.spans("stage/t/enc")) == 1
        outs.append(out["results"])
    assert outs[0] == outs[1] == [i * 10 + v for i, v in enumerate(range(8))]


def test_fanout_stage_works_with_a_single_worker():
    """A lone worker coordinates AND executes every item (no deadlock even
    though its steal tokens can never be claimed)."""
    for R in PKGS:
        rt = R.PipelineRuntime([_fanout_task(R, lambda s, it: it[1] + 1)],
                               workers=1, staging_capacity=1)
        R.run_pipeline(2, lambda i: {"x": lambda: [1, 2, 3, 4, 5]}, rt)
        assert not rt.errors, rt.errors[:1]
        assert [r.result["results"] for r in rt.results] == \
            [[2, 3, 4, 5, 6]] * 2
        # tokens never occupy the ring's last free slot: on a capacity-1
        # ring no steal token was ever put (only the 2 firings themselves)
        assert rt.staging.puts == 2


def test_fanout_stage_under_sync_placement_runs_on_the_pool_too():
    """SYNC: the loop thread coordinates; registration still spins up the
    pool so items can be stolen."""
    for R in PKGS:
        rt = R.PipelineRuntime(
            [_fanout_task(R, lambda s, it: it[1] * 2,
                          placement=R.Placement.SYNC)],
            workers=2)
        assert rt._threads            # pool exists despite SYNC placement
        R.run_pipeline(1, lambda i: {"x": lambda: [3, 4]}, rt)
        assert rt.results[0].result["results"] == [6, 8]


def test_fanout_stage_empty_split_gathers_empty():
    for R in PKGS:
        rt = R.PipelineRuntime([_fanout_task(R, lambda s, it: 1 / 0)],
                               workers=1)
        R.run_pipeline(1, lambda i: {"x": lambda: []}, rt)
        assert not rt.errors
        assert rt.results[0].result["results"] == []


def test_fanout_stage_item_error_fails_the_firing():
    def work(step, item):
        if item[0] == 2:
            raise RuntimeError("leaf 2 exploded")
        return item[1]

    for R in PKGS:
        rt = R.PipelineRuntime([_fanout_task(R, work)], workers=2)
        R.run_pipeline(1, lambda i: {"x": lambda: [0, 1, 2, 3]}, rt)
        assert len(rt.errors) == 1
        assert "leaf 2 exploded" in str(rt.errors[0][2])
        assert rt.results == []


# -- split_payload ------------------------------------------------------------

def test_split_payload_shards_pytree_leaves_on_leading_axis():
    tree = {"a": np.arange(10), "b": np.ones((10, 3))}
    want = JR.split_payload(tree, 2)
    for parts in (want, TR.split_payload(tree, 2),
                  TR.split_payload({k: torch.as_tensor(v)
                                    for k, v in tree.items()}, 2)):
        assert len(parts) == 2
        assert parts[0]["a"].shape == (5,) and parts[1]["b"].shape == (5, 3)
        np.testing.assert_array_equal(
            np.concatenate([p["a"] for p in parts]), tree["a"])
        for p, w in zip(parts, want):
            for k in tree:
                np.testing.assert_array_equal(np.asarray(p[k]), w[k])


def test_split_payload_rejects_unshardable_leaves():
    for R in PKGS:
        with pytest.raises(ValueError, match="leading axis"):
            R.split_payload({"a": 3.0}, 2)
        with pytest.raises(ValueError, match="0-d"):
            R.split_payload(np.asarray(1.0), 2)


def test_split_payload_rejects_undersized_leading_axis():
    """A leading axis shorter than the shard count would silently produce
    empty shards (np.array_split pads with empties) — raise instead."""
    for R in PKGS:
        with pytest.raises(ValueError, match="non-empty"):
            R.split_payload(np.ones(2), 4)
        with pytest.raises(ValueError, match="non-empty"):
            R.split_payload({"a": np.ones((1, 8))}, 4)


def test_sharded_async_pytree_firing_runs_each_shard():
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, p: float(p["a"].sum()),
                            placement=R.Placement.ASYNC, shards=2)],
            workers=2)
        R.run_pipeline(1, lambda i: {"x": lambda: {"a": np.ones(10)}}, rt)
        assert sorted(r.result for r in rt.results) == [5.0, 5.0]
        # sharded firings materialize on the loop (a token cannot be split)
        assert len(rt.telemetry.spans("step/handoff")) == 1


# -- telemetry: per-thread span buffers ---------------------------------------

def test_telemetry_concurrent_recording_is_complete_and_ordered():
    n_threads, per_thread = 4, 300
    for Tm in (JTelemetry, TTelemetry):
        tm = Tm()

        def writer(k):
            for i in range(per_thread):
                tm.record(f"x/{k}", float(i), float(i) + 0.5)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        spans = tm.spans("x/")
        assert len(spans) == n_threads * per_thread
        assert [s.t0 for s in spans] == sorted(s.t0 for s in spans)
        assert tm.total("x/") == pytest.approx(0.5 * n_threads * per_thread)
        tm.reset()
        assert tm.spans() == []


# -- backpressure policies ----------------------------------------------------

def _pressured(R, policy, *, n=12, workers=1, task_s=0.03, every=1):
    rt = R.PipelineRuntime(
        [R.PipelineTask("t", "x",
                        sink=lambda s, p: time.sleep(task_s),
                        placement=R.Placement.ASYNC, every=every,
                        backpressure=policy, adapt_after=2)],
        workers=workers, staging_capacity=1)
    _loop(R, rt, n, step_s=0.001)
    return rt


def test_block_policy_records_staging_wait():
    for R in PKGS:
        rt = _pressured(R, "block")
        assert rt.telemetry.total("staging/wait") > 0
        assert len(rt.results) == 12                 # nothing lost
        assert rt.drops["t"] == 0
        assert rt.report()["drops"] == {"t": 0}


def test_drop_policy_counts_drops_and_never_stalls():
    for R in PKGS:
        rt = _pressured(R, "drop")
        assert rt.drops["t"] > 0
        assert len(rt.results) + rt.drops["t"] == 12
        assert rt.telemetry.counters()["staging/drop/t"] == rt.drops["t"]
        assert rt.report()["drops"] == {"t": rt.drops["t"]}
        # a dropping producer must not have blocked on the ring
        assert rt.telemetry.total("staging/wait") == 0


def test_adapt_policy_lengthens_every_under_sustained_pressure():
    for R in PKGS:
        rt = _pressured(R, "adapt", n=24)
        assert rt.effective_every("t") > 1           # the runtime backed off
        assert rt.report()["effective_every"]["t"] == rt.effective_every("t")
        # adapted-but-delivered: every accepted firing produced a result
        assert len(rt.results) == rt.staging.puts


def test_adapt_policy_is_quiet_without_pressure():
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, p: None,
                            placement=R.Placement.ASYNC,
                            backpressure="adapt")],
            workers=2, staging_capacity=8)
        _loop(R, rt, 10, step_s=0.002)
        assert rt.effective_every("t") == 1
        assert len(rt.results) == 10


def test_bad_backpressure_policy_rejected():
    for R in PKGS:
        with pytest.raises(ValueError, match="backpressure"):
            R.PipelineTask("t", "x", sink=lambda s, p: None,
                           backpressure="shrug")


def test_duplicate_registration_rejected():
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, p: None)], workers=1)
        with pytest.raises(ValueError):
            rt.register(R.PipelineTask("t", "x", sink=lambda s, p: None))
        rt.drain()


def test_report_keys_and_counters_match_between_packages():
    """One ASYNC task over the same 6 steps: both runtimes report the same
    keys, results, drops, effective periods and staging puts."""
    reps = []
    for R in PKGS:
        rt = R.PipelineRuntime(
            [R.PipelineTask("t", "x", sink=lambda s, p: float(p.sum()),
                            every=2)],
            workers=2, staging_capacity=4)
        _loop(R, rt, 6, payload=np.arange(4.0))
        rep = rt.report()
        reps.append((rep, sorted((r.step, r.result) for r in rt.results)))
    (jrep, jres), (trep, tres) = reps
    assert set(trep) == set(jrep)
    assert tres == jres == [(0, 6.0), (2, 6.0), (4, 6.0)]
    for key in ("n_results", "n_errors", "staging_puts", "drops",
                "effective_every", "retries", "degraded"):
        assert trep[key] == jrep[key], key


# -- codec registry -----------------------------------------------------------

def _smooth_signal(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 8 * np.pi, n)
    return (np.sin(t) + 0.3 * np.sin(5.1 * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("name", JC.available())
def test_registry_roundtrip_every_codec(name):
    """Each codec of the JAX package's registry is in the port's, round
    trips there (exactly, or within its declared bound), and decodes the
    JAX package's blob of the same signal to the same values."""
    assert name in TC.available()
    x = _smooth_signal()
    jcodec, tcodec = JC.get(name), TC.get(name)
    if hasattr(tcodec, "device"):
        # the port's device codecs run on the card unless told otherwise
        tcodec = copy.copy(tcodec)
        tcodec.device = "cpu"
    assert tcodec.lossy == jcodec.lossy
    blob = tcodec.encode(x)
    out = np.asarray(tcodec.decode(blob))
    jout = np.asarray(tcodec.decode(jcodec.encode(x)))
    want = np.asarray(jcodec.decode(jcodec.encode(x)))
    if tcodec.lossy:
        assert tcodec.error_bound() == jcodec.error_bound()
        for o in (out, jout):
            o = o.ravel()[: x.size].reshape(x.shape)
            rel = float(np.linalg.norm(o - x) / np.linalg.norm(x))
            assert rel <= tcodec.error_bound(), (name, rel)
    else:
        np.testing.assert_array_equal(out, x)
        assert out.dtype == x.dtype
        np.testing.assert_array_equal(jout, want)


def test_registry_knows_lossless_from_lossy():
    for C in (JC, TC):
        names = set(C.available())
        assert {"zlib", "bz2", "none"} <= set(C.available(lossy=False))
        assert {"spectral", "int8-ef"} <= set(C.available(lossy=True))
        assert (set(C.available(lossy=False))
                | set(C.available(lossy=True))) == names
    assert TC.available(lossy=True) == JC.available(lossy=True)


def test_registry_unknown_codec_message():
    for C in (JC, TC):
        with pytest.raises(KeyError, match="available"):
            C.get("nope")


def test_registry_rejects_duplicate_names():
    class Dummy:
        name = "zlib"
        lossy = False
        def encode(self, arr): return b""
        def decode(self, blob): return np.zeros(1)

    for C in (JC, TC):
        with pytest.raises(ValueError):
            C.register(Dummy())


# -- sink retry / degrade and the time budget (the runtime's halves of
#    tests/test_fault.py; the fault preset itself waits for ROADMAP queue 1
#    'Distribution and faults') -------------------------------------------

def _runtime_with_task(R, **kw):
    rt = R.PipelineRuntime(workers=2, staging_capacity=4)
    calls = []

    def sink(step, payload):
        calls.append(step)
        return step

    rt.register(R.PipelineTask(name="t", source="s", sink=sink,
                               placement=R.Placement.SYNC, pipelined=False,
                               retry_backoff_s=0.0, **kw))
    return rt, calls


def _always(R, msg):
    def fault(step):
        raise R.TransientError(msg)
    return fault


def test_transient_sink_failure_retries_then_succeeds():
    for R in PKGS:
        rt, calls = _runtime_with_task(R, retries=3)
        fails = [2]

        def fault(step):
            if fails[0] > 0:
                fails[0] -= 1
                raise R.TransientError("flaky IO")

        rt.inject_sink_fault("t", fault)
        rt.submit(0, {"s": lambda: 1})
        rt.drain()
        assert calls == [0]                      # the sink ultimately ran
        assert rt.retry_counts["t"] == 2
        assert rt.degraded == {} and rt.errors == []


def test_exhausted_retries_degrade_and_drop_instead_of_raising():
    reps = []
    for R in PKGS:
        rt, calls = _runtime_with_task(R, retries=2)
        rt.inject_sink_fault("t", _always(R, "dead disk"))
        for step in range(4):
            rt.submit(step, {"s": lambda: step})
        rt.drain()
        assert calls == [] and rt.errors == []   # degraded, never raised
        deg = rt.degraded["t"]
        assert deg["step"] == 0 and deg["dropped"] == 3
        assert rt.retry_counts["t"] == 2
        rep = rt.report()
        reps.append((rep["degraded"], rep["retries"]))
    assert reps[0] == reps[1]


def test_clearing_fault_hook_does_not_resurrect_degraded_task():
    for R in PKGS:
        rt, calls = _runtime_with_task(R, retries=0)
        rt.inject_sink_fault("t", _always(R, "boom"))
        rt.submit(0, {"s": lambda: 0})
        rt.inject_sink_fault("t", None)          # IO recovers...
        rt.submit(1, {"s": lambda: 1})           # ...the task stays degraded
        rt.drain()
        assert calls == []
        assert rt.degraded["t"]["dropped"] == 1


def test_permanent_sink_failure_is_an_error_not_a_degradation():
    """Only TransientError degrades; a permanent failure on a worker is
    captured as an error with its task and step."""
    for R in PKGS:
        rt = R.PipelineRuntime(workers=2, staging_capacity=4)
        rt.register(R.PipelineTask(name="t", source="s",
                                   sink=lambda step, p: p, retries=5,
                                   placement=R.Placement.ASYNC))
        rt.inject_sink_fault("t", lambda step: 1 / 0)
        rt.submit(3, {"s": lambda: np.ones(4, np.float32)})
        rt.drain()
        assert rt.degraded == {} and rt.results == []
        assert [(n, s, type(e)) for n, s, e in rt.errors] == [
            ("t", 3, ZeroDivisionError)]


def test_retry_backoff_is_capped_exponential():
    for R in PKGS:
        rt = R.PipelineRuntime(workers=1, staging_capacity=2)
        sleeps = []
        rt._sleep = sleeps.append
        rt.register(R.PipelineTask(
            name="t", source="s", placement=R.Placement.SYNC,
            pipelined=False, retries=6, retry_backoff_s=0.5,
            sink=lambda step, p: _always(R, "x")(step)))
        rt.submit(0, {"s": lambda: 0})
        rt.drain()
        assert sleeps == [0.5, 1.0, 2.0, 2.0, 2.0, 2.0]   # capped at 2 s
        assert rt.degraded["t"]["retries"] == 6


def test_budget_widens_after_consecutive_over_budget_firings():
    for R in PKGS:
        rt = R.PipelineRuntime(workers=1, staging_capacity=2)
        rt.register(R.PipelineTask(
            name="slow", source="s", placement=R.Placement.SYNC,
            pipelined=False, budget_s=0.005, adapt_after=2,
            adapt_max_every=8, sink=lambda step, p: time.sleep(0.02)))
        for i in range(3):
            rt.submit(i, {"s": lambda: 1})
        # two consecutive over-budget sync firings -> period doubles
        assert rt.effective_every("slow") == 2
        assert rt.telemetry.counters()["budget/adapt/slow"] >= 1
        rt.drain()


def test_budget_under_budget_firings_and_widen_cap():
    for R in PKGS:
        rt = R.PipelineRuntime(workers=1, staging_capacity=2)
        rt.register(R.PipelineTask(
            name="t", source="s", placement=R.Placement.SYNC,
            pipelined=False, budget_s=10.0, adapt_after=2,
            adapt_max_every=4, sink=lambda step, p: p))
        for i in range(8):
            rt.submit(i, {"s": lambda: 1})
        assert rt.effective_every("t") == 1      # never over budget
        assert rt.widen_every("t") is True       # 1 -> 2
        assert rt.widen_every("t") is True       # 2 -> 4
        assert rt.widen_every("t") is False      # capped
        assert rt.effective_every("t") == 4
        rt.drain()
