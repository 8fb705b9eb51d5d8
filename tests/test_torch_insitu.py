"""The port's legacy InSituEngine path against the JAX package's, case for
case with ``tests/test_insitu.py`` (CPU): the paper's Fig. 1 contract,
measured through both packages' ``InSituEngine`` / ``run_workflow`` on the
same task lists, with the reference test's own margins.

  SYNC   — task runs on the loop thread; loop time includes it.
  ASYNC  — loop only pays the hand-off; task runs on insitu-* threads
           concurrently with subsequent steps.
  Backpressure — a slow consumer stalls the producer once the ring fills
           (the F3 regime).

Also: the staging ring and the allocator of both packages, and
``run_pipeline`` over a hand-wired runtime against ``Session.run`` of the
equivalent plan (the shim IS a session run).
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import allocator as JA
from repro.core import staging as JS
from repro_torch.core import allocator as TA
from repro_torch.core import staging as TS

PKGS = (J, T)


def _engine(P, mode, task_s=0.02, every=1, p_i=2, cap=4):
    def work(step, payload):
        time.sleep(task_s)
        return ("done", step)

    return P.InSituEngine(
        [P.InSituTask("t", "x", work, mode=P.InSituMode(mode), every=every)],
        p_i=p_i, staging_capacity=cap)


def _run(P, engine, n=6, step_s=0.01):
    def app_step(i):
        time.sleep(step_s)   # a device step: host-idle wait
        return {"x": lambda: np.zeros(8)}

    return P.run_workflow(n, app_step, engine)


def test_sync_runs_on_loop_thread():
    for P in PKGS:
        eng = _engine(P, "sync")
        _run(P, eng)
        assert len(eng.results) == 6
        assert all(r.worker == threading.main_thread().name
                   for r in eng.results)
        assert eng.telemetry.total("insitu-sync/") > 0
        assert eng.telemetry.total("insitu-async/") == 0
        assert [r.result for r in eng.results] == [("done", i)
                                                   for i in range(6)]


def test_async_runs_on_workers_and_overlaps():
    for P in PKGS:
        eng = _engine(P, "async", task_s=0.03)
        t0 = time.perf_counter()
        _run(P, eng, n=6, step_s=0.03)
        wall = time.perf_counter() - t0
        assert len(eng.results) == 6
        assert all(r.worker.startswith("insitu-") for r in eng.results)
        # serial would be >= 6*(0.03+0.03) = 0.36; overlap must beat it
        assert wall < 0.33, f"{P.__name__}: no overlap: wall={wall:.3f}s"
        assert eng.telemetry.total("insitu-sync/") == 0


def test_async_backpressure_recorded():
    for P in PKGS:
        eng = _engine(P, "async", task_s=0.05, p_i=1, cap=1)
        _run(P, eng, n=8, step_s=0.001)
        # ring of 1 with slow consumer -> producer must have waited
        assert eng.telemetry.total("staging/wait") > 0
        assert len(eng.results) == 8


def test_every_n_steps():
    for P in PKGS:
        eng = _engine(P, "async", task_s=0.0, every=3)
        _run(P, eng, n=9)
        assert sorted(r.step for r in eng.results) == [0, 3, 6]


def test_worker_errors_captured_not_fatal():
    def bad(step, payload):
        raise RuntimeError("boom")

    for P in PKGS:
        eng = P.InSituEngine([P.InSituTask("bad", "x", bad,
                                           P.InSituMode.ASYNC)], p_i=1)
        _run(P, eng, n=3)
        assert len(eng.errors) == 3
        assert len(eng.results) == 0
        assert [e[1] for e in eng.errors] == [0, 1, 2]
        assert eng.report()["n_errors"] == 3


def test_lazy_providers_only_called_when_fired():
    for P in PKGS:
        calls = []

        def app_step(i):
            return {"x": lambda: calls.append(i) or np.zeros(2)}

        eng = _engine(P, "async", task_s=0.0, every=5)
        P.run_workflow(10, app_step, eng)
        assert calls == [0, 5]


def test_undeclared_provider_is_ignored():
    """The legacy providers-dict contract: the loop offers every source
    and tasks pick; an unmatched source is a no-op, not an error."""
    for P in PKGS:
        calls = []

        def app_step(i):
            return {"x": lambda: np.zeros(2),
                    "other": lambda: calls.append(i)}

        eng = _engine(P, "sync", task_s=0.0)
        P.run_workflow(4, app_step, eng)
        assert calls == [] and len(eng.results) == 4 and not eng.errors


# -- staging ring -------------------------------------------------------------

def test_staging_fifo_and_close():
    for S in (JS, TS):
        buf = S.StagingBuffer(capacity=3)
        for i in range(3):
            buf.put(S.StagedItem(i, "a", i))
        assert [buf.get().payload for _ in range(3)] == [0, 1, 2]
        buf.close()
        with pytest.raises(S.Closed):
            buf.get(timeout=0.01)
        with pytest.raises(S.Closed):
            buf.put(S.StagedItem(9, "a", 9))


def test_staging_try_put_drop_policy():
    for S in (JS, TS):
        buf = S.StagingBuffer(capacity=1)
        assert buf.try_put(S.StagedItem(0, "a", 0))
        assert not buf.try_put(S.StagedItem(1, "a", 1))


def _timed_consumer(S, buf, out):
    try:
        item = buf.get()
        out.append(("item", item.payload, time.perf_counter()))
    except S.Closed:
        out.append(("closed", None, time.perf_counter()))


def test_staging_get_wakes_immediately_on_put():
    """Condition-driven ring: no 0.1 s poll loop between put and wake-up."""
    for S in (JS, TS):
        buf = S.StagingBuffer(capacity=2)
        out = []
        th = threading.Thread(target=_timed_consumer, args=(S, buf, out))
        th.start()
        time.sleep(0.05)                      # consumer is parked in get()
        t_put = time.perf_counter()
        buf.put(S.StagedItem(0, "a", 42))
        th.join(timeout=5)
        assert not th.is_alive()
        kind, payload, t_wake = out[0]
        assert (kind, payload) == ("item", 42)
        assert t_wake - t_put < 0.05, f"woke after {t_wake - t_put:.3f}s"


def test_staging_close_wakes_blocked_consumer_immediately():
    for S in (JS, TS):
        buf = S.StagingBuffer(capacity=2)
        out = []
        th = threading.Thread(target=_timed_consumer, args=(S, buf, out))
        th.start()
        time.sleep(0.05)
        t_close = time.perf_counter()
        buf.close()
        th.join(timeout=5)
        assert not th.is_alive()
        kind, _, t_wake = out[0]
        assert kind == "closed"
        assert t_wake - t_close < 0.05, f"woke after {t_wake - t_close:.3f}s"


def test_staging_blocked_producer_raises_on_close():
    for S in (JS, TS):
        buf = S.StagingBuffer(capacity=1)
        buf.put(S.StagedItem(0, "a", 0))        # ring now full
        errs = []

        def producer():
            try:
                buf.put(S.StagedItem(1, "a", 1))
            except S.Closed:
                errs.append("closed")

        th = threading.Thread(target=producer)
        th.start()
        time.sleep(0.05)
        buf.close()
        th.join(timeout=5)
        assert not th.is_alive()
        assert errs == ["closed"]


# -- allocator (Table I / F1 / F6) ---------------------------------------------

def test_amdahl_fit():
    fits = []
    for A in (JA, TA):
        m = A.AmdahlModel()
        for p in (1, 2, 4, 8):
            m.observe(p, 1.0 + 8.0 / p)
        assert m.serial == pytest.approx(1.0, abs=0.05)
        assert m.parallel == pytest.approx(8.0, rel=0.05)
        fits.append((m.serial, m.parallel))
    assert fits[0] == pytest.approx(fits[1])


def test_allocator_balances_app_and_task():
    """F1: optimal async split puts both sides at roughly equal duration."""
    plans = []
    for A in (JA, TA):
        al = A.Allocator(p_total=72)
        for p in (18, 36, 72):
            al.observe_app(p, 10.0 / p)        # app scales well
            al.observe_task(p, 0.05 + 2.0 / p)  # task scales worse
        plan = al.plan(n_steps=100, every=5)
        assert plan.mode == "async"
        assert al.balance_quality(plan) < 0.35
        assert plan.p_app + plan.p_insitu == 72
        plans.append((plan.mode, plan.p_app, plan.p_insitu))
    assert plans[0] == plans[1]


def test_allocator_prefers_sync_for_cheap_tasks():
    """F6: when the task is trivially cheap, sync wins (no staging tax)."""
    for A in (JA, TA):
        al = A.Allocator(p_total=8, handoff_s=0.5)
        al.observe_app(8, 1.0)
        al.observe_task(8, 1e-4)
        al.observe_task(1, 1e-3)
        plan = al.plan(n_steps=100, every=1)
        assert plan.mode == "sync"


# -- the shims are session runs -----------------------------------------------

def _hand_wired(P, mode, work):
    return P.PipelineRuntime(
        [P.PipelineTask("t", "x", sink=work, placement=P.Placement(mode),
                        every=2)],
        workers=2, staging_capacity=4)


@pytest.mark.parametrize("mode", ["sync", "async", "hybrid"])
def test_run_pipeline_matches_session_run_on_the_same_plan(mode):
    """``run_pipeline`` over a hand-wired runtime and ``Session.run`` of the
    equivalent plan give the same results, workers' kind and report keys,
    in both packages; a HYBRID device stage runs on the loop first."""
    def work(step, p):
        return float(np.asarray(p).sum())

    def device(step, p):
        return p * 2

    def app(P):
        arr = (lambda i: torch.full((4,), float(i))) if P is T else \
            (lambda i: np.full((4,), float(i), np.float32))
        return lambda i: {"x": lambda: arr(i)}

    seen = {}
    for P in PKGS:
        rt = _hand_wired(P, mode, work)
        if mode == "hybrid":
            rt = P.PipelineRuntime(
                [P.PipelineTask("t", "x", sink=work, device_stage=device,
                                placement=P.Placement.HYBRID, every=2)],
                workers=2, staging_capacity=4)
        tm = P.run_pipeline(6, app(P), rt)
        plan = P.InSituPlan(
            streams=["x"],
            tasks=[P.TaskSpec(name="t", stream="x", sink=work,
                              trigger=P.Every(2), placement=P.Placement(mode),
                              device_stage=device if mode == "hybrid"
                              else None)],
            workers=2, staging_capacity=4)
        sess = P.Session(plan)
        sess.run(6, app(P))
        got = []
        for res, tel, rep in ((rt.results, tm, None),
                              (sess.results, sess.telemetry, sess.report())):
            got.append(sorted((r.step, r.result) for r in res))
            sync = mode == "sync"
            assert all((r.worker == threading.main_thread().name) == sync
                       for r in res)
            assert len(tel.spans("step/compute")) == 6
            if rep is not None:
                assert rep["tasks"]["t"] == {"stream": "x", "results": 3,
                                             "errors": 0}
        assert got[0] == got[1], P.__name__
        seen[P] = got[0]
    scale = 2.0 if mode == "hybrid" else 1.0
    assert seen[J] == seen[T] == [(i, 4.0 * i * scale) for i in (0, 2, 4)]


def test_shim_session_joins_the_pool_once():
    """``over_runtime`` hands the runtime to the session: its finish drains
    the pool once (one ``insitu/drain`` span), and finishing the engine
    again — or a checkpoint manager sharing the runtime finishing — joins
    nothing more."""
    for P in PKGS:
        eng = _engine(P, "async", task_s=0.0)
        _run(P, eng, n=3)
        eng.finish()
        eng.finish()
        assert len(eng.telemetry.spans("insitu/drain")) == 1
        assert not any(th.is_alive() for th in eng.runtime._threads)

        rt = _hand_wired(P, "async", lambda s, p: None)
        sess = P.Session.over_runtime(rt)
        assert sess._owns_runtime and sess.runtime is rt
        assert sess.streams == frozenset({"x"})
        assert sess.stream_of("t") == "x"
        sess.run(2, lambda i: {"x": lambda: np.zeros(2), "y": lambda: 0})
        sess.finish()
        assert len(rt.telemetry.spans("insitu/drain")) == 1
        assert len(rt.results) == 1


def test_engine_report_carries_the_session_report_keys():
    reps = []
    for P in PKGS:
        eng = _engine(P, "async", task_s=0.0)
        _run(P, eng, n=4, step_s=0.002)
        reps.append(eng.report())
    for rep in reps:
        for key in ("step_compute_s", "handoff_s", "n_results", "tasks",
                    "errors", "effective_every"):
            assert key in rep
        assert rep["n_results"] == 4
        assert rep["tasks"]["t"]["stream"] == "x"
    assert set(reps[0]) == set(reps[1])
    assert reps[0]["tasks"] == reps[1]["tasks"]


def test_legacy_task_lowerings_match():
    """``InSituTask.to_spec`` / ``to_pipeline`` / ``fires`` / ``split`` give
    the same declarations in both packages."""
    for P in PKGS:
        t = P.InSituTask("t", "x", print, mode=P.InSituMode.HYBRID, every=3,
                         shards=2)
        assert [s for s in range(7) if t.fires(s)] == [0, 3, 6]
        spec = t.to_spec()
        assert (spec.stream, spec.trigger, spec.placement, spec.shards) == (
            "x", P.Every(3), P.Placement.HYBRID, 2)
        pt = t.to_pipeline()
        assert (pt.source, pt.every, pt.shards, pt.placement) == (
            "x", 3, 2, P.Placement.HYBRID)
        parts = t.split(np.arange(6))
        assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5]]
    assert T.InSituMode is T.Placement
