"""The port's Session against the JAX package's (CPU).

* The training presets: the ``grad_health`` and ``spectra`` artifacts are
  computed by the same host-only numpy code, so they must be equal; the
  ``checkpoint`` preset folds a CheckpointManager into the plan, restores,
  and takes the steering ``lossy_eps`` knob.
* The cases of ``tests/test_session.py``, each run through both packages
  on the same plans: plan validation (errors name the task), the dict
  round trip, the ``Every`` / ``When`` / ``Interval`` / ``Adaptive``
  triggers (``Interval`` on an injected clock), lazy providers, error
  context, steering validation, the checkpoint task, and the legacy shims
  (``InSituEngine`` / ``run_workflow``) against a ``Session`` on the
  fig02 (sync-vs-async placement) and fig05 (frequency / backpressure /
  adapt) semantics. The ``fault`` preset and elastic restore are held
  against the JAX package in ``tests/test_torch_fault.py``.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro_torch.core as TC
from repro.core import session as JS
from repro_torch.core import session as TS

PKGS = (JC, TC)


def _plan(mod, preset, **opts):
    return mod.InSituPlan.from_dict({
        "streams": ["grads"],
        "tasks": {"t": {"stream": "grads", "preset": preset, "every": 2,
                        "placement": "sync", **opts}}})


def _run(mod, plan, payloads):
    with mod.Session(plan) as s:
        for step, p in enumerate(payloads):
            s.emit("grads", step, p)
    return [r.result for r in s.results]


def _payloads():
    rng = np.random.default_rng(0)
    return [{"w": rng.standard_normal((40, 30)).astype(np.float32),
             "b": rng.standard_normal(30).astype(np.float32)}
            for _ in range(5)]


def _same(a, b):
    assert (a.step, a.name) == (b.step, b.name)
    assert a.stats == b.stats
    assert set(a.tables) == set(b.tables)
    for k in a.tables:
        np.testing.assert_array_equal(a.tables[k], b.tables[k])


@pytest.mark.parametrize("preset,opts", [("grad_health", {}),
                                         ("spectra", {"options": {"work": 2}})])
def test_analytics_presets_match_jax(preset, opts):
    pay = _payloads()
    got = _run(TS, _plan(TS, preset, **opts),
               [{k: torch.from_numpy(v) for k, v in p.items()} for p in pay])
    want = _run(JS, _plan(JS, preset, **opts), pay)
    assert len(got) == len(want) == 3          # steps 0, 2, 4
    for g, w in zip(got, want):
        for a, b in (zip(g, w) if isinstance(g, list) else [(g, w)]):
            _same(a, b)


def test_checkpoint_preset_saves_restores_and_takes_lossy_eps(tmp_path):
    plan = TS.InSituPlan.from_dict({
        "streams": ["train_state"],
        "tasks": {"ckpt": {"stream": "train_state", "preset": "checkpoint",
                           "every": 2, "placement": "hybrid",
                           "options": {"directory": str(tmp_path),
                                       "device": "cpu", "keep": 2}}}})
    state = {"params": {"w": torch.randn(64, 40)},
             "mu": {"w": torch.randn(64, 40).to(torch.bfloat16)},
             "nu": {"w": torch.rand(64, 40).to(torch.bfloat16)}}
    with TS.Session(plan) as s:
        assert s.latest_checkpoint_step() is None
        s.set_checkpoint_meta({"arch": "test"})
        rec = s._apply_steering("ckpt", {"task": "ckpt", "lossy_eps": 0.05,
                                         "color": "red"})
        assert rec["applied"] == {"lossy_eps": 0.05}
        assert rec["ignored"] == {"color": "red"}
        assert s.checkpoint.cfg.lossy_eps == 0.05
        assert s._apply_steering("ckpt", {"lossy_eps": float("nan")}
                                 )["rejected"]
        assert s._apply_steering("ckpt", {"every": 3})["applied"] == {
            "every": 3}
        for step in range(7):
            s.emit("train_state", step, state)
        s.wait_idle()
        assert s.checkpoint.list_steps() == [3, 6]
        step, back = s.restore(state)
        assert step == 6 and s.checkpoint.read_meta() == {"arch": "test"}
        assert torch.equal(back["params"]["w"], state["params"]["w"])
        with pytest.raises(TS.PlanError, match="elastic"):
            s.restore(state, elastic=True)
    rep = s.report()
    assert rep["checkpoint"]["saves"] == 3
    assert rep["tasks"]["ckpt"]["results"] == 3
    assert rep["steering"]["steering_rejected"] == 1
    assert s.stream_of("checkpoint") == "train_state"
    assert "checkpoint" in TS.preset_names()


def test_checkpoint_report_last_step_is_the_newest_save(tmp_path):
    """Saves run on several workers, so their reports arrive in completion
    order; the report names the newest step whatever that order."""
    plan = TS.InSituPlan.from_dict({
        "streams": ["train_state"],
        "tasks": {"ckpt": {"stream": "train_state", "preset": "checkpoint",
                           "every": 4,
                           "options": {"directory": str(tmp_path),
                                       "device": "cpu", "keep": 2}}}})
    state = {"w": torch.arange(512, dtype=torch.float32)}
    with TS.Session(plan, raise_on_error=True) as s:
        for step in range(10):
            s.emit("train_state", step, state)
    s.checkpoint.reports.sort(key=lambda r: -r.step)    # 8 finished first
    rep = s.report()
    assert rep["checkpoint"]["saves"] == 3
    assert rep["checkpoint"]["last_step"] == 8
    assert rep["checkpoint"]["kept_steps"] == [4, 8]


@pytest.mark.parametrize("bad,match", [
    ({"options": {}}, "directory"),
    ({"options": {"directory": "x"}, "backpressure": "drop"}, "backpressure"),
    ({"options": {"directory": "x"},
      "trigger": {"kind": "adaptive", "n": 2}}, "Adaptive"),
    ({"options": {"directory": "x"}, "shards": 2}, "shards"),
])
def test_checkpoint_preset_validation(bad, match):
    task = {"stream": "s", "preset": "checkpoint", **bad}
    with pytest.raises(TS.PlanError, match=match):
        TS.InSituPlan.from_dict({"streams": ["s"], "tasks": {"c": task}})


# ---------------------------------------------------------------------------
# the cases of tests/test_session.py, through both packages
# ---------------------------------------------------------------------------

def _plan_dict(**task_over):
    task = {"stream": "a", "preset": "grad_health", "every": 1}
    task.update(task_over)
    return {"streams": ["a"], "tasks": {"t": task}}


def _raises_in_both(match, build):
    msgs = []
    for P in PKGS:
        with pytest.raises(P.PlanError, match=match) as ei:
            build(P)
        msgs.append(str(ei.value))
    return msgs


def test_plan_unknown_stream_names_the_task():
    a, b = _raises_in_both(r"task 't'.*unknown stream 'b'", lambda P:
                           P.InSituPlan.from_dict(_plan_dict(stream="b")))
    assert a == b


def test_plan_duplicate_task_name():
    _raises_in_both(r"duplicate task 't'", lambda P: P.InSituPlan(
        streams=["a"], tasks=[P.TaskSpec(name="t", stream="a", sink=print),
                              P.TaskSpec(name="t", stream="a", sink=print)]))


def test_plan_duplicate_stream():
    _raises_in_both(r"duplicate stream 'a'",
                    lambda P: P.InSituPlan(streams=["a", "a"]))


def test_plan_every_zero():
    a, b = _raises_in_both(r"task 't'.*>= 1.*every=0", lambda P:
                           P.InSituPlan.from_dict(_plan_dict(every=0)))
    assert a == b


def test_plan_conflicting_triggers():
    _raises_in_both(r"task 't'.*conflicting triggers", lambda P:
                    P.InSituPlan.from_dict(_plan_dict(
                        every=2, trigger={"kind": "interval",
                                          "seconds": 1.0})))


def test_plan_adaptive_conflicts_with_non_adapt_backpressure():
    _raises_in_both(r"task 't'.*conflicting", lambda P: P.InSituPlan(
        streams=["a"], tasks=[P.TaskSpec(name="t", stream="a", sink=print,
                                         trigger=P.Adaptive(2),
                                         backpressure="drop")]))


def test_plan_unknown_preset_lists_registered():
    _raises_in_both(r"unknown preset 'nope'", lambda P:
                    P.InSituPlan.from_dict(_plan_dict(preset="nope")))
    for P in PKGS:
        assert {"checkpoint", "grad_health", "spectra",
                "serve_snapshot"} <= set(P.preset_names())


def test_plan_checkpoint_requires_directory():
    _raises_in_both(r"task 't'.*directory", lambda P:
                    P.InSituPlan.from_dict(_plan_dict(preset="checkpoint")))


def test_plan_checkpoint_rejects_unwired_knobs(tmp_path):
    """The checkpoint preset must not silently ignore declared scheduling
    knobs the manager doesn't wire through."""
    opts = {"directory": str(tmp_path)}
    for match, over in ((r"task 't'.*backpressure", {"backpressure": "drop"}),
                        (r"task 't'.*Adaptive", {"trigger": "adaptive"}),
                        (r"task 't'.*shards", {"shards": 2})):
        def build(P, over=over):
            kw = dict(over)
            if kw.get("trigger") == "adaptive":
                kw["trigger"] = P.Adaptive(2)
            return P.InSituPlan(streams=["a"], tasks=[
                P.TaskSpec(name="t", stream="a", preset="checkpoint",
                           options=opts, **kw)])
        _raises_in_both(match, build)


def test_plan_at_most_one_checkpoint_task(tmp_path):
    opts = {"directory": str(tmp_path)}
    _raises_in_both("at most one", lambda P: P.InSituPlan(
        streams=["a"], tasks=[
            P.TaskSpec(name="c1", stream="a", preset="checkpoint",
                       options=opts),
            P.TaskSpec(name="c2", stream="a", preset="checkpoint",
                       options=opts)]))


def test_plan_preset_and_sink_conflict():
    _raises_in_both(r"task 't'.*not both", lambda P: P.InSituPlan(
        streams=["a"], tasks=[P.TaskSpec(name="t", stream="a",
                                         preset="grad_health", sink=print)]))
    _raises_in_both(r"task 't'.*preset or a sink", lambda P: P.InSituPlan(
        streams=["a"], tasks=[P.TaskSpec(name="t", stream="a")]))


def test_plan_unknown_fields_rejected():
    _raises_in_both("unknown plan field", lambda P:
                    P.InSituPlan.from_dict({"streams": [], "typo": 1}))
    _raises_in_both(r"task 't'.*unknown field", lambda P:
                    P.InSituPlan.from_dict(_plan_dict(typo=1)))
    _raises_in_both(r"task 't'.*unknown placement", lambda P:
                    P.InSituPlan.from_dict(_plan_dict(placement="warp")))


# -- dict round-trip ----------------------------------------------------------

def test_plan_dict_round_trip(tmp_path):
    d = {
        "streams": ["grads", "train_state"],
        "workers": 3,
        "staging_capacity": 2,
        "tasks": {
            "gh": {"stream": "grads", "preset": "grad_health", "every": 10,
                   "placement": "sync"},
            "spec": {"stream": "grads", "preset": "spectra",
                     "trigger": {"kind": "adaptive", "n": 4,
                                 "max_every": 32, "after": 3},
                     "options": {"work": 2}},
            "ckpt": {"stream": "train_state", "preset": "checkpoint",
                     "every": 50, "placement": "hybrid",
                     "options": {"directory": str(tmp_path)}},
        },
    }
    dicts = []
    for P in PKGS:
        d2 = P.InSituPlan.from_dict(d).to_dict()
        # a second round-trip is a fixed point
        assert P.InSituPlan.from_dict(d2).to_dict() == d2
        plan2 = P.InSituPlan.from_dict(d2)
        assert [t.name for t in plan2.tasks] == ["gh", "spec", "ckpt"]
        assert plan2.tasks[0].trigger == P.Every(10)
        assert plan2.tasks[0].placement is P.Placement.SYNC
        assert plan2.tasks[1].trigger == P.Adaptive(4, max_every=32, after=3)
        assert plan2.workers == 3 and plan2.staging_capacity == 2
        dicts.append(d2)
    assert dicts[0] == dicts[1]          # one dict format for both packages


def test_plan_list_form_tasks():
    for P in PKGS:
        plan = P.InSituPlan.from_dict({
            "streams": ["a"],
            "tasks": [{"name": "t", "stream": "a", "preset": "grad_health"}]})
        assert plan.tasks[0].name == "t"


def test_callable_tasks_do_not_serialize():
    for P in PKGS:
        plan = P.InSituPlan(streams=["a"],
                            tasks=[P.TaskSpec(name="t", stream="a",
                                              sink=print)])
        with pytest.raises(P.PlanError, match="code"):
            plan.to_dict()
        with pytest.raises(P.PlanError, match="code"):
            P.TaskSpec(name="t", stream="a", sink=print,
                       trigger=P.When(lambda s: True)).to_dict()


# -- session basics -----------------------------------------------------------

def _collect_plan(P, trigger=None, **kw):
    hits = []

    def sink(step, payload):
        hits.append((step, payload))
        return step

    plan = P.InSituPlan(
        streams=["x"],
        tasks=[P.TaskSpec(name="t", stream="x",
                          trigger=trigger or P.Every(1),
                          placement=kw.pop("placement", P.Placement.SYNC),
                          sink=sink, **kw)],
        workers=2)
    return plan, hits


def test_emit_unknown_stream_raises():
    for P in PKGS:
        plan, _ = _collect_plan(P)
        with P.Session(plan) as s:
            with pytest.raises(P.PlanError, match=r"unknown stream 'y'"):
                s.emit("y", 0, 1)


def _fired_steps(trigger_of, n, payload=lambda i: i, clock=None, tick=0.0):
    """The steps a task fires at in each package, with the clock (a list
    cell) advanced by ``tick`` after every emit."""
    out = []
    for P in PKGS:
        plan, hits = _collect_plan(P, trigger=trigger_of(P))
        now = [0.0]
        kw = {"clock": (lambda: now[0]) if clock is None else clock}
        with P.Session(plan, **kw) as s:
            for i in range(n):
                s.emit("x", i, payload(i))
                now[0] += tick
        out.append([h[0] for h in hits])
    assert out[0] == out[1]
    return out[0]


def test_every_trigger_and_lazy_provider():
    calls = {}
    for P in PKGS:
        plan, hits = _collect_plan(P, trigger=P.Every(3))
        calls[P] = []
        with P.Session(plan) as s:
            for i in range(9):
                s.emit("x", i, lambda i=i, c=calls[P]: c.append(i) or i)
        assert [h[0] for h in hits] == [0, 3, 6]
    # provider only evaluated on firings
    assert calls[JC] == calls[TC] == [0, 3, 6]


def test_when_trigger():
    assert _fired_steps(lambda P: P.When(lambda s: s in (2, 5)), 7) == [2, 5]


def test_interval_trigger_fires_by_injected_clock():
    """Interval reads the session's monotonic clock — driven by hand, so
    the expected firings are exact: emit i happens at t = 4*i; the first
    emit always fires (t=0), then once >= 10 s elapse: t=12, t=24."""
    assert _fired_steps(lambda P: P.Interval(10.0), 8, tick=4.0) == [0, 3, 6]


def test_interval_trigger_fires_every_emit_when_clock_outpaces():
    assert _fired_steps(lambda P: P.Interval(1.0), 4,
                        tick=1.0) == [0, 1, 2, 3]


def test_interval_trigger_never_refires_on_a_frozen_clock():
    assert _fired_steps(lambda P: P.Interval(5.0), 5,
                        clock=lambda: 100.0) == [0]


def test_provider_evaluated_once_for_multiple_tasks_on_one_stream():
    for P in PKGS:
        hits = []

        def sink(step, payload):
            hits.append(payload)
            return payload

        plan = P.InSituPlan(
            streams=["x"],
            tasks=[P.TaskSpec(name="a", stream="x", sink=sink,
                              placement=P.Placement.SYNC),
                   P.TaskSpec(name="b", stream="x", sink=sink,
                              placement=P.Placement.SYNC)])
        calls = []
        with P.Session(plan) as s:
            s.emit("x", 0, lambda: calls.append(0) or 7)
        assert hits == [7, 7]          # both tasks fired ...
        assert calls == [0]            # ... off ONE payload materialization


def test_session_streams_property_and_passthrough_payload():
    for P in PKGS:
        plan, hits = _collect_plan(P)
        with P.Session(plan) as s:
            assert s.streams == frozenset({"x"})
            s.emit("x", 0, {"a": 1})
        assert hits == [(0, {"a": 1})]


# -- error propagation --------------------------------------------------------

def _boom_plan(P, placement=None):
    return P.InSituPlan(
        streams=["x"],
        tasks=[P.TaskSpec(name="boom", stream="x", sink=lambda s, p: 1 / 0,
                          placement=placement or P.Placement.ASYNC)])


def test_finish_raises_with_context():
    msgs = []
    for P in PKGS:
        s = P.Session(_boom_plan(P))
        s.emit("x", 4, 1)
        with pytest.raises(P.InSituTaskError) as ei:
            s.finish(raise_on_error=True)
        e = ei.value
        assert (e.task, e.stream, e.step) == ("boom", "x", 4)
        assert "step 4" in str(e) and "ZeroDivisionError" in str(e)
        assert isinstance(e.__cause__, ZeroDivisionError)
        assert len(s.errors()) == 1     # errors stay inspectable too
        assert s.report()["errors"][0]["stream"] == "x"
        msgs.append(str(e))
    assert msgs[0] == msgs[1]


def test_session_default_raise_on_error_via_context_manager():
    for P in PKGS:
        with pytest.raises(P.InSituTaskError):
            with P.Session(_boom_plan(P), raise_on_error=True) as s:
                s.emit("x", 0, 1)


def test_app_exception_not_masked_by_task_error():
    for P in PKGS:
        with pytest.raises(KeyError, match="app-bug"):
            with P.Session(_boom_plan(P), raise_on_error=True) as s:
                s.emit("x", 0, 1)
                raise KeyError("app-bug")


def test_finish_idempotent():
    for P in PKGS:
        plan, hits = _collect_plan(P)
        s = P.Session(plan)
        s.emit("x", 0, 1)
        s.finish()
        s.finish()
        assert len(hits) == 1
        assert len(s.telemetry.spans("insitu/drain")) == 1


# -- checkpoint folded into the session ---------------------------------------

def test_checkpoint_task_saves_restores_and_reports(tmp_path):
    """Both packages save steps 0, 4, 8, keep 2 and restore step 8 with the
    weights bitwise. ``last_step`` is compared for the port only: the JAX
    package's names the last report appended, which concurrent saves may
    append out of order (ROADMAP, standing faults of the reference)."""
    w = np.arange(512, dtype=np.float32)
    mu = np.ones((32, 16), np.float32)
    states = {JC: {"w": jnp.asarray(w), "mu": jnp.asarray(mu)},
              TC: {"w": torch.from_numpy(w), "mu": torch.from_numpy(mu)}}
    for P in PKGS:
        opts = {"directory": str(tmp_path / P.__name__), "keep": 2}
        if P is TC:
            opts["device"] = "cpu"
        plan = P.InSituPlan.from_dict({
            "streams": ["train_state"],
            "tasks": {"checkpoint": {
                "stream": "train_state", "preset": "checkpoint", "every": 4,
                "options": opts}}})
        state = states[P]
        with P.Session(plan, raise_on_error=True) as s:
            for i in range(10):
                s.emit("train_state", i, lambda: state)
        rep = s.report()
        assert rep["checkpoint"]["saves"] == 3            # steps 0, 4, 8
        assert rep["checkpoint"]["kept_steps"] == [4, 8]  # retention keep=2
        assert rep["tasks"]["checkpoint"]["results"] == 3
        if P is TC:
            assert rep["checkpoint"]["last_step"] == 8
        step, restored = s.restore(state)
        assert step == 8
        np.testing.assert_array_equal(np.asarray(restored["w"]), w)


def test_restore_without_checkpoint_task_raises():
    for P, tmpl in ((JC, {"w": jnp.zeros(4)}), (TC, {"w": torch.zeros(4)})):
        plan, _ = _collect_plan(P)
        with P.Session(plan) as s:
            pass
        with pytest.raises(P.PlanError, match="no checkpoint task"):
            s.restore(tmpl)


# -- legacy-shim parity (fig02 / fig05 semantics) -----------------------------

def _device_step(step_s):
    def app_step(i):
        time.sleep(step_s)
        return {"x": lambda: np.zeros(64, np.float32)}
    return app_step


def _work(task_s):
    def work(step, payload):
        if task_s:
            time.sleep(task_s)
        return ("done", step)
    return work


def _session_run(P, placement, *, n, step_s, every=1, task_s=0.0, p_i=2,
                 cap=4, trigger=None):
    plan = P.InSituPlan(
        streams=["x"],
        tasks=[P.TaskSpec(name="t", stream="x", sink=_work(task_s),
                          trigger=trigger or P.Every(every),
                          placement=P.Placement(placement))],
        workers=p_i, staging_capacity=cap)
    session = P.Session(plan)
    session.run(n, _device_step(step_s))
    return session


def _engine_run(P, mode, *, n, step_s, every=1, task_s=0.0, p_i=2, cap=4):
    eng = P.InSituEngine(
        [P.InSituTask("t", "x", _work(task_s), mode=P.InSituMode(mode),
                      every=every)],
        p_i=p_i, staging_capacity=cap)
    P.run_workflow(n, _device_step(step_s), eng)
    return eng


def test_parity_sync_placement_fig02():
    """fig02's sync semantics: the task runs on the loop thread, loop time
    includes it — identical through the shim and the Session."""
    main = threading.main_thread().name
    for P in PKGS:
        sess = _session_run(P, "sync", n=6, step_s=0.005)
        eng = _engine_run(P, "sync", n=6, step_s=0.005)
        assert len(sess.results) == len(eng.results) == 6
        for obj in (sess, eng):
            assert all(r.worker == main for r in obj.results)
            assert obj.telemetry.total("insitu-sync/") > 0
            assert obj.telemetry.total("insitu-async/") == 0


def test_parity_async_placement_fig02():
    """fig02's async semantics: workers consume, loop only pays hand-off."""
    for P in PKGS:
        sess = _session_run(P, "async", n=6, step_s=0.02, task_s=0.02)
        eng = _engine_run(P, "async", n=6, step_s=0.02, task_s=0.02)
        assert len(sess.results) == len(eng.results) == 6
        for obj in (sess, eng):
            assert all(r.worker.startswith("insitu-") for r in obj.results)
        assert sess.telemetry.total("insitu-sync/") == 0


def test_parity_every_n_fig05():
    for P in PKGS:
        sess = _session_run(P, "async", n=9, step_s=0.0, every=3)
        eng = _engine_run(P, "async", n=9, step_s=0.0, every=3)
        assert sorted(r.step for r in sess.results) == [0, 3, 6]
        assert sorted(r.step for r in eng.results) == [0, 3, 6]


def test_parity_backpressure_fig05():
    """fig05's F3 regime: ring of 1, slow consumer — the producer visibly
    backpressures through both entry points."""
    for P in PKGS:
        sess = _session_run(P, "async", n=8, step_s=0.001, task_s=0.05,
                            p_i=1, cap=1)
        eng = _engine_run(P, "async", n=8, step_s=0.001, task_s=0.05,
                          p_i=1, cap=1)
        assert sess.telemetry.total("staging/wait") > 0
        assert eng.telemetry.total("staging/wait") > 0
        assert len(sess.results) == len(eng.results) == 8


def test_adaptive_trigger_widens_effective_every_fig05():
    """fig05's adapt row: under sustained pressure the runtime lengthens
    the effective firing period instead of stalling forever."""
    for P in PKGS:
        sess = _session_run(P, "async", n=24, step_s=0.001, task_s=0.03,
                            p_i=1, cap=1, trigger=P.Adaptive(1, after=2))
        assert sess.report()["effective_every"]["t"] > 1


def test_engine_report_matches_session_report_keys():
    """The shim's report IS a session report (one merged dict)."""
    reps = []
    for P in PKGS:
        rep = _engine_run(P, "async", n=4, step_s=0.002).report()
        for key in ("step_compute_s", "handoff_s", "n_results", "tasks",
                    "errors", "effective_every"):
            assert key in rep
        assert rep["n_results"] == 4
        assert rep["tasks"]["t"]["stream"] == "x"
        reps.append(rep)
    assert set(reps[0]) == set(reps[1])


# -- steering validation: invalid commands are rejected and counted, never
#    half-applied (consumers can push anything up the back-channel) ---------

def _steering_session(P):
    plan = P.InSituPlan.from_dict({
        "streams": ["grads"],
        "tasks": {"gh": {"stream": "grads", "preset": "grad_health",
                         "every": 2, "placement": "sync"}},
    })
    return P.Session(plan, raise_on_error=True)


def _grads(P):
    z = np.zeros(8, np.float32)
    return {"params": torch.from_numpy(z) if P is TC else z}


def test_steering_rejects_bad_every_and_unknown_task():
    for P in PKGS:
        with _steering_session(P) as s:
            before = s.runtime.effective_every("gh")
            for msg in ({"task": "gh", "every": 0},
                        {"task": "gh", "every": -3},
                        {"task": "gh", "every": "soon"},
                        {"task": "nosuch", "every": 2}):
                rec = s._apply_steering("test", msg)
                s._steering.append(rec)
                assert "every" in rec["rejected"], msg
                assert rec["applied"] == {}
            assert s.runtime.effective_every("gh") == before   # untouched
            s.emit("grads", 0, _grads(P))
        st = s.report()["steering"]
        assert st["steering_rejected"] == 4
        assert len(st["commands"]) == 4


def test_steering_rejects_nonfinite_lossy_eps():
    """``nan <= 0`` is False — the guard must be isfinite, not a plain
    comparison, or NaN walks straight into the lossy codec."""
    for P in PKGS:
        with _steering_session(P) as s:
            for bad in (float("nan"), float("inf"), -1.0, 0.0, "tight"):
                rec = s._apply_steering("test", {"task": "gh",
                                                 "lossy_eps": bad})
                s._steering.append(rec)
                assert "lossy_eps" in rec["rejected"], bad
            # valid value but no checkpoint task bound: ignored, not rejected
            rec = s._apply_steering("test", {"task": "gh", "lossy_eps": 0.5})
            s._steering.append(rec)
            assert rec["ignored"] == {"lossy_eps": 0.5}
            assert rec["rejected"] == {}
            s.emit("grads", 0, _grads(P))
        assert s.report()["steering"]["steering_rejected"] == 5


def test_steering_valid_command_still_applies():
    for P in PKGS:
        with _steering_session(P) as s:
            rec = s._apply_steering("test", {"task": "gh", "every": 4})
            s._steering.append(rec)
            assert rec["applied"] == {"every": 4} and rec["rejected"] == {}
            assert s.runtime.effective_every("gh") == 4
            s.emit("grads", 0, _grads(P))
        st = s.report()["steering"]
        assert st["steering_rejected"] == 0
        assert st["commands"][0]["applied"] == {"every": 4}


# -- the legacy adapter --------------------------------------------------------

def test_over_runtime_relaxes_streams_and_owns_the_runtime():
    """``Session.over_runtime`` mirrors the runtime's task sources as
    streams, accepts emits on any other source as a no-op (the relaxed
    ``emit``), and drains the runtime it took over."""
    for P in PKGS:
        rt = P.PipelineRuntime([P.PipelineTask(
            "t", "x", sink=lambda s, p: p * 2, placement=P.Placement.SYNC)],
            workers=1)
        s = P.Session.over_runtime(rt)
        assert s._owns_runtime and not s._strict_streams
        s.emit("x", 0, 3)
        s.emit("elsewhere", 0, lambda: 1 / 0)     # no task: never evaluated
        s.finish()
        assert [r.result for r in rt.results] == [6] and not rt.errors
        assert s.report()["tasks"] == {}          # its plan declares none
        assert s.stream_of("t") == "x"
        strict = P.Session(P.InSituPlan(streams=["x"]))
        with pytest.raises(P.PlanError, match="unknown stream"):
            strict.emit("elsewhere", 0, 1)
        strict.finish()
