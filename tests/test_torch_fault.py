"""The port's fault tolerance against the JAX package's (CPU).

* The cases of ``tests/test_fault.py`` and ``tests/test_fault_data.py``:
  heartbeats on a fake clock, the straggler EWMA and its tiers,
  ``plan_elastic_remesh`` (examples, a grid of shapes x survivors, and the
  hypothesis properties), ``merge_model_shards``, the ``FaultController``
  and the ``fault`` preset through a ``Session``, the runtime's
  retry/degrade and time-budget cases (those not already in
  ``tests/test_torch_runtime.py``), the data pipeline. Each case runs on
  both packages' modules and what it observes must be equal.
* The ``fault`` preset's ingest reports streamed with ``to=`` decode in
  the other package.
* The two elastic-restore cases, on a world-size-1 gloo group a fixture
  creates and destroys.
* The kill-point scenario (``tools/torch_fault_killpoint.py``) at the
  smoke config: a host drop detected, restored and resumed; on one rank,
  and across ranks — the JAX scenario's (2, 2) -> (1, 2) meshes on four
  gloo processes, then two, with the sharded step — against the JAX
  package's run of the same scenario from the same initial state and
  batches (``tests/jax_shard_oracle.py --killpoint``, its state and
  batches placed under the step's shardings on ``Auto`` meshes, in a
  subprocess), under a step whose rate moves the parameters.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _hyp import given, settings, st
import repro.core.runtime as JR
import repro.core.session as JS
import repro.data.pipeline as JD
import repro.distributed.fault as JF
import repro.core.transport as JT
import repro_torch.core.runtime as TR
import repro_torch.core.session as TS
import repro_torch.core.transport as TT
import repro_torch.data.pipeline as TD
import repro_torch.distributed.fault as TF
from repro_torch.distributed import sharding as TSH

ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# host-only cases of tests/test_fault.py and tests/test_fault_data.py: each
# takes a package's fault module, asserts the reference's expectations and
# returns what it observed, which must be equal between the packages
# ---------------------------------------------------------------------------

def heartbeat_seeds_last_seen_from_injected_clock(F):
    clk = FakeClock(5.0)
    hb = F.HeartbeatTracker([0, 1], grace_s=2.0, clock=clk)
    assert hb.failed_hosts() == []
    assert hb.alive_hosts() == [0, 1]
    return hb.last_seen


def heartbeat_grace_transitions_on_fake_clock(F):
    clk = FakeClock(0.0)
    hb = F.HeartbeatTracker([0, 1, 2], grace_s=3.0, clock=clk)
    clk.t = 2.0
    hb.beat(1)
    hb.beat(2)
    clk.t = 4.0
    seen = [hb.failed_hosts(), hb.alive_hosts()]
    assert seen == [[0], [1, 2]]
    clk.t = 6.0
    seen.append(hb.failed_hosts())
    assert seen[-1] == [0, 1, 2]
    hb.beat(0)
    seen.append(hb.failed_hosts())
    assert seen[-1] == [1, 2]
    return seen


def heartbeat_explicit_now_still_wins(F):
    hb = F.HeartbeatTracker([0], grace_s=1.0, clock=FakeClock(0.0))
    hb.beat(0, now=10.0)
    assert hb.failed_hosts(now=10.5) == []
    assert hb.failed_hosts(now=12.0) == [0]
    return hb.last_seen


def heartbeat_failure_detection(F):             # test_fault_data.py
    hb = F.HeartbeatTracker([0, 1, 2], grace_s=10.0)
    now = 1000.0
    for h in (0, 1, 2):
        hb.beat(h, now=now)
    hb.beat(0, now=now + 20)
    hb.beat(1, now=now + 20)
    assert hb.failed_hosts(now=now + 20) == [2]
    assert hb.alive_hosts(now=now + 20) == [0, 1]
    return hb.last_seen


def straggler_ewma_converges(F):
    mon = F.StragglerMonitor(alpha=0.5)
    seen = []
    for v in (1.0, 2.0, 2.0):
        mon.observe(0, v)
        seen.append(mon.ewma[0])
    assert seen[0] == 1.0
    assert seen[1:] == [pytest.approx(1.5), pytest.approx(1.75)]
    return seen


def straggler_flags_and_mitigation_tiers(F):
    mon = F.StragglerMonitor(alpha=1.0, factor=1.5)
    for h in range(4):
        mon.observe(h, 1.0)
    assert mon.stragglers() == [] and mon.mitigation(0) == "none"
    mon.observe(3, 2.0)
    assert mon.stragglers() == [3]
    assert mon.mitigation(3) == "reduce_insitu_pi"
    mon.observe(3, 4.0)
    assert mon.mitigation(3) == "replace_at_checkpoint"
    assert mon.mitigation(0) == "none"
    return mon.report()


def straggler_detection_and_policy(F):          # test_fault_data.py
    mon = F.StragglerMonitor(alpha=1.0, factor=1.5)
    for h in range(8):
        mon.observe(h, 1.0)
    mon.observe(7, 1.8)
    assert mon.stragglers() == [7]
    assert mon.mitigation(7) == "reduce_insitu_pi"
    mon.observe(7, 10.0)
    assert mon.mitigation(7) == "replace_at_checkpoint"
    assert mon.mitigation(0) == "none"
    return mon.report()


def remesh_prefers_smallest_merge_factor_on_ties(F):
    plan = F.plan_elastic_remesh((2, 2), ("data", "model"), 2)
    assert plan.new_shape == (1, 2) and plan.model_merge_factor == 1
    return plan


def remesh_non_power_of_two_model_axis(F):
    plan = F.plan_elastic_remesh((4, 6), ("data", "model"), 9)
    assert plan.new_shape == (3, 3)
    assert plan.model_merge_factor == 2 and plan.new_device_count == 9
    return plan


def remesh_pod_axis_shrinks_by_whole_pods(F):
    plan = F.plan_elastic_remesh((2, 16, 16), ("pod", "data", "model"), 300)
    pod, data, model = plan.new_shape
    assert pod in (1, 2) and pod * data * model <= 300
    return plan


def remesh_raises_when_nothing_fits(F):
    with pytest.raises(ValueError) as e:
        F.plan_elastic_remesh((2, 2), ("data", "model"), 0)
    return str(e.value)


def remesh_shard_sources(F):
    plan = F.plan_elastic_remesh((4, 8), ("data", "model"), 8)
    assert plan.model_merge_factor == 1
    assert list(plan.shard_sources(3)) == [3]
    plan2 = F.plan_elastic_remesh((1, 8), ("data", "model"), 2)
    assert plan2.new_shape == (1, 2) and plan2.model_merge_factor == 4
    assert list(plan2.shard_sources(1)) == [4, 5, 6, 7]
    return [plan, plan2, list(plan2.shard_sources(0))]


def remesh_shrinks_data_axis_first(F):          # test_fault_data.py
    plan = F.plan_elastic_remesh((16, 16), ("data", "model"),
                                 surviving_devices=240)
    assert plan.new_shape == (15, 16) and plan.model_merge_factor == 1
    return plan


def remesh_merges_tp_when_needed(F):            # test_fault_data.py
    plan = F.plan_elastic_remesh((16, 16), ("data", "model"),
                                 surviving_devices=24)
    d, m = plan.new_shape
    assert d * m <= 24 and 16 % m == 0
    return plan


def remesh_multipod_drops_whole_pod(F):         # test_fault_data.py
    plan = F.plan_elastic_remesh((2, 16, 16), ("pod", "data", "model"),
                                 surviving_devices=300)
    assert plan.new_shape[0] in (1, 2)
    assert int(np.prod(plan.new_shape)) <= 300
    return plan


def remesh_impossible_raises(F):                # test_fault_data.py
    with pytest.raises(ValueError) as e:
        F.plan_elastic_remesh((16, 16), ("data", "model"),
                              surviving_devices=0)
    return str(e.value)


def merge_model_shards(F):
    shards = [np.full((2, 3), i, np.float32) for i in range(4)]
    merged = F.merge_model_shards(shards, 2, axis=0)
    assert len(merged) == 2 and merged[0].shape == (4, 3)
    np.testing.assert_array_equal(merged[1][:2], shards[2])
    np.testing.assert_array_equal(merged[1][2:], shards[3])
    errors = []
    for f in (3, 0):
        with pytest.raises(ValueError) as e:
            F.merge_model_shards(shards, f)
        errors.append(str(e.value))
    return [m.tolist() for m in merged] + errors


def controller_ingest_detects_failed_host(F):
    clk = FakeClock(0.0)
    ctrl = F.FaultController([0, 1], grace_s=2.0, clock=clk)
    outs = []
    for i in range(5):
        clk.t = float(i)
        beats = {0: 0.1} if i >= 2 else {0: 0.1, 1: 0.1}
        outs.append(ctrl.ingest(i, {"hosts": beats}))
    assert outs[-1]["failed_hosts"] == [1]
    assert ctrl.report()["alive_hosts"] == [0]
    return outs + [ctrl.report()]


def controller_payload_forms(F):
    ctrl = F.FaultController([0, 1], clock=FakeClock(0.0))
    ctrl.ingest(0, {"host": 0, "step_s": 0.5})
    ctrl.ingest(0, {"hosts": {1: 0.25}})
    ctrl.ingest(0, {0: 0.5, 1: 0.25})
    assert set(ctrl.monitor.ewma) == {0, 1}
    with pytest.raises(ValueError) as e:
        ctrl.ingest(0, "not a mapping")
    return [ctrl.report(), str(e.value)]


def controller_escalates_once_per_transition(F):
    ctrl = F.FaultController([0, 1, 2], alpha=1.0, factor=1.5,
                             clock=FakeClock(0.0))
    base = {0: 1.0, 1: 1.0}
    seen = []
    for i, v in enumerate((1.0, 2.0, 2.0, 8.0, 1.0)):
        seen.append(ctrl.ingest(i, {"hosts": {**base, 2: v}}))
        seen.append(ctrl.shed_events)
    assert seen[1::2] == [0, 1, 1, 2, 2]
    assert seen[2]["mitigations"][2] == "reduce_insitu_pi"
    assert ctrl.replace_candidates == {2}
    assert 2 not in ctrl.mitigations
    return seen + [ctrl.report()]


def synth_batch_deterministic(F):               # test_fault_data.py
    D = JD if F is JF else TD
    spec = D.BatchSpec(4, 64, 50000)
    a, b, c = (D.synth_batch(spec, step=s, seed=1) for s in (7, 7, 8))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].max() < 50000
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    return {k: v.tolist() for k, v in a.items()}


def prefetcher_produces_and_closes(F):          # test_fault_data.py
    D = JD if F is JF else TD
    pf = D.Prefetcher(D.BatchSpec(2, 16, 1000), depth=2)
    batches = [next(pf) for _ in range(5)]
    pf.close()
    assert all(b["tokens"].shape == (2, 16) for b in batches)
    return sorted(b["tokens"].tolist() for b in batches)


def prefetcher_preprocess_hook(F):              # test_fault_data.py
    D = JD if F is JF else TD
    pf = D.Prefetcher(D.BatchSpec(2, 16, 1000), depth=1,
                      preprocess=lambda s, b: {**b, "extra": np.ones(3)})
    b = next(pf)
    pf.close()
    assert "extra" in b
    return sorted(b)


def frontend_prefix_in_batch(F):                # test_fault_data.py
    D = JD if F is JF else TD
    b = D.synth_batch(D.BatchSpec(2, 16, 1000, frontend_tokens=8,
                                  d_model=64), 0)
    assert b["prefix"].shape == (2, 8, 64)
    return b["prefix"].tolist()


HOST_CASES = [
    heartbeat_seeds_last_seen_from_injected_clock,
    heartbeat_grace_transitions_on_fake_clock,
    heartbeat_explicit_now_still_wins,
    heartbeat_failure_detection,
    straggler_ewma_converges,
    straggler_flags_and_mitigation_tiers,
    straggler_detection_and_policy,
    remesh_prefers_smallest_merge_factor_on_ties,
    remesh_non_power_of_two_model_axis,
    remesh_pod_axis_shrinks_by_whole_pods,
    remesh_raises_when_nothing_fits,
    remesh_shard_sources,
    remesh_shrinks_data_axis_first,
    remesh_merges_tp_when_needed,
    remesh_multipod_drops_whole_pod,
    remesh_impossible_raises,
    merge_model_shards,
    controller_ingest_detects_failed_host,
    controller_payload_forms,
    controller_escalates_once_per_transition,
    synth_batch_deterministic,
    prefetcher_produces_and_closes,
    prefetcher_preprocess_hook,
    frontend_prefix_in_batch,
]


def _plain(x):
    """A plan (either package's RemeshPlan) as plain data."""
    if hasattr(x, "model_merge_factor"):
        return (x.old_shape, x.new_shape, x.axis_names, x.dropped_hosts,
                x.model_merge_factor, x.new_device_count)
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("case", HOST_CASES, ids=lambda c: c.__name__)
def test_host_case_equal_in_both_packages(case):
    assert _plain(case(TF)) == _plain(case(JF))


def test_merge_model_shards_takes_tensors():
    shards = [torch.full((2, 3), float(i)) for i in range(4)]
    merged = TF.merge_model_shards(shards, 2, axis=1)
    assert all(isinstance(m, torch.Tensor) for m in merged)
    want = JF.merge_model_shards([s.numpy() for s in shards], 2, axis=1)
    for got, w in zip(merged, want):
        np.testing.assert_array_equal(got.numpy(), w)


SHAPES_2D = [(2, 2), (1, 8), (4, 8), (4, 6), (16, 16), (3, 5), (8, 1)]
SHAPES_3D = [(2, 16, 16), (2, 2, 2), (4, 3, 8), (1, 4, 6)]


@pytest.mark.parametrize("old", SHAPES_2D + SHAPES_3D, ids=str)
def test_remesh_plans_equal_over_a_grid_of_survivors(old):
    names = ("data", "model") if len(old) == 2 else ("pod", "data", "model")
    for survivors in range(1, int(np.prod(old)) + 2):
        want = JF.plan_elastic_remesh(old, names, survivors, [survivors])
        got = TF.plan_elastic_remesh(old, names, survivors, [survivors])
        assert _plain(got) == _plain(want), (old, survivors)
        for j in range(got.new_shape[-1]):
            assert got.shard_sources(j) == want.shard_sources(j)


@settings(max_examples=80, deadline=None)
@given(data=st.integers(1, 32), model=st.integers(1, 32),
       survivors=st.integers(1, 1024))
def test_remesh_properties_2d(data, model, survivors):
    plan = TF.plan_elastic_remesh((data, model), ("data", "model"), survivors)
    d, m = plan.new_shape
    assert d * m <= survivors
    assert model % m == 0
    assert plan.model_merge_factor == model // m
    assert _plain(plan) == _plain(JF.plan_elastic_remesh(
        (data, model), ("data", "model"), survivors))


@settings(max_examples=60, deadline=None)
@given(pod=st.integers(1, 4), data=st.integers(1, 16),
       model=st.integers(1, 16), survivors=st.integers(1, 512))
def test_remesh_properties_3d(pod, data, model, survivors):
    names = ("pod", "data", "model")
    plan = TF.plan_elastic_remesh((pod, data, model), names, survivors)
    p, d, m = plan.new_shape
    assert p * d * m <= survivors
    assert 1 <= p <= pod
    assert model % m == 0
    assert _plain(plan) == _plain(JF.plan_elastic_remesh(
        (pod, data, model), names, survivors))


# ---------------------------------------------------------------------------
# the fault preset wired into a Session, through both packages
# ---------------------------------------------------------------------------

SESSIONS = {"jax": JS, "torch": TS}


def _fault_plan(extra_tasks=None, **opts):
    options = {"hosts": [0, 1], "grace_s": 2.0, "alpha": 1.0,
               "factor": 1.5, **opts}
    tasks = {"fault": {"stream": "health", "preset": "fault", "every": 1,
                       "placement": "sync", "pipelined": False,
                       "options": options}}
    tasks.update(extra_tasks or {})
    streams = sorted({t["stream"] for t in tasks.values()})
    return {"streams": streams, "workers": 2, "tasks": tasks}


@pytest.mark.parametrize("S", SESSIONS.values(), ids=list(SESSIONS))
@pytest.mark.parametrize("opts,match", [
    ({"hosts": []}, "hosts"), ({"bogus": 1}, "unknown fault option")])
def test_fault_preset_validates_options(S, opts, match):
    with pytest.raises(S.PlanError, match=match):
        S.Session(_fault_plan(**opts))


def _heartbeats_on_session_clock(S):
    clk = FakeClock(0.0)
    with S.Session(_fault_plan(), clock=lambda: clk.t) as s:
        ctrl = s.fault_controller()
        for i in range(6):
            clk.t = float(i)
            beats = {0: 0.1} if i >= 2 else {0: 0.1, 1: 0.1}
            s.emit("health", i, {"hosts": beats})
        assert ctrl.failed_hosts() == [1]
    rep = s.report()
    assert rep["fault"]["failed_hosts"] == [1]
    assert rep["fault"]["alive_hosts"] == [0]
    assert 0 in rep["fault"]["straggler_ewma"]
    return rep["fault"], [r.result for r in s.results]


def test_fault_preset_heartbeats_on_session_clock():
    assert _heartbeats_on_session_clock(TS) == \
        _heartbeats_on_session_clock(JS)


def _sheds_insitu_load(S):
    extra = {"analytics": {"stream": "x", "preset": "spectra",
                           "every": 2, "placement": "sync",
                           "pipelined": False}}
    plan = _fault_plan(extra_tasks=extra, hosts=[0, 1, 2])
    clk = FakeClock(0.0)
    seen = []
    with S.Session(plan, clock=lambda: clk.t) as s:
        ctrl = s.fault_controller("fault")
        assert s.runtime.effective_every("analytics") == 2
        for i, lag in enumerate((1.0, 2.0, 9.0)):
            s.emit("health", i, {"hosts": {0: 1.0, 1: 1.0, 2: lag}})
            seen.append((ctrl.shed_events, dict(ctrl.widened),
                         s.runtime.effective_every("analytics"),
                         s.runtime.effective_every("fault")))
        assert seen[1] == (1, {"analytics": 4}, 4, 1)
        assert ctrl.report()["replace_at_checkpoint"] == [2]
    rep = s.report()
    assert rep["fault"]["shed_events"] == 2
    assert rep["fault"]["mitigations"] == {2: "replace_at_checkpoint"}
    counters = s.runtime.telemetry.counters()
    return seen, rep["fault"], rep["effective_every"], {
        k: v for k, v in counters.items() if k.startswith("fault/")}


def test_fault_preset_sheds_insitu_load_before_replacing():
    """The same payloads on the same fake clock: equal controller reports,
    effective periods and shed counters in both packages."""
    got = _sheds_insitu_load(TS)
    assert got == _sheds_insitu_load(JS)
    assert got[3] == {"fault/shed/analytics": 2}


def test_shed_insitu_never_sheds_the_checkpoint(tmp_path):
    for S in (JS, TS):
        opts = {"directory": str(tmp_path / S.__name__)}
        if S is TS:
            opts["device"] = "cpu"
        plan = _fault_plan(extra_tasks={
            "checkpoint": {"stream": "state", "preset": "checkpoint",
                           "every": 2, "options": opts},
            "analytics": {"stream": "x", "preset": "spectra", "every": 1}})
        with S.Session(plan) as s:
            assert s.shed_insitu(exclude=("fault",)) == {"analytics": 2}
            assert s.shed_insitu() == {"analytics": 4, "fault": 2}


@pytest.mark.parametrize("S", SESSIONS.values(), ids=list(SESSIONS))
def test_fault_controller_lookup_errors(S):
    with S.Session(_fault_plan()) as s:
        with pytest.raises(S.PlanError):
            s.fault_controller("nope")
    plan = S.InSituPlan.from_dict({"streams": ["x"], "tasks": {
        "t": {"stream": "x", "preset": "spectra"}}})
    with S.Session(plan) as s:
        with pytest.raises(S.PlanError):
            s.fault_controller()


def test_fault_preset_is_registered_and_round_trips():
    plan = _fault_plan()
    for S in (JS, TS):
        assert "fault" in S.preset_names()
        assert S.InSituPlan.from_dict(plan).to_dict() == \
            JS.InSituPlan.from_dict(plan).to_dict()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_fault_reports_stream_to_the_other_package(tmp_path, direction):
    """``to=file://...`` streams each ingest report; the other package's
    ``FileSource`` reads the frames and decodes the reports."""
    S, src_pkg = (TS, JT) if direction == "port_to_jax" else (JS, TT)
    clk = FakeClock(0.0)
    with S.Session(_fault_plan(to=f"file://{tmp_path}"),
                   clock=lambda: clk.t) as s:
        for i in range(5):
            clk.t = float(i)
            s.emit("health", i, {"hosts": {0: 0.1 * (i + 1), 1: 0.1}
                                 if i < 2 else {0: 0.2}})
    want = [r.result for r in s.results]
    frames = list(src_pkg.FileSource(str(tmp_path)).frames())
    assert [(f.stream, f.step) for f in frames] == [
        ("health", i) for i in range(5)]
    got = [src_pkg.decode_frame_payload(f) for f in frames]
    # the wire is JSON: integer keys come back as strings
    assert got == json.loads(json.dumps(want))
    assert got[-1]["failed_hosts"] == [1]
    assert s.report()["tasks"]["fault"]["transport"]["frames"] == 5


def test_default_train_plan_adds_the_health_stream():
    from repro.launch import train as JTR
    from repro_torch.launch import train as TTR
    kw = dict(fault=True, fault_hosts=[0, 3], fault_grace_s=5.0)
    got = TTR.default_train_plan(device="cpu", **kw)
    assert got == JTR.default_train_plan(**kw)
    assert TTR.default_train_plan(device="cpu") == JTR.default_train_plan()


def test_train_loop_beats_health_and_records_its_mesh(tmp_path):
    """``train_loop`` emits ``{"host": 0, "step_s": ...}`` on ``health``
    each step and records the (1, 1) mesh geometry beside the arch, as
    the JAX package's loop does."""
    from repro_torch.launch import train as TTR
    plan = TTR.default_train_plan(insitu_mode="sync",
                                  ckpt_dir=str(tmp_path), ckpt_every=2,
                                  fault=True, device="cpu")
    out = TTR.train_loop("smollm-135m", steps=3, plan=plan, device="cpu",
                         log=lambda m: None)
    rep = out["session_report"]
    assert rep["fault"]["alive_hosts"] == [0]
    assert list(rep["fault"]["straggler_ewma"]) == [0]
    assert rep["tasks"]["fault"]["results"] == 3
    meta = TS.Session(plan).checkpoint.read_meta()
    assert meta == {"arch": "smollm-135m-smoke",
                    "mesh": {"shape": [1, 1], "axes": ["data", "model"]}}


# ---------------------------------------------------------------------------
# the runtime's cases of tests/test_fault.py not already in
# tests/test_torch_runtime.py
# ---------------------------------------------------------------------------

RUNTIMES = {"jax": (JR, JS), "torch": (TR, TS)}


@pytest.mark.parametrize("R,S", RUNTIMES.values(), ids=list(RUNTIMES))
def test_transient_error_from_sink_itself_degrades(R, S):
    rt = R.PipelineRuntime(workers=1, staging_capacity=2)
    rt.register(R.PipelineTask(
        name="t", source="s", placement=R.Placement.SYNC, pipelined=False,
        retries=1, retry_backoff_s=0.0,
        sink=lambda step, p: (_ for _ in ()).throw(
            R.TransientError("sink-side"))))
    rt.submit(0, {"s": lambda: 0})
    rt.drain()
    assert rt.errors == []
    assert rt.degraded["t"]["retries"] == 1


@pytest.mark.parametrize("R,S", RUNTIMES.values(), ids=list(RUNTIMES))
def test_plan_validates_retry_fields(R, S):
    base = {"streams": ["x"], "tasks": {
        "t": {"stream": "x", "preset": "spectra", "retries": -1}}}
    with pytest.raises(S.PlanError, match="retries"):
        S.InSituPlan.from_dict(base)
    base["tasks"]["t"] = {"stream": "x", "preset": "spectra",
                          "retry_backoff_s": -0.1}
    with pytest.raises(S.PlanError, match="retry_backoff_s"):
        S.InSituPlan.from_dict(base)


@pytest.mark.parametrize("R,S", RUNTIMES.values(), ids=list(RUNTIMES))
def test_adaptive_budget_round_trips_through_dict(R, S):
    trig = S.Adaptive(2, max_every=16, after=3, budget_s=0.25)
    d = trig.to_dict()["trigger"]
    assert d["budget_s"] == 0.25
    plan = S.InSituPlan.from_dict({"streams": ["x"], "tasks": {
        "t": {"stream": "x", "preset": "spectra", "trigger": d}}})
    assert plan.tasks[0].trigger == trig
    assert plan.to_dict()["tasks"]["t"]["trigger"]["budget_s"] == 0.25


@pytest.mark.parametrize("R,S", RUNTIMES.values(), ids=list(RUNTIMES))
def test_adaptive_budget_validation(R, S):
    with pytest.raises(S.PlanError, match="budget_s"):
        S.InSituPlan.from_dict({"streams": ["x"], "tasks": {
            "t": {"stream": "x", "preset": "spectra",
                  "trigger": {"kind": "adaptive", "n": 1, "budget_s": 0}}}})


@pytest.mark.parametrize("R,S", RUNTIMES.values(), ids=list(RUNTIMES))
def test_budget_widen_after_consecutive_over_budget_firings(R, S):
    plan = S.InSituPlan(streams=["x"], tasks=[
        S.TaskSpec(name="slow", stream="x",
                   trigger=S.Adaptive(1, max_every=8, after=2,
                                      budget_s=0.005),
                   placement=R.Placement.SYNC, pipelined=False,
                   sink=lambda step, p: time.sleep(0.02))])
    with S.Session(plan) as s:
        for i in range(3):
            s.emit("x", i, {"v": 1})
        assert s.runtime.effective_every("slow") == 2
        assert s.runtime.telemetry.counters()["budget/adapt/slow"] >= 1
    assert s.report()["effective_every"]["slow"] >= 2


# ---------------------------------------------------------------------------
# elastic restore on a world-size-1 gloo group
# ---------------------------------------------------------------------------

def _tool():
    path = ROOT / "tools" / "torch_fault_killpoint.py"
    spec = importlib.util.spec_from_file_location("torch_fault_killpoint",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def world_of_one(tmp_path):
    with _tool().world_of_one(str(tmp_path / "store"), "gloo"):
        yield


def _ckpt_plan(directory):
    return {"streams": ["state"], "tasks": {
        "checkpoint": {"stream": "state", "preset": "checkpoint",
                       "every": 1, "placement": "sync",
                       "options": {"directory": str(directory),
                                   "device": "cpu"}}}}


def test_elastic_restore_requires_mesh_meta(tmp_path, world_of_one):
    plan = _ckpt_plan(tmp_path / "ck")
    state = {"w": torch.arange(8, dtype=torch.float32)}
    with TS.Session(plan) as s:
        s.emit("state", 0, state)
    with TS.Session(plan) as s:
        with pytest.raises(TS.PlanError, match="mesh geometry"):
            s.restore(state, elastic=True, devices=[0])


def test_elastic_restore_single_device_roundtrip(tmp_path, world_of_one):
    """The port's restore on a (1, 1) DeviceMesh of the one rank; the same
    checkpoint restored elastically by the JAX package gives the same
    plan and values."""
    import jax
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    plan = _ckpt_plan(tmp_path / "ck")
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    state = {"w": torch.arange(8, dtype=torch.float32)}
    with TS.Session(plan) as s:
        s.set_checkpoint_meta(mesh=mesh)
        s.emit("state", 2, state)
    assert s.checkpoint.read_meta()["mesh"] == {"shape": [1, 1],
                                                "axes": ["data", "model"]}
    with TS.Session(plan) as s:
        step, restored = s.restore(
            {"w": torch.empty(8, device="meta")}, elastic=True, devices=[0],
            make_shardings=lambda m: {"w": (Replicate(), Shard(0))})
        assert step == 2
        assert isinstance(restored["w"], DTensor)
        assert restored["w"].placements == (Replicate(), Shard(0))
        np.testing.assert_array_equal(restored["w"].full_tensor().numpy(),
                                      np.arange(8, dtype=np.float32))
        rm = s.remesh
        assert isinstance(rm, TF.ElasticRestore)
        assert rm.step == 2 and rm.plan.new_shape == (1, 1)
        assert tuple(rm.mesh.mesh_dim_names) == ("data", "model")
    assert s.remesh is rm
    jplan = _ckpt_plan(tmp_path / "ck")
    del jplan["tasks"]["checkpoint"]["options"]["device"]
    with JS.Session(jplan) as js:
        jstep, jrestored = js.restore(
            {"w": np.zeros(8, np.float32)}, elastic=True,
            devices=jax.devices()[:1])
    assert jstep == 2 and js.remesh.plan == JF.RemeshPlan(
        *(getattr(rm.plan, f) for f in (
            "old_shape", "new_shape", "axis_names", "dropped_hosts",
            "model_merge_factor")))
    np.testing.assert_array_equal(np.asarray(jrestored["w"]),
                                  restored["w"].to_local().numpy())


def test_elastic_restore_needs_a_process_group(tmp_path):
    plan = _ckpt_plan(tmp_path / "ck")
    state = {"w": torch.arange(8, dtype=torch.float32)}
    with TS.Session(plan) as s:
        s.set_checkpoint_meta({"arch": "t"}, mesh=TSH.abstract_mesh(
            (1, 1), ("data", "model")))
        s.emit("state", 0, state)
        with pytest.raises(TS.PlanError, match="process group"):
            s.restore(state, elastic=True)


# ---------------------------------------------------------------------------
# the kill-point scenario at the smoke config
# ---------------------------------------------------------------------------

def test_killpoint_host_drop_resumes_on_remeshed_grid(tmp_path,
                                                      world_of_one):
    """Drop a host mid-run; the run halts, restores elastically on the
    surviving rank and resumes; the resumed losses match the golden run
    within the lossy checkpoint's bounds (the JAX scenario's asserts), and
    the plan is the one the JAX package computes for the same mesh."""
    from repro_torch.configs import base as configs

    cfg = configs.get("smollm-135m", smoke=True)
    out = _tool().run_scenario(cfg, "cpu", 9, 4, 2, 2.5,
                               ckpt_dir=str(tmp_path / "ck"),
                               log=lambda m: None)
    assert out["failed_hosts"] == [1]
    assert out["fault_report"]["alive_hosts"] == [0]
    assert out["detect_step"] >= 4
    assert out["restored_step"] <= out["detect_step"]
    want = JF.plan_elastic_remesh((1, 1), ("data", "model"), 1)
    assert (tuple(out["new_shape"]), out["merge_factor"]) == (
        want.new_shape, want.model_merge_factor)
    golden = out["golden_losses"]
    resumed = out["resumed_losses"]
    assert max(resumed) == len(golden) - 1
    for i, loss in resumed.items():
        assert abs(loss - golden[i]) <= max(0.05, 0.02 * abs(golden[i]))
    assert out["failure_losses"] == golden[:out["detect_step"] + 1]
    assert out["saves"] == 4 and out["resume_saves"] == 1


KILLPOINT_RANKS_TIMEOUT_S = 150.0
#: the two packages' losses in the across-ranks scenario, golden and
#: resumed (measured up to 9.3e-4 apart; the JAX package's own meshes
#: differ by up to 5.4e-4 after two such steps, tests/
#: test_torch_shard_step.py), and under what a resume from an older save
#: moves the step-7 loss (4.3e-3 and more, held in the test)
KILLPOINT_LOSS_ATOL = 2e-3


def _killpoint_across_ranks(d: Path) -> tuple[dict, dict]:
    """Both packages' (2, 2) -> (1, 2) scenario from the port's seed-0
    state, under the tool's ``CHECK_STEP`` (its rate moves the
    parameters each step): the port's result and the JAX package's."""
    from repro_torch.configs import base as tbase
    from repro_torch.core import host, pytree
    from repro_torch.launch import train as TTR

    sys.path.insert(0, str(ROOT / "tests"))
    import jax_shard_oracle as oracle

    tool = _tool()
    cfg = tbase.get("smollm-135m", smoke=True)
    state = TTR.init_state(cfg, 0, tool.check_step_config().opt,
                           device="cpu")
    oracle.save_tree(str(d / "init_smollm-135m.npz"), {
        pytree.keystr(p): host.to_numpy(t)
        for p, t in pytree.flatten_with_path(state)})
    (d / "step.json").write_text(json.dumps(tool.CHECK_STEP))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    ref_proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_shard_oracle.py"),
         "--killpoint", "--dir", str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.monotonic()
    try:
        out = tool.run_across_ranks(str(d / "port"),
                                    timeout_s=KILLPOINT_RANKS_TIMEOUT_S)
        ref_out, ref_err = ref_proc.communicate(timeout=max(
            1.0, KILLPOINT_RANKS_TIMEOUT_S - (time.monotonic() - t0)))
        assert ref_proc.returncode == 0, ref_err[-4000:]
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    ref = json.loads(ref_out.strip().splitlines()[-1])
    ref["resumed_losses"] = {int(k): v for k, v in
                             ref["resumed_losses"].items()}
    return out, ref


def _resumed_from_older_saves(saves=(0, 2, 4), at: int = 7) -> list:
    """The step-``at`` loss on one device, resumed from the state each of
    the scenario's older ``saves`` held (the state after that step) in
    place of the newest: what a wrong restore would give."""
    from repro_torch.configs import base as tbase
    from repro_torch.launch import train as TTR

    tool = _tool()
    sc = tool.check_step_config()
    cfg = tbase.get("smollm-135m", smoke=True)
    step = TTR.make_train_step(cfg, sc)
    batch = lambda i: {k: torch.from_numpy(v) for k, v in
                       tool.synth_batch(cfg, tbase.SMOKE_SHAPE, i).items()}
    state, kept = TTR.init_state(cfg, 0, sc.opt, device="cpu"), {}
    for i in range(max(saves) + 1):
        state, _ = step(state, batch(i))
        if i in saves:
            kept[i] = state
    return [float(step(kept[i], batch(at))[1]["loss"]) for i in saves]


def test_killpoint_across_ranks_matches_the_jax_scenario(tmp_path):
    """The (2, 2) -> (1, 2) scenario on four ranks, then two, against the
    JAX package's run of it from the same initial state, batches and
    step: detection at the same step, the same restored step, plan and
    merge; the failure run equal to golden up to the halt; every golden
    and every resumed loss within KILLPOINT_LOSS_ATOL of the JAX
    package's, and every resumed loss within max(0.05, 0.02 |golden|) of
    golden (the JAX scenario's bound). The step is the tool's
    ``CHECK_STEP``, whose rate moves the parameters: a resume from an
    older save (steps 0, 2, 4) would put the step-7 loss further than the
    bound from the JAX package's, which the test shows on one device
    (measured 3.6e-2, 4.3e-3, 7.7e-3)."""
    out, ref = _killpoint_across_ranks(tmp_path)
    assert ref["detect_step"] == out["detect_step"] == 6
    assert ref["restored_step"] == out["restored_step"] == 6
    assert ref["failed_hosts"] == out["failed_hosts"] == [1]
    assert out["fault_report"]["alive_hosts"] == [0]
    assert (ref["new_shape"], ref["merge_factor"]) == (
        out["new_shape"], out["merge_factor"]) == ([1, 2], 1)
    assert out["old_shape"] == [2, 2]
    golden, ref_golden = out["golden_losses"], ref["golden_losses"]
    assert out["failure_losses"] == golden[:out["detect_step"] + 1]
    assert ref["failure_losses"] == ref_golden[:7]
    np.testing.assert_allclose(golden, ref_golden, rtol=0,
                               atol=KILLPOINT_LOSS_ATOL)
    resumed, ref_resumed = out["resumed_losses"], ref["resumed_losses"]
    assert sorted(resumed) == sorted(ref_resumed) == [7, 8]
    for i, loss in resumed.items():
        assert abs(loss - ref_resumed[i]) <= KILLPOINT_LOSS_ATOL, (
            i, loss, ref_resumed[i])
        assert abs(loss - golden[i]) <= max(0.05, 0.02 * abs(golden[i]))
    assert out["saves"] == 4 and out["resume_saves"] == 1
    for wrong in _resumed_from_older_saves():
        assert abs(wrong - ref_resumed[7]) > KILLPOINT_LOSS_ATOL, wrong
