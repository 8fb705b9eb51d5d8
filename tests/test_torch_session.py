"""The training presets of the port's Session against the JAX package's
(CPU): the ``grad_health`` and ``spectra`` artifacts are computed by the
same host-only numpy code, so they must be equal; the ``checkpoint``
preset folds a CheckpointManager into the plan, restores, and takes the
steering ``lossy_eps`` knob.
"""
import numpy as np
import pytest
import torch

from repro.core import session as JS
from repro_torch.core import session as TS


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


def test_fault_preset_still_names_its_roadmap_item():
    with pytest.raises(TS.PlanError, match="Distribution and faults"):
        TS.InSituPlan.from_dict({"streams": ["s"], "tasks": {
            "f": {"stream": "s", "preset": "fault"}}})
