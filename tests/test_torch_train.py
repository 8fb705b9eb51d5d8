"""Training parity between the PyTorch port and the JAX package (CPU).

Both packages start from the same weights: the JAX package materializes a
smoke-size ``smollm-135m`` tree, cast to f32, and the port takes it
through ``state_from_numpy``; batches are ``synth_batch``'s numpy draws.
The reference is ``transformer.train_loss`` with no ``bspec`` (as
``tests/test_models.py`` runs it), ``optim.update`` and
``optim.schedules.warmup_cosine``, written into a loop here: the JAX
package's own ``train_loop`` needs a mesh this JAX version refuses
(``ROADMAP.md``, open items).

Tolerances and why:

* loss rtol 1e-5 and grads rtol 1e-4 / atol 1e-6: f32 on both sides, the
  same math summed in other orders (attention chunks, matmul blocking);
  gradients pass through two layers' backward products.
* params after one or five AdamW steps rtol 1e-4 / atol 1e-6: the update
  divides by sqrt(v) + 1e-8, which amplifies the grads' rounding where v
  is small.
* bf16 moments: one bf16 step (rtol 2^-7): each package rounds its f32
  moment to bf16, and f32 inputs that differ in the last bits can round
  to neighbouring bf16 values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import base as jbase
from repro.data.pipeline import batch_spec_for as j_batch_spec
from repro.data.pipeline import synth_batch as j_synth
from repro.checkpoint import serialization as JS
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.checkpoint import serialization as TS
from repro_torch.configs import base as tbase
from repro_torch.core import pytree
from repro_torch.core.session import Every, InSituPlan, Placement, TaskSpec
from repro_torch.data.pipeline import batch_spec_for, synth_batch
from repro_torch.launch import train as TT
from repro_torch.models import transformer as TM

ARCH = "smollm-135m"
STEP = TT.StepConfig()


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _jax_state(count=50, seed=0):
    cfg = jbase.get(ARCH, smoke=True)
    params = _f32(JP.materialize(jax.random.PRNGKey(seed),
                                 JT.param_spec(cfg)))
    ost = JO.init(params, JO.AdamWConfig())
    return cfg, {"params": params, "mu": ost.mu, "nu": ost.nu,
                 "count": jnp.asarray(count, jnp.int32)}


def _batch(step):
    spec = batch_spec_for(tbase.get(ARCH, smoke=True), tbase.SMOKE_SHAPE)
    return synth_batch(spec, step)


def _jax_step(cfg):
    def step(state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: JT.train_loss(p, cfg, batch))(state["params"])
        lr = JO.schedules.warmup_cosine(
            state["count"], peak=STEP.lr_peak, warmup=STEP.lr_warmup,
            total=STEP.lr_total)
        ost = JO.AdamWState(state["count"], state["mu"], state["nu"], None)
        params, ost = JO.update(grads, ost, state["params"], JO.AdamWConfig(),
                                lr=lr)
        return {"params": params, "mu": ost.mu, "nu": ost.nu,
                "count": ost.count}, loss
    return jax.jit(step)


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(tree):
    if isinstance(pytree.leaves(tree)[0], torch.Tensor):
        return {pytree.keystr(p): t.detach().float().numpy()
                for p, t in pytree.flatten_with_path(tree)}
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want, **tol):
    got, want = _np(got), _np(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_batches_are_the_jax_packages():
    jspec = j_batch_spec(jbase.get(ARCH, smoke=True), jbase.SMOKE_SHAPE)
    for step in (0, 3):
        jb, tb = j_synth(jspec, step), _batch(step)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


def test_train_loss_and_grads_match_jax():
    cfg, jstate = _jax_state()
    tcfg = tbase.get(ARCH, smoke=True)
    batch = _batch(0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.train_loss(p, cfg, {k: jnp.asarray(v)
                                         for k, v in batch.items()}))(
        jstate["params"])
    tparams = TT.state_from_numpy(jax.device_get(jstate), "cpu")["params"]
    flat = pytree.flatten_with_path(tparams)
    live = {pytree.keystr(p): t.requires_grad_(True) for p, t in flat}
    loss = TM.train_loss(pytree.unflatten_like(tparams, live), tcfg,
                         _port_batch(batch))
    grads = torch.autograd.grad(loss, list(live.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(pytree.unflatten_like(tparams, dict(zip(live, grads))),
                       jgrads, rtol=1e-4, atol=1e-6)


def test_remat_changes_nothing():
    import dataclasses
    cfg, jstate = _jax_state()
    tcfg = tbase.get(ARCH, smoke=True)
    params = TT.state_from_numpy(jax.device_get(jstate), "cpu")["params"]
    batch = _port_batch(_batch(1))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(tcfg, remat=remat)
        flat = pytree.flatten_with_path(params)
        live = {pytree.keystr(p): t.detach().requires_grad_(True)
                for p, t in flat}
        loss = TM.train_loss(pytree.unflatten_like(params, live), c, batch)
        out.append((loss.item(), torch.autograd.grad(loss,
                                                     list(live.values()))))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_one_step_matches_optim_update():
    cfg, jstate = _jax_state(count=50)
    tcfg = tbase.get(ARCH, smoke=True)
    batch = _batch(0)
    jnew, jloss = _jax_step(cfg)(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    tstate = TT.state_from_numpy(jax.device_get(jstate), "cpu")
    tnew, metrics = TT.make_train_step(tcfg, STEP)(tstate, _port_batch(batch))
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                               rtol=1e-5)
    assert int(tnew["count"]) == int(jnew["count"]) == 51
    _assert_tree_close(tnew["params"], jnew["params"], rtol=1e-4, atol=1e-6)
    for grp in ("mu", "nu"):
        assert all(t.dtype == torch.bfloat16
                   for t in pytree.leaves(tnew[grp]))
        _assert_tree_close(tnew[grp], jnew[grp], rtol=2 ** -7, atol=1e-12)
    # the step leaves its input state as it was
    for (_, a), (_, b) in zip(pytree.flatten_with_path(tstate["params"]),
                              pytree.flatten_with_path(TT.state_from_numpy(
                                  jax.device_get(jstate), "cpu")["params"])):
        assert torch.equal(a, b)


def test_five_step_loop_matches_jax():
    cfg, jstate = _jax_state(count=50, seed=1)
    tcfg = tbase.get(ARCH, smoke=True)
    jstep = _jax_step(cfg)
    tstep = TT.make_train_step(tcfg, STEP)
    tstate = TT.state_from_numpy(jax.device_get(jstate), "cpu")
    jlosses, tlosses = [], []
    for i in range(5):
        b = _batch(i)
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, m = tstep(tstate, _port_batch(b))
        jlosses.append(float(jl))
        tlosses.append(m["loss"].item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    _assert_tree_close(tstate["params"], jstate["params"], rtol=1e-4,
                       atol=1e-6)


def _jax_template():
    cfg = jbase.get(ARCH, smoke=True)
    params = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(cfg))
    ost = JO.init(params, JO.AdamWConfig())
    return {"params": params, "mu": ost.mu, "nu": ost.nu,
            "count": ost.count}


def test_hybrid_train_loop_checkpoints_restore_in_jax_and_resume(tmp_path):
    logs: list[str] = []
    out = TT.train_loop(ARCH, steps=12, insitu_mode="hybrid",
                        ckpt_dir=str(tmp_path), ckpt_every=5, device="cpu",
                        log=logs.append)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 12
    rep = out["session_report"]
    assert rep["errors"] == [] and rep["checkpoint"]["saves"] == 3
    assert rep["checkpoint"]["kept_steps"] == [0, 5, 10]
    assert out["insitu_results"] == 2               # grad_health at 0, 10
    newest = tmp_path / "step_000000010"
    template = _jax_template()
    restored = JS.read_state(str(newest), template)
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    assert all(np.isfinite(np.asarray(x, np.float32)).all()
               for x in jax.tree.leaves(restored))
    assert int(restored["count"]) == 11
    logs.clear()
    out2 = TT.train_loop(ARCH, steps=3, insitu_mode="hybrid",
                         ckpt_dir=str(tmp_path), ckpt_every=5, device="cpu",
                         log=logs.append)
    assert "resumed from step 10" in logs
    assert np.isfinite(out2["losses"]).all()


def test_checkpoint_at_step_k_holds_step_k_params(tmp_path):
    """What each save writes is the state emitted at its step, though the
    loop has moved on by the time the workers encode it."""
    emitted: dict[int, dict] = {}

    def keep(step, payload):
        emitted[step] = {pytree.keystr(p): np.array(a) for p, a in
                         pytree.flatten_with_path(payload["params"])}

    base = InSituPlan.from_dict(TT.default_train_plan(
        insitu_mode="hybrid", ckpt_dir=str(tmp_path), ckpt_every=2,
        device="cpu"))
    probe = TaskSpec(name="probe", stream="train_state", trigger=Every(2),
                     placement=Placement.SYNC, sink=keep)
    plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                      workers=base.workers)
    out = TT.train_loop(ARCH, steps=7, plan=plan, device="cpu",
                        log=lambda _: None)
    assert out["session_report"]["checkpoint"]["kept_steps"] == [2, 4, 6]
    template = TT.init_state(tbase.get(ARCH, smoke=True), 0,
                             STEP.opt, device="cpu")
    for step in (2, 4, 6):
        st = TS.read_state(str(tmp_path / f"step_{step:09d}"), template,
                           "cpu")
        for p, t in pytree.flatten_with_path(st["params"]):
            want = emitted[step][pytree.keystr(p)]
            got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
                else t.numpy()
            assert np.array_equal(got.view(np.uint8),
                                  want.view(np.uint8)), (step, p)


def test_state_from_numpy_bridges_bits():
    _, jstate = _jax_state()
    jstate["mu"] = jax.tree.map(lambda x: x + 1e-3, jstate["mu"])
    t = TT.state_from_numpy(jax.device_get(jstate), "cpu")
    assert t["count"].dtype == torch.int32 and t["count"].shape == ()
    for (_, a), (_, b) in zip(pytree.flatten_with_path(t["mu"]),
                              jax.tree_util.tree_flatten_with_path(
                                  jstate["mu"])[0]):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np.asarray(b).view(np.int16))


def test_train_cli_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    import sys
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--steps", "3", "--insitu", "hybrid",
        "--ckpt-dir", str(tmp_path)])
    TT.main()
    out = capsys.readouterr().out
    assert "final loss:" in out and "in-situ results: 1" in out
    assert (tmp_path / "step_000000000" / "manifest.json").exists()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_non_hybrid_placements_run_on_the_cpu(tmp_path, mode):
    out = TT.train_loop(ARCH, steps=3, insitu_mode=mode, ckpt_every=2,
                        ckpt_dir=str(tmp_path), device="cpu",
                        log=lambda _: None)
    assert out["session_report"]["checkpoint"]["kept_steps"] == [0, 2]
    assert out["session_report"]["errors"] == []
