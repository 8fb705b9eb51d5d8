"""Kill-point: a host stops beating, the run halts, restores elastically, resumes

    python3 tools/torch_fault_killpoint.py [--layers 30] [--steps 9]
        [--fail-at 4] [--ckpt-every 2] [--grace-s 2.5] [--device cuda]
        [--world 1|4]

The JAX package's kill-point scenario (``tests/test_fault.py``'s
subprocess) on the port, JAX-free, for ``smollm-135m`` at full width (``--layers`` of its 30
blocks; widths unchanged) at ``launch/train.py``'s ``FULL_SHAPE`` (4 x
4096 tokens), seed 0:

  golden    ``--steps`` steps, no failure.
  failure   the same run with the ``fault`` preset: hosts 0 and 1 beat on
            an injected clock that advances 1 s a step, host 1 stops at
            ``--fail-at``; HYBRID v2 checkpoints every ``--ckpt-every``
            steps carry the mesh geometry; the run halts on the step the
            controller declares host 1 failed (``--grace-s`` of silence).
  recover   ``Session.restore(elastic=True)`` over the surviving ranks of
            the default process group (``plan_elastic_remesh`` picks the
            grid), each leaf placed on their ``DeviceMesh`` under
            ``state_shardings``, then a resume to ``--steps``.

Batches are drawn from the step index (``numpy.random.RandomState(1000 +
step)``, as the JAX scenario's ``synth_batch``), so the resumed steps see
the golden run's batches.

``--world 1`` (the default): one process in a world-size-1 group (NCCL
on the card, gloo on the CPU; a ``FileStore`` under ``build/``), one
mesh device, so the resumed step takes the DTensors' local tensors. On
CUDA one captured train step (``graph_train_step``) serves all three
runs: each run fills its static state tensors first (the initial
weights, then the restored checkpoint), so no collective and no second
capture runs.

``--world 4``: the JAX scenario's meshes across processes
(:func:`run_across_ranks`). Golden and failure run on four ranks, a
(2, 2) ('data', 'model') mesh, with ``launch.train``'s sharded step; at
each step where the checkpoint fires every rank gathers the state whole
on its loop thread (:func:`launch.train.gather_state`, the same order on
every rank) and rank 0 alone emits it; rank 0 alone runs the session, and
its halt decision reaches the other ranks by an all-reduce each step.
Then ranks 0-1 of a new world of two restore elastically (the plan is
(1, 2), merge 1) and resume on that mesh with the sharded step. The
step is :data:`CHECK_STEP`, not the JAX scenario's default, whose rate
moves nothing in 9 steps: under it a resume from another step's state
shows in the losses. The
ranks are ``tests/torch_shard_ranks.py`` processes over gloo (on the
card all share the one device; the collectives stage through host
buffers), with a deadline.

Gates (the JAX scenario's asserts; a broken one exits 1): host 1 and only
it failed, host 0 alive; detection at or after ``--fail-at``; the restored
step at or before it; the resumed run reaches the last step; every
resumed loss within ``max(0.05, 0.02 |golden|)`` of golden. And: the
failure run's losses equal the golden ones bit for bit up to the halt;
the restored state against the state emitted at its step (params and
count bitwise, moments within ``error_bound(1e-2)``); on the card, kernels
2-4 launched once a packed group a save and kernel 5 once a moment leaf
in the restore, no other kernel (launch counts set to 0 before each run
and read after). Prints one line ``KILLPOINT_RESULT {json}``.

``chip_smoke.py``'s ``fault`` phase calls :func:`run_scenario` at 2
layers inside :func:`world_of_one`; ``tests/test_torch_fault.py`` calls
it, and :func:`run_across_ranks`, at the smoke config on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "smollm-135m"
#: kernels 2-4: what a HYBRID save launches, once a packed group
SAVE_KERNELS = ("dct_hist_coarse_tiled", "hist_refine_tiled",
                "threshold_quant")


def _family_tool():
    """``tools/torch_family_train.py`` (launch counts, the restore check,
    the packed groups), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "torch_family_train", os.path.join(HERE, "torch_family_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def world_of_one(store_dir: str, backend: str):
    """A world-size-1 default process group (``backend``: ``nccl`` on the
    card, ``gloo`` on the CPU) over a ``FileStore`` in ``store_dir``;
    destroyed on exit."""
    import torch.distributed as dist

    import torch

    if backend == "nccl":
        torch.cuda.set_device(0)       # the mesh's one device, before it
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def synth_batch(cfg, shape, step: int) -> dict:
    """The JAX scenario's batch for ``step``: int32 tokens and labels drawn
    from ``RandomState(1000 + step)``."""
    import numpy as np

    rng = np.random.RandomState(1000 + step)
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _ckpt_task(directory: str, dev, every: int):
    """The scenario's HYBRID v2 checkpoint every ``every`` steps."""
    from repro_torch.core.session import Every, Placement, TaskSpec

    return TaskSpec(name="checkpoint", stream="train_state",
                    preset="checkpoint", trigger=Every(every),
                    placement=Placement.HYBRID,
                    options={"directory": directory, "device": str(dev)})


def _failure_plan(ckpt_task, every: int, grace_s: float):
    """The failure run's plan: the checkpoint, the ``fault`` preset over
    hosts 0 and 1, and a SYNC probe keeping the host copy of the state at
    each save step (the newest kept; what the restore is held against).
    Returns ``(plan, kept)``."""
    import numpy as np
    from repro_torch.core import pytree
    from repro_torch.core.session import (Every, InSituPlan, Placement,
                                          TaskSpec, When)

    kept: dict = {}

    def keep(st, payload):
        kept.clear()
        kept.update({"step": st, "leaves": {
            pytree.keystr(p): np.asarray(a)
            for p, a in pytree.flatten_with_path(payload)}})

    plan = InSituPlan(streams=["train_state", "health"], workers=2, tasks=[
        ckpt_task,
        TaskSpec(name="fault", stream="health", preset="fault",
                 trigger=Every(1), placement=Placement.SYNC, pipelined=False,
                 options={"hosts": [0, 1], "grace_s": grace_s}),
        TaskSpec(name="probe", stream="train_state",
                 trigger=When(lambda st: st % every == 0),
                 placement=Placement.SYNC, sink=keep)])
    return plan, kept


def run_scenario(cfg, device, steps: int = 9, fail_at: int = 4,
                 ckpt_every: int = 2, grace_s: float = 2.5, *,
                 ckpt_dir: str, shape=None, kernel_check=None,
                 log=print) -> dict:
    """Golden, failure and recover (module docstring) for ``cfg`` on
    ``device`` at ``shape`` (default the smoke shape), inside a default
    process group of one rank. ``kernel_check(xb, rows, label)``, where
    given, is called after the resume on the packed f32 buffer of the
    largest group of the restored save's moments, as emitted at its step
    (the buffer kernels 2-4 compressed); its launches are not the path's.
    Returns the result dict (the JAX scenario's keys and more); raises
    AssertionError on a gate."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import base as configs
    from repro_torch.core import host, pytree
    from repro_torch.core.session import InSituPlan, Session
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T

    tool = _family_tool()
    dev = host.resolve_device(device)
    shape = shape if shape is not None else configs.SMOKE_SHAPE
    on_card = dev.type == "cuda"
    if dist.get_world_size() != 1:
        raise ValueError("the scenario steps on one device: run it in a "
                         "world-size-1 group (world_of_one)")
    mesh = DeviceMesh(dev.type, torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    step_cfg = T.StepConfig()
    keys, rows, groups = tool.lossy_layout(cfg)
    n_lossy, n_groups = len(keys), len(groups)
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    out: dict = {"arch": cfg.name, "n_layers": cfg.n_layers,
                 "shape": [shape.global_batch, shape.seq_len],
                 "moment_leaves": n_lossy, "groups": n_groups, "part_s": {}}
    t_all = time.perf_counter()

    # the live state: one set of tensors for all three runs (a captured
    # step's static buffers), filled from `initial` or the restore
    initial = T.init_state(cfg, 0, step_cfg.opt, device="cpu")
    state = pytree.tree_map(lambda t: t.to(dev, copy=True), initial)

    def fill(src) -> None:
        by_key = {pytree.keystr(p): t
                  for p, t in pytree.flatten_with_path(src)}
        with torch.no_grad():
            for p, dst in pytree.flatten_with_path(state):
                dst.copy_(by_key[pytree.keystr(p)])

    t0 = time.perf_counter()
    if on_card:
        step_fn = T.graph_train_step(cfg, step_cfg, state,
                                     synth_batch(cfg, shape, 0))
    else:
        eager = T.inplace_train_step(cfg, step_cfg, state)
        step_fn = lambda b: eager({k: torch.from_numpy(v).to(dev)
                                   for k, v in b.items()})
    out["part_s"]["capture"] = time.perf_counter() - t0
    tool.reset_launches()

    def step(i: int) -> float:
        return float(step_fn(synth_batch(cfg, shape, i))["loss"])

    def check_save_launches(what: str, got: dict, saves: int) -> None:
        """A HYBRID save launches kernels 2-4 once a packed group on the
        card and nothing else; the CPU launches nothing."""
        for k, n in got.items():
            want = (saves * n_groups if on_card and k in SAVE_KERNELS
                    else 0)
            if n != want:
                raise AssertionError(f"{what}: save launches {got}: {k} {n}"
                                     f" != {want} ({saves} saves x "
                                     f"{n_groups} groups)")

    # -- golden: the non-failed run ------------------------------------------
    t0 = time.perf_counter()
    golden = [step(i) for i in range(steps)]
    out["part_s"]["golden"] = time.perf_counter() - t0
    out["launches_golden"] = tool.launches()
    if any(out["launches_golden"].values()):
        raise AssertionError(f"golden run launches {out['launches_golden']}")
    log(f"golden: losses {golden}")

    # -- failure: fault preset + checkpoints; host 1 dies at fail_at ---------
    now = [0.0]
    ckpt_task = _ckpt_task(ckpt_dir, dev, ckpt_every)
    plan, emitted = _failure_plan(ckpt_task, ckpt_every, grace_s)
    fill(initial)
    tool.reset_launches()
    detect_step, failed, failure = None, [], []
    t0 = time.perf_counter()
    with Session(plan, clock=lambda: now[0], raise_on_error=True) as session:
        session.set_checkpoint_meta({"arch": cfg.name}, mesh=mesh)
        ctrl = session.fault_controller()
        for i in range(steps):
            now[0] += 1.0
            with session.step_span(i):
                failure.append(step(i))
            session.emit("train_state", i, lambda s=state: s)
            beats = {0: 0.1}
            if i < fail_at:
                beats[1] = 0.1          # host 1 beats until it dies
            session.emit("health", i, {"hosts": beats})
            failed = ctrl.failed_hosts()
            if failed:
                detect_step = i         # halt: the mesh lost a host
                break
        t1 = time.perf_counter()
        session.wait_idle()
        out["failure_drain_s"] = time.perf_counter() - t1
    fail_report = session.report()
    out["part_s"]["failure"] = time.perf_counter() - t0
    tm = session.telemetry
    out["save_blocking_s"] = tool.ckpt_blocking_s(tm)
    out["probe_s"] = sum(sp.dt for sp in tm.spans("insitu-sync/probe"))
    out["failure_step_s"] = [sp.dt for sp in tm.spans("step/compute")]
    out["save_launches"] = tool.launches()
    saves = fail_report["checkpoint"]["saves"]
    log(f"failure: losses {failure}, host(s) {failed} failed at step "
        f"{detect_step}; {saves} saves {fail_report['checkpoint']}, "
        f"launches {out['save_launches']}")
    if failed != [1]:
        raise AssertionError(f"expected host 1 failed, got {failed}")
    if detect_step is None or detect_step < fail_at:
        raise AssertionError(f"detected at {detect_step} < {fail_at}")
    if fail_report["fault"]["alive_hosts"] != [0]:
        raise AssertionError(f"alive hosts {fail_report['fault']}")
    if failure != golden[:detect_step + 1]:
        raise AssertionError(f"failure run losses {failure} != golden "
                             f"{golden[:detect_step + 1]}")
    check_save_launches("failure", out["save_launches"], saves)

    # -- recover: elastic restore on the surviving rank(s), then resume ------
    resume_plan = InSituPlan(streams=["train_state"], workers=2,
                             tasks=[ckpt_task])
    resumed: dict[int, float] = {}
    tool.reset_launches()
    t0 = time.perf_counter()
    with Session(resume_plan, raise_on_error=True) as session:
        start, restored = session.restore(
            T.state_spec(cfg), elastic=True,
            make_shardings=lambda m: T.state_shardings(cfg, m))
        if on_card:
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["restore_launches"] = tool.launches()
        rm = session.remesh
        if rm.plan.new_device_count != 1:
            raise AssertionError(f"{rm.plan}: the resumed step runs on one "
                                 "device (the sharded step is item 5.3)")
        local = pytree.tree_map(lambda d: d.to_local(), restored)
        del restored
        if emitted.get("step") != start:
            raise AssertionError(f"restored step {start}, the probe kept "
                                 f"{emitted.get('step')}")
        out["restore_check"] = tool.check_restored(
            local, emitted["leaves"], f"killpoint step {start}")
        fill(local)
        del local
        tool.reset_launches()
        session.set_checkpoint_meta({"arch": cfg.name}, mesh=rm.mesh)
        for i in range(start + 1, steps):
            resumed[i] = step(i)
            session.emit("train_state", i, lambda s=state: s)
        session.wait_idle()
    resume_report = session.report()
    out["part_s"]["recover"] = time.perf_counter() - t0
    out["resume_launches"] = tool.launches()
    check_save_launches("resume", out["resume_launches"],
                        resume_report["checkpoint"]["saves"])
    log(f"recover: restored step {start} on {rm.plan} in "
        f"{out['restore_s']:.2f} s (launches {out['restore_launches']}), "
        f"{out['restore_check']}; resumed losses {resumed}")
    want = {k: (n_lossy if on_card and k == "dequant_idct" else 0)
            for k in out["restore_launches"]}
    if out["restore_launches"] != want:
        raise AssertionError(f"restore launches {out['restore_launches']} "
                             f"!= {want}")
    if start > detect_step:
        raise AssertionError(f"restored step {start} > detected "
                             f"{detect_step}")
    if not resumed or max(resumed) != steps - 1:
        raise AssertionError(f"resumed steps {sorted(resumed)} do not "
                             f"reach {steps - 1}")
    gaps = {i: abs(v - golden[i]) for i, v in resumed.items()}
    for i, gap in gaps.items():
        if not gap <= max(0.05, 0.02 * abs(golden[i])):
            raise AssertionError(f"step {i}: resumed loss {resumed[i]} vs "
                                 f"golden {golden[i]}")

    # -- kernels 2-5 against their plain versions on the save's buffers ------
    checks: dict = {}
    if kernel_check is not None:
        to_check = tool.checked_groups(rows, groups)
        for label, grp in to_check.items():
            g_rows = [rows[j] for j in grp]
            xb = ops._pack([host.to_tensor(emitted["leaves"][keys[j]], dev)
                            for j in grp], g_rows)
            checks[label] = kernel_check(xb, g_rows,
                                         f"killpoint {label} (step {start})")
            del xb
        tool.reset_launches()
    emitted.clear()
    out.update({
        "golden_losses": golden,
        "failure_losses": failure,
        "resumed_losses": resumed,
        "loss_gaps": gaps,
        "detect_step": detect_step,
        "restored_step": start,
        "failed_hosts": failed,
        "old_shape": list(rm.plan.old_shape),
        "new_shape": list(rm.plan.new_shape),
        "merge_factor": rm.plan.model_merge_factor,
        "saves": saves,
        "resume_saves": resume_report["checkpoint"]["saves"],
        "fault_report": {
            "failed_hosts": fail_report["fault"]["failed_hosts"],
            "alive_hosts": fail_report["fault"]["alive_hosts"]},
        "kernel_check": checks,
        "wall_s": time.perf_counter() - t_all,
    })
    return out


# ---------------------------------------------------------------------------
# the scenario across ranks: golden + failure on (2, 2), resume on (1, 2)
# ---------------------------------------------------------------------------

#: the scenario's numbers (the JAX driver's defaults)
SCENARIO = dict(steps=9, fail_at=4, ckpt_every=2, grace_s=2.5)


def _rank_setup(device: str, layers: int):
    """This rank's device, config and shape: the card's device 0 (every
    rank shares it) at full width and ``layers`` blocks, or the CPU at
    the smoke config."""
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.launch import train as T

    if device == "cpu":
        return (torch.device("cpu"), configs.get(ARCH, smoke=True),
                configs.SMOKE_SHAPE)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=layers)
    return torch.device("cuda", 0), cfg, T.FULL_SHAPE


#: the step of the across-ranks scenario and of the sharded step's checks
#: (``tools/torch_shard_step.py``, ``tests/test_torch_shard_step.py``):
#: the peak rate from the first step (no warm-up), f32 masters, and an eps
#: far above every gradient element, so that AdamW's update is about the
#: clipped gradient itself and every step moves the parameters (at the
#: default warm-up the first rate is 0 and the second 3e-6, under half a
#: bf16 ulp: nothing would move, and a resume from another step's state
#: would give the same losses); no weight decay
CHECK_STEP = {"lr_peak": 1.0, "lr_warmup": 0,
              "opt": {"master_weights": True, "eps": 1.0,
                      "weight_decay": 0.0}}


def check_step_config():
    """:data:`CHECK_STEP` as the port's ``StepConfig``."""
    from repro_torch import optim
    from repro_torch.launch import train as T

    return T.StepConfig(lr_peak=CHECK_STEP["lr_peak"],
                        lr_warmup=CHECK_STEP["lr_warmup"],
                        opt=optim.AdamWConfig(**CHECK_STEP["opt"]))


def _placed_batch(cfg, shape, i, dev, mesh, b_sh):
    import torch
    from repro_torch.distributed.sharding import distribute_tree

    return distribute_tree({k: torch.from_numpy(v).to(dev) for k, v in
                            synth_batch(cfg, shape, i).items()}, mesh, b_sh)


def run_killpoint_rank(d: str, *, device: str = "cpu", layers: int = 0
                       ) -> dict:
    """Golden and failure on this rank of a world of four, a (2, 2)
    ('data', 'model') mesh (module docstring). Rank 0 writes the host copy
    of the state at the newest save step to ``d/kept.pt``; returns its
    part of the result (other ranks: their losses)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import pytree
    from repro_torch.core.session import Session
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.launch import train as T

    tool = _family_tool()
    sc = SCENARIO
    dev, cfg, shape = _rank_setup(device, layers)
    rank = dist.get_rank()
    if dist.get_world_size() != 4:
        raise ValueError("the failure half runs on a world of four ranks")
    mesh = DeviceMesh(dev.type, torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    step_cfg = check_step_config()
    step, st_sh, b_sh, _ = T.jit_train_step(cfg, mesh, step_cfg, shape)
    initial = T.init_state(cfg, 0, step_cfg.opt, device="cpu")
    fresh = lambda: distribute_tree(pytree.tree_map(
        lambda t: t.to(dev, copy=True), initial), mesh, st_sh)
    batch = lambda i: _placed_batch(cfg, shape, i, dev, mesh, b_sh)
    out: dict = {"part_s": {}}

    t0 = time.perf_counter()
    state = fresh()
    golden = []
    for i in range(sc["steps"]):
        state, m = step(state, batch(i))
        golden.append(float(m["loss"]))
    out["part_s"]["golden"] = time.perf_counter() - t0

    now = [0.0]
    plan, emitted = _failure_plan(
        _ckpt_task(os.path.join(d, "ck"), dev, sc["ckpt_every"]),
        sc["ckpt_every"], sc["grace_s"])
    state = fresh()
    tool.reset_launches()
    failure, failed, detect = [], [], None
    t0 = time.perf_counter()
    # rank 0 alone runs the session; the others step and gather
    with (Session(plan, clock=lambda: now[0], raise_on_error=True)
          if rank == 0 else contextlib.nullcontext()) as session:
        if session is not None:
            session.set_checkpoint_meta({"arch": cfg.name}, mesh=mesh)
            ctrl = session.fault_controller()
        for i in range(sc["steps"]):
            now[0] += 1.0
            state, m = step(state, batch(i))
            failure.append(float(m["loss"]))
            if i % sc["ckpt_every"] == 0:
                # a collective: every rank, on the loop thread
                full = T.gather_state(state)
                if session is not None:
                    session.emit("train_state", i, full)
                del full
            halt = torch.zeros((), dtype=torch.int32, device=dev)
            if session is not None:
                beats = {0: 0.1}
                if i < sc["fail_at"]:
                    beats[1] = 0.1          # host 1 beats until it dies
                session.emit("health", i, {"hosts": beats})
                failed = ctrl.failed_hosts()
                halt.fill_(int(bool(failed)))
            if int(sharding.all_reduce(halt, "max", dist.group.WORLD)):
                detect = i
                break
        if session is not None:
            session.wait_idle()
    out["part_s"]["failure"] = time.perf_counter() - t0
    out.update(golden_losses=golden, failure_losses=failure,
               detect_step=detect, save_launches=tool.launches(),
               groups=len(tool.lossy_layout(cfg)[2]),
               wire=sharding.wire.as_dict())
    if session is not None:
        rep = session.report()
        out.update(failed_hosts=failed, saves=rep["checkpoint"]["saves"],
                   fault_report={
                       "failed_hosts": rep["fault"]["failed_hosts"],
                       "alive_hosts": rep["fault"]["alive_hosts"]})
        torch.save(emitted, os.path.join(d, "kept.pt"))
    return out


def run_resume_rank(d: str, *, device: str = "cpu", layers: int = 0
                    ) -> dict:
    """This rank of a new world of two: ``restore(elastic=True)`` of the
    failure run's newest checkpoint onto the surviving ranks' mesh, the
    restore held against the kept host copy, then the resume with the
    sharded step on that mesh (rank 0 saving)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.session import InSituPlan, Session
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as T

    tool = _family_tool()
    sc = SCENARIO
    dev, cfg, shape = _rank_setup(device, layers)
    rank = dist.get_rank()
    step_cfg = check_step_config()
    master = step_cfg.opt.master_weights
    plan = InSituPlan(streams=["train_state"], workers=2, tasks=[
        _ckpt_task(os.path.join(d, "ck"), dev, sc["ckpt_every"])])
    out: dict = {}
    resumed: dict = {}
    tool.reset_launches()
    t0 = time.perf_counter()
    with Session(plan, raise_on_error=True) as session:
        start, state = session.restore(
            T.state_spec(cfg, master=master), elastic=True,
            make_shardings=lambda m: T.state_shardings(cfg, m,
                                                       master=master))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["restore_launches"] = tool.launches()
        rm = session.remesh
        full = T.gather_state(state)
        if rank == 0:
            kept = torch.load(os.path.join(d, "kept.pt"), weights_only=False)
            if kept.get("step") != start:
                raise AssertionError(f"restored step {start}, the failure "
                                     f"run kept {kept.get('step')}")
            out["restore_check"] = tool.check_restored(
                full, kept["leaves"], f"killpoint step {start}")
            session.set_checkpoint_meta({"arch": cfg.name}, mesh=rm.mesh)
        del full
        step, _, b_sh, _ = T.jit_train_step(cfg, rm.mesh, step_cfg, shape)
        tool.reset_launches()
        for i in range(start + 1, sc["steps"]):
            state, m = step(state, _placed_batch(cfg, shape, i, dev,
                                                 rm.mesh, b_sh))
            resumed[i] = float(m["loss"])
            if i % sc["ckpt_every"] == 0:
                full = T.gather_state(state)
                if rank == 0:
                    session.emit("train_state", i, full)
                del full
        session.wait_idle()
        rep = session.report()
    out.update(restored_step=start, resumed_losses=resumed,
               old_shape=list(rm.plan.old_shape),
               new_shape=list(rm.plan.new_shape),
               merge_factor=rm.plan.model_merge_factor,
               coord=rm.mesh.get_coordinate(),
               resume_saves=rep["checkpoint"]["saves"],
               resume_launches=tool.launches(),
               recover_s=time.perf_counter() - t0,
               wire=sharding.wire.as_dict())
    return out


RANKS = os.path.join(ROOT, "tests", "torch_shard_ranks.py")


def _ranks(phase: str, world: int, d: str, device: str, layers: int,
           deadline: float) -> None:
    import subprocess

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, RANKS, "--phase", phase, "--rank", str(r),
         "--world", str(world), "--dir", d, "--device", device,
         "--layers", str(layers)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=max(1.0, deadline -
                                               time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"{phase} rank {r} exited "
                                     f"{p.returncode}: {out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_across_ranks(d: str, *, device: str = "cpu", layers: int = 0,
                     timeout_s: float = 120.0) -> dict:
    """The scenario on four ranks, then two (module docstring), in
    ``d`` (emptied first); returns rank 0's merged result and raises
    AssertionError on a gate (the JAX scenario's, and the failure run
    equal to golden up to the halt, the restore against the kept copy)."""
    if os.path.exists(d):
        shutil.rmtree(d)
    os.makedirs(d)
    deadline = time.monotonic() + timeout_s
    t0 = time.perf_counter()
    _ranks("killpoint", 4, d, device, layers, deadline)
    t1 = time.perf_counter()
    _ranks("resume", 2, d, device, layers, deadline)
    out: dict = {}
    for phase in ("killpoint", "resume"):
        with open(os.path.join(d, f"killpoint_{phase}.json")) as f:
            out.update(json.load(f))
    out["resumed_losses"] = {int(k): v for k, v in
                             out["resumed_losses"].items()}
    out["part_s"].update(recover=time.perf_counter() - t1,
                         failure_world=t1 - t0)
    sc = SCENARIO
    golden, detect = out["golden_losses"], out["detect_step"]
    if out["failed_hosts"] != [1]:
        raise AssertionError(f"expected host 1 failed: {out['failed_hosts']}")
    if out["fault_report"]["alive_hosts"] != [0]:
        raise AssertionError(f"alive hosts {out['fault_report']}")
    if detect is None or detect < sc["fail_at"]:
        raise AssertionError(f"detected at {detect} < {sc['fail_at']}")
    if out["failure_losses"] != golden[:detect + 1]:
        raise AssertionError(f"failure run {out['failure_losses']} != "
                             f"golden {golden[:detect + 1]}")
    if out["restored_step"] > detect:
        raise AssertionError(f"restored step {out['restored_step']} > "
                             f"detected {detect}")
    resumed = out["resumed_losses"]
    if not resumed or max(resumed) != sc["steps"] - 1:
        raise AssertionError(f"resumed steps {sorted(resumed)}")
    out["loss_gaps"] = {i: abs(v - golden[i]) for i, v in resumed.items()}
    for i, gap in out["loss_gaps"].items():
        if not gap <= max(0.05, 0.02 * abs(golden[i])):
            raise AssertionError(f"step {i}: resumed {resumed[i]} vs "
                                 f"golden {golden[i]}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=30,
                    help="blocks of smollm-135m's 30 (widths unchanged)")
    ap.add_argument("--steps", type=int, default=9)
    ap.add_argument("--fail-at", type=int, default=4)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--grace-s", type=float, default=2.5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; FULL_SHAPE) or cpu (the "
                         "smoke config and shape)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        ROOT, "build", "killpoint_ckpt"))
    ap.add_argument("--world", type=int, choices=[1, 4], default=1,
                    help="1: one process; 4: the (2, 2) -> (1, 2) "
                         "scenario across ranks (the scenario's default "
                         "steps, fail-at, every and grace)")
    ap.add_argument("--timeout-s", type=float, default=900.0,
                    help="--world 4: the deadline of both worlds")
    args = ap.parse_args()

    import torch
    from repro_torch.configs import base as configs
    from repro_torch.launch import train as T

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_fault_killpoint: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_card:
        cfg = dataclasses.replace(configs.get(ARCH), n_layers=args.layers)
        shape = T.FULL_SHAPE
    else:
        cfg, shape = configs.get(ARCH, smoke=True), configs.SMOKE_SHAPE
    result: dict = {}
    if on_card:
        result["card"] = _family_tool().card()
        print(result["card"], flush=True)
    t0 = time.perf_counter()
    try:
        if args.world == 4:
            result.update(run_across_ranks(
                args.ckpt_dir, device="cuda" if on_card else "cpu",
                layers=args.layers if on_card else 0,
                timeout_s=args.timeout_s))
        else:
            with world_of_one(os.path.join(ROOT, "build"),
                              "nccl" if on_card else "gloo"):
                result.update(run_scenario(
                    cfg, args.device, args.steps, args.fail_at,
                    args.ckpt_every, args.grace_s, ckpt_dir=args.ckpt_dir,
                    shape=shape, log=lambda m: print(m, flush=True)))
        rc = 0
    except AssertionError as e:
        result.update(fault="gate", message=str(e)[:2000])
        rc = 1
    result["command_s"] = time.perf_counter() - t0
    print("KILLPOINT_RESULT " + json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
