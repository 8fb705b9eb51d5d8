"""Kill-point: a host stops beating, the run halts, restores elastically, resumes

    python3 tools/torch_fault_killpoint.py [--layers 30] [--steps 9]
        [--fail-at 4] [--ckpt-every 2] [--grace-s 2.5] [--device cuda]

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
the golden run's batches. The process runs in a world-size-1 group (NCCL
on the card, gloo on the CPU; a ``FileStore`` under ``build/``). One mesh
device, so the resumed step takes the DTensors' local tensors; the step
sharded across processes is ROADMAP item 5.3. On CUDA one captured train
step (``graph_train_step``) serves all three runs: each run fills its
static state tensors first (the initial weights, then the restored
checkpoint), so no collective and no second capture runs.

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
it at the smoke config on the CPU.
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
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import base as configs
    from repro_torch.core import host, pytree
    from repro_torch.core.session import (Every, InSituPlan, Placement,
                                          Session, TaskSpec, When)
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
    emitted: dict = {}

    def keep(st, payload):
        # the host copy of the state at each save step (the newest kept):
        # what the restore is held against
        emitted.clear()
        emitted.update({"step": st, "leaves": {
            pytree.keystr(p): np.asarray(a)
            for p, a in pytree.flatten_with_path(payload)}})

    ckpt_task = TaskSpec(name="checkpoint", stream="train_state",
                         preset="checkpoint", trigger=Every(ckpt_every),
                         placement=Placement.HYBRID,
                         options={"directory": ckpt_dir, "device": str(dev)})
    plan = InSituPlan(streams=["train_state", "health"], workers=2, tasks=[
        ckpt_task,
        TaskSpec(name="fault", stream="health", preset="fault",
                 trigger=Every(1), placement=Placement.SYNC, pipelined=False,
                 options={"hosts": [0, 1], "grace_s": grace_s}),
        TaskSpec(name="probe", stream="train_state",
                 trigger=When(lambda st: st % ckpt_every == 0),
                 placement=Placement.SYNC, sink=keep)])
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
        with world_of_one(os.path.join(ROOT, "build"),
                          "nccl" if on_card else "gloo"):
            result.update(run_scenario(
                cfg, args.device, args.steps, args.fail_at, args.ckpt_every,
                args.grace_s, ckpt_dir=args.ckpt_dir, shape=shape,
                log=lambda m: print(m, flush=True)))
        rc = 0
    except AssertionError as e:
        result.update(fault="gate", message=str(e)[:2000])
        rc = 1
    result["command_s"] = time.perf_counter() - t0
    print("KILLPOINT_RESULT " + json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
