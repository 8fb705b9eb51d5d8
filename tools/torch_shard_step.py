"""The train step sharded across two processes that share one card

    python3 tools/torch_shard_step.py [--arch smollm-135m] [--layers N]
        [--rows 4] [--steps 3]

Two child processes (``--rank 0|1``) form a gloo world of two on the
card's device 0 (NCCL refuses two ranks on one device; the collectives
stage through host buffers, ``distributed/sharding.py``) and run
``launch.train.jit_train_step`` eagerly for ``--arch`` at full width
(``--layers`` of its blocks, all by default; widths unchanged) on
``--rows`` rows of 4096 tokens (``FULL_SHAPE``'s 4 by default), seed 0,
on each mesh of :data:`MESHES` (``bench_meshes``: the pod mesh at
smollm-135m only):

  1x2            (1, 2) over ('data', 'model'), the default rules: the
                 parameters sharded over 'model', each block gathered
                 whole inside its remat region (twice a step: the
                 forward and the recompute), the rows on both ranks;
  pod2x1x1_int8  (2, 1, 1) over ('pod', 'data', 'model') with the int8
                 pod ring and error feedback: half the rows a rank.

``--arch granite-3-2b --rows 2`` is the case whose blocks (40 of 61 M
parameters) dominate its memory, where gathering block by block shows.

Per step: the wall time between barriers (the card synchronised), the
bytes each rank staged through host buffers and handed to gloo, the ring's
int8 wire bytes, the loss; per mesh the peak memory each process held on
the card. Rank 0 then times the one-process step (``make_train_step``
without a mesh) on the same state and batches, rank 1 idle. Prints the
card's name and power limit, then one line ``SHARD_STEP_RESULT {json}``.

``--phase smoke`` is ``chip_smoke.py``'s ``shard`` phase (:func:`run_pair`
with ``mode="smoke"``; 2 layers there): (a) 2 steps on (1, 2) under
the kill-point tool's ``CHECK_STEP`` (a rate that moves the parameters
from the first step, f32 masters) held against the one-process step, (b) 2 steps on (2, 1, 1) under int8, the ring held
bit for bit against ``int8_ring_mean_plain`` on every leaf and its wire
bytes asserted, (c) a HYBRID save of (a)'s gathered state (masters
included) by rank 0
(kernels 2-4), ``restore(elastic=True)`` on both ranks (kernel 5) and one
resumed sharded step, the kernels held against their plain versions on
the save's largest packed group.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "smollm-135m"
#: name -> (mesh sizes, axis names, grad_compress)
MESHES = {
    "1x2": ((1, 2), ("data", "model"), "none"),
    "pod2x1x1_int8": ((2, 1, 1), ("pod", "data", "model"), "int8"),
}
#: the sharded step against the one-process step on the card, (1, 2):
#: every rank runs the one-process step's operations on gathered
#: parameters and the same rows, so only the card's own nondeterminism
#: (atomics in the embedding backward) may separate them. A parameter or
#: master leaf is held by its change from the initial state, |d - d_one|
#: over |d_one| (L2 over the leaf), a moment leaf by its largest |error|
#: over the leaf's largest |value|
ONE_LOSS_ATOL = 1e-5
ONE_NORM_RTOL = 1e-3
ONE_CHANGE_RTOL = {"params": 0.1, "master": 0.03}
ONE_MOMENT_SHARE = 5e-2
SMOKE_STEPS = 2


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _family_tool():
    return _load("torch_family_train", os.path.join(HERE,
                                                    "torch_family_train.py"))


@functools.cache
def _killpoint_tool():
    """``tools/torch_fault_killpoint.py``: this rank's device, config and
    shape (``_rank_setup``), step ``i``'s batch (``_placed_batch``, the
    JAX scenario's ``synth_batch``) and the checks' step
    (``check_step_config``)."""
    return _load("torch_fault_killpoint",
                 os.path.join(HERE, "torch_fault_killpoint.py"))


def _placed(state, dev, mesh, shardings):
    """``state`` (host tensors, whole) as DTensors on ``mesh`` under
    ``shardings``: each rank's shard taken on the host and copied to
    ``dev`` alone, so no whole leaf reaches the card (a copy even on the
    CPU: the step writes its new state into the placed tensors)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.core.pytree import tree_map
    from repro_torch.distributed.sharding import local_shard

    return tree_map(lambda t, pl: DTensor.from_local(
        local_shard(t, pl, mesh).to(dev, copy=True,
                                    memory_format=torch.contiguous_format),
        mesh, list(pl), run_check=False, shape=t.shape, stride=t.stride()),
        state, shardings)


def _batch(cfg, shape, i: int, dev, mesh=None, b_sh=None):
    """Step ``i``'s batch on ``dev``, placed under ``b_sh`` on ``mesh``
    where given."""
    import torch

    if mesh is not None:
        return _killpoint_tool()._placed_batch(cfg, shape, i, dev, mesh,
                                               b_sh)
    return {k: torch.from_numpy(v).to(dev) for k, v in
            _killpoint_tool().synth_batch(cfg, shape, i).items()}


def _mesh(name: str, dev):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    sizes, axes, _ = MESHES[name]
    return DeviceMesh(dev.type, torch.arange(2).reshape(sizes),
                      mesh_dim_names=axes)


def _initial(cfg, n_pods: int, ef: bool, step_cfg=None) -> dict:
    import torch
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch import train as T

    opt = (step_cfg or T.StepConfig()).opt
    state = T.init_state(cfg, 0, opt, device="cpu")
    if ef:
        state["ef"] = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                               T.state_spec(cfg, ef_pods=n_pods)["ef"])
    return state


def _flat(tree) -> dict:
    from repro_torch.core.pytree import flatten_with_path, keystr
    return {keystr(p): t for p, t in flatten_with_path(tree)}


def _hold_one_device(got: dict, want: dict, init: dict, losses,
                     want_losses, norms, want_norms) -> dict:
    """The sharded step's gathered state and metrics against the
    one-process step's, both from ``init``, within the module's bounds;
    returns the largest differences (each over its bound) and whether all
    is bitwise."""
    import numpy as np
    import torch

    out = {"loss_max_abs": float(np.max(np.abs(np.subtract(losses,
                                                            want_losses)))),
           "norm_max_rel": float(np.max(np.abs(np.subtract(norms, want_norms))
                                        / np.abs(want_norms)))}
    assert out["loss_max_abs"] <= ONE_LOSS_ATOL, (losses, want_losses)
    assert out["norm_max_rel"] <= ONE_NORM_RTOL, (norms, want_norms)
    bitwise = True
    worst = {}
    for k, w in want.items():
        g = got[k]
        bitwise = bitwise and torch.equal(g, w)
        kind = k.split("]")[0][2:-1]
        if kind not in ("params", "master", "mu", "nu"):
            assert torch.equal(g, w), k
            continue
        g32, w32 = g.float(), w.float()
        err = (g32 - w32).abs()
        if kind in ("params", "master"):
            x0 = init[k].to(w.device).float()
            scale = float(torch.linalg.vector_norm(w32 - x0))
            assert scale > 0, (k, "the one-process step left it as it was")
            ratio = float(torch.linalg.vector_norm(g32 - w32)) / (
                scale * ONE_CHANGE_RTOL[kind])
        else:
            ratio = float(err.max() / (ONE_MOMENT_SHARE * w32.abs().max()
                                       + 1e-30))
        assert ratio <= 1.0, (k, float(err.max()))
        worst[kind] = max(worst.get(kind, 0.0), ratio)
    out.update(bitwise=bitwise, worst_of_bound=worst)
    return out


# ---------------------------------------------------------------------------
# per rank
# ---------------------------------------------------------------------------

def bench_setup(arch: str, layers: int, rows: int):
    """This rank's device (the card's device 0, every rank shares it),
    ``arch``'s config at full width and ``layers`` blocks (0: all) and the
    shape of ``rows`` rows of ``FULL_SHAPE``'s 4096 tokens."""
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.launch import train as T

    cfg = configs.get(arch)
    if cfg.frontend is not None:
        raise ValueError(f"{arch}: a frontend arch's batch needs its prefix "
                         f"embeddings, which this tool does not draw")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = dataclasses.replace(T.FULL_SHAPE, name=f"train_4k_b{rows}",
                                global_batch=rows)
    return torch.device("cuda", 0), cfg, shape


def bench_meshes(arch: str) -> tuple:
    """The meshes of :data:`MESHES` that ``arch``'s bench runs. On the pod
    mesh each rank holds the whole state and its error-feedback residual
    ('pod' replicates them), two copies on one card: that fits at
    smollm-135m, not at an arch of billions of parameters, which runs
    (1, 2) alone."""
    return tuple(MESHES) if arch == ARCH else ("1x2",)


def bench_rank(arch: str, layers: int, rows: int, steps: int) -> dict:
    """``--steps`` timed steps on each mesh, then (rank 0) the
    one-process step."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as T
    from repro_torch.optim import grad_compress as gc

    dev, cfg, shape = bench_setup(arch, layers, rows)
    rank = dist.get_rank()
    out: dict = {"arch": cfg.name, "n_layers": cfg.n_layers,
                 "shape": [shape.global_batch, shape.seq_len], "meshes": {}}
    for name in bench_meshes(arch):
        mesh = _mesh(name, dev)
        sc = T.StepConfig(grad_compress=MESHES[name][2])
        step, st_sh, b_sh, ef = T.jit_train_step(cfg, mesh, sc, shape)
        state = _placed(_initial(cfg, MESHES[name][0][0], ef), dev, mesh,
                        st_sh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"step_s": [], "staged_bytes": [], "sent_bytes": [],
               "int8_bytes": [], "losses": []}
        for i in range(steps):
            batch = _batch(cfg, shape, i, dev, mesh, b_sh)
            sharding.wire.reset()
            gc.wire.reset()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            dist.barrier()
            rec["step_s"].append(time.perf_counter() - t0)
            rec["staged_bytes"].append(sharding.wire.bytes["staged"])
            rec["sent_bytes"].append(sharding.wire.bytes["sent"])
            rec["int8_bytes"].append(gc.wire.bytes["int8"])
            rec["losses"].append(loss)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["meshes"][name] = rec
        del state, step, batch
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        step = T.make_train_step(cfg, T.StepConfig())
        state = T.init_state(cfg, 0, T.StepConfig().opt, device=dev)
        torch.cuda.reset_peak_memory_stats()
        rec = {"step_s": [], "losses": []}
        for i in range(steps):
            batch = _batch(cfg, shape, i, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            rec["losses"].append(float(m["loss"]))
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["one_process"] = rec
        del state, step
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def smoke_rank(layers: int, ckpt_dir: str, kernel_check=None,
               device: str = "cuda") -> dict:
    """(a), (b) and (c) of the module docstring on this rank (``device``
    ``cpu``: the smoke config, no kernels)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import host
    from repro_torch.core.pytree import leaves, tree_map
    from repro_torch.core.session import (Every, InSituPlan, Placement,
                                          Session, TaskSpec)
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.optim import grad_compress as gc

    tool = _family_tool()
    dev, cfg, shape = _killpoint_tool()._rank_setup(device, layers)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rank = dist.get_rank()
    out: dict = {"rank": rank, "part_s": {}}

    # -- (a) (1, 2): against the one-process step ----------------------------
    t0 = time.perf_counter()
    mesh = _mesh("1x2", dev)
    sc_a = _killpoint_tool().check_step_config()
    step, st_sh, b_sh, _ = T.jit_train_step(cfg, mesh, sc_a, shape)
    initial = _initial(cfg, 1, False, sc_a)
    state = _placed(initial, dev, mesh, st_sh)
    losses, norms = [], []
    sharding.wire.reset()
    for i in range(SMOKE_STEPS):
        state, m = step(state, _batch(cfg, shape, i, dev, mesh, b_sh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["a_wire"] = sharding.wire.as_dict()
    full_a = T.gather_state(state)
    del state
    if rank == 0:
        one = T.make_train_step(cfg, sc_a)
        ostate = tree_map(lambda t: t.to(dev, copy=True), initial)
        o_losses, o_norms = [], []
        for i in range(SMOKE_STEPS):
            ostate, m = one(ostate, _batch(cfg, shape, i, dev))
            o_losses.append(float(m["loss"]))
            o_norms.append(float(m["grad_norm"]))
        out["a"] = {"losses": losses, "one_process_losses": o_losses,
                    "grad_norms": norms, "one_process_grad_norms": o_norms,
                    **_hold_one_device(_flat(full_a), _flat(ostate),
                                       _flat(initial), losses,
                                       o_losses, norms, o_norms)}
        del ostate, one
    dist.barrier()
    out["part_s"]["a"] = time.perf_counter() - t0

    # -- (b) (2, 1, 1) int8: the ring bit for bit, its wire bytes ------------
    t0 = time.perf_counter()
    mesh_b = _mesh("pod2x1x1_int8", dev)
    sc = T.StepConfig(grad_compress="int8")
    step_b, st_b, bb_sh, ef = T.jit_train_step(cfg, mesh_b, sc, shape)
    state = _placed(_initial(cfg, 2, ef), dev, mesh_b, st_b)
    ring = {"leaves": 0, "differ": [], "max_abs_err": 0.0,
            "probe_staged": 0}
    pod = mesh_b.get_group(step_b.pod_dim)

    def probe(keys, pre, reduced):
        staged = sharding.wire.bytes["staged"]
        for k, x, r in zip(keys, pre, reduced):
            xs = torch.stack(sharding.all_gather(x.float(), pod))
            want = gc.int8_ring_mean_plain(xs).to(r.dtype)
            ring["leaves"] += 1
            err = float((want.float() - r.float()).abs().max())
            ring["max_abs_err"] = max(ring["max_abs_err"], err)
            if not torch.equal(want, r):
                ring["differ"].append(k)
        # the check's own gathers are not the step's
        ring["probe_staged"] += sharding.wire.bytes["staged"] - staged

    step_b.ring_probe = probe
    gc.wire.reset()
    sharding.wire.reset()
    b_losses = []
    for i in range(SMOKE_STEPS):
        state, m = step_b(state, _batch(cfg, shape, i, dev, mesh_b, bb_sh))
        b_losses.append(float(m["loss"]))
    numel = sum(t.to_local().numel() for t in leaves(state["params"]))
    n_leaves = len(leaves(state["params"]))
    out["b"] = {"losses": b_losses, "ring": ring,
                "wire": gc.wire.as_dict(),
                "collectives": sharding.wire.as_dict(),
                "step_staged": sharding.wire.bytes["staged"] - ring["probe_staged"],
                "int8_bytes_want": SMOKE_STEPS * numel}
    assert ring["leaves"] == SMOKE_STEPS * n_leaves, ring
    assert ring["differ"] == [], ring["differ"]
    assert gc.wire.bytes["int8"] == SMOKE_STEPS * numel, gc.wire.as_dict()
    assert gc.wire.calls["int8"] == SMOKE_STEPS * n_leaves
    assert all(math.isfinite(v) for v in b_losses), b_losses
    del state, step_b
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    out["part_s"]["b"] = time.perf_counter() - t0

    # -- (c) a HYBRID save of (a)'s state, the elastic restore, one step -----
    t0 = time.perf_counter()
    ck = ckpt_dir
    keys, rows, groups = tool.lossy_layout(cfg)
    task = TaskSpec(name="checkpoint", stream="train_state",
                    preset="checkpoint", trigger=Every(1),
                    placement=Placement.HYBRID,
                    options={"directory": ck, "device": str(dev)})
    plan = InSituPlan(streams=["train_state"], workers=2, tasks=[task])
    at = int(full_a["count"])
    emitted = {k: host.to_numpy(t.cpu()) for k, t in _flat(full_a).items()}
    if rank == 0:
        import shutil
        if os.path.exists(ck):
            shutil.rmtree(ck)
        tool.reset_launches()
        with Session(plan, raise_on_error=True) as s:
            s.set_checkpoint_meta({"arch": cfg.name}, mesh=mesh)
            s.emit("train_state", at, full_a)
            s.wait_idle()
        out["save_launches"] = tool.launches()
    del full_a
    dist.barrier()
    tool.reset_launches()
    t1 = time.perf_counter()
    with Session(plan, raise_on_error=True) as s:
        start, restored = s.restore(
            T.state_spec(cfg, master=True), elastic=True,
            make_shardings=lambda m: T.state_shardings(cfg, m, master=True))
        sync()
        out["restore_s"] = time.perf_counter() - t1
        out["restore_launches"] = tool.launches()
        rm = s.remesh
    assert start == at, (start, at)
    full = T.gather_state(restored)
    out["restore_check"] = tool.check_restored(full, emitted,
                                               f"shard step {at}")
    del full
    step_c, _, bc_sh, _ = T.jit_train_step(cfg, rm.mesh, sc_a, shape)
    tool.reset_launches()
    _, m = step_c(restored, _batch(cfg, shape, at, dev, rm.mesh, bc_sh))
    out["c"] = {"restored_step": start, "plan": [
        list(rm.plan.old_shape), list(rm.plan.new_shape),
        rm.plan.model_merge_factor], "resumed_loss": float(m["loss"]),
        "resume_launches": tool.launches()}
    assert math.isfinite(out["c"]["resumed_loss"])
    del restored, step_c
    if on_card:
        torch.cuda.empty_cache()
    out["part_s"]["c"] = time.perf_counter() - t0
    if rank == 0 and kernel_check is not None:
        checks = {}
        for label, grp in tool.checked_groups(rows, groups).items():
            g_rows = [rows[j] for j in grp]
            xb = ops._pack([host.to_tensor(emitted[keys[j]], dev)
                            for j in grp], g_rows)
            checks[label] = kernel_check(xb, g_rows,
                                         f"shard {label} (step {at})")
            del xb
        out["kernel_check"] = checks
        out["groups"], out["moment_leaves"] = len(groups), len(keys)
        tool.reset_launches()
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# the pair of processes
# ---------------------------------------------------------------------------

def run_pair(mode: str, *, layers: int, steps: int = 3,
             timeout_s: float = 900.0, device: str = "cuda",
             out_dir: str | None = None, log=print, arch: str = ARCH,
             rows: int = 4) -> list:
    """Runs both ranks (``mode``: ``bench`` or ``smoke``; ``device``
    ``cpu`` runs the smoke config without kernels; ``arch``, ``rows`` and
    ``meshes`` are the bench's) and returns their results, rank 0's
    first; raises ``RuntimeError`` when a rank fails or the deadline
    passes."""
    d = out_dir or os.path.join(ROOT, "build", "shard_step")
    os.makedirs(d, exist_ok=True)
    store = os.path.join(d, f"store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--phase", mode, "--layers", str(layers), "--steps", str(steps),
         "--store", store, "--device", device, "--arch", arch,
         "--rows", str(rows),
         "--out", os.path.join(d, f"{mode}_rank{r}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + timeout_s
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=max(1.0, deadline
                                                    - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"shard {mode}: rank {r} passed the "
                                   f"{timeout_s} s deadline")
            for ln in text.splitlines()[-20:]:
                log(f"shard {mode} rank {r}: {ln}")
            if p.returncode != 0:
                raise RuntimeError(f"shard {mode}: rank {r} exited "
                                   f"{p.returncode}: {text[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if os.path.exists(store):
            os.remove(store)
    res = []
    for r in range(2):
        with open(os.path.join(d, f"{mode}_rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def _child(args) -> int:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=2)
    try:
        ck = os.path.join(os.path.dirname(args.out), "smoke_ckpt")
        # the smoke's arch is smollm-135m, at every layer by default
        layers = args.layers or 30
        if args.phase == "smoke" and args.device == "cpu":
            out = smoke_rank(layers, ck, None, "cpu")
        elif args.phase == "smoke":
            smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
            out = smoke_rank(layers, ck, smoke._family_kernel_check)
        else:
            out = bench_rank(args.arch, args.layers, args.rows, args.steps)
        with open(args.out, "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH,
                    help="the bench's arch, at full width (not a frontend "
                         "arch)")
    ap.add_argument("--layers", type=int, default=0,
                    help="the bench's blocks (0: all of the arch's; "
                         "widths unchanged); --phase smoke: smollm-135m's")
    ap.add_argument("--rows", type=int, default=4,
                    help="the bench's rows of 4096 tokens (even: the pod "
                         "mesh splits them)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--phase", choices=["bench", "smoke"], default="bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or, for --phase smoke, cpu "
                         "(the smoke config)")
    ap.add_argument("--rank", type=int, default=None,
                    help="(internal) run one rank of the pair")
    ap.add_argument("--store", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        return _child(args)

    import torch

    if not torch.cuda.is_available():
        print("torch_shard_step: needs a CUDA card", file=sys.stderr)
        return 2
    card = _family_tool().card()
    print(card, flush=True)
    t0 = time.perf_counter()
    if args.phase == "smoke":
        # built once here: both ranks load the same library
        from repro_torch.kernels import _build
        _build.build(["spectral_lossy"])
    res = run_pair(args.phase, layers=args.layers, steps=args.steps,
                   log=lambda m: print(m, flush=True), arch=args.arch,
                   rows=args.rows)
    out = {"card": card, "ranks": res,
           "command_s": time.perf_counter() - t0}
    print("SHARD_STEP_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
