"""One rank of the port's sharded-step drills on CPU processes (gloo).

    python tests/torch_shard_ranks.py --phase cases --rank R --world W \\
        --dir DIR --cases CASES.json
    python tests/torch_shard_ranks.py --phase ring --rank R --world W \\
        --dir DIR
    python tests/torch_shard_ranks.py --phase wire --rank R --world W \\
        --dir DIR --cases CASES.json
    python tests/torch_shard_ranks.py --phase killpoint|resume --rank R \\
        --world W --dir DIR [--device cpu|cuda] [--layers N]
    python tests/torch_shard_ranks.py --phase scatter|remat --rank R \\
        --world W --dir DIR

``cases``: each case of ``CASES.json`` whose mesh has W devices
(``{"name", "arch", "mesh", "axes", "method", "steps", "step"}``, the
last ``StepConfig``'s rate and AdamW fields) runs
``launch.train.jit_train_step`` from the smoke config's state in
``DIR/init_<arch>.pt`` (the residual zeros of ``state_spec(ef_pods=n)``
under ``int8``) over the batches ``numpy.random.RandomState(1000 + i)``
draws; under the pod ring every leaf's reduction is held against both
pods' inputs on every step (``ring_check``).
Rank 0 writes ``DIR/port_<name>.pt``: losses, gradient norms, the final
state gathered whole, the ring's wire bytes and the bitwise checks.

``ring``: rank R of a world of W reduces row R of each array in
``DIR/ring_<W>.npz`` over the world with ``reduce_leaf`` under each
method (``int8`` also through ``int8_ring_mean`` itself) and writes
``DIR/ring_<W>_rank<R>.pt``, with the wire bytes of each call.

``wire``: one default step (``StepConfig(grad_compress=method)``) of each
case of ``CASES.json`` whose mesh has W devices (``{"name", "arch",
"mesh", "axes", "method", "seq", "remat"}``: the smoke config with that
``remat``, at the smoke shape's batch and ``seq`` tokens), from its
seed-0 state, under ``roofline.analysis.record_collectives`` with
``sharding.wire`` counted from 0; rank 0 writes ``DIR/wire_<W>.json``
(per case the recorded collectives and the wire counts), which
``tests/test_torch_dryrun.py`` holds the dry run's lowering to.

``scatter``: ``sharding.reduce_scatter`` of seeded f32 tensors (this
rank's seed) along dims 0 and 1 over a one-axis mesh of the world,
against ``all_reduce`` then ``local_shard``, under
``record_collectives`` and ``sharding.wire``; each rank writes
``DIR/scatter_<W>_rank<R>.json``.

``remat``: one ``CHECK_STEP`` step of the smollm smoke config on each
mesh of :data:`REMAT_MESHES` with the world's size, from the seed-0
state, with ``remat`` on and off (on: each block gathered again in the
backward's recompute; off: kept for the backward); rank 0 writes
``DIR/remat_<W>.json``: whether the states, losses and norms are equal
bit for bit, and each run's collectives by kind.

``killpoint`` (a world of 4, a (2, 2) mesh) and ``resume`` (a world of 2)
are the two halves of ``tools/torch_fault_killpoint.py``'s scenario
across ranks (:func:`run_killpoint_rank` / :func:`run_resume_rank`
there); rank 0 writes ``DIR/killpoint_<phase>.json``.

Imports no JAX. ``tests/test_torch_shard_step.py`` and
``tests/test_torch_fault.py`` start the ranks with a deadline.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def synth_batch(cfg, shape, step: int) -> dict:
    """The kill-point tool's ``synth_batch`` (``RandomState(1000 + step)``)
    as tensors."""
    import torch

    return {k: torch.from_numpy(v) for k, v in
            _killpoint_tool().synth_batch(cfg, shape, step).items()}


def ring_check(mesh, pod_dim: int, method: str, keys, pre, reduced,
               out: dict) -> None:
    """Every leaf's cross-pod reduction against the pods' inputs
    (gathered from the pod group): under ``int8`` ``int8_ring_mean_plain``
    bit for bit; under ``bf16`` its definition, the mean of the bf16
    operands within one bf16 rounding of their sum. Records the leaves
    that differ in ``out``."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.optim import grad_compress as gc

    group = mesh.get_group(pod_dim)
    for k, x, r in zip(keys, pre, reduced):
        xs = torch.stack(sharding.all_gather(x.float(), group))
        if method == "int8":
            amax = sharding.all_reduce(torch.amax(torch.abs(x.float())),
                                       "max", dist.group.WORLD)
            ok = torch.equal(gc.int8_ring_mean_plain(xs, amax).to(r.dtype),
                             r)
        else:
            ops = xs.to(torch.bfloat16).double()
            bound = 2.0 ** -8 * ops.abs().sum(0) / ops.shape[0]
            ok = bool(torch.all((r.double() - ops.mean(0)).abs() <= bound))
        out["leaves"] += 1
        if not ok:
            out["differ"].append(k)


def run_cases(args) -> None:
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import optim
    from repro_torch.configs import base as configs
    from repro_torch.core.pytree import (flatten_with_path, keystr, leaves,
                                         tree_map)
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.launch import train as T
    from repro_torch.optim import grad_compress as gc

    with open(args.cases) as f:
        cases = [c for c in json.load(f)
                 if int(torch.tensor(c["mesh"]).prod()) == args.world]
    for case in cases:
        cfg = configs.get(case["arch"], smoke=True)
        shape = configs.SMOKE_SHAPE
        mesh = DeviceMesh("cpu", torch.arange(args.world).reshape(
            case["mesh"]), mesh_dim_names=tuple(case["axes"]))
        st = case["step"]
        sc = T.StepConfig(grad_compress=case["method"],
                          lr_peak=st["lr_peak"], lr_warmup=st["lr_warmup"],
                          opt=optim.AdamWConfig(**st["opt"]))
        step, st_sh, b_sh, ef = T.jit_train_step(cfg, mesh, sc, shape)
        state = torch.load(os.path.join(args.dir,
                                        f"init_{case['arch']}.pt"))
        if ef:
            state["ef"] = tree_map(
                lambda t: torch.zeros(t.shape, dtype=t.dtype),
                T.state_spec(cfg, ef_pods=case["mesh"][0])["ef"])
        state = distribute_tree(state, mesh, st_sh)
        ring = {"leaves": 0, "differ": []}
        if step.use_ring:
            step.ring_probe = lambda k, x, r: ring_check(
                mesh, step.pod_dim, case["method"], k, x, r, ring)
        gc.wire.reset()
        losses, norms = [], []
        for i in range(case["steps"]):
            batch = distribute_tree(synth_batch(cfg, shape, i), mesh, b_sh)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        local_numel = sum(t.to_local().numel()
                          for t in leaves(state["params"]))
        full = T.gather_state(state)
        if args.rank == 0:
            torch.save({"loss": losses, "grad_norm": norms,
                        "state": {keystr(p): t for p, t in
                                  flatten_with_path(full)},
                        "wire": gc.wire.as_dict(), "ring": ring,
                        "param_local_numel": local_numel,
                        "use_ring": step.use_ring},
                       os.path.join(args.dir, f"port_{case['name']}.pt"))


def run_wire(args) -> None:
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import base as configs
    from repro_torch.core.pytree import tree_map
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.launch import train as T
    from repro_torch.roofline.analysis import record_collectives

    with open(args.cases) as f:
        cases = [c for c in json.load(f)
                 if int(torch.tensor(c["mesh"]).prod()) == args.world]
    out = {}
    for case in cases:
        cfg = dataclasses.replace(configs.get(case["arch"], smoke=True),
                                  remat=case["remat"])
        shape = dataclasses.replace(configs.SMOKE_SHAPE, seq_len=case["seq"])
        mesh = DeviceMesh("cpu", torch.arange(args.world).reshape(
            case["mesh"]), mesh_dim_names=tuple(case["axes"]))
        sc = T.StepConfig(grad_compress=case["method"])
        step, st_sh, b_sh, ef = T.jit_train_step(cfg, mesh, sc, shape)
        state = T.init_state(cfg, 0, sc.opt, device="cpu")
        if ef:
            state["ef"] = tree_map(
                lambda t: torch.zeros(t.shape, dtype=t.dtype),
                T.state_spec(cfg, ef_pods=case["mesh"][0])["ef"])
        state = distribute_tree(state, mesh, st_sh)
        batch = distribute_tree(synth_batch(cfg, shape, 0), mesh, b_sh)
        sharding.wire.reset()
        with record_collectives() as ops:
            step(state, batch)
        out[case["name"]] = {
            "ops": [[o.kind, o.dtype, list(o.shape), o.group_size,
                     o.wire_bytes, o.operand_bytes] for o in ops],
            "wire": sharding.wire.as_dict()}
    if args.rank == 0:
        with open(os.path.join(args.dir, f"wire_{args.world}.json"),
                  "w") as f:
            json.dump(out, f)


def run_scatter(args) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard
    from repro_torch.distributed import sharding
    from repro_torch.roofline.analysis import record_collectives

    w = args.world
    mesh = DeviceMesh("cpu", torch.arange(w), mesh_dim_names=("data",))
    gen = torch.Generator().manual_seed(args.rank)
    out = {}
    for name, shape, dim in (("rows", (4 * w, 6), 0),
                             ("cols", (3, 2 * w, 5), 1),
                             ("large", (40000 * w,), 0)):
        x = torch.randn(shape, generator=gen) * torch.exp(
            4 * torch.randn(shape, generator=gen))
        sharding.wire.reset()
        with record_collectives() as ops:
            got = sharding.reduce_scatter(x, dist.group.WORLD, dim)
        sent = sharding.wire.bytes["sent"]
        want = sharding.local_shard(
            sharding.all_reduce(x, "sum", dist.group.WORLD), (Shard(dim),),
            mesh)
        out[name] = {
            "equal": bool(torch.equal(got, want)),
            "shape": list(got.shape), "want_shape": list(want.shape),
            "contiguous": got.is_contiguous(),
            "ops": [[o.kind, list(o.shape), o.group_size, o.operand_bytes]
                    for o in ops],
            "sent": sent, "input_bytes": x.numel() * x.element_size()}
    with open(os.path.join(args.dir, f"scatter_{w}_rank{args.rank}.json"),
              "w") as f:
        json.dump(out, f)


#: the ``remat`` phase's meshes over ('data', 'model'), by world size
REMAT_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}


def run_remat(args) -> None:
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import base as configs
    from repro_torch.core.pytree import flatten_with_path, keystr
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.launch import train as T
    from repro_torch.roofline.analysis import record_collectives

    base_cfg = configs.get("smollm-135m", smoke=True)
    shape = configs.SMOKE_SHAPE
    sc = _killpoint_tool().check_step_config()
    out = {}
    for sizes in REMAT_MESHES[args.world]:
        mesh = DeviceMesh("cpu", torch.arange(args.world).reshape(sizes),
                          mesh_dim_names=("data", "model"))
        runs = {}
        for remat in (True, False):
            cfg = dataclasses.replace(base_cfg, remat=remat)
            step, st_sh, b_sh, _ = T.jit_train_step(cfg, mesh, sc, shape)
            state = distribute_tree(T.init_state(cfg, 0, sc.opt,
                                                 device="cpu"), mesh, st_sh)
            batch = distribute_tree(synth_batch(cfg, shape, 0), mesh, b_sh)
            with record_collectives() as ops:
                state, m = step(state, batch)
            kinds: dict = {}
            for o in ops:
                kinds[o.kind] = kinds.get(o.kind, 0) + 1
            runs[remat] = (float(m["loss"]), float(m["grad_norm"]),
                           {keystr(p): t for p, t in
                            flatten_with_path(T.gather_state(state))},
                           kinds)
        on, off = runs[True], runs[False]
        out["x".join(map(str, sizes))] = {
            "loss": [on[0], off[0]], "grad_norm": [on[1], off[1]],
            "differ": [k for k in on[2] if not torch.equal(on[2][k],
                                                           off[2][k])],
            "kinds": [on[3], off[3]]}
    if args.rank == 0:
        with open(os.path.join(args.dir, f"remat_{args.world}.json"),
                  "w") as f:
            json.dump(out, f)


def run_ring(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.optim import grad_compress as gc

    z = np.load(os.path.join(args.dir, f"ring_{args.world}.npz"))
    out = {}
    for name in z.files:
        x = torch.from_numpy(z[name][args.rank].copy())
        got = {}
        for method in gc.METHODS:
            gc.wire.reset()
            got[method] = gc.reduce_leaf(x, method=method,
                                         group=dist.group.WORLD,
                                         n=args.world)
            got[method + "_wire"] = gc.wire.as_dict()
        gc.wire.reset()
        got["ring"] = gc.int8_ring_mean(x, dist.group.WORLD, args.world)
        got["ring_wire"] = gc.wire.as_dict()
        out[name] = got
    torch.save(out, os.path.join(args.dir,
                                 f"ring_{args.world}_rank{args.rank}.pt"))


@functools.cache
def _killpoint_tool():
    path = os.path.join(HERE, "..", "tools", "torch_fault_killpoint.py")
    spec = importlib.util.spec_from_file_location("torch_fault_killpoint",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase",
                    choices=["cases", "ring", "wire", "killpoint",
                             "resume", "scatter", "remat"],
                    required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help="on the card: smollm-135m's blocks (0: the "
                         "smoke config on the CPU)")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = os.path.join(args.dir, f"store_{args.phase}_{args.world}")
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=args.rank, world_size=args.world)
    try:
        if args.phase == "cases":
            run_cases(args)
        elif args.phase == "wire":
            run_wire(args)
        elif args.phase == "ring":
            run_ring(args)
        elif args.phase == "scatter":
            run_scatter(args)
        elif args.phase == "remat":
            run_remat(args)
        else:
            tool = _killpoint_tool()
            fn = (tool.run_killpoint_rank if args.phase == "killpoint"
                  else tool.run_resume_rank)
            out = fn(args.dir, device=args.device, layers=args.layers)
            if args.rank == 0:
                with open(os.path.join(args.dir,
                                       f"killpoint_{args.phase}.json"),
                          "w") as f:
                    json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
