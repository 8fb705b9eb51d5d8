"""One rank of the port's remesh drill on CPU processes (gloo).

    python tests/torch_remesh_ranks.py --phase save --rank R --world 4 \\
        --dir DIR
    python tests/torch_remesh_ranks.py --phase restore --rank R \\
        --world W --dir DIR

``save`` (a world of 4): the smoke ``smollm-135m`` state (seed-0
parameters, seeded random moments) placed under ``state_shardings`` on a
(2, 2) ('data', 'model') ``DeviceMesh``; each rank writes its local
shards to ``DIR/old_rank<R>.pt`` and checks that the gathered leaves
equal the state; rank 0 saves the logically complete state as a v2
checkpoint under ``DIR/ck`` with the mesh geometry in its meta.

``restore`` (a world of W): ``Session.restore(elastic=True)`` over the W
ranks, each leaf placed under ``state_shardings`` of the re-planned mesh;
each rank writes its local shards, its mesh coordinate and the plan to
``DIR/new<W>_rank<R>.pt``.

Imports no JAX; ``tests/test_torch_sharding.py`` starts the ranks and
holds what they wrote against the JAX package's plan and the full
leaves.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _plan(directory: str) -> dict:
    return {"streams": ["train_state"], "tasks": {
        "checkpoint": {"stream": "train_state", "preset": "checkpoint",
                       "every": 1, "placement": "sync",
                       "options": {"directory": directory, "device": "cpu"}}}}


def smoke_state():
    """Seed-0 parameters and seeded random bf16 moments (zero moments
    would make the lossy restore trivial)."""
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch import train as T

    cfg = configs.get("smollm-135m", smoke=True)
    state = T.init_state(cfg, 0, T.StepConfig().opt, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for k in ("mu", "nu"):
        state[k] = tree_map(lambda t: (1e-3 * torch.randn(
            t.shape, generator=gen)).abs().to(t.dtype), state[k])
    return cfg, state


def _local(tree) -> dict:
    from repro_torch.core.pytree import flatten_with_path, keystr
    return {keystr(p): t.to_local().clone() for p, t in
            flatten_with_path(tree)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["save", "restore"], required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.pytree import flatten_with_path, keystr
    from repro_torch.core.session import Session
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.launch import train as T

    store = os.path.join(args.dir, f"store_{args.phase}_{args.world}")
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=args.rank, world_size=args.world)
    ck = os.path.join(args.dir, "ck")
    try:
        cfg, state = smoke_state()
        if args.phase == "save":
            mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                              mesh_dim_names=("data", "model"))
            placed = distribute_tree(state, mesh,
                                     T.state_shardings(cfg, mesh))
            torch.save(_local(placed),
                       os.path.join(args.dir, f"old_rank{args.rank}.pt"))
            full = {keystr(p): t.full_tensor()
                    for p, t in flatten_with_path(placed)}
            for p, t in flatten_with_path(state):
                assert torch.equal(full[keystr(p)], t), keystr(p)
            if args.rank == 0:
                with Session(_plan(ck), raise_on_error=True) as s:
                    s.set_checkpoint_meta({"arch": cfg.name}, mesh=mesh)
                    s.emit("train_state", 5, state)
        else:
            with Session(_plan(ck), raise_on_error=True) as s:
                step, restored = s.restore(
                    T.state_spec(cfg), elastic=True,
                    make_shardings=lambda m: T.state_shardings(cfg, m))
                rm = s.remesh
            torch.save({"step": step, "local": _local(restored),
                        "coord": rm.mesh.get_coordinate(),
                        "plan": (rm.plan.old_shape, rm.plan.new_shape,
                                 rm.plan.axis_names,
                                 rm.plan.model_merge_factor),
                        "placements": {keystr(p): [str(x) for x in
                                                   t.placements]
                                       for p, t in
                                       flatten_with_path(restored)}},
                       os.path.join(args.dir,
                                    f"new{args.world}_rank{args.rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
