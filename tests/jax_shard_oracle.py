"""The JAX package's sharded train step on a multi-device CPU platform.

    python tests/jax_shard_oracle.py --cases CASES.json --dir DIR
    python tests/jax_shard_oracle.py --ring 2 3 4 --dir DIR
    python tests/jax_shard_oracle.py --killpoint --dir DIR

Re-executes itself with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(the suite's conftest keeps the in-process device count at 1). Each case
of ``CASES.json`` (``{"name", "arch", "mesh": [sizes], "axes": [names],
"method", "steps", "step"}``, the last the ``StepConfig``'s ``lr_peak``,
``lr_warmup`` and ``opt`` fields) runs ``repro.launch.train.jit_train_step`` on a mesh
whose axes are ``AxisType.Auto`` (on JAX 0.9 ``jax.make_mesh`` makes
explicit axes, under which the step's ``with_sharding_constraint``
asserts), from the initial state in ``DIR/init_<arch>.npz``, with the
state and every batch ``jax.device_put`` under the shardings the step
returns (``jit`` refuses arguments placed otherwise). The pod ring's
residual is built as ``state_spec(ef_pods=n)`` declares it: zeros of
shape ``(n,) + p.shape`` in bf16 (``init_state(ef_residual=True)`` makes
it without the pod axis, which ``state_shardings`` then refuses).

Batches: step ``i`` draws int32 tokens and labels from
``numpy.random.RandomState(1000 + i)``. Writes ``DIR/ref_<name>.npz``:
``loss`` and ``grad_norm`` per step and the final state's leaves under
``keystr`` paths (bf16 as uint16 bits, named in ``__bf16__``).

``--ring N``: the JAX package's ``int8_ring_mean`` under ``shard_map``
on an N-device ('pod',) mesh, each device reducing its row of each array
in ``DIR/ring_<N>.npz``; writes ``DIR/ref_ring_<N>.npz`` (device 0's
output, and whether every device's equals it).

``--killpoint`` instead runs ``tests/killpoint_driver.py``'s scenario with
the same placements, from the port's initial state in
``DIR/init_smollm-135m.npz`` and under the step of ``DIR/step.json``, and
prints its JSON result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

_CHILD_ENV = "REPRO_SHARD_ORACLE_CHILD"
HERE = os.path.dirname(os.path.abspath(__file__))


def load_tree(path: str) -> dict:
    """``keystr`` -> array of an ``.npz`` written by :func:`save_tree`
    (bf16 back from its uint16 bits)."""
    import ml_dtypes
    import numpy as np

    z = np.load(path)
    bf16 = set(z["__bf16__"].tolist()) if "__bf16__" in z else set()
    return {k: (z[k].view(ml_dtypes.bfloat16) if k in bf16 else z[k])
            for k in z.files if k != "__bf16__"}


def save_tree(path: str, flat: dict) -> None:
    """``flat`` (``keystr`` -> array; bf16 as ``ml_dtypes`` or as the
    port's tagged uint16) as an ``.npz``."""
    import numpy as np

    out, bf16 = {}, []
    for k, a in flat.items():
        a = np.asarray(a)
        if (a.dtype.name == "bfloat16"
                or (a.dtype.metadata or {}).get("dtype") == "bfloat16"):
            bf16.append(k)
            a = a.view(np.uint16)
        out[k] = a
    np.savez(path, __bf16__=np.asarray(bf16, dtype=object).astype(str),
             **out)


def auto_mesh(sizes, names):
    import jax
    import numpy as np

    n = int(np.prod(sizes))
    return jax.make_mesh(tuple(sizes), tuple(names),
                         axis_types=(jax.sharding.AxisType.Auto,)
                         * len(sizes), devices=jax.devices()[:n])


def synth_batch(cfg, shape, step: int) -> dict:
    import numpy as np

    rng = np.random.RandomState(1000 + step)
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def run_case(case: dict, d: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import base as configs
    from repro.distributed import sharding
    from repro.launch import train

    cfg = configs.get(case["arch"], smoke=True)
    shape = configs.SMOKE_SHAPE
    mesh = auto_mesh(case["mesh"], case["axes"])
    sc = dataclasses.replace(step_config(case["step"]),
                             grad_compress=case["method"])
    step, st_sh, b_sh, ef = train.jit_train_step(cfg, mesh, sc, shape,
                                                 donate=False)
    init = load_tree(os.path.join(d, f"init_{case['arch']}.npz"))
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        train.state_spec(cfg, master=sc.opt.master_weights))
    state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(init[jax.tree_util.keystr(p)]) for p, _ in flat])
    if ef:
        state["ef"] = jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype),
            train.state_spec(cfg, ef_pods=case["mesh"][0])["ef"])
    losses, norms = [], []
    with sharding.mesh_context(mesh):
        state = jax.device_put(state, st_sh)
        for i in range(case["steps"]):
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in synth_batch(cfg, shape,
                                                           i).items()}, b_sh)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]}
    out["loss"] = np.asarray(losses, np.float64)
    out["grad_norm"] = np.asarray(norms, np.float64)
    save_tree(os.path.join(d, f"ref_{case['name']}.npz"), out)


def run_ring(n: int, d: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.distributed import sharding
    from repro.optim import grad_compress

    mesh = auto_mesh((n,), ("pod",))
    f = jax.jit(sharding.shard_map(
        lambda v: grad_compress.int8_ring_mean(v[0], "pod", n)[None],
        mesh, in_specs=P("pod"), out_specs=P("pod"), check_vma=False))
    z = np.load(os.path.join(d, f"ring_{n}.npz"))
    out = {}
    with sharding.mesh_context(mesh):
        for name in z.files:
            y = np.asarray(f(jnp.asarray(z[name])))
            out[name] = y[0]
            out[name + "_same"] = np.asarray(bool((y == y[0]).all()))
    np.savez(os.path.join(d, f"ref_ring_{n}.npz"), **out)


def step_config(st: dict):
    """The JAX package's ``StepConfig`` of a case's ``step`` (``{}``: the
    default)."""
    from repro import optim
    from repro.launch import train

    if not st:
        return train.StepConfig()
    return train.StepConfig(lr_peak=st["lr_peak"], lr_warmup=st["lr_warmup"],
                            opt=optim.AdamWConfig(**st["opt"]))


def run_killpoint(d: str, st: dict) -> dict:
    """``tests/killpoint_driver.py``'s scenario with the state and the
    batches placed under the step's shardings on ``Auto`` meshes, from the
    initial state in ``DIR/init_smollm-135m.npz``, under the ``StepConfig``
    of ``st``; checkpoints under ``DIR/ref_ck``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import base as configs
    from repro.core import Session
    from repro.distributed import sharding
    from repro.launch import train

    steps, fail_at, ckpt_every, grace_s = 9, 4, 2, 2.5
    ckpt_dir = os.path.join(d, "ref_ck")
    cfg = configs.get("smollm-135m", smoke=True)
    shape = configs.SMOKE_SHAPE
    step_cfg = step_config(st)
    master = step_cfg.opt.master_weights
    init = load_tree(os.path.join(d, "init_smollm-135m.npz"))
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        train.state_spec(cfg, master=master))
    initial = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(init[jax.tree_util.keystr(p)]) for p, _ in flat])

    def batch(i, b_sh):
        return jax.device_put({k: jnp.asarray(v) for k, v in
                               synth_batch(cfg, shape, i).items()}, b_sh)

    mesh_full = auto_mesh((2, 2), ("data", "model"))
    jit_full, st_sh, b_sh, _ = train.jit_train_step(cfg, mesh_full, step_cfg,
                                                    shape, donate=False)

    def fresh():
        with sharding.mesh_context(mesh_full):
            return jax.device_put(initial, st_sh)

    golden = []
    with sharding.mesh_context(mesh_full):
        state = fresh()
        for i in range(steps):
            state, m = jit_full(state, batch(i, b_sh))
            golden.append(float(m["loss"]))
    now = [0.0]
    plan = {"streams": ["train_state", "health"], "workers": 2, "tasks": {
        "checkpoint": {"stream": "train_state", "preset": "checkpoint",
                       "every": ckpt_every, "placement": "async",
                       "options": {"directory": ckpt_dir}},
        "fault": {"stream": "health", "preset": "fault", "every": 1,
                  "placement": "sync", "pipelined": False,
                  "options": {"hosts": [0, 1], "grace_s": grace_s}}}}
    detect, failed, failure = None, [], []
    with sharding.mesh_context(mesh_full):
        state = fresh()
        with Session(plan, clock=lambda: now[0],
                     raise_on_error=True) as session:
            session.set_checkpoint_meta(mesh=mesh_full)
            ctrl = session.fault_controller()
            for i in range(steps):
                now[0] += 1.0
                state, m = jit_full(state, batch(i, b_sh))
                failure.append(float(m["loss"]))
                session.emit("train_state", i, lambda s=state: s)
                beats = {0: 0.1}
                if i < fail_at:
                    beats[1] = 0.1
                session.emit("health", i, {"hosts": beats})
                failed = ctrl.failed_hosts()
                if failed:
                    detect = i
                    break
            session.wait_idle()
    resume_plan = {"streams": ["train_state"], "workers": 2, "tasks": {
        "checkpoint": plan["tasks"]["checkpoint"]}}
    resumed = {}
    with Session(resume_plan, raise_on_error=True) as session:
        start, state = session.restore(
            train.state_spec(cfg, master=master), elastic=True,
            devices=list(jax.devices()[:2]),
            make_shardings=lambda m: train.state_shardings(cfg, m,
                                                           master=master))
        rm = session.remesh
        mesh_new = auto_mesh(rm.plan.new_shape, rm.plan.axis_names)
        jit_new, st_new, b_new, _ = train.jit_train_step(
            cfg, mesh_new, step_cfg, shape, donate=False)
        with sharding.mesh_context(mesh_new):
            state = jax.device_put(state, st_new)
            for i in range(start + 1, steps):
                state, m = jit_new(state, batch(i, b_new))
                resumed[i] = float(m["loss"])
    return {"golden_losses": golden, "failure_losses": failure,
            "resumed_losses": resumed, "detect_step": detect,
            "restored_step": start, "failed_hosts": failed,
            "new_shape": list(rm.plan.new_shape),
            "merge_factor": rm.plan.model_merge_factor}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=None)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--killpoint", action="store_true")
    ap.add_argument("--ring", type=int, nargs="*", default=None)
    args = ap.parse_args()
    if os.environ.get(_CHILD_ENV) != "1":
        env = dict(os.environ, JAX_PLATFORMS="cpu", **{_CHILD_ENV: "1"})
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                            + env.get("XLA_FLAGS", "")).strip()
        return subprocess.run([sys.executable, os.path.abspath(__file__)]
                              + sys.argv[1:], env=env).returncode
    if args.ring:
        for n in args.ring:
            run_ring(n, args.dir)
        return 0
    if args.killpoint:
        with open(os.path.join(args.dir, "step.json")) as f:
            st = json.load(f)
        print(json.dumps(run_killpoint(args.dir, st)))
        return 0
    with open(args.cases) as f:
        cases = json.load(f)
    for case in cases:
        run_case(case, args.dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
