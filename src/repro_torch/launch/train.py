"""Training on one device: the train step factory and the end-to-end loop.

The loop wires the substrate together: data prefetcher, the in-situ
session (gradient-health analytics + checkpointing, declared as one plan),
straggler monitor, restore-on-start. It runs on the card by default
(``device="cuda"``) and raises without CUDA; ``device="cpu"`` runs it on
the CPU at smoke size.

Shapes: ``smoke=True`` is the CPU smoke shape (2 x 64 tokens);
``smoke=False`` is :data:`FULL_SHAPE`, ``train_4k``'s sequence length of
4096 with the global batch of 256 cut to 4, so that one card and the
smoke's time limit hold it.

Not ported here (ROADMAP.md): the mesh, the sharded step and the cross-pod
compressed gradient ring (``grad_compress``), and the ``fault`` preset.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import base as configs
from repro_torch.core import host
from repro_torch.core.pytree import flatten_with_path, keystr, leaves, \
    tree_map, unflatten_like
from repro_torch.models import params as P_lib
from repro_torch.models import transformer

PyTree = Any

#: train_4k's sequence length; its global batch of 256 cut to 4 (one card)
FULL_SHAPE = configs.ShapeConfig(
    "train_4k_b4", "train", configs.SHAPES["train_4k"].seq_len, 4)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_state(cfg: configs.ModelConfig, seed: int | torch.Generator,
               opt_cfg: optim.AdamWConfig, *,
               device: str | torch.device = "cuda") -> dict:
    """Seeded random parameters and zero AdamW moments on ``device``."""
    dev = host.resolve_device(device)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    params = P_lib.materialize(gen, transformer.param_spec(cfg), dev)
    ostate = optim.init(params, opt_cfg)
    state = {"params": params, "mu": ostate.mu, "nu": ostate.nu,
             "count": ostate.count}
    if opt_cfg.master_weights:
        state["master"] = ostate.master
    return state


def state_from_numpy(tree: PyTree, device: str | torch.device = "cuda"
                     ) -> dict:
    """A JAX-package train state (params, mu, nu, count — numpy leaves,
    e.g. after ``jax.device_get``) as the port's state on ``device``: same
    keys, shapes, dtypes and bits (bf16 through a uint16 view)."""
    dev = host.resolve_device(device)
    return tree_map(lambda a: host.to_tensor(np.asarray(a), dev), tree)


# ---------------------------------------------------------------------------
# step factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepConfig:
    opt: optim.AdamWConfig = dataclasses.field(
        default_factory=optim.AdamWConfig)
    lr_peak: float = 3e-4
    lr_warmup: int = 100
    lr_total: int = 10000


def make_train_step(cfg: configs.ModelConfig, step_cfg: StepConfig
                    ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """Returns ``train_step(state, batch) -> (new_state, metrics)`` for one
    device: loss and grads by autograd, the warmup-cosine schedule at the
    state's step count, then AdamW. The inputs are left as they were."""

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        flat = flatten_with_path(params)
        live = {keystr(p): t.detach().requires_grad_(True) for p, t in flat}
        loss = transformer.train_loss(
            unflatten_like(params, live, "params"), cfg, batch)
        grads = torch.autograd.grad(loss, list(live.values()))
        grads = unflatten_like(params, dict(zip(live, grads)), "grads")
        lr = optim.schedules.warmup_cosine(
            state["count"], peak=step_cfg.lr_peak, warmup=step_cfg.lr_warmup,
            total=step_cfg.lr_total)
        ostate = optim.AdamWState(state["count"], state["mu"], state["nu"],
                                  state.get("master"))
        new_params, new_ostate = optim.update(grads, ostate, params,
                                              step_cfg.opt, lr=lr)
        new_state = dict(state)
        new_state.update(params=new_params, mu=new_ostate.mu,
                         nu=new_ostate.nu, count=new_ostate.count)
        if new_ostate.master is not None:
            new_state["master"] = new_ostate.master
        metrics = {"loss": loss.detach().float(),
                   "grad_norm": optim.adamw.global_norm(grads), "lr": lr}
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# end-to-end loop
# ---------------------------------------------------------------------------

def default_train_plan(*, insitu_mode: str = "async",
                       ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
                       analytics_every: int = 10, p_i: int = 2,
                       device: str | torch.device = "cuda") -> dict:
    """The training loop's declarative in-situ plan, in plain-dict form.

    Two streams: ``grads`` (per-step gradient/param summaries, bound to the
    ``grad_health`` preset) and ``train_state`` (the full checkpointable
    state, bound to the ``checkpoint`` preset when ``ckpt_dir`` is given;
    its lossy stage and restore run on ``device``)."""
    plan: dict = {
        "streams": ["grads", "train_state"],
        "workers": p_i,
        "tasks": {
            "analytics": {"stream": "grads", "preset": "grad_health",
                          "every": analytics_every,
                          "placement": insitu_mode},
        },
    }
    if ckpt_dir:
        plan["tasks"]["checkpoint"] = {
            "stream": "train_state", "preset": "checkpoint",
            "every": ckpt_every, "placement": insitu_mode,
            "options": {"directory": ckpt_dir, "device": str(device)},
        }
    return plan


def train_loop(arch: str, *, steps: int = 50, smoke: bool = True,
               insitu_mode: str = "async", ckpt_dir: Optional[str] = None,
               ckpt_every: int = 20, seed: int = 0,
               analytics_every: int = 10, p_i: int = 2,
               plan: Optional[Any] = None,
               sink_faults: Optional[dict] = None,
               on_session: Optional[Callable[[Any], None]] = None,
               log: Callable[[str], None] = print,
               device: str | torch.device = "cuda") -> dict:
    """End-to-end training with the in-situ stack declared as a plan.

    All in-situ work — analytics and checkpointing — is one
    :class:`~repro_torch.core.session.InSituPlan` driven through a single
    :class:`~repro_torch.core.session.Session`; the loop's only in-situ
    calls are ``session.emit``. ``plan`` replaces the default workflow;
    ``sink_faults`` maps task names to fault hooks
    (``PipelineRuntime.inject_sink_fault``); ``on_session`` runs once with
    the live session before the first step. With a checkpoint on disk the
    loop restores it ("resumed from step N") and then, as the JAX
    package's loop does, counts its steps from 0 again.

    The state is bf16 parameters (f32 norms) with bf16 moments, random
    from ``seed``; the shapes are in the module docstring.
    """
    from repro_torch.core.session import InSituPlan, Session
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.pipeline import Prefetcher, batch_spec_for
    from repro_torch.distributed.fault import StragglerMonitor

    dev = host.resolve_device(device)
    cfg = configs.get(arch, smoke=smoke)
    shape = configs.SMOKE_SHAPE if smoke else FULL_SHAPE
    step_cfg = StepConfig()
    tm = Telemetry()

    if plan is None:
        plan = default_train_plan(
            insitu_mode=insitu_mode, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, analytics_every=analytics_every, p_i=p_i,
            device=dev)
    if not isinstance(plan, InSituPlan):
        plan = InSituPlan.from_dict(plan)

    state = init_state(cfg, seed, step_cfg.opt, device=dev)
    step_fn = make_train_step(cfg, step_cfg)

    # ONE session: analytics and checkpointing share the staging ring and
    # the p_i worker pool (the paper's single p_o/p_i split)
    with Session(plan, telemetry=tm, raise_on_error=True) as session:
        for task_name, hook in (sink_faults or {}).items():
            session.runtime.inject_sink_fault(task_name, hook)
        if on_session is not None:
            on_session(session)
        session.set_checkpoint_meta({"arch": cfg.name})
        if session.latest_checkpoint_step() is not None:
            start, state = session.restore(state)
            log(f"resumed from step {start}")

        pf = Prefetcher(batch_spec_for(cfg, shape), depth=2, seed=seed,
                        telemetry=tm)
        mon = StragglerMonitor()
        losses = []
        try:
            for i in range(steps):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in next(pf).items()}
                t0 = time.perf_counter()
                with session.step_span(i):
                    state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])
                step_s = time.perf_counter() - t0
                mon.observe(0, step_s)
                losses.append(loss)
                # a custom plan may declare only a subset of the default
                # streams — offer each payload only where declared
                if "grads" in session.streams:
                    params_now = state["params"]
                    session.emit("grads", i, lambda p=params_now: {
                        "params": leaves(p)[0].float()})
                if "train_state" in session.streams:
                    session.emit("train_state", i, lambda s=state: s)
                if i % 10 == 0:
                    log(f"step {i} loss {loss:.4f} "
                        f"lr {float(metrics['lr']):.2e}")
        finally:
            pf.close()
    n_analytics = sum(1 for r in session.results if r.task == "analytics")
    return {"losses": losses, "telemetry": tm,
            "insitu_results": n_analytics,
            "session_report": session.report(),
            "straggler_report": mon.report()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--insitu", default="async",
                    choices=["sync", "async", "hybrid"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="full published widths at batch 4 x 4096 tokens "
                         "(a CUDA card)")
    args = ap.parse_args()
    out = train_loop(args.arch, steps=args.steps, smoke=not args.full,
                     insitu_mode=args.insitu, ckpt_dir=args.ckpt_dir,
                     device=args.device)
    print("final loss:", out["losses"][-1])
    print("in-situ results:", out["insitu_results"])


if __name__ == "__main__":
    main()
