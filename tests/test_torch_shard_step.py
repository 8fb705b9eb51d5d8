"""The port's train step sharded across processes against the JAX
package's ``jit_train_step`` (CPU).

Cases: the smoke configs of ``smollm-135m``, ``moonshot-v1-16b-a3b`` and
``deepseek-v3-671b`` on (2, 1) and (1, 2) over ('data', 'model'), (2, 2),
and (2, 1, 1) / (2, 1, 2) over ('pod', 'data', 'model') with the int8 pod
ring and error feedback; two steps each from the port's seed-0 state, on
the batches ``RandomState(1000 + i)`` draws (``SMOKE_SHAPE``, 2 x 64).

* The port: gloo CPU processes, a world of 2 and a world of 4
  (``tests/torch_shard_ranks.py``), each running its cases in turn.
* The reference: ``tests/jax_shard_oracle.py`` in a subprocess with four
  XLA host devices, on meshes of ``AxisType.Auto`` axes with the state and
  the batches ``device_put`` under the step's shardings (what JAX 0.9
  needs to run the JAX package's step; its own train-loop tests fail),
  one process an arch.
  The oracles and both worlds run at once, under one deadline.

Every drill runs :data:`STEP` (the card smoke's part (a) step): the
peak rate 1.0 from the first step, f32 masters, AdamW's eps 1.0 and no
weight decay. An update is then about the clipped gradient itself, so
both steps move the parameters and a gradient that differs shows in the
change at its own size (at the default warm-up the first rate is 0 and
the second 3e-6, under half a bf16 ulp: nothing would move).

Tolerances and why (bf16 parameters and moments, f32 masters and
losses). The reference is not one number: its own meshes differ from
each other (measured between its five meshes of each arch), so the port
is held to that spread with a margin. Groups: the dense arch, an MoE
arch's other leaves, and its expert leaves (``['moe']`` in the path:
top-k routing turns a bf16 rounding of a router logit into another
expert for that token, which moves those leaves' gradients wholesale).

* loss: atol 5e-4 dense, 4e-3 MoE (the reference's meshes differ by up
  to 5.4e-4 and 3.7e-3; the port from the reference's same mesh by up
  to 1.5e-4 and 3.0e-3);
* grad_norm: rtol 5e-3 dense, 2e-2 MoE (gradients are bf16 on both
  sides, summed in other orders; the reference's meshes 5.7e-3 and
  1.4e-2 apart, the port 3.6e-3 and 1.2e-2);
* params and masters, by their change from the initial state:
  ``|d_port - d_ref| / |d_ref|`` (L2 over the leaf; the reference's
  change is asserted nonzero) at most 0.08 / 0.08 / 0.3 on masters and
  0.2 / 0.35 / 0.5 on bf16 params (the reference's meshes: masters 3.1,
  3.9 and 16 %, params 11, 21 and 30 %; the port: masters 2.7, 3.3 and
  17 %, params 8.1, 21 and 34 %: bf16 rounds each change). A missing
  update scores 1, a wrong sign 2, an update written half a leaf away
  above 2.4 on every leaf (``test_state_check_fails_on_a_broken_update``);
* mu / nu: per leaf, 0.2 / 0.25 / 0.4 of the leaf's largest |value| in
  the reference (its meshes: 11, 13 and 26 %; the port 8.7, 9.6 and
  25 %);
* ef (int8 cases): per leaf, one quantisation step (twice the
  reference residual's largest |value|): a gradient element on the other
  side of a rounding boundary moves its residual by a step.

Each ``none`` case is also held against the port's own one-device step:
(1, 2) bit for bit (no rank splits the rows: every rank computes the
one-device step on gathered parameters); (2, 1) and (2, 2) at the first
step's loss atol 1e-5 and grad_norm rtol 1e-3 (measured 0 and 6.2e-5:
the mean over ranks sums bf16 gradients in f32), both steps at the
reference's bounds above (3.1e-5 / 5.5e-4 and 1.1e-3), changes at 0.03
/ 0.03 / 0.1 on masters and 0.1 / 0.25 / 0.25 on params (measured 0.8,
0.9 and 3.3 %; 4.1, 11 and 12 %), moments at 5 / 5 / 30 % (2.2 / 3.1 %
dense, 2.7 % other, 20 % experts). Every int8 case's ring equals
``int8_ring_mean_plain`` bit for bit on every leaf of both steps, and
puts (n - 1) x numel bytes of int8 on the wire per leaf per step. ``bf16`` aborts the JAX package's step,
so it is held to its definition only: the smollm (2, 1, 1) step under
``bf16`` (every leaf's reduction the mean of its bf16 operands within one
bf16 rounding, 2 bytes an element on the wire, no residual) and the
reduction itself in ``tests/test_torch_optim.py``.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.core import host, pytree
from repro_torch.launch import train as TT

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import jax_shard_oracle as oracle  # noqa: E402
import torch_shard_ranks as ranks  # noqa: E402

ARCHS = ("smollm-135m", "moonshot-v1-16b-a3b", "deepseek-v3-671b")
MESHES = {
    "2x1": ((2, 1), ("data", "model"), "none"),
    "1x2": ((1, 2), ("data", "model"), "none"),
    "2x2": ((2, 2), ("data", "model"), "none"),
    "pod2x1x1_int8": ((2, 1, 1), ("pod", "data", "model"), "int8"),
    "pod2x1x2_int8": ((2, 1, 2), ("pod", "data", "model"), "int8"),
    # the port's only: bf16 aborts the JAX package's step (ROADMAP)
    "pod2x1x1_bf16": ((2, 1, 1), ("pod", "data", "model"), "bf16"),
}
STEPS = 2


def _tool(name: str):
    import importlib.util

    path = TESTS.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the drills' step (the card smoke's): the peak rate from the first step
#: (no warm-up), f32 masters, and an eps far above every gradient element,
#: so that AdamW's update is about the clipped gradient itself (not its
#: sign) and a difference of gradients shows in the masters at its own
#: size; no weight decay to blur it
STEP = _tool("torch_fault_killpoint").CHECK_STEP
DRILL_TIMEOUT_S = 600.0
CASES = [f"{a.split('-')[0]}_{m}" for a in ARCHS for m in MESHES
         if not m.endswith("bf16")]
BF16_CASE = "smollm_pod2x1x1_bf16"
NONE_CASES = [c for c in CASES if not c.endswith("int8")]
INT8_CASES = [c for c in CASES if c.endswith("int8")]

#: bounds against the reference by leaf group (dense arch, an MoE arch's
#: other leaves, its expert leaves): see the docstring
LOSS_ATOL = {"dense": 5e-4, "moe": 4e-3}
NORM_RTOL = {"dense": 5e-3, "moe": 2e-2}
CHANGE_RTOL = {"master": {"dense": 0.08, "moe": 0.08, "expert": 0.3},
               "params": {"dense": 0.2, "moe": 0.35, "expert": 0.5}}
MOMENT_SHARE = {"dense": 0.2, "moe": 0.25, "expert": 0.4}
#: bounds against the port's one-device step: the first step's loss and
#: norm, then as above
ONE_LOSS_ATOL, ONE_NORM_RTOL = 1e-5, 1e-3
ONE_CHANGE_RTOL = {"master": {"dense": 0.03, "moe": 0.03, "expert": 0.1},
                   "params": {"dense": 0.1, "moe": 0.25, "expert": 0.25}}
ONE_MOMENT_SHARE = {"dense": 5e-2, "moe": 5e-2, "expert": 0.3}


def step_config(method: str = "none", step: dict = STEP) -> TT.StepConfig:
    """The port's ``StepConfig`` of a case's ``step``."""
    from repro_torch import optim as TO

    return TT.StepConfig(grad_compress=method, lr_peak=step["lr_peak"],
                         lr_warmup=step["lr_warmup"],
                         opt=TO.AdamWConfig(**step["opt"]))


def _case(name: str) -> dict:
    short, mesh = name.split("_", 1)
    arch = next(a for a in ARCHS if a.startswith(short))
    sizes, axes, method = MESHES[mesh]
    return {"name": name, "arch": arch, "mesh": list(sizes),
            "axes": list(axes), "method": method, "steps": STEPS,
            "step": STEP}


def _spawn(cmd, env):
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    return d, run_drills(d)


def run_drills(d: Path) -> dict:
    """Writes the initial states to ``d`` and runs the oracles (one
    process an arch) and both worlds at once, the port's one-device steps
    meanwhile; returns the one-device results."""
    for arch in ARCHS:
        cfg = tbase.get(arch, smoke=True)
        state = TT.init_state(cfg, 0, step_config().opt, device="cpu")
        torch.save(state, d / f"init_{arch}.pt")
        oracle.save_tree(str(d / f"init_{arch}.npz"), {
            pytree.keystr(p): host.to_numpy(t)
            for p, t in pytree.flatten_with_path(state)})
        (d / f"cases_{arch}.json").write_text(json.dumps(
            [_case(c) for c in CASES if _case(c)["arch"] == arch]))
    (d / "cases.json").write_text(json.dumps(
        [_case(c) for c in CASES + [BF16_CASE]]))
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               OMP_NUM_THREADS="1")
    deadline = time.monotonic() + DRILL_TIMEOUT_S
    procs = [_spawn([sys.executable, str(TESTS / "jax_shard_oracle.py"),
                     "--cases", str(d / f"cases_{arch}.json"),
                     "--dir", str(d)], env) for arch in ARCHS]
    for world in (2, 4):
        procs += [_spawn([sys.executable, str(TESTS / "torch_shard_ranks.py"),
                          "--phase", "cases", "--rank", str(r), "--world",
                          str(world), "--dir", str(d), "--cases",
                          str(d / "cases.json")], env)
                  for r in range(world)]
    try:
        one = {arch: _one_device(arch, d) for arch in ARCHS}
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline -
                                               time.monotonic()))
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return one


def _one_device(arch: str, d: Path) -> dict:
    cfg = tbase.get(arch, smoke=True)
    step = TT.make_train_step(cfg, step_config())
    state = torch.load(d / f"init_{arch}.pt")
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, ranks.synth_batch(cfg, tbase.SMOKE_SHAPE, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "state": {pytree.keystr(p): t
                      for p, t in pytree.flatten_with_path(state)}}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _family(name: str) -> str:
    return "moe" if _case(name)["arch"] != "smollm-135m" else "dense"


def _init(d: Path, arch: str) -> dict:
    return {pytree.keystr(p): _f32(t) for p, t in pytree.flatten_with_path(
        torch.load(d / f"init_{arch}.pt"))}


def state_ratios(got: dict, want: dict, init: dict, *, family: str,
                 one_device: bool = False) -> dict:
    """Each leaf's error over its bound (the docstring's; at most 1
    passes) for the params, masters, moments and residual of ``got``
    (port tensors) against ``want`` (arrays or tensors): a parameter or
    master by its change from ``init``, ``|d_got - d_want| / |d_want|``
    (L2 over the leaf; the reference's change must not be 0)."""
    out = {}
    for k, w in want.items():
        kind = k.split("]")[0][2:-1]
        if kind not in ("params", "mu", "nu", "master", "ef"):
            continue
        g, w = _f32(got[k]), _f32(w)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        group = "expert" if "['moe']" in k else family
        if kind in ("params", "master"):
            d_want = w - init[k]
            scale = float(np.linalg.norm(d_want))
            assert scale > 0, (k, "the reference's update left it as it was")
            err = float(np.linalg.norm(g - init[k] - d_want)) / scale
            bound = (ONE_CHANGE_RTOL if one_device else CHANGE_RTOL)[kind][
                group]
        else:
            err = float(np.abs(g - w).max()) if w.size else 0.0
            top = float(np.abs(w).max()) if w.size else 0.0
            share = (2.0 if kind == "ef" else (
                ONE_MOMENT_SHARE if one_device else MOMENT_SHARE)[group])
            bound = share * top
        out[k] = 0.0 if err == 0 else (err / bound if bound else np.inf)
    return out


def _hold_state(got: dict, want: dict, init: dict, label: str, *,
                family: str, one_device: bool = False) -> None:
    ratios = state_ratios(got, want, init, family=family,
                          one_device=one_device)
    over = {k: r for k, r in ratios.items() if not r <= 1.0}
    assert not over, (label, over)


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_jax_jit_train_step(drills, name):
    d, _ = drills
    fam = _family(name)
    got = torch.load(d / f"port_{name}.pt")
    want = oracle.load_tree(str(d / f"ref_{name}.npz"))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=LOSS_ATOL[fam])
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=NORM_RTOL[fam])
    want = {k: v for k, v in want.items() if k not in ("loss", "grad_norm")}
    assert set(got["state"]) == set(want), name
    assert int(got["state"]["['count']"]) == int(want["['count']"]) == STEPS
    _hold_state(got["state"], want, _init(d, _case(name)["arch"]), name,
                family=fam)


@pytest.mark.parametrize("name", NONE_CASES)
def test_sharded_step_matches_the_one_device_step(drills, name):
    d, one = drills
    got = torch.load(d / f"port_{name}.pt")
    ref = one[_case(name)["arch"]]
    assert set(got["state"]) == set(ref["state"])
    if name.endswith("1x2"):
        # no rank splits the rows: each computes the one-device step
        assert got["loss"] == ref["loss"]
        assert got["grad_norm"] == ref["grad_norm"]
        for k, t in ref["state"].items():
            assert torch.equal(got["state"][k], t), k
        return
    fam = _family(name)
    # the first step from the same parameters; the second from updates
    # that differ as two meshes' do
    np.testing.assert_allclose(got["loss"][0], ref["loss"][0], rtol=0,
                               atol=ONE_LOSS_ATOL)
    np.testing.assert_allclose(got["grad_norm"][0], ref["grad_norm"][0],
                               rtol=ONE_NORM_RTOL)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=0,
                               atol=LOSS_ATOL[fam])
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=NORM_RTOL[fam])
    _hold_state(got["state"], ref["state"], _init(d, _case(name)["arch"]),
                name, family=fam, one_device=True)


def _broken(got: dict, init: dict, how: str) -> dict:
    """``got`` with its parameters' and masters' update broken: not made
    (``none``), made with the wrong sign (``sign``), or moved by half the
    leaf along its longest dim, as a step that wrote each update into
    another shard's place would (``shard``)."""
    out = dict(got)
    for k, t in got.items():
        if not k.startswith(("['params']", "['master']")):
            continue
        delta = _f32(t) - init[k]
        if how == "sign":
            delta = -delta
        elif how == "shard":
            dim = int(np.argmax(delta.shape))
            delta = np.roll(delta, delta.shape[dim] // 2, axis=dim)
        out[k] = init[k] + (0.0 if how == "none" else delta)
    return out


@pytest.mark.parametrize("how", ["none", "sign", "shard"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_check_fails_on_a_broken_update(drills, arch, how):
    """The parameter check has teeth: the port's (2, 2) state, which
    passes, fails on every parameter and master leaf once its update is
    missing, of the wrong sign, or written into the wrong shard."""
    d, _ = drills
    name = f"{arch.split('-')[0]}_2x2"
    got = torch.load(d / f"port_{name}.pt")["state"]
    want = oracle.load_tree(str(d / f"ref_{name}.npz"))
    want = {k: v for k, v in want.items() if k not in ("loss", "grad_norm")}
    init = _init(d, arch)
    fam = _family(name)
    assert max(state_ratios(got, want, init, family=fam).values()) <= 1.0
    ratios = state_ratios(_broken(got, init, how), want, init, family=fam)
    moved = [k for k in ratios if k.startswith(("['params']", "['master']"))]
    assert moved and all(ratios[k] > 1.0 for k in moved), {
        k: ratios[k] for k in moved if ratios[k] <= 1.0}


@pytest.mark.parametrize("name", INT8_CASES)
def test_pod_ring_is_its_plain_version_and_counts_int8_bytes(drills, name):
    d, _ = drills
    got = torch.load(d / f"port_{name}.pt")
    assert got["use_ring"]
    n_leaves = len([k for k in got["state"] if k.startswith("['params']")])
    assert got["ring"]["leaves"] == STEPS * n_leaves
    assert got["ring"]["differ"] == []
    n = _case(name)["mesh"][0]
    wire = got["wire"]
    assert wire["bytes"]["int8"] == STEPS * (n - 1) * got[
        "param_local_numel"]
    assert wire["calls"]["int8"] == STEPS * n_leaves
    assert wire["bytes"]["amax"] == STEPS * n_leaves * 4
    assert wire["bytes"]["none"] == wire["bytes"]["bf16"] == 0


def test_bf16_pod_reduction_holds_its_definition(drills):
    d, _ = drills
    got = torch.load(d / f"port_{BF16_CASE}.pt")
    assert got["use_ring"]
    assert not any(k.startswith("['ef']") for k in got["state"])
    n_leaves = len([k for k in got["state"] if k.startswith("['params']")])
    assert got["ring"]["leaves"] == STEPS * n_leaves
    assert got["ring"]["differ"] == []
    wire = got["wire"]
    assert wire["bytes"]["bf16"] == STEPS * 2 * got["param_local_numel"]
    assert wire["calls"]["bf16"] == STEPS * n_leaves
    assert wire["bytes"]["int8"] == wire["bytes"]["none"] == 0
    # the first loss comes before any reduction; the second after an
    # update whose gradient was rounded to bf16 once more
    ref = torch.load(d / "port_smollm_2x1.pt")
    assert got["loss"][0] == ref["loss"][0]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=0,
                               atol=LOSS_ATOL["dense"])
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=NORM_RTOL["dense"])


# ---------------------------------------------------------------------------
# single-process cases
# ---------------------------------------------------------------------------

def test_int8_on_one_pod_never_enters_the_ring(tmp_path):
    """A (1, 1, 1) mesh under int8: the state carries ``ef`` (as the JAX
    package's ``jit_train_step`` says), but one pod never enters the
    ring: no int8 byte, ``ef`` unchanged, and the step equal to the
    one-device step bit for bit."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.optim import grad_compress as TG

    cfg = tbase.get("smollm-135m", smoke=True)
    sc = TT.StepConfig(grad_compress="int8")
    with _tool("torch_fault_killpoint").world_of_one(str(tmp_path), "gloo"):
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1, 1),
                          mesh_dim_names=("pod", "data", "model"))
        step, st_sh, b_sh, ef = TT.jit_train_step(cfg, mesh, sc,
                                                  tbase.SMOKE_SHAPE)
        assert ef and "ef" in st_sh and not step.use_ring
        init = TT.init_state(cfg, 0, sc.opt, device="cpu")
        state = dict(init, ef=pytree.tree_map(
            lambda t: torch.full(t.shape, 0.5, dtype=t.dtype),
            TT.state_spec(cfg, ef_pods=1)["ef"]))
        placed = distribute_tree(pytree.tree_map(lambda t: t.clone(), state),
                                 mesh, st_sh)
        TG.wire.reset()
        batch = ranks.synth_batch(cfg, tbase.SMOKE_SHAPE, 0)
        new, m = step(placed, distribute_tree(batch, mesh, b_sh))
        assert TG.wire.bytes["int8"] == 0 and TG.wire.calls["int8"] == 0
        full = TT.gather_state(new)
    one, m1 = TT.make_train_step(cfg, sc)(init, batch)
    assert float(m["loss"]) == float(m1["loss"])
    for p, t in pytree.flatten_with_path(one):
        assert torch.equal(_at(full, p), t), pytree.keystr(p)
    for p, t in pytree.flatten_with_path(full["ef"]):
        assert torch.all(t == 0.5), pytree.keystr(p)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_sharded_step_refuses_an_unknown_method_and_stray_chunks():
    cfg = tbase.get("moonshot-v1-16b-a3b", smoke=True)
    with pytest.raises(ValueError, match="unknown grad-compression"):
        TT.ShardedTrainStep(cfg, TT.StepConfig(grad_compress="fp8"),
                            object())
    # moe_ffn's chunk rule: min(token_chunk, T), the whole list when that
    # does not divide it
    chunk = cfg.moe.token_chunk
    assert TT._moe_chunk(cfg, 2 * chunk) == chunk
    assert TT._moe_chunk(cfg, chunk // 2) == chunk // 2
    assert TT._moe_chunk(cfg, chunk + chunk // 2) == chunk + chunk // 2


def test_the_smoke_shard_phase_runs_on_the_cpu(tmp_path):
    """``tools/torch_shard_step.py``'s smoke mode (the card's ``shard``
    phase) at the smoke config on two gloo CPU processes: (a) bitwise
    against the one-process step, (b) the ring bitwise with its int8
    bytes, (c) the elastic restore's plan and a finite resumed loss."""
    r0, r1 = _tool("torch_shard_step").run_pair(
        "smoke", layers=0, device="cpu", out_dir=str(tmp_path),
        timeout_s=120.0, log=lambda m: None)
    assert r0["a"]["bitwise"] and r0["a"]["loss_max_abs"] == 0.0
    for r in (r0, r1):
        assert r["b"]["ring"]["differ"] == [] and r["b"]["ring"]["leaves"]
        assert r["b"]["wire"]["bytes"]["int8"] == r["b"]["int8_bytes_want"]
        assert r["c"]["plan"] == [[1, 2], [1, 2], 1]
        assert r["c"]["restored_step"] == 2
        assert np.isfinite(r["c"]["resumed_loss"])
        assert r["restore_check"]["below_energy_slack"] == []
    assert r0["c"]["resumed_loss"] == r1["c"]["resumed_loss"]


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v3-671b"])
def test_train_loss_with_hoisted_gathers_is_the_plain_loss(arch):
    """The pod ring's loss (``h0``, ``mtp_pre``, the gather-free
    cross-entropy) equals the plain ``train_loss`` bit for bit, gradients
    included (the gathers' cotangents scattered back), and the
    gather-free cross-entropy equals the JAX package's."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as TM

    cfg = tbase.get(arch, smoke=True)
    params = TT.init_state(cfg, 0, TT.StepConfig().opt, device="cpu")[
        "params"]
    batch = ranks.synth_batch(cfg, tbase.SMOKE_SHAPE, 0)
    table = params["embed"]["embedding"]
    plain_tbl = table.detach().requires_grad_(True)
    plain = TM.train_loss(dict(params, embed={"embedding": plain_tbl}),
                          cfg, batch)
    (g_plain,) = torch.autograd.grad(plain, [plain_tbl])
    tbl = table.detach().requires_grad_(True)
    tok, lab = batch["tokens"].long(), batch["labels"].long()
    hoisted = [table[tok].detach().requires_grad_(True)]
    if cfg.family == "moe":
        hoisted += [table[tok].detach().requires_grad_(True),
                    table[lab].detach().requires_grad_(True)]
    loss = TM.train_loss(dict(params, embed={"embedding": tbl}), cfg, batch,
                         h0=hoisted[0], mtp_pre=tuple(hoisted[1:]) or None,
                         gather_free=True)
    grads = torch.autograd.grad(loss, [tbl] + hoisted)
    assert torch.equal(loss, plain)
    g = grads[0].float()
    for dh, idx in zip(grads[1:], (tok, tok, lab)):
        g = g.index_add(0, idx.reshape(-1), dh.reshape(-1, g.shape[1]).float())
    # the plain loss sums the table's two gradients (the unembed's product
    # and the gather's scatter) in bf16, the hoisted one in f32
    err = float((g - g_plain.float()).abs().max())
    assert err <= 2 ** -7 * float(g_plain.float().abs().max()), err
    logits = torch.randn(2, 5, 48, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 48, (2, 5), generator=torch.Generator()
                           .manual_seed(1))
    t = TL.cross_entropy(logits, labels, gather_free=True)
    assert torch.equal(t, TL.cross_entropy(logits, labels))
    j = JL.cross_entropy(jnp.asarray(logits.numpy()),
                         jnp.asarray(labels.numpy()), gather_free=True)
    assert abs(float(j) - float(t)) <= 1e-6
