"""Training of the hybrid, xLSTM and MoE/MLA families: the port against the
JAX package (CPU).

Each case runs one of ``hymba-1.5b``, ``xlstm-1.3b``,
``moonshot-v1-16b-a3b`` and ``deepseek-v3-671b`` at its smoke config, with
the same weights in both packages (the JAX package materializes the spec,
the port takes it through ``state_from_numpy``) and the same batches
(``synth_batch``'s numpy draws). The reference step is the JAX package's
``transformer.train_loss`` with no ``bspec`` under ``jax.value_and_grad``,
the warmup-cosine schedule and ``optim.update``, written into a loop
here: the JAX package's own ``train_loop`` needs a mesh that this JAX
version refuses (ROADMAP.md, open items).

Tolerances and why:

* losses, every step: rtol 1e-5, each family's ``train_loss`` bound
  (``tests/test_torch_{hymba,xlstm,moe}.py``), f32 on both sides;
* params after five AdamW steps: rtol 1e-4 (the dense five-step bound,
  ``tests/test_torch_train.py``) plus an atol of a share of the leaf's
  largest change over the five steps (~5e-4, a few learning rates): 5e-3
  for hymba and the MoE archs, 2e-2 for xlstm. AdamW divides each
  gradient element by its own running magnitude, so an element's
  gradient error relative to that element, not to the leaf, sets its
  update's error: the families' gradient bounds (atol 1e-5 at gradients
  of ~1e-2; xlstm 2e-3 of the leaf's largest |gradient|, its mLSTM
  dividing by max(|den|, e^-m)) carried into small elements. Measured
  worst past rtol: 0.26 % of the change (hymba, moonshot, deepseek),
  0.57 % (xlstm); the losses agree to 4e-7;
* a HYBRID checkpoint of ``train_loop`` read by the JAX package's
  ``read_state`` and by the port's: params and count bitwise against the
  state emitted at the saved step, each moment leaf within
  ``error_bound(1e-2)`` relative L2 (the codec's bound);
* the per-chunk remat of the SSM scan, the grouped packing of the HYBRID
  device stage and the sLSTM's step views: the same bits as the form
  they replace (same operations in the same order).
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.checkpoint import serialization as JS
from repro.configs import base as jbase
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.checkpoint import serialization as TS
from repro_torch.checkpoint.manager import default_lossy_policy
from repro_torch.configs import base as tbase
from repro_torch.core import pytree
from repro_torch.core.session import InSituPlan, Placement, TaskSpec, When
from repro_torch.data.pipeline import batch_spec_for, synth_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import spectral_lossy as K
from repro_torch.launch import train as TL
from repro_torch.models import params as TP
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TM
from repro_torch.models import xlstm as TX
from repro_torch.models.layers import rmsnorm

ARCHS = ("hymba-1.5b", "xlstm-1.3b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b")
STEP = TL.StepConfig()
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
#: atol as a share of a leaf's largest change over the five steps
PARAM_MOVE_TOL = {"hymba-1.5b": 5e-3, "xlstm-1.3b": 2e-2,
                  "moonshot-v1-16b-a3b": 5e-3, "deepseek-v3-671b": 5e-3}


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _jax_state(arch, count=50, seed=1):
    cfg = jbase.get(arch, smoke=True)
    params = _f32(JP.materialize(jax.random.PRNGKey(seed),
                                 JT.param_spec(cfg)))
    ost = JO.init(params, JO.AdamWConfig())
    return cfg, {"params": params, "mu": ost.mu, "nu": ost.nu,
                 "count": jnp.asarray(count, jnp.int32)}


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


def _batches(arch, n):
    spec = batch_spec_for(tbase.get(arch, smoke=True), tbase.SMOKE_SHAPE)
    return [synth_batch(spec, i) for i in range(n)]


def _np_tree(tree):
    if isinstance(pytree.leaves(tree)[0], torch.Tensor):
        return {pytree.keystr(p): t.detach().float().numpy()
                for p, t in pytree.flatten_with_path(tree)}
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_five_steps_match_jax(arch):
    jcfg, jstate = _jax_state(arch)
    tcfg = tbase.get(arch, smoke=True)
    start = _np_tree(jstate["params"])
    jstep = _jax_step(jcfg)
    tstep = TL.make_train_step(tcfg, STEP)
    tstate = TL.state_from_numpy(jax.device_get(jstate), "cpu")
    jlosses, tlosses = [], []
    for b in _batches(arch, 5):
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, m = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        jlosses.append(float(jl))
        tlosses.append(m["loss"].item())
    assert all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert int(tstate["count"]) == int(jstate["count"]) == 55
    got, want = _np_tree(tstate["params"]), _np_tree(jstate["params"])
    assert set(got) == set(want)
    for k in want:
        moved = float(np.abs(want[k] - start[k]).max())
        assert moved > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_MOVE_TOL[arch] * moved,
                                   err_msg=k)


def _jax_template(arch):
    cfg = jbase.get(arch, smoke=True)
    params = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(cfg))
    ost = JO.init(params, JO.AdamWConfig())
    return {"params": params, "mu": ost.mu, "nu": ost.nu,
            "count": ost.count}


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_checkpoint_restores_in_both_packages(arch, tmp_path):
    """``train_loop(arch, insitu_mode="hybrid")`` saves at steps 0 and 2
    (the device stage through kernels 2-4's CPU twins); both packages'
    ``read_state`` restore step 2 into their own trees: params and count
    the bits emitted at step 2, moments within the codec's bound."""
    emitted: dict = {}

    def keep(step, payload):
        emitted.update({pytree.keystr(p): np.array(a) for p, a in
                        pytree.flatten_with_path(payload)})

    base = InSituPlan.from_dict(TL.default_train_plan(
        insitu_mode="hybrid", ckpt_dir=str(tmp_path), ckpt_every=2,
        device="cpu"))
    probe = TaskSpec(name="probe", stream="train_state",
                     trigger=When(lambda st: st == 2),
                     placement=Placement.SYNC, sink=keep)
    plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                      workers=base.workers)
    out = TL.train_loop(arch, steps=3, plan=plan, device="cpu",
                        log=lambda _: None)
    assert np.isfinite(out["losses"]).all()
    assert out["session_report"]["checkpoint"]["kept_steps"] == [0, 2]
    d = str(tmp_path / "step_000000002")
    jtree = JS.read_state(d, _jax_template(arch))
    got_j = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    ttemplate = TL.init_state(tbase.get(arch, smoke=True), 5,
                              STEP.opt, device="cpu")
    got_t = {pytree.keystr(p): t for p, t in
             pytree.flatten_with_path(TS.read_state(d, ttemplate, "cpu"))}
    assert set(got_j) == set(got_t) == set(emitted)
    if arch == "xlstm-1.3b":
        assert "['mu']['super']['mlstm']['wq']" in emitted
    bound = ref.error_bound(1e-2)
    n_lossy = 0
    for key, want in emitted.items():
        t = got_t[key]
        t_np = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                else t.numpy())
        if default_lossy_policy(key):
            n_lossy += 1
            w = (torch.from_numpy(want.view(np.int16)).view(torch.bfloat16)
                 if want.dtype.kind == "u" else torch.from_numpy(want))
            for got in (torch.from_numpy(np.asarray(got_j[key], np.float32)),
                        t.float()):
                assert ref.rel_l2_error(w.float(), got) <= bound, key
        else:
            np.testing.assert_array_equal(_bits(got_j[key]), _bits(want),
                                          err_msg=key)
            np.testing.assert_array_equal(_bits(t_np), _bits(want),
                                          err_msg=key)
    assert n_lossy == 2 * len(pytree.leaves(ttemplate["params"]))
    assert int(got_j["['count']"]) == 3


def _tool():
    """``tools/torch_family_train.py`` (a script, not a package)."""
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "torch_family_train.py"
    spec = importlib.util.spec_from_file_location("torch_family_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_family_tool_runs_its_gates_on_the_cpu(arch, tmp_path):
    """The card phase's runs (``tools/torch_family_train.py::run``) at the
    smoke config on the CPU, where every step is eager: the run with the
    HYBRID save, the probe and the profiler window gives the plain run's
    losses, and the resume restores step 0 (params bitwise, moments
    within the codec's bound, each in one packed group)."""
    tool = _tool()
    moe = arch in ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
    out = tool.run(arch, smoke=True, save_eager=moe, eager_steps=2,
                   graph_steps=2, ckpt_dir=str(tmp_path / "ck"),
                   device="cpu", log=lambda _: None)
    runs = out["runs"]
    assert runs["graph"]["losses"] == runs["eager"]["losses"]
    assert len(runs["resume"]["losses"]) == 1
    n_leaves = len(pytree.leaves(TM.param_spec(tbase.get(arch,
                                                         smoke=True))))
    assert out["save"]["moment_leaves"] == 2 * n_leaves
    assert out["save"]["groups"] == 1
    assert out["restore"]["below_energy_slack"] == []
    assert 0 < out["restore"]["worst_rel_l2"] <= ref.error_bound(1e-2)
    assert not any(out["launches"].values())       # plain versions here


@pytest.mark.parametrize("arch", ARCHS)
def test_family_tool_checks_kernels_on_the_saves_buffers(arch, tmp_path,
                                                         monkeypatch):
    """``run``'s ``kernel_check`` gets the very buffers the save
    compressed: with a group bound that splits the smoke config's save
    and leaves its largest leaf past the bound, it is called once on the
    largest group within the bound and once on that leaf, and each buffer
    compresses (plain versions, the save's eps) to the q and scale bits
    the graphed run's save made in its dispatch of that group."""
    tool = _tool()
    keys, rows, _ = tool.lossy_layout(tbase.get(arch, smoke=True))
    monkeypatch.setattr(ops, "GROUP_BYTES", (max(rows) - 1) * 256 * 4)
    saved, got = [], {}
    compress_group = ops._compress_group

    def recorded(leaves, g_rows, eps):
        q, scale = compress_group(leaves, g_rows, eps)
        saved.append((q.clone(), scale.clone()))
        return q, scale

    def check(xb, g_rows, label):
        assert xb.dtype == torch.float32 and xb.shape == (sum(g_rows), 256)
        got[label] = (list(g_rows),
                      ops._compress_packed(xb, list(g_rows), tool.EPS))
        return {"blocks": sum(g_rows)}

    monkeypatch.setattr(ops, "_compress_group", recorded)
    moe = arch in ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
    out = tool.run(arch, smoke=True, save_eager=moe, eager_steps=1,
                   graph_steps=2, ckpt_dir=str(tmp_path / "ck"),
                   device="cpu", kernel_check=check, tag="t",
                   log=lambda _: None)
    _, _, groups = tool.lossy_layout(tbase.get(arch, smoke=True))
    assert out["save"]["groups"] == len(groups) > 2
    want = tool.checked_groups(rows, groups)
    assert set(want) == {"largest group", "leaf past the bound"}
    assert want["leaf past the bound"] == [rows.index(max(rows))]
    assert set(out["kernel_check"]) == set(want)
    assert set(got) == {f"t {k}" for k in want}
    for label, grp in want.items():
        g_rows, (q, scale) = got[f"t {label}"]
        assert g_rows == [rows[j] for j in grp]
        # the graphed run's save, one dispatch a group in group order
        sq, sscale = saved[len(saved) - len(groups) + groups.index(grp)]
        assert torch.equal(q, sq) and torch.equal(scale, sscale), label


# ---------------------------------------------------------------------------
# the SSM scan's per-chunk remat
# ---------------------------------------------------------------------------

def _hymba(seq_chunks):
    cfg = dataclasses.replace(tbase.get("hymba-1.5b", smoke=True),
                              dtype="float32")
    prm = pytree.tree_map(lambda t: t.float(), TP.materialize(
        torch.Generator().manual_seed(0), TM.param_spec(cfg), "cpu"))
    return cfg, prm, seq_chunks * cfg.ssm.chunk


def _loss_and_grads(fn, params):
    live = {pytree.keystr(p): t.detach().clone().requires_grad_(True)
            for p, t in pytree.flatten_with_path(params)}
    loss = fn(pytree.unflatten_like(params, live))
    return loss, torch.autograd.grad(loss, list(live.values()))


@pytest.mark.parametrize("where", ["ssm_mixer", "train_loss"])
@pytest.mark.parametrize("chunks", [1, 4])
def test_scan_chunk_remat_is_bitwise(where, chunks):
    """The scan recomputed per chunk in the backward pass gives the loss
    and every gradient bit for bit as the scan kept whole: at the mixer
    (only the chunk remat differs) and at the model's ``train_loss``
    (block and chunk remat both on against both off)."""
    cfg, prm, seq = _hymba(chunks)
    rng = np.random.default_rng(chunks)
    if where == "ssm_mixer":
        p = pytree.tree_map(lambda t: t[0], prm["swa_blocks"]["ssm"])
        x = torch.from_numpy(
            rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32))

        def fn(c):
            return lambda q: (TSSM.ssm_mixer(q, x, c) ** 2).mean()
        params = p
    else:
        tok = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tok),
                 "labels": torch.from_numpy(np.roll(tok, -1, axis=1))}

        def fn(c):
            return lambda q: TM.train_loss(q, c, batch)
        params = prm
    on = _loss_and_grads(fn(cfg), params)
    off = _loss_and_grads(fn(dataclasses.replace(cfg, remat=False)), params)
    assert torch.equal(on[0], off[0])
    assert len(on[1]) == len(off[1])
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the HYBRID device stage in groups
# ---------------------------------------------------------------------------

def _moments(rng, sizes):
    """A state of bf16 moment leaves of ``sizes`` elements (and one
    param leaf the policy passes through)."""
    mk = lambda n: torch.from_numpy(
        (rng.standard_normal(n) * rng.uniform(1e-4, 1.0)).astype(
            np.float32)).to(torch.bfloat16)
    return {"mu": {f"l{i}": mk(n) for i, n in enumerate(sizes)},
            "nu": {f"l{i}": mk(n).abs() for i, n in enumerate(sizes)},
            "params": {"w": mk(100)}}


def _policy(key):
    return "'mu'" in key or "'nu'" in key


SIZES = (300, 5000, 70_000, 2048, 256 * 8 * 3 + 1, 40_000)


@pytest.mark.parametrize("group_bytes", [
    8 * 256 * 4,            # one tile: every leaf a group of its own
    48 * 256 * 4,           # the small leaves share, 160 and 280 rows alone
    200 * 256 * 4,          # 160 rows share, 280 still past the bound
])
def test_grouped_packing_is_bitwise_one_dispatch(group_bytes, monkeypatch):
    state = _moments(np.random.default_rng(0), SIZES)
    monkeypatch.setattr(ops, "GROUP_BYTES", 1 << 40)
    one = ops.spectral_compress_tree(state, 1e-2, _policy)
    monkeypatch.setattr(ops, "GROUP_BYTES", group_bytes)
    grouped = ops.spectral_compress_tree(state, 1e-2, _policy)
    rows = []
    for key in sorted(state["mu"]) * 2:
        nb = -(-state["mu"][key].numel() // 256)
        rows.append(nb + (-nb) % K.HIST_TILE)
    groups = ops._groups(rows, group_bytes)
    assert len(groups) > 1 and len(ops._groups(rows, 1 << 40)) == 1
    big = [g for g in groups if rows[g[0]] * 256 * 4 > group_bytes]
    assert big and all(len(g) == 1 for g in big)
    assert [i for g in groups for i in g] == list(range(len(rows)))
    for g in groups:
        assert len(g) == 1 or sum(rows[i] for i in g) * 256 * 4 <= \
            group_bytes
    n = 0
    for grp in ("mu", "nu"):
        for key in state[grp]:
            x, y = one[grp][key], grouped[grp][key]
            assert isinstance(x, ref.Compressed) and \
                isinstance(y, ref.Compressed)
            n += 1
            assert torch.equal(x.q, y.q) and torch.equal(
                x.scale.view(torch.int32), y.scale.view(torch.int32))
            assert (x.n_elements, x.shape, x.dtype) == \
                (y.n_elements, y.shape, y.dtype)
    assert one["params"]["w"] is grouped["params"]["w"] is \
        state["params"]["w"]
    assert n == 2 * len(SIZES)


@pytest.mark.parametrize("arch,groups", [
    ("smollm-135m", 1), ("hymba-1.5b", None), ("xlstm-1.3b", None)])
def test_group_bound_keeps_smollm_one_dispatch(arch, groups):
    """Full-width smollm-135m's 1,050,928 moment blocks stay one group
    (kernels 2-4 once a save); the larger families' saves split, no group
    past the bound but a single leaf larger than it."""
    spec = TM.param_spec(tbase.get(arch))
    rows = []
    for path, s in pytree.flatten_with_path({"mu": spec, "nu": spec}):
        nb = -(-math.prod(s.shape) // 256)
        rows.append(nb + (-nb) % K.HIST_TILE)
    got = ops._groups(rows, ops.GROUP_BYTES)
    if arch == "smollm-135m":
        assert sum(rows) == 1_050_928
    if groups is not None:
        assert len(got) == groups
    else:
        assert len(got) > 1
    for g in got:
        assert len(g) == 1 or \
            sum(rows[i] for i in g) * 256 * 4 <= ops.GROUP_BYTES


# ---------------------------------------------------------------------------
# the sLSTM's step views
# ---------------------------------------------------------------------------

def _slstm_mixer_indexed(p, x, cfg, unbind: bool = False):
    """``slstm_mixer`` over the plain time loop with each step's input as
    ``gx_all[:, t]`` (one select a step, the form ``unbind`` replaced),
    or, with ``unbind``, over ``slstm_loop`` (the loop ``SLSTMScan`` is
    held to, which takes them through one ``unbind``)."""
    bsz, l, d = x.shape
    nh = cfg.n_heads
    x_in = rmsnorm({"scale": p["ln"]}, x, cfg.norm_eps)
    z = torch.zeros((bsz, nh, d // nh), dtype=torch.float32)
    state = {"c": z, "n": z, "m": z - 1e30, "h": z.to(x.dtype)}
    gx_all = x_in @ p["w_gates"] + p["b_gates"]
    r = TX._recurrent_weights(p["r_gates"])
    if unbind:
        h, state = TX.slstm_loop(cfg, gx_all, r, state)
        h = h.to(x.dtype)
    else:
        hs = []
        for t in range(l):
            state = TX._slstm_step(cfg, gx_all[:, t], state, r)
            hs.append(state["h"])
        h = torch.stack(hs, dim=1).reshape(bsz, l, d).to(x.dtype)
    h = TX._groupnorm(h, p["gn"], nh, cfg.norm_eps)
    y = x + h
    yn = rmsnorm({"scale": p["ffn_ln"]}, y, cfg.norm_eps)
    g = yn @ p["ffn_gate"]
    u = yn @ p["ffn_up"]
    hf = torch.nn.functional.gelu(g.float(), approximate="tanh").to(
        y.dtype) * u
    return y + hf @ p["ffn_down"], state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_step_views_give_the_same_gradients(dtype):
    """The plain time loop (``slstm_loop``, which ``slstm_mixer``'s
    ``SLSTMScan`` is held to in ``tests/test_torch_xlstm.py``) takes its
    steps' inputs through one ``unbind``: the same output bits as a select
    a step, and the same gradient bits (the selects' zero-padded
    gradients add zeros), with one stacked gradient in place of one of
    gx's whole size a step. The mixer's forward is those bits too."""
    cfg = dataclasses.replace(tbase.get("xlstm-1.3b", smoke=True),
                              dtype=dtype)
    spec = TM.param_spec(cfg)["super"]["slstm"]
    prm = TP.materialize(torch.Generator().manual_seed(3), spec, "cpu")
    p = pytree.tree_map(lambda t: t[0].to(getattr(torch, dtype))
                        if t.dtype == torch.bfloat16 else t[0], prm)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    out = []
    for unbind in (False, True):
        live = {k: t.detach().clone().requires_grad_(True)
                for k, t in p.items()}
        xx = x.clone().requires_grad_(True)
        y, state = _slstm_mixer_indexed(live, xx, cfg, unbind)
        loss = (y.float() ** 2).mean() + state["c"].sum()
        out.append((y, torch.autograd.grad(loss, [xx, *live.values()])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(TX.slstm_mixer(p, x, cfg)[0], out[0][0])
