"""The xLSTM family (xlstm-1.3b) of the port against the JAX package (CPU).

Both packages start from the same parameters (the JAX package
materializes the spec, the port takes it through its weight bridge) and
the same inputs, drawn with numpy from a seed. Each test runs at the
smoke config (4 blocks, one sLSTM per 2: one mLSTM layer a super-block)
and at a variant of it with 8 blocks and one sLSTM per 4 (three mLSTM
layers a super-block, so the doubly stacked axis is larger than 1).
Tolerances:

* mixers in f32: rtol/atol 2e-5. The port adds in other orders than
  XLA (the chunk's three-operand einsums, the variance); both stay near
  f32 rounding (1.2e-7 relative) over 40 steps of O(1) values. In bf16:
  atol 3e-2 on outputs of O(1), the SSM mixer's bound: every projection
  rounds to bf16 (relative step 2^-8 ~ 4e-3) in both packages, at
  places XLA's CPU backend sometimes keeps in f32;
* the chunkwise form against the port's own stepwise oracle, and
  decode stepped over a sequence against the mixer: rtol/atol 2e-5;
* ``forward`` f32 logits rtol 1e-4 / atol 5e-4 and ``train_loss`` rtol
  1e-5; the gradient of every parameter leaf against ``jax.grad`` within
  rtol 1e-4 plus 2e-3 of that leaf's largest |gradient|. The family is
  ill-conditioned at random init: the mLSTM output divides by
  max(|den|, e^-m), and |den| near 0 amplifies summation-order
  differences (gradients reach 100-120 at the embedding). The JAX
  package against itself, scanned against unrolled, differs by up to
  1.1e-4 in the logits and 3.6e-4 of a leaf's largest gradient at the
  8-block variant (seeds 0-1); the port against it by up to 2.6e-4 and
  1.9e-3 (seeds 0-2). Remat on and off give the same loss and gradient
  bits;
* the specs, the state shapes and the parameter count are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.configs import base as tbase
from repro_torch.core import pytree
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX

ARCH = "xlstm-1.3b"
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=0.0, atol=3e-2)
MODEL_F32 = dict(rtol=1e-4, atol=5e-4)
GRAD_RTOL, GRAD_SCALE_TOL = 1e-4, 2e-3
VARIANTS = ("smoke", "per3")


def _cfgs(variant, dtype="bfloat16"):
    jc, tc = jbase.get(ARCH, smoke=True), tbase.get(ARCH, smoke=True)
    if variant == "per3":
        jc = dataclasses.replace(
            jc, n_layers=8, xlstm=dataclasses.replace(jc.xlstm, slstm_every=4))
        tc = dataclasses.replace(
            tc, n_layers=8, xlstm=dataclasses.replace(tc.xlstm, slstm_every=4))
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype))


def _bridge(jspec, dtype, seed):
    jprm = JP.materialize(jax.random.PRNGKey(seed), jspec)
    if dtype == "float32":
        jprm = JP.cast_tree(jprm, jnp.float32)
    return jprm, TP.from_numpy_tree(jax.device_get(jprm), "cpu")


def _x(shape, dtype, seed=3):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _mlstm(variant, dtype, seed=2):
    jc, tc = _cfgs(variant, dtype)
    return (jc, tc) + _bridge(JX.mlstm_spec(jc), dtype, seed)


def _slstm(variant, dtype, seed=4):
    jc, tc = _cfgs(variant, dtype)
    return (jc, tc) + _bridge(JX.slstm_spec(jc), dtype, seed)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("length", [32, 24])
def test_mlstm_mixer_matches_jax(variant, dtype, tol, length):
    """chunk 16: two chunks (32), and a ragged length (24 % 16 != 0: one
    chunk of 24, the chunk rule). The final state too."""
    jc, tc, jp, tp = _mlstm(variant, dtype)
    jx, tx = _x((2, length, jc.d_model), dtype)
    jy, jst = JX.mlstm_mixer(jp, jx, jc, return_state=True)
    ty, tst = TX.mlstm_mixer(tp, tx, tc, return_state=True)
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    assert sorted(tst) == sorted(jst)
    for k in ("c", "n", "m"):
        assert tst[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k, **F32
                                   if dtype == "float32" else tol)
    np.testing.assert_allclose(_np(tst["conv"]), _np(jst["conv"]), **tol)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("length", [32, 24, 7])
def test_chunkwise_equals_the_stepwise_reference(variant, length):
    _, tc, _, tp = _mlstm(variant, "float32")
    _, tx = _x((2, length, tc.d_model), "float32", seed=5)
    np.testing.assert_allclose(_np(TX.mlstm_mixer(tp, tx, tc)),
                               _np(TX.mlstm_mixer_reference(tp, tx, tc)),
                               **F32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_mlstm_decode_stepped_equals_the_mixer(variant):
    """From the zero state (m at -1e30), 24 decode steps give the mixer's
    outputs and its final state."""
    _, tc, _, tp = _mlstm(variant, "float32")
    _, tx = _x((2, 24, tc.d_model), "float32", seed=6)
    want, wst = TX.mlstm_mixer(tp, tx, tc, return_state=True)
    shapes = TX.mlstm_state_shape(tc, 2)
    st = {k: torch.zeros(s) for k, s in shapes.items()}
    st["m"].fill_(TX.NEG)
    outs = []
    for t in range(24):
        y, st = TX.mlstm_decode(tp, tx[:, t:t + 1], tc, st)
        outs.append(y)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(want), **F32)
    for k in ("c", "n", "m", "conv"):
        np.testing.assert_allclose(_np(st[k]), _np(wst[k]), err_msg=k, **F32)


def test_mlstm_decode_matches_jax():
    jc, tc, jp, tp = _mlstm("smoke", "float32")
    rng = np.random.default_rng(8)
    shapes = JX.mlstm_state_shape(jc, 2)
    assert TX.mlstm_state_shape(tc, 2) == shapes
    st = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    st["n"] = np.abs(st["n"])
    st["m"] = rng.uniform(-2, 0, shapes["m"]).astype(np.float32)
    jx, tx = _x((2, 1, jc.d_model), "float32", seed=9)
    jy, jst = JX.mlstm_decode(jp, jx, jc, {k: jnp.asarray(v)
                                           for k, v in st.items()})
    ty, tst = TX.mlstm_decode(tp, tx, tc, {k: torch.from_numpy(v)
                                           for k, v in st.items()})
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for k in st:
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k, **F32)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_mixer_matches_jax(variant, dtype, tol, with_state):
    """Over 20 steps, from the zero state or from the state 12 earlier
    steps left (the decode path's ``state``)."""
    jc, tc, jp, tp = _slstm(variant, dtype)
    jx, tx = _x((2, 20, jc.d_model), dtype)
    jst = tst = None
    if with_state:
        jx0, tx0 = _x((2, 12, jc.d_model), dtype, seed=10)
        _, jst = JX.slstm_mixer(jp, jx0, jc)
        _, tst = TX.slstm_mixer(tp, tx0, tc)
        for k in jst:
            np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k,
                                       **tol)
    jy, jst = JX.slstm_mixer(jp, jx, jc, jst)
    ty, tst = TX.slstm_mixer(tp, tx, tc, tst)
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    assert TX.slstm_state_shape(tc, 2) == JX.slstm_state_shape(jc, 2)
    for k in ("c", "n", "m", "h"):
        assert tuple(tst[k].shape) == jst[k].shape, k
        assert str(tst[k].dtype).split(".")[-1] == jst[k].dtype.name, k
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_groupnorm_matches_jax(dtype, tol):
    rng = np.random.default_rng(11)
    scale = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    jx, tx = _x((2, 5, 96), dtype, seed=12)
    jx, tx = jx * 3 + 1, tx * 3 + 1
    want = JX._groupnorm(jx, jnp.asarray(scale), 3, 1e-5)
    got = TX._groupnorm(tx, torch.from_numpy(scale), 3, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("variant", VARIANTS + ("full",))
def test_param_spec_matches_jax(variant):
    if variant == "full":
        jc, tc = jbase.get(ARCH), tbase.get(ARCH)
    else:
        jc, tc = _cfgs(variant)
    js = jax.tree_util.tree_leaves_with_path(
        JT.param_spec(jc), is_leaf=lambda x: isinstance(x, JP.ParamSpec))
    jspec = {jax.tree_util.keystr(p): s for p, s in js}
    tspec = {pytree.keystr(p): s
             for p, s in pytree.flatten_with_path(TT.param_spec(tc))}
    assert sorted(tspec) == sorted(jspec)
    for k, js_ in jspec.items():
        ts_ = tspec[k]
        assert (ts_.shape, ts_.axes, ts_.init, ts_.scale) == \
            (js_.shape, js_.axes, js_.init, js_.scale), k
        assert str(ts_.dtype).split(".")[-1] == np.dtype(js_.dtype).name, k
    per = tc.xlstm.slstm_every - 1
    n_super = tc.n_layers // tc.xlstm.slstm_every
    assert tspec["['super']['mlstm']['wq']"].shape[:2] == (n_super, per)
    assert tspec["['super']['slstm']['r_gates']"].axes[:2] == ("layers", None)
    assert tc.n_params() == jc.n_params()
    if variant == "full":
        assert tc.n_params() == 3_606_514_000


def _model(variant):
    jc, tc = _cfgs(variant, "float32")
    jp, tp = _bridge(JT.param_spec(jc), "float32", 0)
    return jc, jp, tc, tp


def _batch(vocab, seq):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, vocab, size=(2, seq)).astype(np.int32)
    mask = np.ones((2, seq), np.float32)
    mask[1, seq - 4:] = 0.0
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "mask": mask}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seq", [16, 40])
def test_forward_matches_jax(variant, seq):
    jc, jp, tc, tp = _model(variant)
    toks = _batch(jc.vocab_size, seq)["tokens"]
    jl, ja, _ = JT.forward(jp, jc, jnp.asarray(toks))
    tl, ta, _ = TT.forward(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_F32)
    assert ta.item() == float(ja) == 0.0


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_loss_and_grads_match_jax(variant):
    jc, jp, tc, tp = _model(variant)
    batch = _batch(jc.vocab_size, 40)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.train_loss(p, jc, {k: jnp.asarray(v)
                                        for k, v in batch.items()}))(jp)
    flat = pytree.flatten_with_path(tp)
    live = {pytree.keystr(p): t.requires_grad_(True) for p, t in flat}
    loss = TT.train_loss(pytree.unflatten_like(tp, live), tc,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(live.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(want) == set(live)
    assert "['super']['slstm']['r_gates']" in live
    for key, g in zip(live, grads):
        w = want[key]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_SCALE_TOL * float(np.abs(w).max()), err_msg=key)


@pytest.mark.parametrize("variant", VARIANTS)
def test_remat_gives_the_same_loss_and_grads(variant):
    _, _, tc, tp = _model(variant)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tc.vocab_size, 40).items()}
    out = []
    for cfg in (tc, dataclasses.replace(tc, remat=False)):
        live = {k: t.detach().clone().requires_grad_(True)
                for k, t in ((pytree.keystr(p), t)
                             for p, t in pytree.flatten_with_path(tp))}
        loss = TT.train_loss(pytree.unflatten_like(tp, live), cfg, batch)
        out.append((loss, torch.autograd.grad(loss, list(live.values()))))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


# ---------------------------------------------------------------------------
# SLSTMScan: the time loop as one autograd node over the cell kernel's
# plain version (on the card, kernels/slstm.py's CUDA kernels; see
# chip_smoke.py's family_train phase)
# ---------------------------------------------------------------------------

#: against the plain loop's autograd: f32 gradients within rtol 1e-5 plus
#: 1e-6 of the leaf's largest |gradient| (the same formulas, summed in
#: other orders); bf16 gradients within one bf16 rounding (2^-8) of the
#: leaf's largest |gradient|. In bf16 the loop takes the recurrent weights
#: in f32 and casts them at each step (``slstm_loop``'s ``r_dtype``): the
#: same forward, and autograd sums their gradient in f32 as the scan's
#: one product does, where a bf16 sum would round its running total once
#: a step
SCAN_GRAD = {"float32": (1e-5, 1e-6), "bfloat16": (0.0, 2.0 ** -8)}
SCAN_STEPS = 19
#: against jax.grad of the JAX package's mixer, f32: rtol 1e-4 plus 1e-5 of
#: the leaf's largest |gradient| (XLA's and torch's CPU kernels sum in
#: other orders; the gradient passes through the post-mixer FFN and the
#: group norm, whose own tolerance is F32's 2e-5)
JAX_GRAD_RTOL, JAX_GRAD_SCALE_TOL = 1e-4, 1e-5


def _scan_inputs(dtype, length=SCAN_STEPS, seed=20):
    tc = dataclasses.replace(tbase.get(ARCH, smoke=True), dtype=dtype)
    d, nh = tc.d_model, tc.n_heads
    dh = d // nh
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    gx = torch.from_numpy(2 * rng.standard_normal((3, length, 4 * d))
                          .astype(np.float32))
    rg = torch.from_numpy((rng.standard_normal((4, nh, dh, dh)) / dh ** 0.5)
                          .astype(np.float32)).to(dt)
    st = {k: torch.from_numpy(rng.standard_normal((3, nh, dh))
                              .astype(np.float32)) for k in ("c", "n", "m")}
    st["n"] = st["n"].abs() + 0.5
    st["h"] = torch.from_numpy(rng.standard_normal((3, nh, dh))
                               .astype(np.float32)).to(dt)
    return tc, gx, rg, st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("initial", ["zero", "given"])
def test_slstm_scan_forward_is_the_loop_bit_for_bit(dtype, initial):
    tc, gx, rg, st = _scan_inputs(dtype)
    if initial == "zero":
        z = torch.zeros_like(st["c"])
        st = {"c": z, "n": z, "m": z - 1e30, "h": z.to(st["h"].dtype)}
    r = TX._recurrent_weights(rg)
    want, wst = TX.slstm_loop(tc, gx, r, dict(st))
    got, c, n, m = TX.SLSTMScan.apply(gx, r, st["c"], st["n"], st["m"],
                                      st["h"])
    assert got.dtype == st["h"].dtype
    assert torch.equal(got, want)
    for k, t in (("c", c), ("n", n), ("m", m)):
        assert torch.equal(t, wst[k]), k
    assert torch.equal(got[:, -1].reshape(wst["h"].shape), wst["h"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan_grads_match_the_loops_autograd(dtype):
    """Gradients of gx, the recurrent weights and every initial state
    leaf, through h and through the final state."""
    tc, gx, rg, st = _scan_inputs(dtype)
    rng = np.random.default_rng(21)
    w_h = torch.from_numpy(rng.standard_normal((3, SCAN_STEPS, tc.d_model))
                           .astype(np.float32))
    w_c = torch.from_numpy(rng.standard_normal(st["c"].shape)
                           .astype(np.float32))
    grads = []
    for scan in (False, True):
        leaves = [gx.clone().requires_grad_(True),
                  rg.clone().requires_grad_(True)] + [
            st[k].clone().requires_grad_(True) for k in ("c", "n", "m", "h")]
        init = dict(zip(("c", "n", "m", "h"), leaves[2:]))
        if scan:
            hs, c, n, m = TX.SLSTMScan.apply(
                leaves[0], TX._recurrent_weights(leaves[1]), *leaves[2:])
        else:
            hs, fin = TX.slstm_loop(
                tc, leaves[0], TX._recurrent_weights(leaves[1].float()),
                init, r_dtype=rg.dtype)
            c, n, m = fin["c"], fin["n"], fin["m"]
        loss = ((hs.float() * w_h).sum() + (c * w_c).sum() + n.sum()
                + 0.1 * m.sum())
        grads.append(torch.autograd.grad(loss, leaves))
    rtol, one = SCAN_GRAD[dtype]
    names = ("gx", "r_gates", "c", "n", "m", "h")
    for name, want, got in zip(names, *grads):
        assert got.dtype == want.dtype, name
        w = want.float().numpy()
        np.testing.assert_allclose(got.float().numpy(), w, rtol=rtol,
                                   atol=one * float(np.abs(w).max()),
                                   err_msg=name)


def _tie_params(jp, tp, case):
    """Parameters (and an initial state) that force ties: ``m`` — the i
    and f gates' weights, biases and recurrent blocks equal and m = 0, so
    that p_f + m == p_i at the first step; ``n`` — the i gate's bias at
    -100 and n = 1e-6, m = 0, so that n' = 1 * 1e-6 + exp(-100 - p_f)
    rounds to the floor 1e-6 at every step."""
    w = np.asarray(jp["w_gates"], np.float32).copy()
    b = np.asarray(jp["b_gates"], np.float32).copy()
    r = np.asarray(jp["r_gates"], np.float32).copy()
    d = w.shape[0]
    if case == "m":
        w[:, :d] = w[:, d:2 * d]
        b[:d] = b[d:2 * d] = 0.25
        r[0] = r[1]
    else:
        b[:d] = -100.0
    jp = dict(jp, w_gates=jnp.asarray(w), b_gates=jnp.asarray(b),
              r_gates=jnp.asarray(r))
    tp = dict(tp, w_gates=torch.from_numpy(w), b_gates=torch.from_numpy(b),
              r_gates=torch.from_numpy(r))
    return jp, tp


@pytest.mark.parametrize("case", ["none", "m", "n"])
def test_slstm_mixer_grads_match_jax_grad(case):
    """x, w_gates, r_gates and b_gates against ``jax.grad`` of the JAX
    package's ``slstm_mixer`` in f32, over 16 steps; ``m`` and ``n``
    force ties in ``jnp.maximum`` (in m' and in n's floor), where JAX
    hands each side half of the cotangent."""
    jc, tc, jp, tp = _slstm("smoke", "float32")
    if case != "none":
        jp, tp = _tie_params(jp, tp, case)
    jx, tx = _x((2, 16, jc.d_model), "float32", seed=22)
    nh, dh = tc.n_heads, tc.d_model // tc.n_heads
    z = np.zeros((2, nh, dh), np.float32)
    init = {"c": z + 0.5, "n": z + (1e-6 if case == "n" else 1.0), "m": z,
            "h": z}
    w_y = np.random.default_rng(23).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    keys = ("w_gates", "r_gates", "b_gates")

    def jloss(x, *ws):
        p = dict(jp, **dict(zip(keys, ws)))
        y, _ = JX.slstm_mixer(p, x, jc,
                              {k: jnp.asarray(v) for k, v in init.items()})
        return jnp.sum(y * w_y)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(jx, *(jp[k] for k in keys))
    leaves = [tx.clone().requires_grad_(True)] + [
        tp[k].clone().requires_grad_(True) for k in keys]
    ty, _ = TX.slstm_mixer(dict(tp, **dict(zip(keys, leaves[1:]))),
                           leaves[0], tc,
                           {k: torch.from_numpy(v) for k, v in init.items()})
    got = torch.autograd.grad((ty * torch.from_numpy(w_y)).sum(), leaves)
    if case == "m":
        # the tie is there: p_f + m == p_i at step 0 in every element
        x_in = TX.rmsnorm({"scale": tp["ln"]}, tx, tc.norm_eps)
        gx = x_in @ tp["w_gates"] + tp["b_gates"]
        d = tc.d_model
        assert torch.equal(gx[:, 0, :d], gx[:, 0, d:2 * d])
    for name, g, w in zip(("x",) + keys, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=JAX_GRAD_RTOL,
            atol=JAX_GRAD_SCALE_TOL * float(np.abs(w).max()), err_msg=name)


def test_slstm_tie_rule_is_jnp_maximums():
    """At a tie the plain backward hands half of the cotangent to each
    side, as ``jnp.maximum``'s does; ``torch.clamp`` would hand it all to
    n (the rule the port's loop used before)."""
    from repro_torch.kernels import slstm as SK

    x = torch.tensor([1e-6, 2e-6, 5e-7], dtype=torch.float32)
    assert SK._max_share(x, SK.N_FLOOR).tolist() == [0.5, 1.0, 0.0]
    g = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 1e-6)))(
        jnp.asarray(x.numpy()))
    assert np.asarray(g).tolist() == [0.5, 1.0, 0.0]
