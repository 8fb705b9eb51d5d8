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
