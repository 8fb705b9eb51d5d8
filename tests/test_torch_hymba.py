"""The hybrid family (hymba) of the port against the JAX package (CPU).

Same weights in both packages (the JAX package materializes the smoke
config, the port takes it through ``from_numpy_tree``), same inputs drawn
with numpy from a seed. Tolerances:

* ``global_layer_ids``, ``layer_runs`` and the specs are exact;
* ``fuse`` in f32, rtol/atol 1e-6 (two rmsnorms and a mean of products,
  the same operations in the same order), in bf16 atol 1e-2 (one bf16
  step at the O(1) outputs);
* ``forward`` f32 logits rtol/atol 1e-4 and ``train_loss`` rtol 1e-5,
  the gradient of every parameter leaf rtol 1e-4 / atol 1e-5 against
  ``jax.grad`` of the JAX package's ``train_loss`` with no ``bspec``
  (its ``train_loop`` needs a mesh this JAX version refuses:
  ROADMAP.md, open items) — the MoE family's bounds. Sequences of 40
  and 48 tokens pass the smoke config's 32-token window, and 48 runs the
  SSM scan as three chunks of 16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import hymba as JH
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.core import pytree
from repro_torch.models import hymba as TH
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT

ARCH = "hymba-1.5b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_layers", [1, 2, 3, 7, 12, 32])
@pytest.mark.parametrize("n_global", [0, 1, 2, 3, 4, 5])
def test_global_layer_ids_and_runs_match_jax(n_layers, n_global):
    jc = dataclasses.replace(jbase.get(ARCH), n_layers=n_layers,
                             n_global_layers=n_global)
    tc = dataclasses.replace(tbase.get(ARCH), n_layers=n_layers,
                             n_global_layers=n_global)
    gids = JH.global_layer_ids(jc)
    assert TH.global_layer_ids(tc) == gids
    # the runs walk every layer once, in order, each kind's stack in order
    walked, seen = [], {True: 0, False: 0}
    for is_g, first, count in TH.layer_runs(tc):
        assert first == seen[is_g] and count >= 1
        seen[is_g] += count
        walked += [is_g] * count
    assert walked == [i in set(gids) for i in range(n_layers)]


def test_full_width_runs_are_five():
    assert TH.global_layer_ids(tbase.get(ARCH)) == (0, 16, 31)
    assert TH.layer_runs(tbase.get(ARCH)) == [
        (True, 0, 1), (False, 0, 15), (True, 1, 1), (False, 15, 14),
        (True, 2, 1)]


@pytest.mark.parametrize("layers", [None, 3])
def test_fusion_spec_matches_jax(layers):
    jspec = JH.fusion_spec(jbase.get(ARCH), layers)
    tspec = TH.fusion_spec(tbase.get(ARCH), layers)
    assert list(jspec) == list(tspec)
    for k, js in jspec.items():
        ts = tspec[k]
        assert (ts.shape, ts.axes, ts.init, ts.scale) == \
            (js.shape, js.axes, js.init, js.scale), k
        assert ts.dtype == torch.float32 and np.dtype(js.dtype).name == \
            "float32", k


@pytest.mark.parametrize("dtype,tol", [
    ("float32", dict(rtol=1e-6, atol=1e-6)),
    ("bfloat16", dict(rtol=0.0, atol=1e-2))])
def test_fuse_matches_jax(dtype, tol):
    jc, tc = jbase.get(ARCH, smoke=True), tbase.get(ARCH, smoke=True)
    rng = np.random.default_rng(6)
    pf = {k: (1.0 + 0.1 * rng.standard_normal(jc.d_model)).astype(np.float32)
          for k in ("attn_norm", "ssm_norm", "attn_gain", "ssm_gain")}
    a, s = (rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
            for _ in range(2))
    jd = jnp.dtype(dtype)
    want = JH.fuse({k: jnp.asarray(v) for k, v in pf.items()},
                   jnp.asarray(a).astype(jd), jnp.asarray(s).astype(jd), jc)
    td = getattr(torch, dtype)
    got = TH.fuse({k: torch.from_numpy(v) for k, v in pf.items()},
                  torch.from_numpy(a).to(td), torch.from_numpy(s).to(td), tc)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def _f32_params():
    jc = dataclasses.replace(jbase.get(ARCH, smoke=True), dtype="float32")
    tc = dataclasses.replace(tbase.get(ARCH, smoke=True), dtype="float32")
    jp = JP.cast_tree(JP.materialize(jax.random.PRNGKey(0),
                                     JT.param_spec(jc)), jnp.float32)
    return jc, jp, tc, TP.from_numpy_tree(jax.device_get(jp), "cpu")


def _batch(vocab, seq):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, vocab, size=(2, seq)).astype(np.int32)
    mask = np.ones((2, seq), np.float32)
    mask[1, seq - 4:] = 0.0
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "mask": mask}


@pytest.mark.parametrize("seq", [16, 40, 48])
def test_forward_matches_jax(seq):
    jc, jp, tc, tp = _f32_params()
    toks = _batch(jc.vocab_size, seq)["tokens"]
    jl, ja, _ = JT.forward(jp, jc, jnp.asarray(toks))
    tl, ta, _ = TT.forward(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    assert ta.item() == float(ja) == 0.0


@pytest.mark.parametrize("seq", [40, 48])
def test_train_loss_and_grads_match_jax(seq):
    jc, jp, tc, tp = _f32_params()
    batch = _batch(jc.vocab_size, seq)
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
    assert any("['ssm']['a_log']" in k for k in live)
    for key, g in zip(live, grads):
        np.testing.assert_allclose(g.numpy(), want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def test_remat_gives_the_same_loss():
    _, _, tc, tp = _f32_params()
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tc.vocab_size, 40).items()}
    base = TT.train_loss(tp, tc, batch)
    assert torch.equal(base, TT.train_loss(
        tp, dataclasses.replace(tc, remat=False), batch))


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_unported_families_still_name_their_item(arch):
    with pytest.raises(NotImplementedError, match="Other model families"):
        tbase.get(arch)
    cfg = dataclasses.replace(tbase.get(ARCH, smoke=True),
                              family=jbase.get(arch).family)
    with pytest.raises(NotImplementedError, match="Other model families"):
        TT.param_spec(cfg)
