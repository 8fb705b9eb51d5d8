"""The frontend families (audio: ``musicgen-medium``, vlm:
``internvl2-26b``) of the port against the JAX package (CPU).

Both archs are the dense backbone behind a stub that prepends precomputed
frame or patch embeddings in training. Same weights in both packages (the
JAX package materializes the smoke config, the port takes it through
``from_numpy_tree`` / ``state_from_numpy``), same inputs drawn with numpy
from a seed. Tolerances:

* ``splice_prefix``, its mask, ``frontend_embed_shape`` and
  ``synth_batch``'s ``prefix`` are exact (bitwise);
* ``forward`` f32 logits rtol/atol 1e-4 (the dense family's bound); bf16
  logits atol 8e-2: unlike smollm's tied head (logits O(0.5), atol
  2e-2), these untied smoke configs reach |logit| ~3-4.2, where one bf16
  step is 2^-6 ~ 0.016, and every matmul rounds to bf16 at other places
  in the two packages; seeds 0-2 differ by at most 0.047 with the prefix
  and 0.044 without (``tests/test_torch_serving.py`` holds the MoE
  archs, whose logits reach 3.5, at the same bound);
* ``train_loss`` rtol 1e-5 and the gradient of every parameter leaf rtol
  1e-4 / atol 1e-6 against ``jax.value_and_grad`` of the JAX package's
  ``train_loss`` with no ``bspec`` (``tests/test_torch_train.py``'s
  bounds: f32 on both sides, the same math summed in other orders);
* one AdamW step: params rtol 1e-4 / atol 1e-6, bf16 moments one bf16
  step (rtol 2^-7), as ``tests/test_torch_train.py`` holds them, with
  ``mu``'s atol (1 - beta1) x the grads' atol = 1e-7: the moment is a
  tenth of the gradient, so a gradient element of ~5e-8 (within the
  grads' bound of its other package's value but 2 % from it) moves
  its ``mu`` by more than a bf16 step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.checkpoint import serialization as JS
from repro.configs import base as jbase
from repro.data.pipeline import batch_spec_for as j_batch_spec
from repro.data.pipeline import synth_batch as j_synth
from repro.models import frontends as JF
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.core import pytree
from repro_torch.data.pipeline import batch_spec_for, synth_batch
from repro_torch.launch import train as TL
from repro_torch.models import frontends as TF
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT

ARCHS = ("musicgen-medium", "internvl2-26b")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
STEP = TL.StepConfig()


@pytest.mark.parametrize("tok_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_pre,s_tok", [(4, 16), (8, 5), (1, 1)])
def test_splice_prefix_is_the_jax_packages(tok_dtype, s_pre, s_tok):
    """The hidden sequence (the prefix cast to the tokens' dtype, then the
    tokens) and the f32 mask (zeros, then ones), bit for bit."""
    rng = np.random.default_rng(3)
    tok = rng.standard_normal((2, s_tok, 64)).astype(np.float32)
    pre = rng.standard_normal((2, s_pre, 64)).astype(np.float32)
    jh, jm = JF.splice_prefix(jnp.asarray(tok).astype(tok_dtype),
                              jnp.asarray(pre))
    th, tm = TF.splice_prefix(torch.from_numpy(tok).to(getattr(torch,
                                                               tok_dtype)),
                              torch.from_numpy(pre))
    assert th.dtype == getattr(torch, tok_dtype) and tm.dtype == torch.float32
    assert tuple(th.shape) == jh.shape == (2, s_pre + s_tok, 64)
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh.astype(jnp.float32)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm[:, :s_pre].sum() == 0 and bool((tm[:, s_pre:] == 1).all())


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_embed_shape_and_config(arch, smoke):
    jc, tc = jbase.get(arch, smoke=smoke), tbase.get(arch, smoke=smoke)
    assert (tc.frontend, tc.frontend_tokens) == (jc.frontend,
                                                 jc.frontend_tokens)
    for b in (1, 4):
        assert TF.frontend_embed_shape(tc, b) == \
            tuple(JF.frontend_embed_shape(jc, b))


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_synth_batch_prefix_is_the_jax_packages(arch, step):
    """``batch_spec_for`` carries the frontend tokens, and every key of
    ``synth_batch`` (``prefix`` among them) is the JAX package's bits."""
    jspec = j_batch_spec(jbase.get(arch, smoke=True), jbase.SMOKE_SHAPE)
    tspec = batch_spec_for(tbase.get(arch, smoke=True), tbase.SMOKE_SHAPE)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    jb, tb = j_synth(jspec, step), synth_batch(tspec, step)
    assert sorted(tb) == sorted(jb) == ["labels", "prefix", "tokens"]
    assert tb["prefix"].shape == (2, tspec.frontend_tokens, tspec.d_model)
    for k in jb:
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def _params(arch, dtype="float32", seed=0):
    jc = dataclasses.replace(jbase.get(arch, smoke=True), dtype=dtype)
    tc = dataclasses.replace(tbase.get(arch, smoke=True), dtype=dtype)
    jp = JP.materialize(jax.random.PRNGKey(seed), JT.param_spec(jc))
    if dtype == "float32":
        jp = JP.cast_tree(jp, jnp.float32)
    return jc, jp, tc, TP.from_numpy_tree(jax.device_get(jp), "cpu")


def _batch(cfg, seq, mask=False, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, seq)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
           "prefix": rng.standard_normal(
               (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    if mask:
        m = np.ones((2, seq), np.float32)
        m[1, seq - 4:] = 0.0
        out["mask"] = m
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_a_prefix_matches_jax(arch, dtype):
    """Logits over prefix + tokens (S_pre + 16 positions: the smoke
    configs' 16-wide attention chunks cut the sequence), the aux loss 0
    and the loss mask, against the JAX package's."""
    jc, jp, tc, tp = _params(arch, dtype)
    b = _batch(tc, 16)
    jl, ja, jm = JT.forward(jp, jc, jnp.asarray(b["tokens"]),
                            prefix_embeds=jnp.asarray(b["prefix"]))
    tl, ta, tm = TT.forward(tp, tc, torch.from_numpy(b["tokens"]),
                            prefix_embeds=torch.from_numpy(b["prefix"]))
    assert tuple(tl.shape) == jl.shape == (2, tc.frontend_tokens + 16,
                                           tc.padded_vocab)
    tol = F32_TOL if dtype == "float32" else dict(rtol=0, atol=8e-2)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)), **tol)
    assert ta.item() == float(ja) == 0.0
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_a_prefix_is_ignored_without_a_frontend():
    """A prefix given to a config with no frontend changes nothing (as in
    the JAX package): the logits are those of the tokens alone."""
    jc, jp, tc, tp = _params("smollm-135m")
    assert tc.frontend is None
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tc.vocab_size, size=(2, 12)).astype(np.int32)
    pre = rng.standard_normal((2, 3, tc.d_model)).astype(np.float32)
    bare, _, m0 = TT.forward(tp, tc, torch.from_numpy(toks))
    got, _, m1 = TT.forward(tp, tc, torch.from_numpy(toks),
                            prefix_embeds=torch.from_numpy(pre))
    assert torch.equal(got, bare) and torch.equal(m0, m1)
    assert tuple(got.shape[:2]) == (2, 12)
    jl, _, _ = JT.forward(jp, jc, jnp.asarray(toks),
                          prefix_embeds=jnp.asarray(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **F32_TOL)
    # a frontend arch given no prefix runs the tokens alone too
    jc, jp, tc, tp = _params("musicgen-medium")
    got, _, m = TT.forward(tp, tc, torch.from_numpy(toks % tc.vocab_size))
    assert tuple(got.shape[:2]) == (2, 12) and bool((m == 1).all())


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, mask):
    """The loss over the tokens only (labels and a user mask left-padded
    over the prefix) and the gradient of every leaf, against
    ``jax.value_and_grad`` of the JAX package's ``train_loss``."""
    jc, jp, tc, tp = _params(arch)
    batch = _batch(tc, 20, mask=mask)
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
    for key, g in zip(live, grads):
        np.testing.assert_allclose(g.numpy(), want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    # the prefix is really in the loss's forward: without it, other loss
    no_prefix = {k: torch.from_numpy(v) for k, v in batch.items()
                 if k != "prefix"}
    assert TT.train_loss(tp, tc, no_prefix).item() != loss.item()


def test_user_mask_over_the_tokens_only():
    """A user mask that keeps no token gives the same loss as a mask that
    keeps them all but one token: the padded prefix slots count in
    neither (their loss mask is zero)."""
    _, _, tc, tp = _params("internvl2-26b")
    b = {k: torch.from_numpy(v) for k, v in _batch(tc, 10).items()}
    one = torch.zeros((2, 10))
    one[0, 3] = 1.0
    l_one = TT.train_loss(tp, tc, dict(b, mask=one))
    logits, _, _ = TT.forward(tp, tc, b["tokens"], prefix_embeds=b["prefix"])
    row = logits[0, tc.frontend_tokens + 3, :tc.vocab_size].double()
    want = torch.logsumexp(row, 0) - row[int(b["labels"][0, 3])]
    np.testing.assert_allclose(l_one.item(), want.item(), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_optim_update(arch):
    """``make_train_step`` on a batch with its ``prefix`` against the JAX
    package's ``train_loss`` + ``optim.update`` at the same schedule."""
    jc, jp, tc, _ = _params(arch)
    ost = JO.init(jp, JO.AdamWConfig())
    jstate = {"params": jp, "mu": ost.mu, "nu": ost.nu,
              "count": jnp.asarray(50, jnp.int32)}
    batch = synth_batch(batch_spec_for(tc, tbase.SMOKE_SHAPE), 0)
    assert "prefix" in batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.train_loss(p, jc, jb))(jstate["params"])
    lr = JO.schedules.warmup_cosine(jstate["count"], peak=STEP.lr_peak,
                                    warmup=STEP.lr_warmup,
                                    total=STEP.lr_total)
    jparams, jost = JO.update(
        jgrads, JO.AdamWState(jstate["count"], ost.mu, ost.nu, None), jp,
        JO.AdamWConfig(), lr=lr)
    tstate = TL.state_from_numpy(jax.device_get(jstate), "cpu")
    tnew, metrics = TL.make_train_step(tc, STEP)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                               rtol=1e-5)
    assert int(tnew["count"]) == int(jost.count) == 51

    def close(got, want, **tol):
        want = {jax.tree_util.keystr(p): np.asarray(x, np.float32) for p, x
                in jax.tree_util.tree_flatten_with_path(want)[0]}
        got = {pytree.keystr(p): t.float().numpy()
               for p, t in pytree.flatten_with_path(got)}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)

    close(tnew["params"], jparams, rtol=1e-4, atol=1e-6)
    for grp, want, atol in (("mu", jost.mu, 1e-7), ("nu", jost.nu, 1e-12)):
        assert all(t.dtype == torch.bfloat16
                   for t in pytree.leaves(tnew[grp]))
        close(tnew[grp], want, rtol=2 ** -7, atol=atol)


def test_musicgen_hybrid_checkpoint_restores_in_jax(tmp_path):
    """A smoke HYBRID ``train_loop("musicgen-medium")`` (batches with their
    frame prefix; the lossy stage through kernels 2-5's CPU twins) saves
    checkpoints that the JAX package's ``read_state`` restores into its
    own state tree, finite, at the saved step."""
    logs: list[str] = []
    out = TL.train_loop("musicgen-medium", steps=7, insitu_mode="hybrid",
                        ckpt_dir=str(tmp_path), ckpt_every=5, device="cpu",
                        log=logs.append)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 7
    rep = out["session_report"]
    assert rep["errors"] == [] and rep["checkpoint"]["kept_steps"] == [0, 5]
    cfg = jbase.get("musicgen-medium", smoke=True)
    params = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(cfg))
    ost = JO.init(params, JO.AdamWConfig())
    template = {"params": params, "mu": ost.mu, "nu": ost.nu,
                "count": ost.count}
    restored = JS.read_state(str(tmp_path / "step_000000005"), template)
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    assert all(np.isfinite(np.asarray(x, np.float32)).all()
               for x in jax.tree.leaves(restored))
    assert int(restored["count"]) == 6
