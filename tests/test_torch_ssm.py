"""The selective SSM mixer of the port against the JAX package (CPU).

Both packages start from the same parameters (the JAX package
materializes ``ssm_spec`` of hymba's smoke config, the port takes them
through its weight bridge) and the same inputs, drawn with numpy from a
seed. Tolerances:

* f32: rtol/atol 2e-5. The port's log-depth scan adds in another order
  than XLA's ``associative_scan``, and the JAX path is itself another
  order than its per-step oracle; both stay near f32 rounding (1.2e-7
  relative) over 48 steps of O(1) values;
* bf16: atol 3e-2 on outputs of O(1) magnitude. Every projection rounds
  to bf16 (relative step 2^-8 ~ 4e-3) in both packages, and XLA's CPU
  backend computes some bf16 elementwise chains in f32 before rounding
  where the port rounds each op;
* ``ssm_state_shape`` and the chunk rule are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import params as JP
from repro.models import ssm as JS
from repro_torch.configs import base as tbase
from repro_torch.models import params as TP
from repro_torch.models import ssm as TS

ARCH = "hymba-1.5b"
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=0.0, atol=3e-2)


def _setup(dtype, chunk=None, seed=2):
    jcfg, tcfg = jbase.get(ARCH, smoke=True), tbase.get(ARCH, smoke=True)
    if chunk is not None:
        jcfg = dataclasses.replace(
            jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=chunk))
        tcfg = dataclasses.replace(
            tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=chunk))
    jprm = JP.materialize(jax.random.PRNGKey(seed), JS.ssm_spec(jcfg))
    if dtype == "float32":
        jprm = JP.cast_tree(jprm, jnp.float32)
    tprm = TP.from_numpy_tree(jax.device_get(jprm), "cpu")
    return jcfg, jprm, tcfg, tprm


def _x(shape, dtype, seed=3):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jx, torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("length", [8, 16, 24, 48, 50])
def test_ssm_mixer_matches_jax_at_the_chunk_rule_edges(length):
    """chunk 16: l < chunk (8), l == chunk, l % chunk != 0 (24, 50: one
    chunk of l), several chunks (48: three). The final state too."""
    jcfg, jprm, tcfg, tprm = _setup("float32")
    jx, tx = _x((2, length, jcfg.d_model), "float32")
    jy, jst = JS.ssm_mixer(jprm, jx, jcfg, return_state=True)
    ty, tst = TS.ssm_mixer(tprm, tx, tcfg, return_state=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k,
                                   **F32)


def test_ssm_mixer_matches_jax_with_one_step_chunks():
    jcfg, jprm, tcfg, tprm = _setup("float32", chunk=1)
    jx, tx = _x((2, 6, jcfg.d_model), "float32")
    np.testing.assert_allclose(_np(TS.ssm_mixer(tprm, tx, tcfg)),
                               _np(JS.ssm_mixer(jprm, jx, jcfg)), **F32)


def test_ssm_mixer_reference_matches_jax():
    jcfg, jprm, tcfg, tprm = _setup("float32")
    jx, tx = _x((2, 20, jcfg.d_model), "float32")
    np.testing.assert_allclose(
        _np(TS.ssm_mixer_reference(tprm, tx, tcfg)),
        _np(JS.ssm_mixer_reference(jprm, jx, jcfg)), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_jax_step_by_step(dtype):
    jcfg, jprm, tcfg, tprm = _setup(dtype)
    jx, tx = _x((2, 12, jcfg.d_model), dtype, seed=4)
    di = JS.d_inner(jcfg)
    jst = {"h": jnp.zeros((2, di, jcfg.ssm.d_state), jnp.float32),
           "conv": jnp.zeros((2, jcfg.ssm.d_conv - 1, di), jnp.dtype(dtype))}
    tst = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "h" else getattr(torch, dtype))
        for k, v in jst.items()}
    tol = F32 if dtype == "float32" else BF16
    for t in range(12):
        jy, jst = JS.ssm_decode(jprm, jx[:, t:t + 1], jcfg, jst)
        ty, tst = TS.ssm_decode(tprm, tx[:, t:t + 1], tcfg, tst)
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=f"step {t}",
                                   **tol)
        assert tst["conv"].dtype == getattr(torch, dtype)
        assert tst["h"].dtype == torch.float32
        np.testing.assert_allclose(_np(tst["h"]), _np(jst["h"]),
                                   err_msg=f"h at step {t}", **tol)


def test_ssm_mixer_matches_jax_in_bf16():
    jcfg, jprm, tcfg, tprm = _setup("bfloat16")
    jx, tx = _x((2, 40, jcfg.d_model), "bfloat16")
    jy, jst = JS.ssm_mixer(jprm, jx, jcfg, return_state=True)
    ty, tst = TS.ssm_mixer(tprm, tx, tcfg, return_state=True)
    assert ty.dtype == torch.bfloat16 and tst["conv"].dtype == torch.bfloat16
    assert tst["h"].dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **BF16)
    np.testing.assert_allclose(_np(tst["h"]), _np(jst["h"]), **BF16)


@pytest.mark.parametrize("smoke", [True, False])
def test_ssm_state_shape_and_spec_match_jax(smoke):
    jcfg, tcfg = jbase.get(ARCH, smoke=smoke), tbase.get(ARCH, smoke=smoke)
    assert TS.ssm_state_shape(tcfg, 3) == JS.ssm_state_shape(jcfg, 3)
    assert TS.d_inner(tcfg) == JS.d_inner(jcfg)
    assert TS._dt_rank(tcfg) == JS._dt_rank(jcfg)
    jspec, tspec = JS.ssm_spec(jcfg, 4), TS.ssm_spec(tcfg, 4)
    assert list(jspec) == list(tspec)
    for k, js in jspec.items():
        ts = tspec[k]
        assert (ts.shape, ts.axes, ts.init, ts.scale) == \
            (js.shape, js.axes, js.init, js.scale), k
        assert str(ts.dtype).split(".")[-1] == np.dtype(js.dtype).name, k


def test_ssm_chunked_matches_stepwise():
    """The port's own chunked scan against its per-step oracle over three
    chunks (``tests/test_models.py``'s property, same tolerance)."""
    _, _, tcfg, tprm = _setup("float32")
    _, tx = _x((2, 3 * tcfg.ssm.chunk, tcfg.d_model), "float32", seed=5)
    np.testing.assert_allclose(_np(TS.ssm_mixer(tprm, tx, tcfg)),
                               _np(TS.ssm_mixer_reference(tprm, tx, tcfg)),
                               rtol=2e-3, atol=2e-3)


def test_ssm_decode_matches_parallel():
    """Decoding a sequence token by token from a zero state gives the
    parallel mixer's output and final state (``tests/test_models.py:117``,
    same tolerance)."""
    _, _, tcfg, tprm = _setup("float32")
    _, tx = _x((2, 12, tcfg.d_model), "float32", seed=4)
    full, st_full = TS.ssm_mixer(tprm, tx, tcfg, return_state=True)
    di = TS.d_inner(tcfg)
    state = {"h": torch.zeros((2, di, tcfg.ssm.d_state)),
             "conv": torch.zeros((2, tcfg.ssm.d_conv - 1, di))}
    outs = []
    for t in range(12):
        y, state = TS.ssm_decode(tprm, tx[:, t:t + 1], tcfg, state)
        outs.append(y)
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full),
                               rtol=2e-3, atol=2e-3)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(state[k]), _np(st_full[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``: above 20 it differs
    from ``x`` by e^-x, which ``F.softplus``'s switch drops."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.0, 20.5, 25.0], np.float32)
    got = TS._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))
