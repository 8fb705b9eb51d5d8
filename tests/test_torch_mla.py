"""MLA parity between the PyTorch port and the JAX package (CPU).

One attention layer of the smoke ``deepseek-v3-671b`` config, in f32,
with the JAX package's weights through ``from_numpy_tree`` and inputs
drawn with numpy from a seed. Tolerance rtol/atol 1e-4 throughout: the
same math in f32, summed in other orders (the flash attention's chunks,
the absorbed einsums).

* ``mla_attention``: the prefill/training path (per-head K/V from the
  latent, Dk = nope + rope != Dv through the chunked flash attention).
* ``mla_new_cache_entry``: the latent and the shared rope key decode
  appends.
* ``mla_decode``: the absorbed path over a cache that holds the current
  token, at per-row lengths (1, a middle one, full), and the same output
  as the prefill path's last position over the same prefix.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models import mla as JMLA
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.models import mla as TMLA
from repro_torch.models import params as TP

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _setup():
    jc = dataclasses.replace(jbase.get(ARCH, smoke=True), dtype="float32")
    tc = dataclasses.replace(tbase.get(ARCH, smoke=True), dtype="float32")
    prm = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(jc))
    attn = jax.tree.map(lambda t: t[0].astype(jnp.float32),
                        prm["moe_blocks"]["attn"])
    return jc, attn, tc, TP.from_numpy_tree(jax.device_get(attn), "cpu")


def _x(b, s, d, seed=1):
    x = np.random.default_rng(seed).standard_normal((b, s, d))
    x = x.astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _pos(b, s):
    p = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return jnp.asarray(p), torch.from_numpy(np.ascontiguousarray(p))


def test_mla_attention_matches_jax():
    jc, jp, tc, tp = _setup()
    jx, tx = _x(2, 16, jc.d_model)
    jpos, tpos = _pos(2, 16)
    want = JMLA.mla_attention(jp, jx, jc, jpos)
    got = TMLA.mla_attention(tp, tx, tc, tpos)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_new_cache_entry_matches_jax():
    jc, jp, tc, tp = _setup()
    jx, tx = _x(2, 5, jc.d_model, seed=3)
    jpos, tpos = _pos(2, 5)
    for got, want in zip(TMLA.mla_new_cache_entry(tp, tx, tc, tpos + 7),
                         JMLA.mla_new_cache_entry(jp, jx, jc, jpos + 7)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_decode_matches_jax_and_the_prefill_path():
    jc, jp, tc, tp = _setup()
    m = tc.mla
    s = 16
    jx, tx = _x(3, s, jc.d_model, seed=4)
    jpos, tpos = _pos(3, s)
    jckv, jkr = JMLA.mla_new_cache_entry(jp, jx, jc, jpos)
    tckv, tkr = TMLA.mla_new_cache_entry(tp, tx, tc, tpos)
    assert tuple(tckv.shape) == (3, s, m.kv_lora)
    assert tuple(tkr.shape) == (3, s, m.qk_rope)
    lengths = np.array([1, 9, s], np.int32)
    rows = np.arange(3)
    jq, tq = jx[rows, lengths - 1][:, None], tx[rows, lengths - 1][:, None]
    want = JMLA.mla_decode(jp, jq, jc, jckv, jkr, jnp.asarray(lengths))
    got = TMLA.mla_decode(tp, tq, tc, tckv, tkr, torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the absorbed path is the prefill path's last row over the prefix
    full = TMLA.mla_attention(tp, tx, tc, tpos)
    np.testing.assert_allclose(got[:, 0].numpy(),
                               full[rows, lengths - 1].numpy(), **TOL)
