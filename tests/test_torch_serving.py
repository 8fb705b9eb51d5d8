"""Serving parity between the PyTorch port and the JAX package (CPU).

Both packages start from the same weights: the JAX package materializes a
smoke-size ``smollm-135m`` tree, and the port takes it through its weight
bridge. Tolerances:

* the bridge is bitwise (same bits, bf16 through a uint16 view);
* f32 prefill logits agree to rtol/atol 1e-4 (two frameworks, same math,
  different summation order);
* bf16 prefill logits agree to atol 2e-2: every matmul output rounds to
  bf16 (8 significant bits, relative step 2^-8 ~ 4e-3) in both packages
  but at different places, and the differences accumulate over two
  layers; the smoke logits are O(0.1..1);
* greedy token streams of the paged engines are equal in f32 (params and
  cache cast to f32 on both sides), with and without a registered prefix.
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
from repro.serving import engine as JE
from repro.serving import pages as JPG
from repro_torch.configs import base as tbase
from repro_torch.core import host
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import pages as TPG

ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def bridged():
    """(jax cfg, jax params, port cfg, port params), bf16 as materialized."""
    return _bridged(ARCH)


def _f32(jcfg, jprm, tcfg, tprm):
    return (dataclasses.replace(jcfg, dtype="float32"),
            JP.cast_tree(jprm, jnp.float32),
            dataclasses.replace(tcfg, dtype="float32"),
            TP.cast_tree(tprm, torch.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_bridge_is_bitwise(bridged):
    _, jprm, _, tprm = bridged
    jflat = _flat(jax.device_get(jprm))
    tflat = _flat(tprm)
    assert jflat.keys() == tflat.keys()
    for k, ja in jflat.items():
        t = tflat[k]
        assert tuple(t.shape) == ja.shape, k
        ta = host.to_numpy(t)
        assert host.logical_name(ta.dtype) == host.logical_name(ja.dtype), k
        if host.logical_name(ja.dtype) == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(ta.view(np.uint16),
                                          ja.view(np.uint16), err_msg=k)
        else:
            assert ta.dtype == ja.dtype, k
            np.testing.assert_array_equal(ta, ja, err_msg=k)


def test_port_param_spec_matches_jax(bridged):
    jcfg, _, tcfg, _ = bridged
    js = jax.tree_util.tree_leaves_with_path(
        JT.param_spec(jcfg), is_leaf=lambda x: isinstance(x, JP.ParamSpec))
    ts = _flat(TT.param_spec(tcfg))
    jshapes = {jax.tree_util.keystr(p): s.shape for p, s in js}
    assert len(jshapes) == len(ts)
    assert tcfg.n_params() == sum(int(np.prod(s)) for s in jshapes.values())


def _bridged(arch):
    jcfg = jbase.get(arch, smoke=True)
    jprm = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(jcfg))
    return (jcfg, jprm, tbase.get(arch, smoke=True),
            TP.from_numpy_tree(jax.device_get(jprm), "cpu"))


@pytest.mark.parametrize("arch,dtype", [
    ("smollm-135m", "float32"), ("smollm-135m", "bfloat16"),
    ("granite-3-2b", "float32"),
    ("qwen3-4b", "float32"),         # qk_norm, head_dim decoupled
    ("qwen1.5-110b", "float32"),     # qkv bias
])
def test_prefill_logits_match_jax(bridged, arch, dtype):
    jcfg, jprm, tcfg, tprm = bridged if arch == ARCH else _bridged(arch)
    if dtype == "float32":
        jcfg, jprm, tcfg, tprm = _f32(jcfg, jprm, tcfg, tprm)
        tol = dict(rtol=1e-4, atol=1e-4)
    else:
        tol = dict(rtol=0, atol=2e-2)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, jcache, _ = JE.make_prefill(jcfg, 32)(jprm, jnp.asarray(toks))
    tl, tcache, _ = TE.make_prefill(tcfg, 32)(tprm, torch.from_numpy(toks))
    jl = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(tl.float().numpy(), jl, **tol)
    jk = np.asarray(jcache["kv"]["k"].astype(jnp.float32))
    assert tuple(tcache["kv"]["k"].shape) == jk.shape
    np.testing.assert_allclose(tcache["kv"]["k"].float().numpy(), jk, **tol)


def _requests(cls, vocab, seed, n, prefix=None, max_new=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, size=4 if prefix is not None else 8)
        prompt = tail if prefix is None else np.concatenate([prefix, tail])
        out.append(cls(i, prompt.astype(np.int32), max_new=max_new))
    return out


@pytest.mark.parametrize("shared_prefix", [False, True])
def test_paged_engine_token_streams_match_jax(bridged, shared_prefix):
    jcfg, jprm, tcfg, tprm = _f32(*bridged)
    kw = dict(num_pages=9, page_size=16, max_reqs=2, prompt_len=24,
              max_len=64)
    prefix = (np.random.default_rng(7).integers(0, jcfg.vocab_size, size=16)
              .astype(np.int32) if shared_prefix else None)
    ja = _requests(JE.Request, jcfg.vocab_size, 3, 4, prefix)
    tb = _requests(TE.Request, tcfg.vocab_size, 3, 4, prefix)

    jeng = JPG.PagedServingEngine(jcfg, jprm, **kw)
    teng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
    if shared_prefix:
        assert jeng.register_prefix(prefix) == teng.register_prefix(prefix)
    jeng.run(ja, max_steps=64)
    teng.run(tb, max_steps=64)
    for ra, rb in zip(ja, tb):
        assert ra.done and rb.done
        assert ra.out == rb.out, f"request {ra.rid} diverged"
    if shared_prefix:
        assert teng.prefix_stats()["hits"] == 4
        assert teng.prefix_stats() == jeng.prefix_stats()
    assert teng.page_stats() == jeng.page_stats()
    used = teng.page_stats()["used_pages"]
    assert used == (1 if shared_prefix else 0)   # only the pinned prefix


def test_engine_snapshot_payload_matches_jax_leaves(bridged):
    """After the same admits and steps, the port's snapshot payload holds
    the JAX engine's leaves under the same keys (pool to f32 tolerance,
    tables, lengths, tokens and the meta JSON exactly)."""
    from repro.serving.snapshot import _flatten as jflatten
    from repro_torch.core.runtime import default_handoff
    from repro_torch.serving.snapshot import _flatten as tflatten

    jcfg, jprm, tcfg, tprm = _f32(*bridged)
    kw = dict(num_pages=9, page_size=16, max_reqs=2, prompt_len=16,
              max_len=64)
    jeng = JPG.PagedServingEngine(jcfg, jprm, **kw)
    teng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
    for eng, cls in ((jeng, JE.Request), (teng, TE.Request)):
        for r in _requests(cls, jcfg.vocab_size, 5, 2, max_new=8):
            assert eng.admit(r)
        eng.step()
        eng.step()
    jl = jflatten(jeng.snapshot_payload()["cache"])
    tl = tflatten(default_handoff(teng.snapshot_payload()["cache"]))
    assert list(jl) == list(tl)
    for k in jl:
        if k.startswith("['pool']"):
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert jeng.snapshot_payload()["chunk_hints"] == \
        teng.snapshot_payload()["chunk_hints"]
