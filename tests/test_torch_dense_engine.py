"""The dense fixed-slot baseline engine of the port against the JAX
package's (CPU).

* ``make_decode`` logits agree with the JAX package's to rtol/atol 1e-4 in
  f32 (same math, different summation order), and the cache rows it
  writes are the JAX ones;
* ``ServingEngine`` greedy token streams equal the JAX engine's in f32;
* the port's paged engine decodes the same tokens as its dense engine
  (``tests/test_paged_serving.py::test_paged_engine_matches_dense``), in
  bf16 and f32: the plain paged attention gathers the pages and runs the
  dense attention on them;
* ``serve_loop(engine_kind="dense")`` serves every request.
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
from repro_torch.configs import base as tbase
from repro_torch.launch.serve import default_serve_plan, serve_loop
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import kvcache
from repro_torch.serving import pages as TPG

ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def bridged():
    jcfg = jbase.get(ARCH, smoke=True)
    jprm = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(jcfg))
    return (jcfg, jprm, tbase.get(ARCH, smoke=True),
            TP.from_numpy_tree(jax.device_get(jprm), "cpu"))


def _f32(jcfg, jprm, tcfg, tprm):
    return (dataclasses.replace(jcfg, dtype="float32"),
            JP.cast_tree(jprm, jnp.float32),
            dataclasses.replace(tcfg, dtype="float32"),
            TP.cast_tree(tprm, torch.float32))


def _requests(cls, vocab, n=3, max_new=4, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, 8).astype(np.int32),
                max_new=max_new) for i in range(n)]


def test_decode_step_matches_jax(bridged):
    jcfg, jprm, tcfg, tprm = _f32(*bridged)
    rng = np.random.default_rng(2)
    b, s = 3, 32
    lengths = np.array([5, 17, 0], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    cache = kvcache.init_cache(tcfg, b, s)          # zeros, then fill
    for leaf in (cache["kv"]["k"], cache["kv"]["v"]):
        leaf.copy_(torch.from_numpy(
            rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
    jin = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), cache)
    jl, jout, jlen = JE.make_decode(jcfg)(jprm, jin, jnp.asarray(toks),
                                          jnp.asarray(lengths))
    tl, tout, tlen = TE.make_decode(tcfg)(
        tprm, cache, torch.from_numpy(toks), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert tlen.tolist() == np.asarray(jlen).tolist()
    assert tout["kv"]["k"] is cache["kv"]["k"]   # updated in place
    for name in ("k", "v"):
        np.testing.assert_allclose(tout["kv"][name].numpy(),
                                   np.asarray(jout["kv"][name]),
                                   rtol=1e-4, atol=1e-4)


def test_insert_at_drops_slots_past_the_end():
    """An idle row's length runs past the cache; JAX's scatter drops such
    a write, and so does the port's (no clamp onto the last slot)."""
    cache = torch.zeros(3, 4, 2)
    new = torch.ones(3, 2)
    TE._insert_at(cache, new, torch.tensor([1, 4, 9], dtype=torch.int32))
    assert cache[0, 1].tolist() == [1.0, 1.0]
    assert int((cache != 0).sum()) == 2         # rows 1 and 2 dropped


@pytest.mark.parametrize("max_new", [4, 7])
def test_dense_engine_token_streams_match_jax(bridged, max_new):
    jcfg, jprm, tcfg, tprm = _f32(*bridged)
    ja = _requests(JE.Request, jcfg.vocab_size, 5, max_new)
    tb = _requests(TE.Request, tcfg.vocab_size, 5, max_new)
    jeng = JE.ServingEngine(jcfg, jprm, slots=2, prompt_len=8, max_len=64)
    teng = TE.ServingEngine(tcfg, tprm, slots=2, prompt_len=8, max_len=64,
                            device="cpu")
    jeng.run(ja, max_steps=64)
    teng.run(tb, max_steps=64)
    for ra, rb in zip(ja, tb):
        assert ra.done and rb.done
        assert ra.out == rb.out, f"request {ra.rid} diverged"
    assert teng.state_version == jeng.state_version
    assert teng.lengths.tolist() == np.asarray(jeng.lengths).tolist()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_engine_matches_dense(bridged, dtype):
    _, _, tcfg, tprm = bridged
    if dtype == "float32":
        tcfg = dataclasses.replace(tcfg, dtype="float32")
        tprm = TP.cast_tree(tprm, torch.float32)
    a = _requests(TE.Request, tcfg.vocab_size)
    b = _requests(TE.Request, tcfg.vocab_size)
    dense = TE.ServingEngine(tcfg, tprm, slots=2, prompt_len=8, max_len=64,
                             device="cpu")
    dense.run(a, max_steps=64)
    paged = TPG.PagedServingEngine(tcfg, tprm, num_pages=9, page_size=16,
                                   max_reqs=2, prompt_len=8, max_len=64,
                                   device="cpu")
    paged.run(b, max_steps=64)
    for ra, rb in zip(a, b):
        assert ra.done and rb.done
        assert ra.out == rb.out, f"request {ra.rid} diverged"


def test_dense_snapshot_payload_has_the_cache():
    tcfg = tbase.get(ARCH, smoke=True)
    prm = TP.materialize(torch.Generator().manual_seed(0),
                         TT.param_spec(tcfg), "cpu")
    eng = TE.ServingEngine(tcfg, prm, slots=2, prompt_len=8, max_len=32,
                           device="cpu")
    v0 = eng.state_version
    assert eng.admit(_requests(TE.Request, tcfg.vocab_size, 1)[0])
    eng.step()
    pay = eng.snapshot_payload()
    assert pay["version"] == v0 + 2
    assert pay["cache"] is eng.cache


def test_serve_loop_dense_serves_every_request():
    out = serve_loop(ARCH, engine_kind="dense", n_requests=5, max_new=6,
                     slots=2, plan=default_serve_plan(insitu_mode="sync"),
                     device="cpu", log=lambda *_: None)
    assert all(r.done and len(r.out) == 6 for r in out["requests"])
    assert out["prefix_stats"] is None and out["hydrate_info"] is None
    snap = out["session_report"]["tasks"]["kv_snapshot"]
    assert snap["publishes"] >= 1


def test_serve_loop_dense_and_paged_serve_the_same_tokens():
    kw = dict(n_requests=4, max_new=6, slots=2, device="cpu",
              plan=default_serve_plan(insitu_mode="sync"),
              log=lambda *_: None)
    dense = serve_loop(ARCH, engine_kind="dense", **kw)
    paged = serve_loop(ARCH, engine_kind="paged", **kw)
    assert ([r.out for r in dense["requests"]]
            == [r.out for r in paged["requests"]])


def test_dense_engine_needs_cuda_unless_cpu_is_asked(bridged):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device exists")
    _, _, tcfg, tprm = bridged
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.ServingEngine(tcfg, tprm, slots=2)
