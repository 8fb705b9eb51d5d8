"""Serving parity between the PyTorch port and the JAX package (CPU).

Every test runs for ``smollm-135m`` (dense), the two MoE archs,
``moonshot-v1-16b-a3b`` (GQA) and ``deepseek-v3-671b`` (MLA), and the
hybrid ``hymba-1.5b`` (SWA rings and SSM state beside a global page
pool) and the ssm family's ``xlstm-1.3b`` (per-row mLSTM/sLSTM state and
no page pool at all). Both
packages start from the same weights: the JAX package materializes a
smoke-size tree, and the port takes it through its weight bridge.
Parameter specs are compared at the published widths, by shape and dtype,
without materializing them. Tolerances:

* the bridge is bitwise (same bits, bf16 through a uint16 view);
* f32 prefill logits agree to rtol/atol 1e-4 (two frameworks, same math,
  different summation order);
* bf16 prefill logits agree to atol 2e-2: every matmul output rounds to
  bf16 (8 significant bits, relative step 2^-8 ~ 4e-3) in both packages
  but at different places, and the differences accumulate over two
  layers; the smoke logits are O(0.1..1). The MoE archs' to atol 8e-2:
  their smoke logits reach about 3.5, where one bf16 step is 2^-6 ~ 0.016,
  over three layers whose MoE and MLA blocks round at more places (expert
  outputs, combine, shared experts, latents), some of which XLA's
  compiled scan body keeps in f32; seeds 0-2 differ by at most 0.059
  with every expert id equal. hymba's to atol 8e-2 as well: its smoke
  logits reach 3.75, and from its second layer on the SSM branch and the
  fusion round at more places (conv taps, four projections, two norms);
  seeds 0-2 differ by at most 0.053 (its first, global layer's cache
  bits equal). xlstm's to atol 1.25e-1: its smoke logits reach about
  3.5 over four blocks whose mLSTM divides by its normalizer and whose
  sLSTM rounds every step's ``h`` to bf16; seeds 1-3 differ by at most
  0.078. Every cache leaf is held at the logits' tolerance, and has the
  JAX package's dtype (hymba's SSM ``h`` and xlstm's ``c``/``n``/``m``
  are f32 in both). xlstm's bf16 state is held at that tolerance times
  the leaf's largest |value|: the stabilizer ``m`` is a max over
  bf16-rounded gates (up to ~25, where one bf16 step is 0.125), and
  ``c``/``n`` scale with it; seeds 1-3 differ by at most 4.8 % of a
  leaf's largest value (the sLSTM ``n``);
* greedy token streams of the paged and dense engines are equal in f32
  (params and cache cast to f32 on both sides), with and without a
  registered prefix (the hybrid and ssm families refuse a prefix in both
  packages: their per-row state cannot be shared), across the smoke
  window's wrap (40-token prompts, 30 new tokens, window 32), and with
  prompts prefilled at their exact length (5 and 17 tokens: the SSM
  state equals the JAX package's, and differs from a padded prefill's).
  In the MoE family the rows of one decode step share
  each expert's capacity, and an idle row's token competes for it as in
  the JAX package; so the streams are compared only where both packages
  run identical batches (the same engine, geometry and admissions);
* an MoE, hybrid or xlstm chain one package's engine wrote hydrates the
  other package's engine, which decodes the in-flight requests to the
  same f32 tokens; a hybrid chain carries its ``state`` leaves, and an
  xlstm chain only ``state`` leaves (its pool is empty and flattens to no
  key in either package).
"""
import functools
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

ARCHS = ("smollm-135m", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
         "hymba-1.5b", "xlstm-1.3b")
RECURRENT = ("hybrid", "ssm")


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    """(jax cfg, jax params, port cfg, port params), bf16 as materialized."""
    return _bridged(request.param)


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


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_param_spec_matches_jax(arch, smoke):
    """Same leaves, shapes and dtypes (published widths and smoke size),
    the same configs, and the same parameter counts."""
    jcfg, tcfg = jbase.get(arch, smoke=smoke), tbase.get(arch, smoke=smoke)
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    js = jax.tree_util.tree_leaves_with_path(
        JT.param_spec(jcfg), is_leaf=lambda x: isinstance(x, JP.ParamSpec))
    jspec = {"".join(f"/{k.key}" for k in p): s for p, s in js}
    tspec = _flat(TT.param_spec(tcfg))
    assert list(sorted(jspec)) == list(sorted(tspec))
    for k, js_ in jspec.items():
        ts_ = tspec[k]
        assert ts_.shape == js_.shape and ts_.axes == js_.axes, k
        assert str(ts_.dtype).split(".")[-1] == np.dtype(js_.dtype).name, k
        assert (ts_.init, ts_.scale) == (js_.init, js_.scale), k
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_active_params() == jcfg.n_active_params()


@functools.lru_cache(maxsize=None)
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
    ("moonshot-v1-16b-a3b", "float32"), ("moonshot-v1-16b-a3b", "bfloat16"),
    ("deepseek-v3-671b", "float32"), ("deepseek-v3-671b", "bfloat16"),
    ("hymba-1.5b", "float32"), ("hymba-1.5b", "bfloat16"),
    ("xlstm-1.3b", "float32"), ("xlstm-1.3b", "bfloat16"),
])
def test_prefill_logits_match_jax(arch, dtype):
    jcfg, jprm, tcfg, tprm = _bridged(arch)
    if dtype == "float32":
        jcfg, jprm, tcfg, tprm = _f32(jcfg, jprm, tcfg, tprm)
        tol = dict(rtol=1e-4, atol=1e-4)
    else:
        tol = dict(rtol=0, atol={"moe": 8e-2, "hybrid": 8e-2,
                                 "ssm": 1.25e-1}.get(jcfg.family, 2e-2))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, jcache, _ = JE.make_prefill(jcfg, 32)(jprm, jnp.asarray(toks))
    tl, tcache, _ = TE.make_prefill(tcfg, 32)(tprm, torch.from_numpy(toks))
    jl = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(tl.float().numpy(), jl, **tol)
    jflat, tflat = _flat(jcache), _flat(tcache)
    assert sorted(tflat) == sorted(jflat)
    for name, leaf in jflat.items():
        jk = np.asarray(leaf.astype(jnp.float32))
        assert tuple(tflat[name].shape) == jk.shape, name
        assert str(tflat[name].dtype).split(".")[-1] == \
            np.dtype(leaf.dtype).name, name
        leaf_tol = tol
        if jcfg.family == "ssm" and dtype == "bfloat16":
            # stabilized state: its scale follows the bf16-rounded gates
            leaf_tol = dict(rtol=0, atol=tol["atol"]
                            * max(1.0, float(np.abs(jk).max())))
        np.testing.assert_allclose(tflat[name].float().numpy(), jk,
                                   err_msg=name, **leaf_tol)


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
    if shared_prefix and jcfg.family in RECURRENT:
        # per-row recurrent state cannot be shared: both packages refuse
        for eng in (jeng, teng):
            with pytest.raises(ValueError, match="recurrent state"):
                eng.register_prefix(prefix)
        shared_prefix = False
    elif shared_prefix:
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
    if jcfg.family == "hybrid":
        assert any(k.startswith("['state']['ssm_swa']") for k in tl)
    if jcfg.family == "ssm":
        assert not any(k.startswith("['pool']") for k in tl)
        assert "['state']['mlstm']['c']" in tl
    for k in jl:
        if k.startswith(("['pool']", "['state']")):
            assert tl[k].dtype == jl[k].dtype, k
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert jeng.snapshot_payload()["chunk_hints"] == \
        teng.snapshot_payload()["chunk_hints"]


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_token_streams_match_jax(arch):
    """The fixed-slot engines of both packages, f32, two slots for four
    requests (admissions refill freed slots between steps)."""
    jcfg, jprm, tcfg, tprm = _f32(*_bridged(arch))
    ja = _requests(JE.Request, jcfg.vocab_size, 3, 4)
    tb = _requests(TE.Request, tcfg.vocab_size, 3, 4)
    JE.ServingEngine(jcfg, jprm, slots=2, prompt_len=16, max_len=64).run(ja)
    TE.ServingEngine(tcfg, tprm, slots=2, prompt_len=16, max_len=64,
                     device="cpu").run(tb)
    for ra, rb in zip(ja, tb):
        assert ra.done and rb.done
        assert ra.out == rb.out, f"request {ra.rid} diverged"


def _chain(eng, reqs, directory, store_cls, plan_mod):
    """Admit ``reqs``, decode three steps with a SYNC snapshot after each
    into ``directory``."""
    plan = plan_mod.InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {"kv_snapshot": {
            "stream": "kv_pages", "preset": "serve_snapshot", "every": 1,
            "placement": "sync",
            "options": {"base_every": 2, "directory": directory}}}})
    for r in reqs:
        assert eng.admit(r)
    with plan_mod.Session(plan, raise_on_error=True) as session:
        for step in range(3):
            eng.step()
            session.emit("kv_pages", step, eng.snapshot_payload)
    return store_cls(directory).restore("kv_pages")


@pytest.mark.parametrize("producer", ["jax", "torch"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_chain_hydrates_the_other_package(arch, producer, tmp_path):
    """A paged MoE engine's snapshot chain (pool leaves ``['kv']['k']`` /
    ``['kv']['v']``, or ``['kv']['ckv']`` / ``['kv']['krope']`` for MLA)
    written by one package hydrates the other's engine, which decodes the
    in-flight requests to the producer's f32 tokens with no prefill."""
    from repro.core import session as JS
    from repro.serving.snapshot import SnapshotStore as JStore
    from repro_torch.core import session as TS
    from repro_torch.serving.snapshot import SnapshotStore as TStore

    jcfg, jprm, tcfg, tprm = _f32(*_bridged(arch))
    kw = dict(num_pages=17, page_size=16, max_reqs=4, prompt_len=16,
              max_len=64)
    d = str(tmp_path / "chain")
    if producer == "jax":
        prod = JPG.PagedServingEngine(jcfg, jprm, **kw)
        reqs = _requests(JE.Request, jcfg.vocab_size, 9, 3, max_new=10)
        step, leaves = _chain(prod, reqs, d, JStore, JS)
        rep = TPG.PagedServingEngine.from_snapshot(tcfg, tprm, leaves,
                                                   device="cpu")
    else:
        prod = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
        reqs = _requests(TE.Request, tcfg.vocab_size, 9, 3, max_new=10)
        step, leaves = _chain(prod, reqs, d, TStore, TS)
        rep = JPG.PagedServingEngine.from_snapshot(jcfg, jprm, leaves)
    assert step == 2
    pool_keys = sorted(k for k in leaves if k.startswith("['pool']"))
    want = (["['pool']['kv']['ckv']", "['pool']['kv']['krope']"]
            if arch.startswith("deepseek") else
            ["['pool']['kv']['k']", "['pool']['kv']['v']"])
    assert pool_keys == want
    assert leaves[want[0]].shape[0] == tcfg.n_layers
    live = [a for a in rep.active if a is not None]
    assert [r.out for r in live] == [r.out for r in reqs]
    pre = rep.prefill_tokens
    for _ in range(12):
        for eng in (prod, rep):
            if any(a is not None for a in eng.active):
                eng.step()
    for a, b in zip(reqs, live):
        assert a.done and b.done
        assert a.out == b.out, f"replica diverged on request {a.rid}"
    assert rep.prefill_tokens == pre


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_hybrid_chain_hydrates_the_other_package(producer, tmp_path):
    """A paged hybrid engine's chain (pool ``['pool']['global_kv']``, per-row
    ``['state']`` rings and SSM state) written by one package hydrates
    the other's engine, which decodes the in-flight requests to the
    producer's f32 tokens with no prefill, across the window's wrap."""
    from repro.core import session as JS
    from repro.serving.snapshot import SnapshotStore as JStore
    from repro_torch.core import session as TS
    from repro_torch.serving.snapshot import SnapshotStore as TStore

    jcfg, jprm, tcfg, tprm = _f32(*_bridged("hymba-1.5b"))
    kw = dict(num_pages=25, page_size=16, max_reqs=3, prompt_len=40,
              max_len=64)
    d = str(tmp_path / "chain")
    if producer == "jax":
        prod = JPG.PagedServingEngine(jcfg, jprm, **kw)
        reqs = _wrap_requests(JE.Request, 3, 30, max_new=14)
        step, leaves = _chain(prod, reqs, d, JStore, JS)
        rep = TPG.PagedServingEngine.from_snapshot(tcfg, tprm, leaves,
                                                   device="cpu")
    else:
        prod = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
        reqs = _wrap_requests(TE.Request, 3, 30, max_new=14)
        step, leaves = _chain(prod, reqs, d, TStore, TS)
        rep = JPG.PagedServingEngine.from_snapshot(jcfg, jprm, leaves)
    assert step == 2
    assert sorted(k for k in leaves if k.startswith("['pool']")) == \
        ["['pool']['global_kv']['k']", "['pool']['global_kv']['v']"]
    assert sorted(k for k in leaves if k.startswith("['state']")) == [
        "['state']['ssm_global']['conv']", "['state']['ssm_global']['h']",
        "['state']['ssm_swa']['conv']", "['state']['ssm_swa']['h']",
        "['state']['swa_kv']['k']", "['state']['swa_kv']['v']"]
    assert leaves["['state']['swa_kv']['k']"].shape[:3] == (2, 3, 32)
    live = [a for a in rep.active if a is not None]
    assert [r.out for r in live] == [r.out for r in reqs]
    pre = rep.prefill_tokens
    for _ in range(14):
        for eng in (prod, rep):
            if any(a is not None for a in eng.active):
                eng.step()
    for a, b in zip(reqs, live):
        assert a.done and b.done
        assert a.out == b.out, f"replica diverged on request {a.rid}"
    assert rep.prefill_tokens == pre


def _wrap_requests(cls, n, prompt, max_new, seed=11):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, 257, size=prompt).astype(np.int32),
                max_new=max_new) for i in range(n)]


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_hybrid_streams_match_jax_across_the_window_wrap(kind):
    """Prompts of 40 tokens pass the smoke window of 32 (the prefill keeps
    the last 32 in ring order), and 30 new tokens wrap the ring again in
    decode: the f32 token streams equal the JAX package's."""
    jcfg, jprm, tcfg, tprm = _f32(*_bridged("hymba-1.5b"))
    assert jcfg.swa_window == 32
    ja = _wrap_requests(JE.Request, 4, 40, 30)
    tb = _wrap_requests(TE.Request, 4, 40, 30)
    if kind == "paged":
        kw = dict(num_pages=11, page_size=16, max_reqs=2, prompt_len=40,
                  max_len=80)
        jeng = JPG.PagedServingEngine(jcfg, jprm, **kw)
        teng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
    else:
        kw = dict(slots=2, prompt_len=40, max_len=80)
        jeng = JE.ServingEngine(jcfg, jprm, **kw)
        teng = TE.ServingEngine(tcfg, tprm, device="cpu", **kw)
    jeng.run(ja, max_steps=256)
    teng.run(tb, max_steps=256)
    for ra, rb in zip(ja, tb):
        assert ra.done and rb.done and len(rb.out) == 30
        assert ra.out == rb.out, f"request {ra.rid} diverged"


def test_hybrid_prefills_prompts_at_their_exact_length():
    """Prompts of 5 and 17 tokens in a 24-token prompt window: the SSM
    state the port's paged engine holds after admission equals the JAX
    engine's, and differs from the state of the same prompt padded to the
    window (pad tokens would advance it)."""
    jcfg, jprm, tcfg, tprm = _f32(*_bridged("hymba-1.5b"))
    kw = dict(num_pages=9, page_size=16, max_reqs=2, prompt_len=24,
              max_len=64)
    jeng = JPG.PagedServingEngine(jcfg, jprm, **kw)
    teng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 257, size=n).astype(np.int32) for n in (5, 17)]
    for i, pr in enumerate(prompts):
        assert jeng.admit(JE.Request(i, pr, max_new=4))
        assert teng.admit(TE.Request(i, pr, max_new=4))
    for key in ("ssm_global", "ssm_swa"):
        for leaf in ("h", "conv"):
            want = np.asarray(jeng.state[key][leaf])
            got = teng.state[key][leaf].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key}/{leaf}")
    assert [r.out for r in teng.active] == [r.out for r in jeng.active]
    padded = np.zeros((1, 24), np.int32)
    padded[0, :5] = prompts[0]
    _, cache, _ = TE.make_prefill(tcfg, 64)(tprm, torch.from_numpy(padded))
    assert not torch.allclose(cache["ssm_swa"]["h"][:, 0],
                              teng.state["ssm_swa"]["h"][:, 0], atol=1e-3)


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_xlstm_chain_hydrates_the_other_package(producer, tmp_path):
    """A paged xlstm engine's chain holds ``state`` leaves only (its pool is
    ``{}``, which flattens to no key in either package); written by one
    package, it hydrates the other's engine, which decodes the in-flight
    requests to the producer's f32 tokens with no prefill."""
    from repro.core import session as JS
    from repro.serving.snapshot import SnapshotStore as JStore
    from repro_torch.core import session as TS
    from repro_torch.serving.snapshot import SnapshotStore as TStore

    jcfg, jprm, tcfg, tprm = _f32(*_bridged("xlstm-1.3b"))
    kw = dict(num_pages=17, page_size=16, max_reqs=3, prompt_len=16,
              max_len=64)
    d = str(tmp_path / "chain")
    if producer == "jax":
        prod = JPG.PagedServingEngine(jcfg, jprm, **kw)
        reqs = _requests(JE.Request, jcfg.vocab_size, 9, 3, max_new=10)
        step, leaves = _chain(prod, reqs, d, JStore, JS)
        rep = TPG.PagedServingEngine.from_snapshot(tcfg, tprm, leaves,
                                                   device="cpu")
    else:
        prod = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
        reqs = _requests(TE.Request, tcfg.vocab_size, 9, 3, max_new=10)
        step, leaves = _chain(prod, reqs, d, TStore, TS)
        rep = JPG.PagedServingEngine.from_snapshot(jcfg, jprm, leaves)
    assert step == 2
    assert not any(k.startswith("['pool']") for k in leaves)
    assert sorted(k for k in leaves if k.startswith("['state']")) == [
        "['state']['mlstm']['c']", "['state']['mlstm']['conv']",
        "['state']['mlstm']['m']", "['state']['mlstm']['n']",
        "['state']['slstm']['c']", "['state']['slstm']['h']",
        "['state']['slstm']['m']", "['state']['slstm']['n']"]
    assert leaves["['state']['mlstm']['c']"].shape == (2, 1, 3, 2, 64, 64)
    live = [a for a in rep.active if a is not None]
    assert [r.out for r in live] == [r.out for r in reqs]
    pre = rep.prefill_tokens
    for _ in range(10):
        for eng in (prod, rep):
            if any(a is not None for a in eng.active):
                eng.step()
    for a, b in zip(reqs, live):
        assert a.done and b.done
        assert a.out == b.out, f"replica diverged on request {a.rid}"
    assert rep.prefill_tokens == pre


def _per3(jcfg, jprm, tcfg, tprm):
    """The xlstm smoke config at 8 blocks, one sLSTM per 4 (three mLSTM
    layers a super-block), f32 weights bridged from the JAX package."""
    jc = dataclasses.replace(
        jcfg, n_layers=8, dtype="float32",
        xlstm=dataclasses.replace(jcfg.xlstm, slstm_every=4))
    tc = dataclasses.replace(
        tcfg, n_layers=8, dtype="float32",
        xlstm=dataclasses.replace(tcfg.xlstm, slstm_every=4))
    jp = JP.cast_tree(JP.materialize(jax.random.PRNGKey(3),
                                     JT.param_spec(jc)), jnp.float32)
    return jc, jp, tc, TP.from_numpy_tree(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_xlstm_streams_match_jax_at_three_mlstm_layers_a_block(kind):
    """Admission writes a request's state into its row of leaves
    (n_super, per, B, ...) with per = 3: the batch axis is the third.
    Prompts of 5 to 20 tokens (prefilled at their exact length), 8 new
    tokens, two rows for five requests: the f32 token streams equal the
    JAX package's, and the state after the first admissions agrees to
    the 8-block forward's bound (rtol 1e-4, atol 5e-4)."""
    jcfg, jprm, tcfg, tprm = _per3(*_bridged("xlstm-1.3b"))
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 257, size=n).astype(np.int32)
               for n in (5, 20, 9, 13, 16)]
    ja = [JE.Request(i, p, max_new=8) for i, p in enumerate(prompts)]
    tb = [TE.Request(i, p, max_new=8) for i, p in enumerate(prompts)]
    if kind == "paged":
        kw = dict(num_pages=9, page_size=16, max_reqs=2, prompt_len=24,
                  max_len=64)
        jeng = JPG.PagedServingEngine(jcfg, jprm, **kw)
        teng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **kw)
        state = lambda e: e.state
    else:
        kw = dict(slots=2, prompt_len=24, max_len=64)
        jeng = JE.ServingEngine(jcfg, jprm, **kw)
        teng = TE.ServingEngine(tcfg, tprm, device="cpu", **kw)
        state = lambda e: e.cache
    for eng, reqs in ((jeng, ja), (teng, tb)):
        assert eng.admit(reqs[0]) and eng.admit(reqs[1])
    jst, tst = _flat(state(jeng)), _flat(state(teng))
    assert sorted(jst) == sorted(tst)
    assert tst["/mlstm/c"].shape[:3] == (2, 3, 2)
    for k, leaf in jst.items():
        # the 8-block forward's bound (tests/test_torch_xlstm.py)
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(leaf),
                                   rtol=1e-4, atol=5e-4, err_msg=k)
    jeng.run(ja[2:], max_steps=64)
    teng.run(tb[2:], max_steps=64)
    for ra, rb in zip(ja, tb):
        assert ra.done and rb.done and len(rb.out) == 8
        assert ra.out == rb.out, f"request {ra.rid} diverged"
