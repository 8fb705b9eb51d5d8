"""The port's optimizer, schedules and gradient compression against the
JAX package's (CPU).

* The cases of ``tests/test_optim.py`` through both packages on the same
  seeded inputs: AdamW on a quadratic, master weights, clipping, the
  schedule's shape, the int8 error bound, the one-pod ring, the
  error-feedback invariant (atol 0.01, as there) and the ring's property
  under hypothesis. Each asserts the reference's expectation on both and
  holds the port's numbers to the JAX package's.
* The int8 ring across gloo CPU processes at n = 2, 3 and 4
  (``tests/torch_shard_ranks.py --phase ring``) against the JAX package's
  ``int8_ring_mean`` under ``shard_map`` on n host devices (a subprocess,
  ``tests/jax_shard_oracle.py --ring``): the same on every rank, equal
  to ``int8_ring_mean_plain`` bit for bit, and within one quantisation
  step (``scale / n``) of the JAX package's, the elements that differ
  counted and reported. ``bf16`` and ``none`` are held to their
  definitions (``bf16`` aborts the JAX package's sharded step), and each
  call's wire bytes to (n - 1) x numel under ``int8``.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro import optim as JO
from repro.distributed import sharding as JSH
from repro.optim import grad_compress as JG
from repro.optim import schedules as JSC
from repro_torch import optim as TO
from repro_torch.optim import grad_compress as TG
from repro_torch.optim import schedules as TSC

TESTS = Path(__file__).resolve().parent
RING_SIZES = (2, 3, 4)
RING_TIMEOUT_S = 120.0


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the cases of tests/test_optim.py through both packages
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    runs = {}
    for name, O, mk in (
            ("jax", JO, jnp.asarray),
            ("torch", TO, lambda v: torch.tensor(v, dtype=torch.float32))):
        cfg = O.AdamWConfig(lr=0.1, weight_decay=0.0, bf16_moments=False,
                            grad_clip=0)
        params = {"x": mk([5.0, -3.0])}
        st_ = O.init(params, cfg)
        for _ in range(200):
            g = {"x": 2 * params["x"]}          # d/dx x^2
            params, st_ = O.update(g, st_, params, cfg)
        runs[name] = _np(params["x"])
        assert float(np.max(np.abs(runs[name]))) < 0.05
    np.testing.assert_allclose(runs["torch"], runs["jax"], atol=1e-5)


def test_master_weights_allow_tiny_updates():
    runs = {}
    for name, O, ones in (
            ("jax", JO, lambda: jnp.ones((4,), jnp.bfloat16)),
            ("torch", TO, lambda: torch.ones(4, dtype=torch.bfloat16))):
        cfg = O.AdamWConfig(lr=1e-4, weight_decay=0.0, master_weights=True)
        params = {"x": ones()}
        st_ = O.init(params, cfg)
        g = {"x": ones()}
        for _ in range(100):
            params, st_ = O.update(g, st_, params, cfg)
        runs[name] = (_np(st_.master["x"]), _np(params["x"]))
        # master accumulates sub-bf16 deltas; params eventually move
        assert float(runs[name][0][0]) < 1.0 - 1e-3
    np.testing.assert_allclose(runs["torch"][0], runs["jax"][0], rtol=1e-6)
    np.testing.assert_array_equal(runs["torch"][1], runs["jax"][1])


@pytest.mark.parametrize("master", [False, True])
def test_dry_update_writes_nothing_and_update_in_place_matches(master):
    """``dry_update`` (a captured train step's warm-up) leaves params,
    moments, masters and count as they were; ``update_`` then writes the
    bits that ``update`` returns."""
    gen = torch.Generator().manual_seed(0)
    cfg = TO.AdamWConfig(lr=1e-2, master_weights=master)
    params = {"a": torch.randn(3, 4, generator=gen).to(torch.bfloat16),
              "b": {"c": torch.randn(5, generator=gen)}}
    grads = {"a": torch.randn(3, 4, generator=gen).to(torch.bfloat16),
             "b": {"c": torch.randn(5, generator=gen)}}
    st_ = TO.update(grads, TO.init(params, cfg), params, cfg)[1]
    flat = lambda *trees: [t.clone() for tr in trees
                           for t in TO.adamw.leaves(tr)]
    before = flat(params, st_.mu, st_.nu, st_.master or {}, st_.count)
    TO.adamw.dry_update(grads, st_, params, cfg)
    after = flat(params, st_.mu, st_.nu, st_.master or {}, st_.count)
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    new_p, new_st = TO.update(grads, st_, params, cfg)
    TO.adamw.update_(grads, st_, params, cfg)
    assert all(torch.equal(x, y) for x, y in zip(
        flat(new_p, new_st.mu, new_st.nu, new_st.master or {},
             new_st.count),
        flat(params, st_.mu, st_.nu, st_.master or {}, st_.count)))


def test_grad_clip():
    j = float(JO.adamw.global_norm({"x": jnp.asarray([100.0, 0.0])}))
    t = float(TO.adamw.global_norm({"x": torch.tensor([100.0, 0.0])}))
    assert j == pytest.approx(100.0) and t == j


def test_schedules_shapes():
    for S in (JSC, TSC):
        lr0 = float(S.warmup_cosine(0, peak=1.0, warmup=10, total=100))
        lr_w = float(S.warmup_cosine(10, peak=1.0, warmup=10, total=100))
        lr_end = float(S.warmup_cosine(100, peak=1.0, warmup=10,
                                       total=100))
        assert lr0 == 0.0 and lr_w == pytest.approx(1.0)
        assert lr_end == pytest.approx(0.1, abs=1e-5)   # floor_frac
    for s in (0, 3, 10, 57, 100, 250):
        assert float(TSC.warmup_cosine(s, peak=3e-4, warmup=10, total=100)) \
            == pytest.approx(float(JSC.warmup_cosine(
                s, peak=3e-4, warmup=10, total=100)), rel=1e-6)


def test_int8_quantization_error_bounded(rng):
    x = rng.standard_normal(4096).astype(np.float32)
    amax = float(np.max(np.abs(x)))
    scale = amax / 127.0
    q = jnp.clip(jnp.round(jnp.asarray(x) / scale), -127, 127).astype(
        jnp.int8)
    err = float(jnp.max(jnp.abs(q.astype(jnp.float32) * scale - x)))
    assert err <= scale / 2 + 1e-7
    # the port's quantize-dequantize of one pod (its plain ring at n = 1)
    deq = TG.int8_ring_mean_plain(torch.from_numpy(x)[None])
    t_err = float(torch.max(torch.abs(deq - torch.from_numpy(x))))
    assert t_err <= scale / 2 + 1e-7
    np.testing.assert_allclose(deq.numpy(), np.asarray(q, np.float32)
                               * scale, rtol=0, atol=scale * 1e-6)


def test_int8_ring_mean_single_device_mesh(tmp_path):
    """n = 1: quantize + dequantize in both packages; the port's over a
    world-of-one gloo group enters no ring and sends no payload."""
    import torch.distributed as dist

    x = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    mesh = jax.make_mesh((1,), ("pod",))
    f = JSH.shard_map(lambda v: JG.int8_ring_mean(v, "pod", 1), mesh,
                      in_specs=jax.sharding.PartitionSpec(),
                      out_specs=jax.sharding.PartitionSpec(),
                      check_vma=False)
    with JSH.mesh_context(mesh):
        j_out = np.asarray(f(jnp.asarray(x)))
    store = tmp_path / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        TG.wire.reset()
        t_out = TG.int8_ring_mean(torch.from_numpy(x), dist.group.WORLD, 1)
        wire = TG.wire.as_dict()
        same = TG.reduce_leaf(torch.from_numpy(x), method="int8",
                              group=dist.group.WORLD, n=1)
    finally:
        dist.destroy_process_group()
    amax = float(np.max(np.abs(x)))
    for out in (j_out, t_out.numpy()):
        assert float(np.max(np.abs(out - x))) <= amax / 127.0
    assert wire["bytes"]["int8"] == 0 and wire["bytes"]["amax"] == 4
    np.testing.assert_array_equal(same.numpy(), x)     # n = 1: no ring
    assert float(np.max(np.abs(t_out.numpy() - j_out))) <= amax / 127.0


def test_error_feedback_invariant(rng):
    """g_pre == reduced + residual (what EF carries is exactly what was
    lost), in both packages on the same gradient."""
    w = rng.standard_normal(128).astype(np.float32)
    out = {}
    for name, G, mk, rnd in (
            ("jax", JG, jnp.asarray, lambda x: jnp.round(x, 1)),
            ("torch", TG, torch.from_numpy,
             lambda x: torch.round(x, decimals=1))):
        g = {"w": mk(w)}
        res = G.ef_init(g)
        assert str(res["w"].dtype) in ("bfloat16", "torch.bfloat16")
        g_pre = G.ef_pre(g, res)
        reduced = {"w": rnd(g_pre["w"])}      # a lossy reduction
        new_res = G.ef_post(g_pre, reduced)
        recon = _np(reduced["w"]) + _np(new_res["w"])
        np.testing.assert_allclose(recon, _np(g_pre["w"]), atol=0.01)
        out[name] = _np(new_res["w"])
    np.testing.assert_allclose(out["torch"], out["jax"], atol=2 ** -8)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 100), n=st.integers(2, 8))
def test_int8_ring_math_property(seed, n):
    """Pure-python model of the ring: mean of quantized == quantized mean;
    the port's plain ring is the model in f32."""
    r = np.random.default_rng(seed)
    xs = r.standard_normal((n, 64)).astype(np.float32)
    amax = np.abs(xs).max()
    scale = max(amax, 1e-30) / 127.0
    qs = np.clip(np.round(xs / scale), -127, 127)
    ring_mean = qs.sum(0) * scale / n
    true_mean = xs.mean(0)
    assert np.max(np.abs(ring_mean - true_mean)) <= scale / 2 + 1e-6
    port = TG.int8_ring_mean_plain(torch.from_numpy(xs)).numpy()
    assert np.max(np.abs(port - true_mean)) <= scale / 2 + 1e-6
    assert np.max(np.abs(port - ring_mean)) <= scale / n + 1e-6


# ---------------------------------------------------------------------------
# the ring across gloo processes against the JAX package's under shard_map
# ---------------------------------------------------------------------------

def _ring_inputs(n: int) -> dict:
    r = np.random.default_rng(100 + n)
    return {"normal": r.standard_normal((n, 4097)).astype(np.float32),
            "wide": (r.standard_normal((n, 1000)) * np.logspace(
                -6, 2, 1000)).astype(np.float32),
            "zeros": np.zeros((n, 64), np.float32)}


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    for n in RING_SIZES:
        np.savez(d / f"ring_{n}.npz", **_ring_inputs(n))
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               OMP_NUM_THREADS="1")
    deadline = time.monotonic() + RING_TIMEOUT_S
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "jax_shard_oracle.py"), "--ring",
         *map(str, RING_SIZES), "--dir", str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for n in RING_SIZES:
        procs += [subprocess.Popen(
            [sys.executable, str(TESTS / "torch_shard_ranks.py"), "--phase",
             "ring", "--rank", str(r), "--world", str(n), "--dir", str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline -
                                               time.monotonic()))
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return d


@pytest.mark.parametrize("n", RING_SIZES)
def test_int8_ring_across_gloo_ranks_against_the_jax_ring(ring_runs, n):
    d = ring_runs
    xs = dict(np.load(d / f"ring_{n}.npz"))
    ref = np.load(d / f"ref_ring_{n}.npz")
    got = [torch.load(d / f"ring_{n}_rank{r}.pt") for r in range(n)]
    report = {}
    for name, x in xs.items():
        ring = [g[name]["ring"] for g in got]
        plain = TG.int8_ring_mean_plain(torch.from_numpy(x))
        for r in range(n):
            assert torch.equal(ring[r], plain), (name, r)
            assert torch.equal(got[r][name]["int8"], plain), (name, r)
            for key in ("ring_wire", "int8_wire"):
                wire = got[r][name][key]
                assert wire["bytes"]["int8"] == (n - 1) * x.shape[1]
                assert wire["bytes"]["amax"] == 4
                assert wire["calls"]["int8"] == 1
        assert bool(ref[name + "_same"])
        step = TG._scale(torch.tensor(np.abs(x).max())).item() / n
        diff = np.abs(ring[0].numpy() - ref[name])
        assert np.all(diff <= step * (1 + 1e-6)), (name, float(diff.max()),
                                                   step)
        report[name] = {"differ": int(np.count_nonzero(diff)),
                        "of": int(diff.size),
                        "max_steps": float(diff.max() / step)}
    # n = 3: ~4000 of 4097 normal elements differ by one f32 ulp of the
    # output (XLA's scale / 3 is not the correctly rounded one)
    print(f"n={n}: the port's ring against the JAX package's: "
          f"{json.dumps(report)}")


@pytest.mark.parametrize("n", RING_SIZES)
def test_bf16_and_none_reductions_hold_their_definitions(ring_runs, n):
    d = ring_runs
    xs = dict(np.load(d / f"ring_{n}.npz"))
    got = [torch.load(d / f"ring_{n}_rank{r}.pt") for r in range(n)]
    for name, x in xs.items():
        xt = torch.from_numpy(x)
        # bf16: a mean of bf16 operands (n - 1 bf16 additions), cast back
        ops = xt.to(torch.bfloat16).double()
        exact = ops.mean(0)
        bound = n * 2.0 ** -8 * ops.abs().sum(0) / n
        # none: the f32 mean (n - 1 f32 additions and a division)
        exact32 = xt.double().mean(0)
        bound32 = n * 2.0 ** -23 * xt.double().abs().sum(0) / n
        for r in range(n):
            b = got[r][name]["bf16"]
            assert b.dtype == torch.float32
            assert torch.equal(b, got[0][name]["bf16"])
            assert torch.all((b.double() - exact).abs() <= bound), name
            assert torch.equal(b, b.to(torch.bfloat16).float())
            m = got[r][name]["none"]
            assert torch.equal(m, got[0][name]["none"])
            assert torch.all((m.double() - exact32).abs() <= bound32), name
            assert got[r][name]["bf16_wire"]["bytes"]["bf16"] == \
                2 * x.shape[1]
            assert got[r][name]["none_wire"]["bytes"]["none"] == \
                4 * x.shape[1]
            assert got[r][name]["bf16_wire"]["bytes"]["int8"] == 0


def test_reduce_leaf_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="unknown grad-compression"):
        TG.reduce_leaf(torch.zeros(3), method="fp8", group=None, n=2)
    # a group of one never enters any reduction, whatever the method
    x = torch.arange(3.0)
    assert TG.reduce_leaf(x, method="int8", group=None, n=1) is x
    assert TG.pod_size(TG.sharding.abstract_mesh((2, 4), ("pod", "data"))
                       ) == 2
    assert TG.pod_size(TG.sharding.abstract_mesh((4,), ("data",))) == 1
    assert JG.pod_size(jax.make_mesh((1,), ("pod",))) == 1
