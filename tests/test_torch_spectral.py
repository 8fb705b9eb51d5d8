"""The port's spectral codec against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances and why:

* y (the DCT) allclose rtol 1e-5, atol 1e-6: XLA's and PyTorch's CPU
  matrix products sum the 256-long dot products in different orders.
* histogram counts equal; energies rtol 1e-4, atol 1e-6 — the JAX
  package's own kernel tests' tolerance (``tests/test_kernels.py``): the
  Pallas kernel sums energies in f32 through a one-hot product, the plain
  version in f64 rounded once, and the DCT's rounding (atol 1e-6 on y)
  moves the energy of the smallest coefficients by a large relative
  amount; 1e-4 relative also covers subnormal energies, where f32 keeps
  few significant bits.
* thresholds, q and scales bitwise, for the same y: the selection walks
  the same edge grid with the same f32 comparisons. The JAX package runs
  its codec compiled, where XLA computes ``amax / 127.0`` as
  ``amax * f32(1/127)``; the port does that product, so the JAX side is
  taken through ``jax.jit`` as its codec runs. XLA's CPU backend flushes
  subnormals to zero, so the port runs these comparisons under
  ``torch.set_flush_denormal(True)`` (the 1e-20 payloads then drop every
  coefficient in both packages; on the card, which keeps subnormals, they
  do not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels import spectral_lossy as JK
from repro_torch.core import pytree
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import spectral_lossy as TK


@pytest.fixture
def ftz():
    """Denormals flushed, as XLA's CPU backend computes."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _signal(n, seed=0, kind="smooth"):
    """``tests/test_kernels.py``'s payloads, plus heavier and stranger ones."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 20, n)
    if kind == "smooth":
        x = np.sin(t) + 0.25 * np.sin(9 * t) + 0.02 * rng.standard_normal(n)
    elif kind == "noise":
        x = rng.standard_normal(n)
    elif kind == "spiky":
        x = np.zeros(n)
        x[rng.integers(0, n, size=max(1, n // 50))] = rng.standard_normal(
            max(1, n // 50)) * 10
    elif kind == "gaussian":
        x = rng.normal(0.0, 3.0, n)
    elif kind == "cauchy":
        x = rng.standard_cauchy(n)
    elif kind == "tiny":
        x = rng.standard_normal(n) * 1e-20
    elif kind == "sparse":
        x = rng.standard_normal(n) * (rng.random(n) < 0.01)
    elif kind == "zeros":
        x = np.zeros(n)
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


KINDS = ["smooth", "noise", "spiky", "gaussian", "cauchy", "tiny", "sparse",
         "zeros"]
EPS = [1e-3, 1e-2, 1e-1, 1.0, 2.0]


def _blocks(x, tile):
    xb = x.reshape(-1)
    pad = (-xb.size) % JR.BLOCK
    xb = np.pad(xb, (0, pad)).reshape(-1, JR.BLOCK)
    return np.pad(xb, ((0, (-xb.shape[0]) % tile), (0, 0)))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [8, 24, 13, 97])
@pytest.mark.parametrize("kind", ["noise", "smooth", "tiny"])
def test_dct_hist_coarse_tiled_plain_matches_pallas(nb, kind, ftz):
    xb = _blocks(_signal(nb * JR.BLOCK, nb, kind), JK.HIST_TILE)  # 13 -> 16
    y_j, cnt_j, eng_j = JK.dct_hist_coarse_tiled(jnp.asarray(xb),
                                                 interpret=True)
    y_t, cnt_t, eng_t = TK.dct_hist_coarse_tiled(_t(xb))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(eng_t.numpy(), np.asarray(eng_j),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("nb", [8, 24, 13, 97])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_hist_refine_tiled_plain_matches_pallas(nb, kind):
    rng = np.random.default_rng(nb)
    xb = _blocks(_signal(nb * JR.BLOCK, nb, kind), JK.HIST_TILE)
    y = np.asarray(JR.dct_blocks(jnp.asarray(xb)))
    # each block's own busiest coarse bin, and some foreign ones
    own = np.asarray(JR.bin_index(jnp.abs(jnp.asarray(y)))) // JR.NBINS_FINE
    coarse = np.array([np.bincount(r).argmax() for r in own], np.int32)
    coarse[::3] = rng.integers(0, JR.NBINS_COARSE, coarse[::3].size)
    cnt_j, eng_j = JK.hist_refine_tiled(jnp.asarray(y), jnp.asarray(coarse),
                                        interpret=True)
    cnt_t, eng_t = TK.hist_refine_tiled(_t(y), _t(coarse))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(eng_t.numpy(), np.asarray(eng_j),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("nb", [8, 24, 13, 97])
def test_threshold_quant_and_dequant_plain_match_pallas(nb):
    rng = np.random.default_rng(nb + 1)
    y = (rng.standard_normal((nb, JR.BLOCK)) * 3).astype(np.float32)
    y[::5] = 0                                    # all-zero blocks
    t = np.abs(rng.standard_normal(nb)).astype(np.float32)
    q_j, s_j = JK.threshold_quant(jnp.asarray(y), jnp.asarray(t),
                                  interpret=True)   # pads 13 -> its tile
    q_t, s_t = TK.threshold_quant(_t(y), _t(t))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    x_j = JK.dequant_idct(q_j, s_j, interpret=True)
    x_t = TK.dequant_idct(q_t, s_t)
    # outputs are O(1..10) here: atol 1e-5 is the DCT's 1e-6 at that scale
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the oracle: thresholds, q and scale bitwise over payloads x eps
# ---------------------------------------------------------------------------

_jquant = jax.jit(JR.quantize_blocks)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eps", EPS)
def test_ref_selection_and_quantization_bitwise(kind, eps, ftz):
    y = np.asarray(JR.dct_blocks(JR.blockize(
        jnp.asarray(_signal(40000, kind=kind)))[0]))
    yt = _t(y)
    _, e_j = JR.energy_histogram(jnp.asarray(y))
    t_flat_j = JR.threshold_from_histogram(e_j, eps)
    t_two_j = JR.threshold_two_level(jnp.asarray(y), eps)
    _, e_t = TR.energy_histogram(yt)
    t_flat_t = TR.threshold_from_histogram(e_t, eps)
    t_two_t = TR.threshold_two_level(yt, eps)
    for got, want in ((t_flat_t, t_flat_j), (t_two_t, t_two_j),
                      (t_two_t, t_flat_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q_j, s_j = _jquant(jnp.asarray(y), t_flat_j)
    q_t, s_t = TR.quantize_blocks(yt, t_flat_t)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    if eps >= 1 or kind in ("zeros", "tiny"):
        assert not q_t.any()             # drop-everything / no energy


@pytest.mark.parametrize("selector", ["histogram", "two_level"])
@pytest.mark.parametrize("case", ["eps_ge_1", "zeros", "single_block"])
def test_ref_selector_edge_cases(selector, case, ftz):
    """``tests/test_kernels.py::test_selector_edge_cases`` for the port,
    against the JAX oracle on the same y."""
    if case == "eps_ge_1":
        x, eps = _signal(4096, kind="noise"), 1.5     # budget >= total energy
    elif case == "zeros":
        x, eps = np.zeros(4096, np.float32), 1e-2
    else:
        x, eps = _signal(JR.BLOCK, kind="smooth"), 1e-2   # exactly one block
    y = np.asarray(JR.dct_blocks(JR.blockize(jnp.asarray(x))[0]))
    if selector == "histogram":
        t_t = TR.threshold_from_histogram(TR.energy_histogram(_t(y))[1], eps)
    else:
        t_t = TR.threshold_two_level(_t(y), eps)
    t_j = JR.threshold_from_histogram(
        JR.energy_histogram(jnp.asarray(y))[1], eps)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    q_t, s_t = TR.quantize_blocks(_t(y), t_t)
    q_j, s_j = _jquant(jnp.asarray(y), t_j)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    if case in ("eps_ge_1", "zeros"):
        assert not q_t.any()


def test_ref_bin_edges_and_dct_basis_match():
    np.testing.assert_array_equal(TR.dct_matrix(), JR.dct_matrix())
    b = np.arange(JR.NBINS + 1)
    np.testing.assert_array_equal(TR.bin_edge(torch.from_numpy(b)).numpy(),
                                  np.asarray(JR.bin_edge(jnp.asarray(b))))
    assert TR.error_bound(1e-2) == JR.error_bound(1e-2)


@pytest.mark.parametrize("n", [256, 2048 + 256, 257, 40000])
def test_ref_compress_roundtrip_within_bound(n):
    x = _t(_signal(n, kind="smooth"))
    c = TR.compress(x, 1e-2, selector="two_level")
    assert TR.rel_l2_error(x, TR.decompress(c)) <= TR.error_bound(1e-2)


# ---------------------------------------------------------------------------
# the fused tree path
# ---------------------------------------------------------------------------

def _smoke_state(seed=0):
    """A smoke-config ``smollm-135m`` train state's shapes, with moments
    filled from a seed (bf16, as the loop keeps them)."""
    from repro.configs import base as jbase
    from repro.models import params as JP
    from repro.models import transformer as JT
    cfg = jbase.get("smollm-135m", smoke=True)
    params = jax.device_get(JP.materialize(jax.random.PRNGKey(seed),
                                           JT.param_spec(cfg)))
    rng = np.random.default_rng(seed)
    mom = lambda s: jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * s,
                              jnp.bfloat16), params)
    return {"params": params, "mu": mom(1e-3),
            "nu": jax.tree.map(lambda v: jnp.abs(v), mom(1e-6)),
            "count": jnp.asarray(3, jnp.int32)}


def _policy(key):
    return "'mu'" in key or "'nu'" in key


def _port_state(jstate):
    from repro_torch.launch.train import state_from_numpy
    return state_from_numpy(jax.device_get(jstate), "cpu")


def test_spectral_compress_tree_matches_jax_bitwise():
    jstate = _smoke_state()
    j = JO.spectral_compress_tree(jstate, 1e-2, _policy)
    t = TO.spectral_compress_tree(_port_state(jstate), 1e-2, _policy)
    jflat = dict((jax.tree_util.keystr(p), l) for p, l in
                 jax.tree_util.tree_flatten_with_path(
                     j, is_leaf=lambda x: isinstance(x, JR.Compressed))[0])
    tflat = dict((pytree.keystr(p), l) for p, l in pytree.flatten_with_path(
        t, lambda x: isinstance(x, TR.Compressed)))
    assert set(jflat) == set(tflat)
    n_lossy = 0
    for key, jl in jflat.items():
        tl = tflat[key]
        if isinstance(jl, JR.Compressed):
            n_lossy += 1
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
            np.testing.assert_array_equal(tl.scale.numpy(),
                                          np.asarray(jl.scale))
            assert (tl.n_elements, tl.shape) == (jl.n_elements, jl.shape)
            assert tl.dtype == torch.bfloat16
    assert n_lossy == 2 * len(jax.tree.leaves(jstate["params"]))


def test_fused_equals_per_leaf_bitwise():
    state = _port_state(_smoke_state(1))
    fused = TO.spectral_compress_tree(state, 1e-2, _policy)
    per_leaf = TO.spectral_compress_tree(state, 1e-2, _policy, fused=False)
    for grp in ("mu", "nu"):
        for (_, a), (_, b) in zip(pytree.flatten_with_path(
                fused[grp], lambda x: isinstance(x, TR.Compressed)),
                pytree.flatten_with_path(
                    per_leaf[grp], lambda x: isinstance(x, TR.Compressed))):
            assert torch.equal(a.q, b.q)
            assert torch.equal(a.scale, b.scale)


def test_tile_padding_equals_pow2_bucketing_bitwise():
    """The port pads each leaf only to a tile multiple; the JAX package's
    pow2 buckets add zero blocks that carry no energy — same bits."""
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal(n).astype(np.float32) * s
              for n, s in ((5000, 1.0), (300, 1e-3), (70000, 10.0),
                           (256 * 24, 0.1))]

    def packed(rows):
        buf = torch.zeros((sum(rows), TR.BLOCK))
        off = 0
        for leaf, r in zip(leaves, rows):
            buf.view(-1)[off * TR.BLOCK:off * TR.BLOCK + leaf.size] = \
                torch.from_numpy(leaf)
            off += r
        return buf

    tile = [-(-x.size // TR.BLOCK) for x in leaves]
    tile = [r + (-r) % TK.HIST_TILE for r in tile]
    pow2 = [JO._bucket_rows(r) for r in tile]
    assert pow2 != tile
    q1, s1 = TO._compress_packed(packed(tile), tile, 1e-2)
    q2, s2 = TO._compress_packed(packed(pow2), pow2, 1e-2)
    o1 = o2 = 0
    for r1, r2 in zip(tile, pow2):
        assert torch.equal(q1[o1:o1 + r1], q2[o2:o2 + r1])
        assert torch.equal(s1[o1:o1 + r1], s2[o2:o2 + r1])
        o1, o2 = o1 + r1, o2 + r2


def test_single_tensor_path_matches_jax_and_refuses_cuda_names_roadmap():
    x = _signal(40000, kind="noise")
    c_j = JO.spectral_compress(jnp.asarray(x), 1e-2)
    c_t = TO.spectral_compress(_t(x), 1e-2)
    np.testing.assert_array_equal(c_t.q.numpy(), np.asarray(c_j.q))
    np.testing.assert_array_equal(c_t.scale.numpy(), np.asarray(c_j.scale))
    xh = TO.spectral_decompress(c_t)
    assert TR.rel_l2_error(_t(x), xh) <= TR.error_bound(1e-2)
    chunks, scale, n = TO.spectral_compress_chunked(_t(x), 1e-2,
                                                    chunk_blocks=64)
    assert torch.equal(torch.cat(chunks), c_t.q) and n == x.size
    q, s = TO.compress_in_graph(_t(x), 1e-2)
    assert torch.equal(q, c_t.q) and torch.equal(s, c_t.scale)
    err = TK.not_ported("spectral_compress")
    assert "ROADMAP" in str(err) and "queue 2" in str(err)


def test_wrappers_check_shapes_and_count_no_cpu_launches():
    TK.reset_launches()
    with pytest.raises(ValueError, match="multiple"):
        TK.dct_hist_coarse_tiled(torch.zeros((12, TR.BLOCK)))
    with pytest.raises(ValueError, match="blocked"):
        TK.dct_hist_coarse_tiled(torch.zeros((8, 100)))
    with pytest.raises(ValueError, match="per-block"):
        TK.threshold_quant(torch.zeros((8, TR.BLOCK)), torch.zeros(3))
    TK.dct_hist_coarse_tiled(torch.zeros((8, TR.BLOCK)))
    TK.dequant_idct(torch.zeros((3, TR.BLOCK), dtype=torch.int8),
                    torch.ones(3))
    # the plain versions ran: no kernel was launched
    assert [k.launches for k in TK.KERNELS] == [0, 0, 0, 0]
