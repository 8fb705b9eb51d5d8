"""The flat 512-bin pair of the port (``dct_hist``, ``dct_hist_tiled``)
against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them off the TPU. Tolerances and why:

* y rtol 1e-5, atol 1e-6, and bitwise against XLA's compiled product from
  56 rows on (below that XLA's CPU product sums the DCT in another order
  than the port's FMA chain; see ``test_torch_spectral_single.py``).
* counts equal, except for the elements whose ``bin_index`` differs
  between the packages (an ulp of log2 at a bin edge): the test finds
  those elements and allows exactly their moves, no more.
* energies rtol 1e-5 in every bin such an element does not touch: the
  Pallas kernel sums a tile's 2048 squares in f32 through a one-hot
  product (and the single histogram across tiles in f32), the plain
  version in f64 rounded once.
* thresholds bitwise: the selection walks the same edge grid with the
  same f32 comparisons. XLA's CPU backend flushes subnormals, so the port
  runs under ``torch.set_flush_denormal(True)`` (as
  ``test_torch_spectral.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels import spectral_lossy as JK
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import spectral_lossy as TK
from test_torch_spectral import EPS, KINDS, _blocks, _signal, _t

_jdct = jax.jit(JR.dct_blocks)
_jbins = jax.jit(JK._bin_idx)       # compiled, as inside the kernel


@pytest.fixture
def ftz():
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _assert_rows_match(y_t, cnt_t, eng_t, y_j, cnt_j, eng_j):
    """Per-tile (count, energy) rows of the port against the Pallas
    kernel's, allowing exactly the elements whose bin differs."""
    b_t = TR.bin_index(y_t.abs()).numpy().reshape(cnt_t.shape[0], -1)
    b_j = np.asarray(_jbins(jnp.abs(y_j))).reshape(b_t.shape)
    moved = np.zeros(cnt_t.shape, np.int64)
    touched = np.zeros(cnt_t.shape, bool)
    for tile, col in zip(*np.nonzero(b_t != b_j)):
        moved[tile, b_t[tile, col]] += 1
        moved[tile, b_j[tile, col]] -= 1
        touched[tile, [b_t[tile, col], b_j[tile, col]]] = True
    cnt_t, eng_t = cnt_t.numpy(), eng_t.numpy()
    cnt_j, eng_j = np.asarray(cnt_j), np.asarray(eng_j)
    np.testing.assert_array_equal(cnt_t - cnt_j, moved)
    np.testing.assert_allclose(eng_t[~touched], eng_j[~touched], rtol=1e-5,
                               atol=0)


# ---------------------------------------------------------------------------
# the plain pair against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [8, 24, 13, 64, 97])
@pytest.mark.parametrize("kind", ["noise", "smooth", "tiny", "cauchy"])
def test_dct_hist_tiled_plain_matches_pallas(nb, kind, ftz):
    xb = _blocks(_signal(nb * JR.BLOCK, nb, kind), JK.HIST_TILE)
    y_j, cnt_j, eng_j = JK.dct_hist_tiled(jnp.asarray(xb), interpret=True)
    y_t, cnt_t, eng_t = TK.dct_hist_tiled(_t(xb))
    assert cnt_t.shape == eng_t.shape == (xb.shape[0] // 8, JR.NBINS)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-6)
    if xb.shape[0] >= 56:
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(_jdct(xb)))
    _assert_rows_match(y_t, cnt_t, eng_t, y_j, cnt_j, eng_j)


@pytest.mark.parametrize("nb", [8, 24, 64, 97])
@pytest.mark.parametrize("kind", ["noise", "smooth", "tiny", "cauchy"])
def test_dct_hist_plain_matches_pallas(nb, kind, ftz):
    xb = _blocks(_signal(nb * JR.BLOCK, nb + 1, kind), JK.HIST_TILE)
    y_j, cnt_j, eng_j = JK.dct_hist(jnp.asarray(xb), interpret=True)
    y_t, cnt_t, eng_t = TK.dct_hist(_t(xb))
    assert cnt_t.shape == eng_t.shape == (JR.NBINS,)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-6)
    _assert_rows_match(y_t, cnt_t[None], eng_t[None], y_j, cnt_j[None],
                       eng_j[None])


@functools.lru_cache(maxsize=None)
def _flat_energies(kind):
    """One 40000-element payload (160 blocks) of ``kind`` through both
    packages' flat histograms: (port energies, JAX energies)."""
    xb = _blocks(_signal(40000, kind=kind), JK.HIST_TILE)
    torch.set_flush_denormal(True)
    try:
        eng_t = TK.dct_hist(_t(xb))[2]
    finally:
        torch.set_flush_denormal(False)
    return eng_t, JK.dct_hist(jnp.asarray(xb), interpret=True)[2]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eps", EPS)
def test_flat_threshold_bitwise_equal_to_jax(kind, eps):
    eng_t, eng_j = _flat_energies(kind)
    np.testing.assert_array_equal(
        TR.threshold_from_histogram(eng_t, eps).numpy(),
        np.asarray(JR.threshold_from_histogram(eng_j, eps)))


# ---------------------------------------------------------------------------
# the reference's own kernel tests, on the port
# ---------------------------------------------------------------------------

def test_dct_hist_tiled_rows_sum_to_the_single_histogram():
    """``tests/test_kernels.py::test_dct_hist_tiled_matches_accumulated_
    histogram``: per-tile rows sum to the single histogram."""
    xb = _blocks(_signal(40000), TK.HIST_TILE)
    y_t, cnt_t, eng_t = TK.dct_hist_tiled(_t(xb))
    y_a, cnt_a, eng_a = TK.dct_hist(_t(xb))
    assert cnt_t.shape == (xb.shape[0] // TK.HIST_TILE, TR.NBINS)
    assert torch.equal(y_t, y_a)
    assert torch.equal(cnt_t.sum(0), cnt_a)
    torch.testing.assert_close(eng_t.sum(0), eng_a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["smooth", "noise", "cauchy"])
@pytest.mark.parametrize("eps", [1e-3, 1e-2, 1e-1])
def test_two_level_threshold_equals_flat(kind, eps):
    """``tests/test_kernels.py::test_kernel_two_level_path_threshold_
    equals_flat``: coarse kernel, select_coarse, refine kernel, select_fine
    land on the flat kernel's threshold exactly."""
    xb = _t(_blocks(_signal(40000, kind=kind), TK.HIST_TILE))
    y, _, ce = TK.dct_hist_coarse(xb)
    c, cc, base, budget = TR.select_coarse(ce, eps)
    _, fe = TK.hist_refine(y, cc)
    t_two = TR.select_fine(fe, c, cc, base, budget)
    t_flat = TR.threshold_from_histogram(TK.dct_hist(xb)[2], eps)
    assert torch.equal(t_two, t_flat)
    assert torch.equal(TO.select_two_level(xb, eps)[1], t_flat)


def test_tiled_rows_summed_in_order_equal_the_single_histogram():
    """``tests/test_kernels.py::test_tiled_rows_segment_sum_parity_with_
    accumulated``: y and counts bitwise, energies within 1e-6, and the
    threshold from the summed rows bitwise across eps."""
    xb = TR.blockize(_t(_signal(64 * TR.BLOCK, kind="noise")))[0]
    y_t, cnt_t, eng_t = TK.dct_hist_tiled(xb)
    y_a, cnt_a, eng_a = TK.dct_hist(xb)
    assert torch.equal(y_t, y_a)
    cnt_seq = torch.zeros(TR.NBINS)
    eng_seq = torch.zeros(TR.NBINS)
    for row in range(eng_t.shape[0]):
        cnt_seq = cnt_seq + cnt_t[row]
        eng_seq = eng_seq + eng_t[row]
    assert torch.equal(cnt_seq, cnt_a)
    torch.testing.assert_close(eng_seq, eng_a, rtol=1e-6, atol=0)
    seg = eng_t.sum(0)
    for eps in (1e-3, 1e-2, 1e-1, 0.5):
        assert torch.equal(TR.threshold_from_histogram(seg, eps),
                           TR.threshold_from_histogram(eng_a, eps))


def test_flat_pair_raises_valueerror_on_bad_shapes():
    """``tests/test_kernels.py::test_hist_kernels_raise_valueerror_on_bad_
    shapes``, and no launch is counted on the CPU."""
    TK.reset_launches()
    with pytest.raises(ValueError, match="multiple"):
        TK.dct_hist(torch.zeros((7, TR.BLOCK)))
    with pytest.raises(ValueError, match="blocked buffer"):
        TK.dct_hist(torch.zeros((8, 128)))
    with pytest.raises(ValueError, match="multiple"):
        TK.dct_hist_tiled(torch.zeros((9, TR.BLOCK)))
    TK.dct_hist(torch.zeros((8, TR.BLOCK)))
    TK.dct_hist_tiled(torch.zeros((0, TR.BLOCK)))
    assert TK.dct_hist.launches == TK.dct_hist_tiled.launches == 0


def test_plain_sums_agree_between_the_cpu_and_the_card_routes():
    """The plain tile sums take one sequential bincount on the CPU and one
    pass per bin on the card: both are f64 sums rounded once, so the rows
    agree to an f32 rounding; elements with bin -1 count nowhere."""
    rng = np.random.default_rng(3)
    a2 = _t(rng.standard_normal((64, TR.BLOCK)).astype(np.float32) ** 2)
    bins = _t(rng.integers(-1, 40, (64, TR.BLOCK)).astype(np.int32))
    cnt, eng = TK._tile_sums(a2, bins, 40, 8)
    a3 = a2.reshape(8, -1).double()
    b3 = bins.reshape(8, -1)
    for b in range(40):
        m = b3 == b
        assert torch.equal(cnt[:, b], m.sum(1).float())
        torch.testing.assert_close(eng[:, b], torch.where(m, a3, 0).sum(1)
                                   .float(), rtol=6e-8, atol=0)
    assert int(cnt.sum()) == int((bins >= 0).sum())
