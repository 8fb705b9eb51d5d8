"""The Hopper spectral-codec kernels against their plain versions, on the
card. Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (run it there with ``--noconftest``; see
README.md, "PyTorch/CUDA port: training").

Tolerances (f32 throughout, TF32 off for the plain product):

* y of the DCT and x of the inverse: rtol 1e-5, atol 1e-5 x the block's
  RMS — the kernel sums each 256-long dot product as one sequential FMA
  chain, cuBLAS in its own blocked order; the magnitudes of a block, not
  of the whole buffer, set the scale of the rounding.
* counts, on the kernel's own y: equal (the same log2f and bin formula).
* energies, on the kernel's own y: rtol 1e-5 — the kernel sums at most
  64 then 32 positive f32 terms in a fixed order (relative error below
  ~95 x 2^-24 = 5.7e-6), the plain version sums in f64 and rounds once.
* q and scale for the same y and t: bitwise (one warp per block does the
  plain version's arithmetic: |y| >= t, amax * f32(1/127), IEEE division,
  round half to even).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import spectral_lossy as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _payload(rng, nb, kind):
    x = rng.standard_normal((nb, ref.BLOCK)).astype(np.float32)
    if kind == "tiny":
        x *= np.float32(1e-20)          # subnormal energies
    elif kind == "zeros":
        x[:] = 0
    elif kind == "sparse":
        x *= rng.random(x.shape) < 0.01
    elif kind == "cauchy":
        x = rng.standard_cauchy(x.shape).astype(np.float32)
    elif kind == "rows_zero":
        x[::3] = 0                      # all-zero blocks among live ones
    return x


def _block_atol(x: torch.Tensor) -> torch.Tensor:
    rms = torch.sqrt(torch.mean(x.double() ** 2, dim=1, keepdim=True))
    return (1e-5 * rms).float()


def _close(got, want, scale_rows):
    tol = _block_atol(scale_rows) + 1e-5 * want.abs()
    bad = (got - want).abs() > tol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements off; max err "
        f"{(got - want).abs().max().item():.3e}")


KINDS = ["normal", "tiny", "zeros", "sparse", "cauchy", "rows_zero"]


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [8, 24, 64, 72, 1000])
@pytest.mark.parametrize("kind", KINDS)
def test_dct_hist_coarse_matches_plain(cuda, nb, kind):
    rng = np.random.default_rng(nb)
    xb = torch.from_numpy(_payload(rng, nb, kind)).to(cuda)
    y, cnt, eng = K.dct_hist_coarse_tiled(xb)
    torch.cuda.synchronize()
    y_p = ref.dct_blocks(xb)
    _close(y, y_p, y_p)
    # histograms on the kernel's own y
    a = torch.abs(y)
    coarse = torch.div(ref.bin_index(a), ref.NBINS_FINE,
                       rounding_mode="floor")
    cnt_p, eng_p = K._tile_sums(a * a, coarse, ref.NBINS_COARSE, K.HIST_TILE)
    assert torch.equal(cnt, cnt_p)
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [8, 24, 1000])
@pytest.mark.parametrize("kind", KINDS)
def test_hist_refine_matches_plain(cuda, nb, kind):
    rng = np.random.default_rng(nb + 1)
    y = ref.dct_blocks(torch.from_numpy(_payload(rng, nb, kind)).to(cuda))
    coarse = torch.from_numpy(rng.integers(0, 32, nb).astype(np.int32))
    # most blocks take their own leaf's busiest coarse bin
    own = torch.div(ref.bin_index(torch.abs(y)), ref.NBINS_FINE,
                    rounding_mode="floor").mode(dim=1).values
    coarse = torch.where(torch.arange(nb) % 4 == 0, coarse,
                         own.cpu().to(torch.int32)).to(cuda)
    cnt, eng = K.hist_refine_tiled(y, coarse)
    cnt_p, eng_p = K.hist_refine_tiled_plain(y, coarse)
    assert torch.equal(cnt, cnt_p)
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 8, 13, 64, 97, 1000])
@pytest.mark.parametrize("kind", KINDS)
def test_threshold_quant_bitwise(cuda, nb, kind):
    rng = np.random.default_rng(nb + 2)
    y = ref.dct_blocks(torch.from_numpy(_payload(rng, nb, kind)).to(cuda))
    a = torch.abs(y)
    # per-block thresholds at several quantiles, one exactly at an element
    pick = torch.from_numpy(rng.integers(0, ref.BLOCK, nb)).to(cuda)
    t = torch.sort(a, dim=1).values.gather(1, pick[:, None])[:, 0]
    t[::5] = a[::5, 7]
    q, s = K.threshold_quant(y, t.contiguous())
    q_p, s_p = K.threshold_quant_plain(y, t)
    assert torch.equal(q, q_p)
    assert torch.equal(s, s_p)
    q1, s1 = K.threshold_quant(y, 0.0)        # scalar threshold
    q1_p, s1_p = K.threshold_quant_plain(y, torch.zeros((), device=cuda))
    assert torch.equal(q1, q1_p) and torch.equal(s1, s1_p)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 8, 13, 64, 97, 1000])
def test_dequant_idct_matches_plain(cuda, nb):
    rng = np.random.default_rng(nb + 3)
    q = torch.from_numpy(rng.integers(-127, 128, (nb, ref.BLOCK)
                                      ).astype(np.int8)).to(cuda)
    q[::4] = 0
    s = torch.from_numpy(np.abs(rng.standard_normal(nb)).astype(np.float32)
                         ).to(cuda)
    s[::7] = 1.0
    x = K.dequant_idct(q, s)
    x_p = K.dequant_idct_plain(q, s)
    _close(x, x_p, ref.dequantize_blocks(q, s))


@pytest.mark.cuda
def test_fused_tree_roundtrip_within_bound(cuda):
    """The packed path on the card: every moment leaf restores within the
    codec's error bound, weights pass through untouched, and each kernel
    launched once per save (the restore launches once per leaf)."""
    rng = np.random.default_rng(7)
    state = {"params": {"w": torch.randn(300, 70, device=cuda)},
             "mu": {"w": torch.from_numpy(rng.standard_normal((300, 70))
                                          .astype(np.float32)).to(cuda)
                    .to(torch.bfloat16),
                    "b": torch.randn(33, device=cuda).to(torch.bfloat16)},
             "nu": {"w": torch.rand(300, 70, device=cuda),
                    "b": torch.zeros(33, device=cuda)}}
    K.reset_launches()
    out = ops.spectral_compress_tree(
        state, 1e-2, lambda k: "'mu'" in k or "'nu'" in k)
    assert [k.launches for k in K.KERNELS[:3]] == [1, 1, 1]
    assert out["params"]["w"] is state["params"]["w"]
    for grp in ("mu", "nu"):
        for name, c in out[grp].items():
            assert isinstance(c, ref.Compressed)
            x = state[grp][name]
            xh = ops.spectral_decompress(c)
            assert xh.dtype == x.dtype and xh.shape == x.shape
            if torch.count_nonzero(x):
                assert ref.rel_l2_error(x, xh) <= ref.error_bound(1e-2)
            else:
                assert not torch.count_nonzero(xh)
    assert K.dequant_idct.launches == 4


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    xb = torch.zeros((12, ref.BLOCK), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        K.dct_hist_coarse_tiled(xb)
    with pytest.raises(ValueError, match="tile"):
        K.dct_hist_coarse_tiled(torch.zeros((16, ref.BLOCK), device=cuda),
                                tile=16)
    with pytest.raises(TypeError, match="dtype"):
        K.threshold_quant(xb.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        K.threshold_quant(torch.zeros((ref.BLOCK, 12), device=cuda).T, 0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.spectral_compress(torch.zeros(10, device=cuda))
