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
* single-tensor histograms, on the kernel's own y: counts equal; energies
  rtol 1e-5 (the tile rows as above, then summed in double).
* the single-tensor codec on the card (two-level selection through the
  kernels) against the CPU's (the flat oracle): thresholds, q and scale
  bitwise. The kernel's y is cuBLAS's and the CPU product's bit for bit
  (each output one FMA chain in k order), and both selectors land on the
  same bin edge.
* the flat 512-bin pair: y bitwise equal to the coarse kernel's (the same
  FMA chain per output); on the kernel's own y, counts equal to the plain version's, to
  the coarse kernel's per 16 bins and to the refine kernel's inside a
  coarse bin; energies rtol 1e-5; the single histogram
  equal to its tile rows summed (counts exactly, energies rtol 1e-6: the
  rows and the single histogram are each rounded once from sums of the
  same squares); its threshold
  equal bitwise to the two-level kernels'; energies equal bitwise from
  run to run. The flat pair adds bins 1..510 as exact integers (u32
  shared-memory atomics, whose order does not change the sum), so those
  energies equal the plain version's f64 sums bit for bit; bins 0 and
  511 are summed in a fixed order (at most 64 then 32 f32 terms).
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import lossy
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
    assert [K.dct_hist_coarse_tiled.launches, K.hist_refine_tiled.launches,
            K.threshold_quant.launches] == [1, 1, 1]
    assert K.dct_hist_coarse.launches == K.hist_refine.launches == 0
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
    with pytest.raises(ValueError, match="tile"):
        K.dct_hist_coarse(torch.zeros((16, ref.BLOCK), device=cuda), tile=16)
    with pytest.raises(ValueError, match="multiple"):
        K.hist_refine(xb, 3)
    with pytest.raises(TypeError, match="dtype"):
        K.dct_hist_coarse(torch.zeros((8, ref.BLOCK), device=cuda).double())


def _own_coarse(y):
    a = torch.abs(y)
    coarse = torch.div(ref.bin_index(a), ref.NBINS_FINE,
                       rounding_mode="floor")
    return a, coarse


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [8, 24, 64, 72, 1000, 1008])
@pytest.mark.parametrize("kind", KINDS)
def test_dct_hist_coarse_single_matches_plain(cuda, nb, kind):
    rng = np.random.default_rng(nb + 10)
    xb = torch.from_numpy(_payload(rng, nb, kind)).to(cuda)
    K.reset_launches()
    y, cnt, eng = K.dct_hist_coarse(xb)
    torch.cuda.synchronize()
    assert K.dct_hist_coarse.launches == 1
    assert cnt.shape == eng.shape == (ref.NBINS_COARSE,)
    y_p = ref.dct_blocks(xb)
    _close(y, y_p, y_p)
    a, coarse = _own_coarse(y)
    cnt_p, eng_p = K._sum_rows(*K._tile_sums(a * a, coarse, ref.NBINS_COARSE,
                                             K.HIST_TILE))
    assert torch.equal(cnt, cnt_p)
    assert int(cnt.sum()) == nb * ref.BLOCK
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [8, 24, 1000, 1008])
@pytest.mark.parametrize("kind", KINDS)
def test_hist_refine_single_matches_plain(cuda, nb, kind):
    rng = np.random.default_rng(nb + 11)
    y = ref.dct_blocks(torch.from_numpy(_payload(rng, nb, kind)).to(cuda))
    _, coarse = _own_coarse(y)
    busiest = int(coarse.reshape(-1).mode().values)
    per_block = torch.from_numpy(rng.integers(0, 32, nb).astype(np.int32)
                                 ).to(cuda)
    per_block[::2] = busiest
    for c in (busiest, per_block):
        cnt, eng = K.hist_refine(y, c)
        cnt_p, eng_p = K.hist_refine_plain(
            y, K._per_block(c, nb, torch.int32, cuda))
        assert cnt.shape == (ref.NBINS_FINE,)
        assert torch.equal(cnt, cnt_p)
        torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1001 * 256 - 7, 40000, 2_500_000])
@pytest.mark.parametrize("kind", ["normal", "sparse", "cauchy", "rows_zero"])
@pytest.mark.parametrize("eps", [1e-3, 1e-2, 1e-1, 2.0])
def test_single_tensor_codec_on_card_equals_cpu(cuda, n, kind, eps):
    rng = np.random.default_rng(n % 977)
    x = _payload(rng, -(-n // ref.BLOCK), kind).reshape(-1)[:n]
    xc = torch.from_numpy(x)
    xb = ops._pad_blocks(ref.blockize(xc)[0], K.HIST_TILE)
    _, t_cpu = ops.select_flat(xb, eps)
    _, t_card = ops.select_two_level(xb.to(cuda), eps)
    assert torch.equal(t_card.cpu(), t_cpu)
    K.reset_launches()
    c_card = ops.spectral_compress(xc.to(cuda), eps)
    assert [K.dct_hist_coarse.launches, K.hist_refine.launches,
            K.threshold_quant.launches] == [1, 1, 1]
    assert K.dct_hist_coarse_tiled.launches == 0
    c_cpu = ops.spectral_compress(xc, eps)
    assert torch.equal(c_card.q.cpu(), c_cpu.q)
    assert torch.equal(c_card.scale.cpu(), c_cpu.scale)
    chunks, scale, _ = ops.spectral_compress_chunked(xc.to(cuda), eps,
                                                     chunk_blocks=4096)
    assert torch.equal(torch.cat(chunks).cpu(), c_cpu.q)
    q, s = ops.compress_in_graph(xc.to(cuda), eps)
    assert torch.equal(q.cpu(), c_cpu.q) and torch.equal(s.cpu(), c_cpu.scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_tensor_frames_on_card_equal_cpu(cuda, dtype):
    """Host arrays and card tensors, streamed (three chunks) and not: the
    RPLY frames are the CPU's byte for byte, and restore within bound."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(2_500_000).astype(np.float32)
                         * 1e-3).to(dtype)
    want, _ = lossy.compress_tensor(x, 1e-2, device="cpu")
    for src in (x.to(cuda), x.float().numpy() if dtype == torch.float32
                else None):
        if src is None:
            continue
        for stream in (True, False):
            blob, _ = lossy.compress_tensor(src, 1e-2, stream=stream,
                                            device="cuda")
            assert blob == want
    back = lossy.decompress_tensor(want, device="cuda")
    assert back.device.type == "cuda" and back.dtype == dtype
    assert ref.rel_l2_error(x.to(cuda), back) <= ref.error_bound(1e-2)
    _, st = lossy.compress_tensor(x.to(cuda), 1e-2, measure=True)
    assert st.rel_l2_error <= ref.error_bound(1e-2)


@pytest.mark.cuda
def test_concurrent_workers_match_serial_and_count_exactly(cuda):
    """Eight threads compress and restore at once, each on its own side
    stream: the frames are the serial ones, every launch is counted."""
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal(n).astype(np.float32)
          for n in (1_200_000, 3000, 70000, 256 * 64) * 2]
    serial = [lossy.compress_tensor(x, 1e-2, device="cuda")[0] for x in xs]
    K.reset_launches()
    out: list = [None] * len(xs)
    errors: list = []

    def work(i):
        try:
            blob, _ = lossy.compress_tensor(xs[i], 1e-2, device="cuda")
            out[i] = (blob, lossy.decompress_tensor(blob, device="cuda"))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(xs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert [o[0] for o in out] == serial
    assert [K.dct_hist_coarse.launches, K.hist_refine.launches,
            K.threshold_quant.launches, K.dequant_idct.launches] == \
        [len(xs)] * 4
    for x, (_, back) in zip(xs, out):
        assert ref.rel_l2_error(torch.from_numpy(x).to(cuda), back) \
            <= ref.error_bound(1e-2)


def _flat_plain(y):
    a = torch.abs(y)
    return K._tile_sums(a * a, ref.bin_index(a), ref.NBINS, K.HIST_TILE)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [8, 24, 64, 72, 1000, 1008])
@pytest.mark.parametrize("kind", KINDS)
def test_dct_hist_tiled_matches_plain_and_the_two_level_kernels(cuda, nb,
                                                                kind):
    rng = np.random.default_rng(nb + 20)
    xb = torch.from_numpy(_payload(rng, nb, kind)).to(cuda)
    K.reset_launches()
    y, cnt, eng = K.dct_hist_tiled(xb)
    torch.cuda.synchronize()
    assert K.dct_hist_tiled.launches == 1
    n_tiles = nb // K.HIST_TILE
    assert cnt.shape == eng.shape == (n_tiles, ref.NBINS)
    y2, cnt2, _ = K.dct_hist_coarse_tiled(xb)
    assert torch.equal(y, y2)
    _close(y, ref.dct_blocks(xb), y)
    cnt_p, eng_p = _flat_plain(y)
    assert torch.equal(cnt, cnt_p)
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)
    assert torch.equal(cnt.view(n_tiles, ref.NBINS_COARSE,
                                ref.NBINS_FINE).sum(-1), cnt2)
    # each tile's busiest coarse bin: its 16 flat bins are the refine
    # kernel's counts
    c_tile = cnt2.argmax(1).to(torch.int32)
    fcnt, _ = K.hist_refine_tiled(y, c_tile.repeat_interleave(K.HIST_TILE))
    idx = (c_tile[:, None].long() * ref.NBINS_FINE
           + torch.arange(ref.NBINS_FINE, device=cuda))
    assert torch.equal(cnt.gather(1, idx), fcnt)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [8, 24, 1000, 1008, 16384])
@pytest.mark.parametrize("kind", KINDS)
def test_dct_hist_equals_its_rows_summed_and_the_two_level_threshold(
        cuda, nb, kind):
    rng = np.random.default_rng(nb + 21)
    xb = torch.from_numpy(_payload(rng, nb, kind)).to(cuda)
    K.reset_launches()
    y, cnt, eng = K.dct_hist(xb)
    torch.cuda.synchronize()
    assert K.dct_hist.launches == 1
    assert cnt.shape == eng.shape == (ref.NBINS,)
    y8, cnt8, eng8 = K.dct_hist_tiled(xb)
    assert torch.equal(y, y8)
    cnt_s, eng_s = K._sum_rows(cnt8, eng8)
    assert torch.equal(cnt, cnt_s)
    torch.testing.assert_close(eng, eng_s, rtol=1e-6, atol=0.0)
    cnt_p, eng_p = K._sum_rows(*_flat_plain(y))
    assert torch.equal(cnt, cnt_p)
    assert int(cnt.sum()) == nb * ref.BLOCK
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)
    y6, _, ce = K.dct_hist_coarse(xb)
    for eps in (1e-3, 1e-2, 1e-1, 1.5):
        c, cc, base, budget = ref.select_coarse(ce, eps)
        _, fe = K.hist_refine(y6, cc)
        t_two = ref.select_fine(fe, c, cc, base, budget)
        assert torch.equal(ref.threshold_from_histogram(eng, eps), t_two), eps


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1000, 4096, 16384, 40000])
@pytest.mark.parametrize("kind", ["normal", "cauchy", "sparse", "tiny"])
def test_flat_histograms_are_the_same_bits_every_run(cuda, kind, nb):
    """1000 blocks end inside a CTA's 64 rows; dct_hist gives each of its
    persistent CTAs one 64-row group at 16,384 blocks and three at
    40,000."""
    rng = np.random.default_rng(31)
    xb = torch.from_numpy(_payload(rng, nb, kind)).to(cuda)
    first = K.dct_hist_tiled(xb) + K.dct_hist(xb)
    for _ in range(3):
        again = K.dct_hist_tiled(xb) + K.dct_hist(xb)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _mixed(rng, nb):
    """Blocks of zeros, 1e-30 and 1e15 magnitudes, magnitudes whose square
    overflows f32, and Gaussians, mixed inside every 8-block tile: tiles
    that fill bins 0 and 511 beside interior bins."""
    x = rng.standard_normal((nb, ref.BLOCK)).astype(np.float32)
    scale = np.array([0.0, 1e-30, 1e15, 1e20, 1.0], dtype=np.float32)
    x *= scale[rng.integers(0, len(scale), nb)][:, None]
    x[rng.random(x.shape) < 0.05] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [64, 1000, 40000])
def test_flat_pair_on_tiles_that_mix_bins_0_511_and_interior(cuda, nb):
    rng = np.random.default_rng(nb + 41)
    xb = torch.from_numpy(_mixed(rng, nb)).to(cuda)
    y, cnt, eng = K.dct_hist_tiled(xb)
    y9, cnt9, eng9 = K.dct_hist(xb)
    torch.cuda.synchronize()
    assert torch.equal(y, y9)
    cnt_p, eng_p = _flat_plain(y)
    assert torch.equal(cnt, cnt_p)
    assert bool((cnt_p[:, 0] > 0).any() and (cnt_p[:, -1] > 0).any())
    assert bool(torch.isinf(eng_p[:, -1]).any())
    # bins 1..510 are exact sums rounded once: the plain version's f64 sums
    assert torch.equal(eng[:, 1:-1], eng_p[:, 1:-1])
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)
    cs, es = K._sum_rows(cnt_p, eng_p)
    assert torch.equal(cnt9, cs)
    torch.testing.assert_close(eng9, es, rtol=1e-5, atol=0.0)
    for _ in range(2):
        again = K.dct_hist_tiled(xb) + K.dct_hist(xb)
        assert all(torch.equal(a, b)
                   for a, b in zip((y, cnt, eng, y9, cnt9, eng9), again))


@pytest.mark.cuda
def test_dct_hist_allocates_no_tile_rows(cuda):
    """The caching allocator's peak grows by y, the partial rows and the
    2 x 512 output, each rounded up to the allocator's granule (512 bytes;
    2 MiB above 1 MiB, where a block keeps a remainder of 1 MiB or less),
    and nothing per tile (per-tile rows would take 20 MB at this size)."""
    nb = 40000
    xb = torch.from_numpy(_payload(np.random.default_rng(5), nb, "normal")
                          ).to(cuda)
    K.dct_hist(xb)                       # the library and D are made once
    torch.cuda.synchronize()
    torch.cuda.empty_cache()             # fresh segments: no cached slack
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = K.dct_hist(xb)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    parts = K._lib().spectral_dct_hist_parts_bytes()
    assert parts <= 264 * ref.NBINS * 16
    want = _allocated(xb.numel() * 4) + _allocated(parts) + _allocated(
        2 * ref.NBINS * 4)
    assert grown <= want, (grown, want)
    assert grown < xb.numel() * 4 + 2 * (nb // 8) * ref.NBINS * 4
    del out


def _allocated(n):
    """At most the bytes the caching allocator counts for an n-byte tensor."""
    g = 512 if n <= 1 << 20 else 2 << 20
    return -(-n // g) * g


@pytest.mark.cuda
def test_flat_kernels_at_zero_blocks_and_their_refusals(cuda):
    y, cnt, eng = K.dct_hist(torch.zeros((0, ref.BLOCK), device=cuda))
    assert y.shape == (0, ref.BLOCK)
    assert not cnt.any() and not eng.any()
    _, cnt, _ = K.dct_hist_tiled(torch.zeros((0, ref.BLOCK), device=cuda))
    assert cnt.shape == (0, ref.NBINS)
    with pytest.raises(ValueError, match="multiple"):
        K.dct_hist(torch.zeros((12, ref.BLOCK), device=cuda))
    with pytest.raises(ValueError, match="tile"):
        K.dct_hist_tiled(torch.zeros((16, ref.BLOCK), device=cuda), tile=16)
    with pytest.raises(TypeError, match="dtype"):
        K.dct_hist(torch.zeros((8, ref.BLOCK), device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        K.dct_hist_tiled(torch.zeros((ref.BLOCK, 8), device=cuda).T)
