"""The premise of the flat pair's exact binning on the card, checked on the
CPU (``csrc/spectral_lossy.cu``: ``flat_base``, ``flat_units``,
``bin_flat``, ``dct_flat_range_kernel``).

The kernels sum the |y|^2 of a flat bin b in 1..510 as integers: each f32
square is ``m << (e - E_b)`` units of 2^(E_b - 23), with m its 24-bit
significand, e its exponent and E_b = floor(5b/16) - 81 the bin's base. A
tile's bin is two u32 words (lo: the units' low 20 bits; hi: count << 20
plus the units' high bits), a range's a u64. Here, with the constants read
from the kernel's source:

* every bin's edges, as ``ref.bin_index`` puts them and one ulp either
  side (the card's log2f may round an edge element one bin over), square
  to an integer count of units below 2^26, and neither a tile's words nor
  the largest range ``dct_hist`` assigns can carry out;
* a Python model of the accumulation gives the same bits in any order
  (hypothesis over permutations), equal to ``math.fsum`` rounded once to
  f32, and to the plain version's per-tile float64 sums bit for bit;
* bins 0 and 511 break the premise, which is why the kernels sum them in
  a fixed order instead.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro_torch.kernels import ref
from repro_torch.kernels import spectral_lossy as K

SRC = (Path(K.__file__).with_name("csrc") / "spectral_lossy.cu").read_text()


def _const(name: str) -> str:
    m = re.search(rf"constexpr [\w ]+ {name} = ([^;]+);", SRC)
    assert m, f"{name} not found in spectral_lossy.cu"
    return m.group(1).strip()


LO_BITS = int(_const("kLoBits"))
MAX_PARTS = int(_const("kMaxParts"))
MAX_COUNT = 1 << int(re.fullmatch(r"1ll << (\d+)",
                                  _const("kMaxFlatCount")).group(1))
TILE_COUNT = K.HIST_TILE * ref.BLOCK          # elements of one tile
ROWS = 64                                     # rows per CTA (kRows)
UNIT_BITS = 26                                # the bound the source states


def test_the_model_is_the_kernels_formula():
    assert "return ((5 * b) >> 4) - 81;" in SRC
    assert (LO_BITS, MAX_PARTS, MAX_COUNT) == (20, 264, 1 << 37)


def flat_base(b):
    return ((5 * np.asarray(b, dtype=np.int64)) >> 4) - 81


def units(a, b) -> np.ndarray:
    """The units of the f32 squares of ``a`` in bin ``b`` (int64), and
    their shifts, as flat_units computes them."""
    a = np.asarray(a, dtype=np.float32)
    u = (a * a).view(np.uint32).astype(np.int64)
    shift = (u >> 23) - 127 - flat_base(b)
    return ((u & 0x7FFFFF) | 0x800000) << np.maximum(shift, 0), shift


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.int64).astype(np.int32).view(np.float32)


def _bins(bits) -> np.ndarray:
    return ref.bin_index(torch.from_numpy(_f32(bits).copy())).numpy()


def lower_edges() -> np.ndarray:
    """Bits of the least f32 that ``ref.bin_index`` puts in bin b, for b
    = 1..511 (a bisection over the bit patterns of positive floats)."""
    b = np.arange(1, ref.NBINS)
    lo = np.full(b.shape, np.float32(2.0 ** -41).view(np.int32), np.int64)
    hi = np.full(b.shape, np.float32(2.0 ** 41).view(np.int32), np.int64)
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        ge = _bins(mid) >= b
        hi, lo = np.where(ge, mid, hi), np.where(ge, lo, mid)
    assert (_bins(hi) == b).all() and (_bins(hi - 1) == b - 1).all()
    return hi


EDGES = lower_edges()                         # EDGES[b - 1]: bin b's


def edge_values(b: int) -> np.ndarray:
    """Both edges of bin b and one ulp either side of each."""
    lo, nxt = EDGES[b - 1], EDGES[b]
    return _f32([lo - 1, lo, lo + 1, nxt - 2, nxt - 1, nxt])


def test_every_square_of_bins_1_to_510_is_a_small_integer_of_units():
    top = 0
    for b in range(1, ref.NBINS - 1):
        u, shift = units(edge_values(b), b)
        assert ((shift >= 0) & (shift <= 2)).all(), (b, shift)
        top = max(top, int(u.max()))
    assert top < 1 << UNIT_BITS


def test_no_word_or_range_sum_can_carry_out():
    top = max(int(units(edge_values(b), b)[0].max())
              for b in range(1, ref.NBINS - 1))
    mask = (1 << LO_BITS) - 1
    # one tile: lo, and hi = count << 20 plus the high bits
    assert TILE_COUNT * mask < 1 << 32
    assert TILE_COUNT * (top >> LO_BITS) < 1 << LO_BITS
    assert (TILE_COUNT << LO_BITS) + TILE_COUNT * (top >> LO_BITS) < 1 << 32
    # the largest range dct_hist assigns, and the largest histogram
    nb = (MAX_COUNT - 1) // ref.BLOCK // K.HIST_TILE * K.HIST_TILE
    groups = -(-nb // ROWS)
    per = -(-groups // MAX_PARTS)
    assert -(-groups // per) <= MAX_PARTS
    assert per * ROWS * ref.BLOCK * top < 1 << 64
    assert MAX_COUNT * top <= 1 << 64


def _model_energy(vals: np.ndarray, b: int, order) -> tuple[int, np.float32]:
    """bin_flat's two words summed in ``order``, then flat_energy."""
    u, _ = units(vals, b)
    lo = hi = 0
    for i in order:
        lo += int(u[i]) & ((1 << LO_BITS) - 1)
        hi += (1 << LO_BITS) | (int(u[i]) >> LO_BITS)
        assert lo < 1 << 32 and hi < 1 << 32
    s = ((hi & ((1 << LO_BITS) - 1)) << LO_BITS) + lo
    unit = np.float32(2.0 ** (int(flat_base(b)) - 23))
    return hi >> LO_BITS, np.float32(s) * unit


def _fsum_f32(vals: np.ndarray) -> np.float32:
    a = np.asarray(vals, dtype=np.float32)
    return np.float32(math.fsum((a * a).astype(np.float64)))


@settings(max_examples=200, deadline=None)
@given(data=st.data())
def test_the_exact_sum_is_order_free_and_rounded_once(data):
    b = data.draw(st.integers(1, ref.NBINS - 2))
    lo, nxt = int(EDGES[b - 1]), int(EDGES[b])
    bits = data.draw(st.lists(st.integers(lo - 1, nxt), min_size=1,
                              max_size=300))
    vals = _f32(bits)
    order = data.draw(st.permutations(range(len(vals))))
    c0, e0 = _model_energy(vals, b, range(len(vals)))
    c1, e1 = _model_energy(vals, b, order)
    assert c0 == c1 == len(vals)
    assert e0.view(np.uint32) == e1.view(np.uint32)
    assert e0.view(np.uint32) == _fsum_f32(vals).view(np.uint32)


@pytest.mark.parametrize("b", [1, 2, 127, 255, 256, 400, 509, 510])
def test_a_full_tile_at_the_top_of_a_bin_sums_exactly(b):
    vals = np.full(TILE_COUNT, _f32(EDGES[b] - 1), dtype=np.float32)
    rng = np.random.default_rng(b)
    vals[::3] = _f32(EDGES[b - 1] - 1)
    c, e = _model_energy(vals, b, rng.permutation(TILE_COUNT))
    assert c == TILE_COUNT
    assert e.view(np.uint32) == _fsum_f32(vals).view(np.uint32)


def test_the_model_equals_the_plain_tile_sums_bit_for_bit():
    """A tile of values over 40 octaves: for every bin 1..510 it holds,
    the model's energy is the plain version's f64 sum rounded once."""
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((K.HIST_TILE, ref.BLOCK))
         * 2.0 ** rng.uniform(-20, 20, (K.HIST_TILE, ref.BLOCK))
         ).astype(np.float32)
    a = torch.from_numpy(np.abs(y))
    bins = ref.bin_index(a)
    cnt, eng = K._tile_sums(a * a, bins, ref.NBINS, K.HIST_TILE)
    flat, fb = np.abs(y).ravel(), bins.numpy().ravel()
    seen = 0
    for b in range(1, ref.NBINS - 1):
        vals = flat[fb == b]
        if not len(vals):
            continue
        seen += 1
        c, e = _model_energy(vals, b, rng.permutation(len(vals)))
        assert c == int(cnt[0, b])
        assert e.view(np.uint32) == eng[0, b].numpy().view(np.uint32), b
    assert seen > 200


def test_bins_0_and_511_break_the_premise():
    # bin 0: exact zeros, subnormal and tiny squares: exponents 70+
    # binades apart, and 0 has no significand bit at all
    zero = _f32([0, 1, EDGES[0] - 1])
    assert (_bins(zero.view(np.int32)) == 0).all()
    _, shift = units(zero[1:], 0)
    assert shift.max() - shift.min() > 2
    # bin 511: from 2^39.84 up to magnitudes whose square overflows f32
    top = np.array([_f32(EDGES[-1]), np.float32(1e18), np.float32(1e30)])
    assert (ref.bin_index(torch.from_numpy(top)) == ref.NBINS - 1).all()
    _, shift = units(top[:2], ref.NBINS - 1)
    assert shift.max() - shift.min() > 2
    with np.errstate(over="ignore"):
        assert not np.isfinite(top[2] * top[2])
