"""The design of the card's single-tensor refine kernel (``hist_refine`` in
``csrc/spectral_lossy.cu``: ``refine_table_scan``, ``refine_range_kernel``,
``refine_total_kernel``), modelled on the CPU with the constants read from
the source, and the CPU path of the wrapper against the JAX package.

* Membership by bits: the table is, per coarse bin, the least interval of
  |y| bit patterns holding all its patterns; an element outside it is no
  member and ``bin_index`` decides inside it. Modelled here with the
  port's ``ref.bin_index`` (the card builds its table with its own log2f,
  and ``chip_smoke.py`` checks that one against all 2^31 patterns): the
  kernel's scan over aligned chunks gives the least intervals, which
  bisection finds too, and the rule decides as ``bin_index`` does on
  every pattern within 2^16 ulps of the 33 coarse edges, on the top of the
  range (inf and NaNs), on 10^6 seeded random patterns and on special
  values.
* Exact units: a model of the range kernel (candidates compacted into a
  per-warp queue and binned 32 at a time, per-warp u32 words flushed per
  tile, u64 units, double for flat bins 0 and 511 and for the runs of a
  coarse bin per block, every order as the kernel's) and of the total.
  Counts equal the plain version's bit for bit, energies within rtol 1e-5
  (the plain version sums each tile in f64 and rounds it to f32 before the
  tiles are summed); the words never carry out.
* The ranges: a function of n_blocks alone, each 8-row tile once, in
  order.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels import spectral_lossy as JK
from repro_torch.kernels import ref
from repro_torch.kernels import spectral_lossy as K
from test_torch_spectral import _blocks, _signal, _t

SRC = (Path(K.__file__).with_name("csrc") / "spectral_lossy.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", SRC)
    assert m, f"{name} not found in spectral_lossy.cu"
    return int(eval(m.group(1).replace("u", "").replace("kTile", "8")
                    .replace("kBlock", "256")))


ROWS = _const("kRows")                 # rows per 64-row group
MAX_PARTS = _const("kMaxParts")
LO_BITS = _const("kLoBits")
SCAN_PER = _const("kScanPer")          # patterns per scan thread
WARPS = _const("kRangeWarps")
TILE_LOADS = _const("kTileLoads")      # float4s per lane per tile
TILE = K.HIST_TILE
PATTERNS = 1 << 31
INF = 0x7F800000


def test_the_model_uses_the_kernels_constants():
    assert (ROWS, MAX_PARTS, LO_BITS, SCAN_PER, WARPS, TILE_LOADS) == (
        64, 264, 20, 1024, 8, 16)
    assert _const("kPatterns") == PATTERNS
    assert "return u - lo < span;" in SRC
    assert "const int k = b - c * kFine;" in SRC


# ---------------------------------------------------------------------------
# membership by bits
# ---------------------------------------------------------------------------

def _f32(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, np.int64).astype(np.uint32)
                            .view(np.float32).copy())


def coarse_of(bits) -> np.ndarray:
    """``bin_index(a) >> 4`` of the floats with these bit patterns."""
    return (ref.bin_index(_f32(bits)).numpy() >> 4).astype(np.int64)


def scan_model(starts, n_chunks) -> np.ndarray:
    """``refine_table_scan`` over the chunks of SCAN_PER patterns from each
    start: per chunk, runs of one coarse bin flush (least pattern, one past
    the run) into an atomic min and max. Returns (2, 32) lo, hi."""
    lo = np.full(32, 0xFFFFFFFF, np.int64)
    hi = np.zeros(32, np.int64)
    for s, n in zip(starts, n_chunks):
        bits = np.arange(s, s + n * SCAN_PER, dtype=np.int64)
        c = coarse_of(bits).reshape(n, SCAN_PER)
        b = bits.reshape(n, SCAN_PER)
        new = np.ones_like(c, dtype=bool)
        new[:, 1:] = c[:, 1:] != c[:, :-1]
        end = np.ones_like(new)
        end[:, :-1] = new[:, 1:]
        np.minimum.at(lo, c[new], b[new])
        np.maximum.at(hi, c[end], b[end] + 1)
    return np.stack([lo, hi])


def bisect_edges() -> np.ndarray:
    """Least pattern whose coarse bin is c or more, c = 1..31."""
    c = np.arange(1, 32)
    lo = np.zeros(c.shape, np.int64)
    hi = np.full(c.shape, INF, np.int64)
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        ge = coarse_of(mid) >= c
        hi, lo = np.where(ge, mid, hi), np.where(ge, lo, mid)
    return hi


EDGES = bisect_edges()


# bin_index of inf: 511 on the card (its float -> int conversion
# saturates), 0 here (the host's gives INT_MIN, clamped)
INF_COARSE = int(coarse_of([INF])[0])


def model_table() -> np.ndarray:
    """The table the scan builds when the coarse bin is monotone in the
    bits (checked in the windows below): coarse bin 0 from pattern 0 to
    the top (NaNs are bin 0), c = 1..31 between the bisected edges, 31 up
    to the largest finite float, or to inf where bin_index puts it in 31."""
    lo = np.concatenate([[0], EDGES])
    hi = np.concatenate([[PATTERNS], EDGES[1:],
                         [INF + (INF_COARSE == 31)]])
    return np.stack([lo, hi])


def _windows():
    """Chunk-aligned windows of at least 2^16 patterns either side of the
    33 coarse edges (the 31 between coarse bins, and 2^-40 and 2^40 where
    bin_index clamps), the bottom of the range (zero and the smallest
    subnormals) and the top (the largest finite floats, inf and every
    NaN)."""
    centres = [int(np.float32(2.0 ** -40).view(np.int32))] + EDGES.tolist() \
        + [int(np.float32(2.0 ** 40).view(np.int32))]
    starts = [(c - (1 << 16)) // SCAN_PER * SCAN_PER for c in centres]
    n = [(2 << 16) // SCAN_PER + 1] * len(starts)
    top = (INF - (1 << 16)) // SCAN_PER * SCAN_PER
    return ([0] + starts + [top],
            [(1 << 16) // SCAN_PER] + n + [(PATTERNS - top) // SCAN_PER])


def test_edges_sit_where_the_bins_put_them():
    assert len(EDGES) == 31 and (np.diff(EDGES) > 0).all()
    assert (coarse_of(EDGES) == np.arange(1, 32)).all()
    assert (coarse_of(EDGES - 1) == np.arange(0, 31)).all()


def test_the_scan_gives_the_least_intervals_and_the_model():
    starts, n = _windows()
    table = scan_model(starts, n)
    want = model_table()
    # the windows hold every interval's ends: the scan over them finds the
    # model's table, i.e. the coarse bin is monotone in every window
    np.testing.assert_array_equal(table, want)
    # the least intervals over the windows' patterns, computed directly
    bits = np.concatenate([np.arange(s, s + k * SCAN_PER)
                           for s, k in zip(starts, n)])
    c = coarse_of(bits)
    for b in range(32):
        assert bits[c == b].min() == table[0, b]
        assert bits[c == b].max() + 1 == table[1, b]


def _candidate(bits: np.ndarray, table: np.ndarray, c: int) -> np.ndarray:
    """The kernel's test ``u - lo < span`` (u32 arithmetic) for coarse bin
    c; bin_index decides the candidates."""
    lo, hi = int(table[0, c]), int(table[1, c])
    return ((bits - lo) & 0xFFFFFFFF) < ((hi - lo) & 0xFFFFFFFF)


def _assert_decides_as_bin_index(bits, table) -> np.ndarray:
    """For every coarse bin c, the rule's members (candidates whose
    bin_index coarse bin is c) are bin_index's members of c; and the
    intervals of coarse bins 1..31 hold no other bin's pattern, so
    bin_index runs there for members alone. Returns the coarse bins."""
    coarse = coarse_of(bits)
    for c in range(32):
        own = coarse == c
        cand = _candidate(bits, table, c)
        np.testing.assert_array_equal(cand & own, own)
        if c:
            assert not (cand & ~own).any(), c
    return coarse


def test_the_rule_decides_as_bin_index_near_every_edge_and_at_the_top():
    starts, n = _windows()
    bits = np.concatenate([np.arange(s, s + k * SCAN_PER)
                           for s, k in zip(starts, n)])
    assert len(bits) > 33 * (2 << 16) and bits.max() == PATTERNS - 1
    _assert_decides_as_bin_index(bits, model_table())


def test_the_rule_on_random_and_special_patterns():
    rng = np.random.default_rng(18)
    bits = rng.integers(0, PATTERNS, 10 ** 6, dtype=np.int64)
    special = np.array([0.0, np.float32(1.4e-45), 1e-38,
                        np.finfo(np.float32).max, np.inf],
                       np.float32).view(np.int32).astype(np.int64)
    coarse = _assert_decides_as_bin_index(np.concatenate([bits, special]),
                                          model_table())
    assert coarse[-5:].tolist() == [0, 0, 0, 31, INF_COARSE]
    # a NaN is a candidate of coarse bin 0 alone, whose member bin_index
    # makes it
    nan = np.array([INF + 1, 0x7FC00000, PATTERNS - 1], np.int64)
    assert (coarse_of(nan) == 0).all()
    assert _candidate(nan, model_table(), 0).all()
    assert not any(_candidate(nan, model_table(), c).any()
                   for c in range(1, 32))


# ---------------------------------------------------------------------------
# the ranges
# ---------------------------------------------------------------------------

def range_parts(nb: int) -> tuple[int, int]:
    """``range_parts`` of the source: (ranges, 64-row groups per range)."""
    groups = -(-nb // ROWS) if nb > 0 else 0
    per = -(-groups // MAX_PARTS) if groups > 0 else 1
    return -(-groups // per), per


def warp_tiles(nb: int):
    """For each range g and warp w, the 8-row tiles it runs, in order."""
    parts, per = range_parts(nb)
    groups = -(-nb // ROWS)
    t_per_group = ROWS // TILE
    for g in range(parts):
        t1 = min(min((g + 1) * per, groups) * t_per_group, nb // TILE)
        for w in range(WARPS):
            yield g, w, list(range(g * per * t_per_group + w, t1, WARPS))


def test_range_parts_is_the_sources():
    body = SRC[SRC.index("int range_parts(int nb, long& per) {"):]
    body = body[:body.index("\n}\n")]
    assert "kMaxParts" in body and "kRows" in body and "SM" not in body


@pytest.mark.parametrize("nb", [0, 8, 64, 72, 1008, 12960, 16896, 16904,
                                38880, 103680, 110592, 1050928])
def test_ranges_cover_every_tile_once_in_order(nb):
    parts, per = range_parts(nb)
    assert parts <= MAX_PARTS
    assert range_parts(nb) == (parts, per)      # nothing but nb
    seen = []
    for g, w, tiles in warp_tiles(nb):
        assert tiles == sorted(tiles)
        seen += tiles
    assert sorted(seen) == list(range(nb // TILE))
    if nb:
        # every range but the last runs `per` groups: the work is even
        assert parts == -(-(-(-nb // ROWS)) // per)


# ---------------------------------------------------------------------------
# the exact units and the fixed-order sums
# ---------------------------------------------------------------------------

def flat_base(b):
    return ((5 * np.asarray(b, np.int64)) >> 4) - 81


def flat_units(a2: np.ndarray, b: np.ndarray) -> np.ndarray:
    u = a2.view(np.uint32).astype(np.int64)
    shift = (u >> 23) - 127 - flat_base(b)
    assert ((shift >= 0) & (shift <= 2)).all()
    return ((u & 0x7FFFFF) | 0x800000) << shift


def _tree32(e: np.ndarray) -> float:
    """``__shfl_down_sync`` from offset 16 to 1: lane 0's sum."""
    e = e.astype(np.float64).copy()
    for off in (16, 8, 4, 2, 1):
        e[:off] = e[:off] + e[off:2 * off]
    return float(e[0])


def kernel_model(y: np.ndarray, coarse) -> tuple[np.ndarray, np.ndarray]:
    """refine_range_kernel and refine_total_kernel on (nb, 256) f32 ``y``
    with one coarse bin (an int) or one per block, candidates by the model
    table, in the kernel's orders: each warp queues its candidates float4
    step by float4 step in lane order, bins the last 32 whenever it holds
    32 or more (value qn + l to lane l) and the rest at the end of the tile
    or of a run of one coarse bin."""
    nb = y.shape[0]
    per_block = not isinstance(coarse, int)
    table = model_table()
    parts, _ = range_parts(nb)
    part_c = np.zeros((parts, 16), np.int64)
    part_u = np.zeros((parts, 16), object)
    part_d = np.zeros((parts, 16), np.float64)
    for g, w, tiles in warp_tiles(nb):
        cnt = np.zeros(16, np.int64)
        units = [0] * 16
        dbl = np.zeros(16, np.float64)
        e_edge = {0: np.zeros(32), 511: np.zeros(32)}   # per lane, in order
        run_c = -1 if per_block else coarse
        words = {"lo": np.zeros(16, np.int64), "hi": np.zeros(16, np.int64)}
        queue: list = []

        def members(vals):
            """One round: value l to lane l."""
            if not (0 <= run_c < 32) or not len(vals):
                return
            a = np.asarray(vals, np.float32)
            b = ref.bin_index(torch.from_numpy(a)).numpy()
            k = b - run_c * 16
            mem = (k >= 0) & (k < 16)
            with np.errstate(over="ignore"):
                a2 = a * a
            for edge in (0, 511):
                m = mem & (b == edge)
                e_edge[edge][:len(a)][m] += a2[m].astype(np.float64)
                np.add.at(words["hi"], k[m], 1 << LO_BITS)
            m = mem & (b != 0) & (b != 511)
            un = flat_units(a2[m], b[m])
            np.add.at(words["lo"], k[m], un & ((1 << LO_BITS) - 1))
            np.add.at(words["hi"], k[m], (1 << LO_BITS) | (un >> LO_BITS))

        def flush():
            lo_w, hi_w = words["lo"], words["hi"]
            assert (lo_w < 1 << 32).all() and (hi_w < 1 << 32).all()
            cnt[:] += hi_w >> LO_BITS
            for k in range(16):
                units[k] += ((int(hi_w[k]) & ((1 << LO_BITS) - 1))
                             << LO_BITS) + int(lo_w[k])
            words["lo"], words["hi"] = (np.zeros(16, np.int64),
                                        np.zeros(16, np.int64))

        def to_double():
            if 0 <= run_c < 32:
                for k in range(16):
                    unit = 2.0 ** (int(flat_base(run_c * 16 + k)) - 23)
                    dbl[k] += float(units[k]) * unit
            units[:] = [0] * 16

        for t in tiles:
            # lane l's float4 i is float4 l + 32 i of the tile (row i // 2)
            v = y[t * TILE:(t + 1) * TILE].reshape(TILE_LOADS, 32, 4)
            for i in range(TILE_LOADS):
                if per_block:
                    c = int(coarse[t * TILE + i // 2])
                    if c != run_c:
                        members(queue)
                        queue = []
                        flush()
                        to_double()
                        run_c = c
                bits = np.abs(v[i]).view(np.uint32).astype(np.int64)
                for j in range(4):
                    if 0 <= run_c < 32:
                        cand = _candidate(bits[:, j], table, run_c)
                    else:
                        cand = np.zeros(32, bool)
                    queue += np.abs(v[i][:, j])[cand].tolist()
                while len(queue) >= 32:
                    members(queue[-32:])
                    del queue[-32:]
            members(queue)
            queue = []
            flush()
        if per_block:
            to_double()
        dbl[0] += _tree32(e_edge[0])
        dbl[15] += _tree32(e_edge[511])
        # the CTA's warps in order
        part_c[g] += cnt
        for k in range(16):
            part_u[g, k] += units[k]
        part_d[g] += dbl          # w ascending: the loop's own order
    # refine_total_kernel: slice s adds rows s, s + 16, ...; then in order
    out_c, out_e = np.zeros(16, np.float32), np.zeros(16, np.float32)
    for k in range(16):
        c = sum(int(part_c[g, k]) for g in range(parts))
        u = sum(int(part_u[g, k]) for g in range(parts))
        slices = [0.0] * 16
        for g in range(parts):
            slices[g % 16] += part_d[g, k]
        d = slices[0]
        for s in slices[1:]:
            d += s
        out_c[k] = np.float32(c)
        if u:
            b = int(coarse) * 16 + k
            out_e[k] = np.float32(u) * np.float32(2.0 ** (
                int(flat_base(b)) - 23))
        else:
            out_e[k] = np.float32(d)
    return out_c, out_e


def _case(nb: int, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((nb, ref.BLOCK)).astype(np.float32)
    if kind == "octaves":           # 40 octaves either side of 1
        y *= (2.0 ** rng.uniform(-40, 40, y.shape)).astype(np.float32)
    elif kind == "mixed":           # zeros, tiny, huge (squares overflow)
        scale = np.array([0.0, 1e-22, 1e-30, 1e15, 1e20, 1.0], np.float32)
        y *= scale[rng.integers(0, len(scale), nb)][:, None]
        y[rng.random(y.shape) < 0.05] = 0.0
    return y


def _plain(y: np.ndarray, coarse):
    cnt, eng = K.hist_refine_plain(torch.from_numpy(y), K._per_block(
        coarse, y.shape[0], torch.int32, torch.device("cpu")))
    return cnt.numpy(), eng.numpy()


@pytest.mark.parametrize("coarse", [1, 10, 15, 20, 30])
def test_exact_units_model_equals_plain_for_coarse_1_to_30(coarse):
    y = _case(72, "octaves", coarse)
    cnt, eng = kernel_model(y, coarse)
    cnt_p, eng_p = _plain(y, coarse)
    assert cnt.sum() > 0
    np.testing.assert_array_equal(cnt, cnt_p)
    np.testing.assert_allclose(eng, eng_p, rtol=1e-5, atol=0)
    # exact integers rounded once: each bin is the math.fsum of its
    # squares rounded once to f32
    a = np.abs(y).ravel()
    b = ref.bin_index(torch.from_numpy(a)).numpy()
    for k in range(16):
        sq = (a[b == coarse * 16 + k] ** 2).astype(np.float32)
        assert eng[k] == np.float32(math.fsum(sq.astype(np.float64)))


@pytest.mark.parametrize("coarse", [0, 31])
def test_bins_0_and_511_take_the_fixed_order_double_sum(coarse):
    y = _case(72, "mixed", 40 + coarse)
    cnt, eng = kernel_model(y, coarse)
    cnt_p, eng_p = _plain(y, coarse)
    edge = 0 if coarse == 0 else 15
    assert cnt[edge] > 0
    np.testing.assert_array_equal(cnt, cnt_p)
    np.testing.assert_allclose(eng, eng_p, rtol=1e-5, atol=0)
    if coarse == 31:
        assert np.isinf(eng[15])


@pytest.mark.parametrize("kind", ["octaves", "mixed", "normal"])
def test_per_block_runs_model_equals_plain(kind):
    rng = np.random.default_rng(5)
    y = _case(64, kind, 6)
    a = np.abs(y)
    own = (ref.bin_index(torch.from_numpy(a)).numpy() >> 4)
    coarse = np.array([np.bincount(r, minlength=32).argmax() for r in own],
                      np.int32)
    coarse[::3] = rng.integers(0, 32, coarse[::3].size)
    coarse[:8] = [0, 31, 31, 0, 5, 5, 5, 40]      # runs, bins 0/31, outside
    cnt, eng = kernel_model(y, coarse)
    cnt_p, eng_p = _plain(y, coarse)
    np.testing.assert_array_equal(cnt, cnt_p)
    np.testing.assert_allclose(eng, eng_p, rtol=1e-5, atol=0)


def test_ranges_of_several_groups_in_the_model():
    """16,904 blocks: 265 groups, so ranges of two groups (16 tiles, two a
    warp) and a last range of one."""
    nb = 16904
    assert range_parts(nb) == (133, 2)
    y = _case(nb, "normal", 3) * np.float32(1e-3)
    cnt, eng = kernel_model(y, 12)
    cnt_p, eng_p = _plain(y, 12)
    np.testing.assert_array_equal(cnt, cnt_p)
    np.testing.assert_allclose(eng, eng_p, rtol=1e-5, atol=0)


@pytest.mark.parametrize("coarse", [1, 16, 30])
def test_a_full_tile_at_the_top_of_a_coarse_bin_cannot_carry(coarse):
    """The worst tile: all 2048 elements members of the coarse bin's
    highest fine bin, each its largest pattern (the most units a square
    has): the words stay below 2^32 (asserted in the model's flush) and
    the energy is the exact sum rounded once."""
    top = EDGES_FLAT[coarse * 16 + 16] - 1        # largest of fine bin 15
    y = np.repeat(_f32([top]).numpy(), TILE * ref.BLOCK).reshape(
        TILE, ref.BLOCK)
    assert (ref.bin_index(torch.from_numpy(y)).numpy() == coarse * 16
            + 15).all()
    cnt, eng = kernel_model(y, coarse)
    assert cnt[15] == TILE * ref.BLOCK and cnt[:15].sum() == 0
    sq = np.float32(y[0, 0]) * np.float32(y[0, 0])
    assert eng[15] == np.float32(math.fsum([float(sq)] * TILE * ref.BLOCK))
    cnt_p, eng_p = _plain(y, coarse)
    np.testing.assert_array_equal(cnt, cnt_p)
    np.testing.assert_allclose(eng, eng_p, rtol=1e-5, atol=0)


def _flat_edges() -> np.ndarray:
    """Least pattern of flat bin b, b = 1..512 (512: past the top)."""
    b = np.arange(1, 512)
    lo = np.zeros(b.shape, np.int64)
    hi = np.full(b.shape, INF, np.int64)
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        ge = ref.bin_index(_f32(mid)).numpy() >= b
        hi, lo = np.where(ge, mid, hi), np.where(ge, lo, mid)
    return np.concatenate([[0], hi, [INF + 1]])


EDGES_FLAT = _flat_edges()


# ---------------------------------------------------------------------------
# the wrapper's CPU path against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.fixture
def ftz():
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("nb", [8, 24, 96])
@pytest.mark.parametrize("form", ["int", "0-d", "one element", "per block"])
def test_cpu_path_with_every_form_of_the_coarse_bin_matches_pallas(
        nb, form, ftz):
    xb = _blocks(_signal(nb * JR.BLOCK, nb, "noise"), JK.HIST_TILE)
    y = np.asarray(JR.dct_blocks(jnp.asarray(xb)))
    _, ce = JR.coarse_energy_histogram(jnp.asarray(y))
    c = int(JR.select_coarse(ce, 1e-2)[1])
    per = np.full(y.shape[0], c, np.int32)
    per[::4] = (c + 1) % 32
    coarse = {"int": c, "0-d": torch.tensor(c, dtype=torch.int32),
              "one element": torch.tensor([c], dtype=torch.int32),
              "per block": _t(per)}[form]
    want = per if form == "per block" else np.int32(c)
    cnt_j, eng_j = JK.hist_refine(jnp.asarray(y), jnp.asarray(want),
                                  interpret=True)
    K.reset_launches()
    cnt, eng = K.hist_refine(_t(y), coarse)
    assert K.hist_refine.launches == 0          # the plain version ran
    assert cnt.shape == eng.shape == (16,)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(eng.numpy(), np.asarray(eng_j), rtol=1e-4,
                               atol=1e-6)
