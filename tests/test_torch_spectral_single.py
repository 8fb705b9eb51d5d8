"""The single-tensor spectral codec of the port against the JAX package's,
on the CPU: the two single-tensor kernels' plain versions, the two-level
route the card takes, the sort selector, the ``int8-ef`` wire codec and
the p_o/p_i allocator.

Inputs are made from a seed with numpy and handed to both packages; the
JAX side runs as ``tests/test_kernels.py`` runs it off the TPU (Pallas in
interpret mode, the codec compiled). Tolerances and why:

* y (the DCT) rtol 1e-5, atol 1e-5; counts equal; energies rtol 1e-4,
  atol 1e-6 — ``tests/test_kernels.py``'s own (the Pallas kernel sums
  energies in f32 through a one-hot product, the plain version in f64
  rounded once). Counts below 2^24 per bin, where JAX's f32 counts are
  exact.
* thresholds, q and scale bitwise. The card selects with the two-level
  route; the JAX package, off the TPU, with the flat one: they land on the
  same bin edge. Where XLA's CPU product of fewer than 56 rows sums the
  DCT in another order than the port's FMA chain (the port's order is the
  card's and cuBLAS's, and XLA's own from 56 rows on), the coefficients
  differ within the DCT's tolerance above: there thresholds stay bitwise,
  scales (a block's amax times f32(1/127)) are held to the same rtol 1e-5
  and q to one step (a coefficient on a rounding boundary). The tests
  check which case they are in, so neither passes unnoticed.
* subnormals: XLA's CPU backend flushes them, so the port runs under
  ``torch.set_flush_denormal(True)`` (as ``test_torch_spectral.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import lossy as JL
from repro.core.allocator import Allocator as JAllocator
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels import spectral_lossy as JK
from repro_torch.core import compression as TC
from repro_torch.core import lossy as TL
from repro_torch.core import pytree
from repro_torch.core.allocator import Allocator, AmdahlModel
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import spectral_lossy as TK
from test_codec_properties import PAYLOAD_KINDS
from test_codec_properties import _payload as codec_payload
from test_torch_spectral import EPS, KINDS, _blocks, _signal, _t


@pytest.fixture
def ftz():
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


# ---------------------------------------------------------------------------
# the two kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [8, 24, 13, 97])
@pytest.mark.parametrize("kind", ["noise", "smooth", "tiny", "cauchy"])
def test_dct_hist_coarse_plain_matches_pallas(nb, kind, ftz):
    xb = _blocks(_signal(nb * JR.BLOCK, nb, kind), JK.HIST_TILE)
    y_j, cnt_j, eng_j = JK.dct_hist_coarse(jnp.asarray(xb), interpret=True)
    y_t, cnt_t, eng_t = TK.dct_hist_coarse(_t(xb))
    assert cnt_t.shape == eng_t.shape == (JR.NBINS_COARSE,)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(eng_t.numpy(), np.asarray(eng_j),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("nb", [8, 24, 13, 97])
@pytest.mark.parametrize("per_block", [False, True])
def test_hist_refine_plain_matches_pallas(nb, per_block, ftz):
    rng = np.random.default_rng(nb + 5)
    xb = _blocks(_signal(nb * JR.BLOCK, nb, "noise"), JK.HIST_TILE)
    y = np.asarray(JR.dct_blocks(jnp.asarray(xb)))
    _, ce = JR.coarse_energy_histogram(jnp.asarray(y))
    _, cc, _, _ = JR.select_coarse(ce, 1e-2)
    coarse = np.int32(cc)
    if per_block:
        coarse = np.full(y.shape[0], coarse, np.int32)
        coarse[::3] = rng.integers(0, JR.NBINS_COARSE, coarse[::3].size)
    cnt_j, eng_j = JK.hist_refine(jnp.asarray(y), jnp.asarray(coarse),
                                  interpret=True)
    cnt_t, eng_t = TK.hist_refine(_t(y), _t(coarse))
    assert cnt_t.shape == (JR.NBINS_FINE,)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(eng_t.numpy(), np.asarray(eng_j),
                               rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the card's two-level route (on the plain kernels) against the JAX codec
# ---------------------------------------------------------------------------

_jdct = jax.jit(JR.dct_blocks)


def _jax_threshold(xb, eps):
    y = _jdct(jnp.asarray(xb))
    return JR.threshold_from_histogram(JR.energy_histogram(y)[1], eps)


def _assert_route_matches_jax(x, eps):
    """The port's two-level route against ``repro``'s ``spectral_compress``
    of the same tensor (see the module docstring for the rule below 56
    rows). Returns whether the two DCTs were bitwise equal."""
    xb = TO._pad_blocks(TR.blockize(_t(x))[0], TK.HIST_TILE)
    y, t = TO.select_two_level(xb, eps)
    q, s = TK.threshold_quant(y, t)
    c = JO.spectral_compress(jnp.asarray(x), eps)
    np.testing.assert_array_equal(t.numpy(), np.asarray(
        _jax_threshold(xb.numpy(), eps)))
    same_y = np.array_equal(y.numpy(), np.asarray(_jdct(xb.numpy())))
    assert same_y or 0 < xb.shape[0] < 56, xb.shape
    if same_y:
        np.testing.assert_array_equal(q.numpy(), np.asarray(c.q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(c.scale))
    else:
        dq = np.abs(q.numpy().astype(np.int16) - np.asarray(c.q, np.int16))
        assert dq.max() <= 1
        np.testing.assert_allclose(s.numpy(), np.asarray(c.scale),
                                   rtol=1e-5, atol=0)
    # the CPU's own route (the flat selector) gives the same bits
    c_t = TO.spectral_compress(_t(x), eps)
    assert torch.equal(c_t.q, q) and torch.equal(c_t.scale, s)
    return same_y


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eps", EPS)
def test_two_level_route_matches_jax_codec_bitwise(kind, eps, ftz):
    assert _assert_route_matches_jax(_signal(40000, kind=kind), eps)


@pytest.mark.parametrize("kind", PAYLOAD_KINDS)
@pytest.mark.parametrize("eps", EPS)
def test_two_level_route_matches_jax_on_codec_payload_classes(kind, eps,
                                                              ftz):
    _assert_route_matches_jax(codec_payload(kind, floats=True), eps)


@pytest.mark.parametrize("case", ["one_block", "1001_blocks", "eps_ge_1",
                                  "zeros", "single_block"])
def test_two_level_route_at_the_edges(case, ftz):
    """``tests/test_kernels.py::test_selector_edge_cases`` plus 1 block and
    a block count that is no tile multiple (1001 -> 1008 rows)."""
    if case == "one_block":
        x, eps = _signal(100, kind="noise"), 1e-2
    elif case == "1001_blocks":
        x, eps = _signal(1001 * JR.BLOCK - 3, kind="smooth"), 1e-2
    elif case == "eps_ge_1":
        x, eps = _signal(4096, kind="noise"), 1.5
    elif case == "zeros":
        x, eps = np.zeros(4096, np.float32), 1e-2
    else:
        x, eps = _signal(JR.BLOCK, kind="smooth"), 1e-2
    _assert_route_matches_jax(x, eps)
    if case in ("eps_ge_1", "zeros"):
        assert not TO.spectral_compress(_t(x), eps).q.any()


def test_chunks_and_in_graph_equal_the_codec_and_jax():
    x = _signal(1001 * JR.BLOCK - 3, kind="noise")
    c = TO.spectral_compress(_t(x), 1e-2)
    chunks, scale, n = TO.spectral_compress_chunked(_t(x), 1e-2,
                                                    chunk_blocks=64)
    assert n == x.size and [ch.shape[0] for ch in chunks] == [64] * 15 + [48]
    assert torch.equal(torch.cat(chunks), c.q) and torch.equal(scale, c.scale)
    j_chunks, j_scale, _ = JO.spectral_compress_chunked(jnp.asarray(x), 1e-2,
                                                        chunk_blocks=64)
    for a, b in zip(chunks, j_chunks, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    q, s = TO.compress_in_graph(_t(x), 1e-2)
    # compiled, as it runs inside the JAX package's train step
    q_j, s_j = jax.jit(lambda v: JO.compress_in_graph(v, 1e-2))(
        jnp.asarray(x))
    assert torch.equal(q, c.q) and torch.equal(s, c.scale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


def test_per_leaf_tree_path_equals_fused_and_jax():
    from test_torch_spectral import _policy, _port_state, _smoke_state
    jstate = _smoke_state(4)
    state = _port_state(jstate)
    per_leaf = TO.spectral_compress_tree(state, 1e-2, _policy, fused=False)
    fused = TO.spectral_compress_tree(state, 1e-2, _policy)
    j = JO.spectral_compress_tree(jstate, 1e-2, _policy)
    is_c = lambda v: isinstance(v, (TR.Compressed, JR.Compressed))
    leaves = lambda tree: [v for _, v in pytree.flatten_with_path(tree, is_c)
                           if is_c(v)]
    j_leaves = [v for v in jax.tree.leaves(j, is_leaf=is_c) if is_c(v)]
    n = 0
    for c, f, jc in zip(leaves(per_leaf), leaves(fused), j_leaves,
                        strict=True):
        assert torch.equal(c.q, f.q) and torch.equal(c.scale, f.scale)
        dq = np.abs(c.q.numpy().astype(np.int16) - np.asarray(jc.q, np.int16))
        assert dq.max() <= 1        # small leaves: see the module docstring
        n += 1
    assert n == 2 * len(jax.tree.leaves(jstate["params"]))


@pytest.mark.parametrize("stream", [False, True])
def test_frames_from_the_two_level_route_equal_jax(stream, monkeypatch):
    """The RPLY frames ``compress_tensor`` writes when it selects as the
    card does (two-level, through the kernels' plain versions) are the JAX
    package's byte for byte, streamed (two 1 MiB chunks) and not."""
    monkeypatch.setattr(TO, "select_flat", TO.select_two_level)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(300_000) * 1e-3).astype(np.float32)
    TK.reset_launches()
    t_blob, t_st = TL.compress_tensor(x, 1e-2, stream=stream, device="cpu")
    j_blob, j_st = JL.compress_tensor(x, 1e-2, stream=stream)
    assert t_blob == j_blob
    assert t_st.kept_fraction == pytest.approx(j_st.kept_fraction)
    assert [k.launches for k in TK.KERNELS] == [0] * len(TK.KERNELS)


# ---------------------------------------------------------------------------
# the sort selector, kept_fraction, int8-ef, the allocator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["smooth", "noise", "cauchy", "sparse",
                                  "zeros"])
@pytest.mark.parametrize("eps", [1e-3, 1e-2, 1e-1, 2.0])
def test_threshold_by_sort_and_kept_fraction_match_jax(kind, eps):
    y = np.asarray(_jdct(JR.blockize(jnp.asarray(
        _signal(4096 * 3, kind=kind)))[0]))
    t_j = JR.threshold_by_sort(jnp.asarray(y), eps)
    t_t = TR.threshold_by_sort(_t(y), eps)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    c_j = JR.compress(jnp.asarray(_signal(40000, kind=kind)), eps,
                      selector="sort")
    c_t = TR.compress(_t(_signal(40000, kind=kind)), eps, selector="sort")
    np.testing.assert_array_equal(c_t.q.numpy(), np.asarray(c_j.q))
    assert TR.kept_fraction(c_t) == pytest.approx(JR.kept_fraction(c_j),
                                                  rel=1e-6)
    # the sorted threshold is the tightest: the histogram's never exceeds
    if eps < 1:
        t_hist = TR.threshold_from_histogram(
            TR.energy_histogram(_t(y))[1], eps)
        assert float(t_hist) <= float(t_t)


@pytest.mark.parametrize("kind", PAYLOAD_KINDS)
def test_int8_ef_frames_byte_identical(kind):
    arr = codec_payload(kind, floats=True) * np.float32(3.0)
    t_codec, j_codec = TC.get("int8-ef"), JC.get("int8-ef")
    assert t_codec.lossy and t_codec.error_bound() == j_codec.error_bound()
    blob = t_codec.encode(arr)
    assert blob == j_codec.encode(arr)
    out = t_codec.decode(blob)
    np.testing.assert_array_equal(out, j_codec.decode(blob))
    assert out.shape == arr.shape and out.dtype == np.float32


def test_amdahl_fit():
    m = AmdahlModel()
    for p in (1, 2, 4, 8):
        m.observe(p, 1.0 + 8.0 / p)
    assert m.serial == pytest.approx(1.0, abs=0.05)
    assert m.parallel == pytest.approx(8.0, rel=0.05)


def _allocators(p_total, handoff_s, app, task):
    out = []
    for cls in (Allocator, JAllocator):
        al = cls(p_total=p_total, handoff_s=handoff_s)
        for p, t in app:
            al.observe_app(p, t)
        for p, t in task:
            al.observe_task(p, t)
        out.append(al)
    return out


def test_allocator_balances_app_and_task_as_jax():
    """F1: the best async split puts both sides at roughly equal duration
    — the same plan as the JAX package's."""
    al, jal = _allocators(72, 0.0, [(p, 10.0 / p) for p in (18, 36, 72)],
                          [(p, 0.05 + 2.0 / p) for p in (18, 36, 72)])
    plan, jplan = al.plan(n_steps=100, every=5), jal.plan(n_steps=100,
                                                          every=5)
    assert plan.mode == "async"
    assert al.balance_quality(plan) < 0.35
    assert plan.p_app + plan.p_insitu == 72
    assert (plan.mode, plan.p_app, plan.p_insitu, plan.predicted_total_s,
            plan.detail) == (jplan.mode, jplan.p_app, jplan.p_insitu,
                             jplan.predicted_total_s, jplan.detail)


def test_allocator_prefers_sync_for_cheap_tasks_as_jax():
    """F6: when the task is trivially cheap, sync wins (no staging tax)."""
    al, jal = _allocators(8, 0.5, [(8, 1.0)], [(8, 1e-4), (1, 1e-3)])
    plan, jplan = al.plan(n_steps=100, every=1), jal.plan(n_steps=100,
                                                          every=1)
    assert plan.mode == jplan.mode == "sync"
    assert plan.predicted_total_s == jplan.predicted_total_s
    assert al.balance_quality(plan) == 1.0
