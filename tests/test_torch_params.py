"""``materialize``: stacked leaves one layer slice at a time (CPU).

A full-width MoE stacks its experts on a ``layers`` axis: moonshot's
``w_gate`` is (47, 64, 2048, 1408), 8.7 G values; xlstm's mLSTM ``wq`` is
(6, 7, 4096, 4096) on two. ``materialize`` draws such a leaf one layer
slice at a time into its place, so no f32 temporary is larger than one
layer's slice. Every caller of the port draws the dense
family's weights through the same ``materialize`` on a CPU generator, so
all of them see the same bits: these tests pin the rule (slice by slice,
in tree order, from one generator) rather than a digest of a torch
version's random stream.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.core.pytree import flatten_with_path, keystr, leaves
from repro_torch.launch.serve import weight_generator
from repro_torch.models import params as P
from repro_torch.models import transformer as T


def _recording(monkeypatch):
    """Record the element count of every f32 tensor the initializers
    fill."""
    seen = []
    trunc = torch.nn.init.trunc_normal_

    def rec_trunc(x, *a, **kw):
        seen.append(x.numel())
        return trunc(x, *a, **kw)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", rec_trunc)
    return seen


def _slice_size(s) -> int:
    """Elements of one slice of a leaf: its shape past every leading
    ``layers`` axis (two for the xLSTM family's mLSTM stack)."""
    lead = 0
    while lead < len(s.shape) - 1 and s.axes[lead] == "layers":
        lead += 1
    return int(np.prod(s.shape[lead:]))


@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b",
                                  "deepseek-v3-671b", "hymba-1.5b",
                                  "xlstm-1.3b"])
def test_no_f32_temporary_exceeds_one_layer_slice(monkeypatch, arch):
    spec = T.param_spec(tbase.get(arch, smoke=True))
    seen = _recording(monkeypatch)
    P.materialize(torch.Generator().manual_seed(0), spec, "cpu")
    biggest_slice = max(_slice_size(s) for s in leaves(spec)
                        if s.init == "normal")
    assert seen and max(seen) <= biggest_slice


def test_a_stacked_leaf_is_its_slices_drawn_in_order(monkeypatch):
    spec = {"a": P.ParamSpec((3, 5, 7), ("layers", "embed", "mlp")),
            "e": P.ParamSpec((11, 4), ("vocab", "embed"), init="embed",
                             scale=0.02),
            "w": P.ParamSpec((2, 6), ("layers", "embed"), torch.float32)}
    seen = _recording(monkeypatch)
    got = P.materialize(torch.Generator().manual_seed(4), spec, "cpu")
    assert seen == [35, 35, 35, 6, 6]           # a slice at a time
    gen = torch.Generator().manual_seed(4)
    want_a = [P._draw(gen, spec["a"], (5, 7)) for _ in range(3)]
    want_e = P._draw(gen, spec["e"], (11, 4))
    want_w = [P._draw(gen, spec["w"], (6,)) for _ in range(2)]
    assert torch.equal(got["a"], torch.stack(want_a))
    assert torch.equal(got["e"], want_e)
    assert torch.equal(got["w"], torch.stack(want_w))
    assert got["a"].dtype == torch.bfloat16 and got["w"].dtype == torch.float32
    # fan-in ignores the stacked axis: 1/sqrt(5) scales a (5, 7) slice
    assert got["a"].float().abs().max() <= 2.0 / np.sqrt(5) + 1e-2


def test_a_doubly_stacked_leaf_is_its_slices_drawn_in_order(monkeypatch):
    """The xLSTM family's mLSTM leaves are stacked (n_super, per, ...):
    one draw per (super-block, layer) slice, in row-major order, fan-in
    ignoring both stacked axes."""
    spec = {"m": P.ParamSpec((2, 3, 5, 7), ("layers", "layers", "mlp",
                                             "mlp")),
            "r": P.ParamSpec((2, 4, 3, 3), ("layers", None, "heads",
                                             "head_dim"), scale=0.5)}
    seen = _recording(monkeypatch)
    got = P.materialize(torch.Generator().manual_seed(9), spec, "cpu")
    assert seen == [35] * 6 + [36] * 2
    gen = torch.Generator().manual_seed(9)
    want_m = [P._draw(gen, spec["m"], (5, 7)) for _ in range(6)]
    want_r = [P._draw(gen, spec["r"], (4, 3, 3)) for _ in range(2)]
    assert torch.equal(got["m"], torch.stack(want_m).view(2, 3, 5, 7))
    assert torch.equal(got["r"], torch.stack(want_r))
    assert got["m"].float().abs().max() <= 2.0 / np.sqrt(5) + 1e-2
    assert got["r"].float().abs().max() <= 2.0 * 0.5 + 1e-2


def test_xlstm_spec_and_count_match_jax():
    """xlstm-1.3b's spec at the published widths, leaf by leaf, and its
    parameter count, 3,606,514,000, against the JAX package's (its dense
    4096 x 4096 q/k/v projections, beyond the published ~1.3 G)."""
    from repro.configs import base as jbase
    from repro.models import params as JP
    from repro.models import transformer as JT
    import jax

    jspec = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 JT.param_spec(jbase.get("xlstm-1.3b")),
                 is_leaf=lambda x: isinstance(x, JP.ParamSpec))[0]}
    tspec = {keystr(p): s for p, s in
             flatten_with_path(T.param_spec(tbase.get("xlstm-1.3b")))}
    assert sorted(tspec) == sorted(jspec)
    for k, js in jspec.items():
        ts = tspec[k]
        assert (ts.shape, ts.axes, ts.init, ts.scale) == \
            (js.shape, js.axes, js.init, js.scale), k
    assert tspec["['super']['mlstm']['wq']"].shape == (6, 7, 4096, 4096)
    assert tspec["['super']['slstm']['r_gates']"].shape == (6, 4, 4, 512, 512)
    assert tbase.get("xlstm-1.3b").n_params() == 3_606_514_000


def test_full_width_xlstm_draws_on_the_card():
    """xlstm at full width on the card draws on the card's generator (3.6 G
    parameters would take minutes on the host's); at smoke size, or on
    the CPU, on the CPU's."""
    cpu = torch.device("cpu")
    for smoke in (True, False):
        assert weight_generator(tbase.get("xlstm-1.3b", smoke=smoke), 0,
                                cpu, smoke).device.type == "cpu"
    assert weight_generator(tbase.get("xlstm-1.3b", smoke=True), 0,
                            torch.device("cuda"), True).device.type == "cpu"
    if torch.cuda.is_available():
        assert weight_generator(tbase.get("xlstm-1.3b"), 0,
                                torch.device("cuda"),
                                False).device.type == "cuda"


def test_one_seed_gives_one_set_of_weights():
    spec = T.param_spec(tbase.get("smollm-135m", smoke=True))
    a = P.materialize(torch.Generator().manual_seed(0), spec, "cpu")
    b = P.materialize(torch.Generator().manual_seed(0), spec, "cpu")
    for (path, x), (_, y) in zip(flatten_with_path(a), flatten_with_path(b)):
        assert torch.equal(x, y), keystr(path)


def test_serve_loop_draws_on_the_cpu_unless_full_width_moe_on_the_card():
    """The CPU's generator everywhere but a full-width model of a non-dense
    family on the card: MoE, and the frontend families (vlm, audio), whose
    19.9 G / 1.8 G parameters would take minutes on the host's."""
    cpu = torch.device("cpu")
    for arch in ("smollm-135m", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
                 "internvl2-26b", "musicgen-medium"):
        for smoke in (True, False):
            gen = weight_generator(tbase.get(arch, smoke=smoke), 0, cpu,
                                   smoke)
            assert gen.device.type == "cpu"
    # smollm on the card still draws on the CPU's generator, and so does
    # a smoke config
    gen = weight_generator(tbase.get("smollm-135m"), 0,
                           torch.device("cuda"), False)
    assert gen.device.type == "cpu"
    for arch in ("internvl2-26b", "musicgen-medium"):
        assert weight_generator(tbase.get(arch, smoke=True), 0,
                                torch.device("cuda"),
                                True).device.type == "cpu"
        if torch.cuda.is_available():
            assert weight_generator(tbase.get(arch), 0, torch.device("cuda"),
                                    False).device.type == "cuda"


def test_hybrid_spec_and_count_match_jax():
    """hymba's spec at the published widths, leaf by leaf (shape, axes,
    dtype, initializer), and its parameter count, 1,663,182,400, against
    the JAX package's; the SSM and fusion vectors are f32, ``a_log`` an
    ``embed`` draw at scale 0.5."""
    from repro.configs import base as jbase
    from repro.models import params as JP
    from repro.models import transformer as JT
    import jax

    jspec = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 JT.param_spec(jbase.get("hymba-1.5b")),
                 is_leaf=lambda x: isinstance(x, JP.ParamSpec))[0]}
    tcfg = tbase.get("hymba-1.5b")
    tspec = {keystr(p): s for p, s in
             flatten_with_path(T.param_spec(tcfg))}
    assert sorted(tspec) == sorted(jspec)
    for k, js in jspec.items():
        ts = tspec[k]
        assert (ts.shape, ts.axes, ts.init, ts.scale) == \
            (js.shape, js.axes, js.init, js.scale), k
        assert str(ts.dtype).split(".")[-1] == np.dtype(js.dtype).name, k
    f32 = sorted(k.rsplit("[", 1)[1] for k, s in tspec.items()
                 if s.dtype == torch.float32 and "['ssm']" in k)
    assert f32 == ["'a_log']", "'a_log']", "'d_skip']", "'d_skip']",
                   "'dt_bias']", "'dt_bias']"]
    assert tspec["['swa_blocks']['ssm']['a_log']"].init == "embed"
    assert tspec["['swa_blocks']['ssm']['a_log']"].scale == 0.5
    assert tspec["['global_blocks']['fusion']['ssm_gain']"].shape == (3, 1600)
    assert tcfg.n_params() == jbase.get("hymba-1.5b").n_params() \
        == 1_663_182_400


def test_full_width_hybrid_draws_on_the_card():
    """hymba at full width on the card draws on the card's generator (as
    a full-width MoE does); at smoke size, or on the CPU, on the CPU's."""
    cpu = torch.device("cpu")
    for smoke in (True, False):
        assert weight_generator(tbase.get("hymba-1.5b", smoke=smoke), 0,
                                cpu, smoke).device.type == "cpu"
    assert weight_generator(tbase.get("hymba-1.5b", smoke=True), 0,
                            torch.device("cuda"), True).device.type == "cpu"
    if torch.cuda.is_available():
        assert weight_generator(tbase.get("hymba-1.5b"), 0,
                                torch.device("cuda"),
                                False).device.type == "cuda"
