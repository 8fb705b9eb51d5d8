"""``materialize``: stacked leaves one layer slice at a time (CPU).

A full-width MoE stacks its experts on a ``layers`` axis: moonshot's
``w_gate`` is (47, 64, 2048, 1408), 8.7 G values. ``materialize`` draws such
a leaf one layer slice at a time into its place, so no f32 temporary is
larger than one layer's slice. Every caller of the port draws the dense
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


@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b",
                                  "deepseek-v3-671b"])
def test_no_f32_temporary_exceeds_one_layer_slice(monkeypatch, arch):
    spec = T.param_spec(tbase.get(arch, smoke=True))
    seen = _recording(monkeypatch)
    P.materialize(torch.Generator().manual_seed(0), spec, "cpu")
    biggest_slice = max(
        int(np.prod(s.shape[1:] if s.axes[0] == "layers" else s.shape))
        for s in leaves(spec) if s.init == "normal")
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


def test_one_seed_gives_one_set_of_weights():
    spec = T.param_spec(tbase.get("smollm-135m", smoke=True))
    a = P.materialize(torch.Generator().manual_seed(0), spec, "cpu")
    b = P.materialize(torch.Generator().manual_seed(0), spec, "cpu")
    for (path, x), (_, y) in zip(flatten_with_path(a), flatten_with_path(b)):
        assert torch.equal(x, y), keystr(path)


def test_serve_loop_draws_on_the_cpu_unless_full_width_moe_on_the_card():
    cpu = torch.device("cpu")
    for arch in ("smollm-135m", "moonshot-v1-16b-a3b", "deepseek-v3-671b"):
        for smoke in (True, False):
            gen = weight_generator(tbase.get(arch, smoke=smoke), 0, cpu,
                                   smoke)
            assert gen.device.type == "cpu"
    # smollm on the card still draws on the CPU's generator
    gen = weight_generator(tbase.get("smollm-135m"), 0,
                           torch.device("cuda"), False)
    assert gen.device.type == "cpu"
