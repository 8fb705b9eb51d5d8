"""Parameter specs, seeded materialization, and the weight bridge.

Every model describes its parameters as a tree of ``ParamSpec`` (shape +
torch dtype + logical axis names + initializer), the same trees the JAX
package builds. From one spec tree:

  * ``materialize(generator, spec, device)`` -> real tensors from an
    explicit ``torch.Generator`` (the same initializer *families* as the JAX
    package; ``jax.random`` bits cannot be reproduced, so numbers differ),
    stacked leaves one layer slice at a time;
  * ``from_numpy_tree(tree, device)`` -> the port's tensors for a parameter
    tree the JAX package materialized, handed over as numpy arrays — same
    keys, shapes, dtypes and bits. This is how parity tests start both
    packages from identical weights;
  * ``abstract(spec)`` -> tensors on the ``meta`` device (shape and dtype,
    no storage), the counterpart of ``jax.ShapeDtypeStruct`` stand-ins;
  * ``logical_axes(spec)`` -> the tree of logical-axis tuples, which
    ``distributed/sharding.py`` maps onto a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import host
from repro_torch.core.pytree import leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names, len(axes) == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # overrides the default fan-in scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"ParamSpec rank mismatch: shape={self.shape} axes={self.axes}"
            )


def _fan_in(shape: tuple, axes: tuple) -> int:
    """Fan-in ignoring a leading stacked-layers dim."""
    dims = [s for s, a in zip(shape, axes) if a != "layers"]
    if len(dims) <= 1:
        return max(dims[0] if dims else 1, 1)
    # all but the last dim count as inputs for a dense kernel
    return max(int(np.prod(dims[:-1])), 1)


def _draw(gen: torch.Generator, spec: ParamSpec, shape: tuple
          ) -> torch.Tensor:
    """One f32 draw of ``shape`` for ``spec``'s initializer on the
    generator's device, cast to the spec's dtype."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 1.0
        x.normal_(generator=gen)
        return (x * scale).to(spec.dtype)
    # dense kernels: truncated-normal, 1/sqrt(fan_in)
    scale = spec.scale
    if scale is None:
        scale = 1.0 / math.sqrt(_fan_in(spec.shape, spec.axes))
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(spec.dtype)


def _init_leaf(gen: torch.Generator, spec: ParamSpec,
               device: torch.device) -> torch.Tensor:
    """The leaf on ``device``. A leaf stacked on leading ``layers`` axes
    (one, or two for the xLSTM family's mLSTM stack) is drawn one layer
    slice at a time into its place, so no f32 temporary is larger than one
    layer's slice (full-width MoE expert stacks hold tens of GB). The
    slices are drawn in row-major order from the one generator, so one
    seed gives one leaf; their bits differ from those of one draw of the
    whole leaf."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    lead = 0
    while lead < len(spec.shape) - 1 and spec.axes[lead] == "layers":
        lead += 1
    if lead == 0:
        return _draw(gen, spec, spec.shape).to(device)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    flat = out.view(-1, *spec.shape[lead:])
    for i in range(flat.shape[0]):
        flat[i].copy_(_draw(gen, spec, spec.shape[lead:]))
    return out


def materialize(generator: torch.Generator, spec_tree: PyTree,
                device: str | torch.device = "cuda") -> PyTree:
    """Initialize real parameters from a spec tree.

    Leaves are drawn on the generator's device in a fixed (tree) order, so
    one seed on one generator device gives one set of weights wherever
    they are placed, and written to ``device``. A CUDA generator draws a
    full-width MoE model in seconds where the CPU's takes minutes; the two
    give different numbers from the same seed.
    """
    dev = host.resolve_device(device)
    return tree_map(lambda s: _init_leaf(generator, s, dev), spec_tree)


def weight_generator(cfg, seed: int, device: torch.device,
                     smoke: bool) -> torch.Generator:
    """The generator ``serve_loop`` and ``train_loop`` draw their random
    weights from: the card's for a full-width model of any family but
    dense (MoE, hybrid, ssm, audio, vlm) on the card (GBs, drawn in
    seconds there and in minutes on the host), the CPU's for every other
    config (whose bits the port's other callers draw the same way)."""
    on_card = (cfg.family != "dense" and not smoke
               and device.type == "cuda")
    return torch.Generator(device if on_card else "cpu").manual_seed(seed)


def from_numpy_tree(tree: PyTree, device: str | torch.device = "cuda"
                    ) -> PyTree:
    """A JAX-package parameter tree (numpy leaves, e.g. after
    ``jax.device_get``) as the port's tensors on ``device`` (the card
    unless the caller asks for the CPU): same keys, shapes, dtypes and
    bits. ``ml_dtypes`` bf16 leaves cross through a uint16 bit view, so the
    port never imports ``ml_dtypes``."""
    dev = host.resolve_device(device)
    return tree_map(lambda a: host.to_tensor(np.asarray(a), dev), tree)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def abstract(spec_tree: PyTree) -> PyTree:
    """Meta-device stand-ins (shape + dtype, allocates nothing)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def logical_axes(spec_tree: PyTree) -> PyTree:
    """The logical-axis tuple of each leaf, in the spec tree's structure
    (walk it beside a tensor tree: its tuples are leaves there)."""
    return tree_map(lambda s: s.axes, spec_tree)


def param_count(spec_tree: PyTree) -> int:
    return sum(int(np.prod(s.shape)) for s in leaves(spec_tree))


def param_bytes(spec_tree: PyTree) -> int:
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in leaves(spec_tree))


def cast_tree(tree: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)
