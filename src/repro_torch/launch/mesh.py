"""Production mesh builders, as ``DeviceMesh``es over the default group.

Functions, not module constants: importing this module touches no process
group (the dry run starts its own, on the ``fake`` backend, before it
builds a mesh; tests and tools keep whatever group they made).

Mesh topology (one process a mesh device):
  single-pod : (16, 16)    axes ('data', 'model')        — 256 devices
  multi-pod  : (2, 16, 16) axes ('pod', 'data', 'model') — 512 devices

'pod' is the slow inter-pod axis: the sharding rules keep parameters off
it (pure DP), and the optional int8 gradient ring (optim/grad_compress)
shrinks its wire bytes. 'data' carries FSDP + batch, 'model' TP/EP.
"""
from __future__ import annotations

import math


def device_type() -> str:
    """The meshes' device type: ``cuda`` where a card is visible, else
    ``cpu``."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the first
    ``prod(shape)`` ranks of the default group, in rank order."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device_type(), ranks, mesh_dim_names=tuple(axes))


def production_geometry(multi_pod: bool = False):
    """``(shape, axes)`` of the production mesh (module docstring)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ('data', 'model') mesh, or (2, 16, 16) ('pod', 'data',
    'model') with ``multi_pod``, over every rank of the default process
    group, which must have 256 (512) of them."""
    import torch.distributed as dist

    shape, axes = production_geometry(multi_pod)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a default group of {math.prod(shape)} "
                         f"ranks, not {world}")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A small ('data', 'model') mesh over the first ranks of the default
    group, clamped to its world size — tests and examples."""
    import torch.distributed as dist

    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return make_mesh((data, model), ("data", "model"))
