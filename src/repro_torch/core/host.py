"""Host arrays for tensors, bf16 included, without ``ml_dtypes``.

NumPy has no bfloat16 of its own; the JAX package leans on ``ml_dtypes``
for it, which the port must not need. Here a bf16 host array is a
``uint16`` array whose dtype carries the metadata ``{"dtype":
"bfloat16"}`` (:data:`BF16`): the same bits, the same byte layout, and a
logical name the codecs write as the frame's dtype token — so frames stay
byte-identical to the ones the JAX package writes from ``ml_dtypes``
arrays. NumPy keeps dtype metadata through views, reshapes, copies and
``frombuffer``; arithmetic on such an array is meaningless and the port
does none.
"""
from __future__ import annotations

import numpy as np
import torch

#: bf16 on the host: uint16 bits tagged with their logical dtype name.
BF16 = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def logical_name(dtype: np.dtype) -> str | None:
    """``'bfloat16'`` for a tagged or ``ml_dtypes`` bf16 dtype, else None."""
    dt = np.dtype(dtype)
    meta = dt.metadata or {}
    if "dtype" in meta:
        return str(meta["dtype"])
    if dt.kind == "V" and dt.names is None and dt.name == "bfloat16":
        return "bfloat16"
    return None


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's host array (shares memory where torch allows it);
    bf16 comes back as :data:`BF16`."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        # int16 rather than uint16: every torch that has bf16 maps int16
        # to numpy, the reinterpretation is free either way
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def to_tensor(arr: np.ndarray, device: str | torch.device = "cpu"
              ) -> torch.Tensor:
    """Host array -> tensor on ``device``; tagged or ``ml_dtypes`` bf16
    arrays become ``torch.bfloat16`` through a uint16 bit view."""
    shape = np.shape(arr)              # ascontiguousarray makes 0-d 1-d
    arr = np.ascontiguousarray(arr)
    if logical_name(arr.dtype) == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).reshape(shape).to(device)
    return torch.from_numpy(arr.copy()).reshape(shape).to(device)


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. A CUDA device must exist: the
    port's entry points default to ``"cuda"`` and never fall back to the
    CPU — the CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev
