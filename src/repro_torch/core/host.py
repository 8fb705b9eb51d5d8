"""Host arrays for tensors, bf16 included, without ``ml_dtypes``; and the
copies between them and the card that worker threads make.

NumPy has no bfloat16 of its own; the JAX package leans on ``ml_dtypes``
for it, which the port must not need. Here a bf16 host array is a
``uint16`` array whose dtype carries the metadata ``{"dtype":
"bfloat16"}`` (:data:`BF16`): the same bits, the same byte layout, and a
logical name the codecs write as the frame's dtype token — so frames stay
byte-identical to the ones the JAX package writes from ``ml_dtypes``
arrays. NumPy keeps dtype metadata through views, reshapes, copies and
``frombuffer``; arithmetic on such an array is meaningless and the port
does none.

Device work that a worker thread starts (the checkpoint's per-leaf lossy
stage and its restore) runs on a side stream of that thread's own
(:func:`worker_stream`): on the legacy default stream, which the training
loop uses, a worker's copies and kernels would queue behind the loop's
step and the loop's next step behind them. Host arrays go to the card
through pinned memory (:func:`to_device`) and come back the same way
(:class:`HostCopy`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

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


def to_device(arr: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """A host array on ``device`` (bf16 through its bit pattern). To a
    card it goes through pinned memory, as a non-blocking copy on the
    current stream."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return to_tensor(arr, dev)
    shape = np.shape(arr)
    arr = np.ascontiguousarray(arr)
    bf16 = logical_name(arr.dtype) == "bfloat16"
    src = arr.view(np.int16) if bf16 else arr
    dtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
    pinned = torch.empty(src.shape, dtype=dtype, pin_memory=True)
    np.copyto(pinned.numpy(), src)
    out = pinned.to(dev, non_blocking=True).reshape(shape)
    return out.view(torch.bfloat16) if bf16 else out


class HostCopy:
    """A CUDA tensor's copy into pinned host memory, started on the current
    stream; :meth:`result` waits for this copy alone."""

    __slots__ = ("host", "done")

    def __init__(self, t: torch.Tensor) -> None:
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    @property
    def shape(self) -> torch.Size:
        return self.host.shape

    def result(self) -> np.ndarray:
        self.done.synchronize()
        return to_numpy(self.host)


_local = threading.local()


@contextlib.contextmanager
def worker_stream(device: str | torch.device, *inputs: torch.Tensor
                  ) -> Iterator[Optional[torch.cuda.Stream]]:
    """Run a block's device work on this thread's own side stream of
    ``device`` (made on the thread's first use and kept), and wait for it
    when the block ends, so the host may read what the block made.

    ``inputs`` are tensors the block reads that another stream produced:
    as ``runtime._start_d2h`` does, the side stream first waits for their
    producer (the thread's current stream) and each is marked as used on
    the side stream (``record_stream``). Host arrays need neither, so a
    block that only reads host arrays never waits for the loop's queued
    work. On the CPU it does nothing."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield None
        return
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    streams = _local.__dict__.setdefault("streams", {})
    side = streams.get(idx)
    if side is None:
        side = streams[idx] = torch.cuda.Stream(device=idx)
    for t in inputs:
        if t.device.type == "cuda":
            side.wait_stream(torch.cuda.current_stream(t.device))
            t.record_stream(side)
    with torch.cuda.stream(side):
        yield side
    side.synchronize()
