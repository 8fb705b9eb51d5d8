"""A step captured in a CUDA graph: the port's counterpart of a jitted step.

The JAX package compiles each step of its main paths with ``jax.jit``
(the paged engine's decode ``_step``, ``launch/train.py::jit_train_step``).
The port captures the same step's kernels once in a
``torch.cuda.CUDAGraph`` and replays them: one launch from the host a
step, where the eager step issues every op from Python. A replay runs the
kernels of the eager step in the same order, so the two give the same
bits.

What a capture asks of its caller:

* every tensor the step reads, or writes in place, keeps its address for
  the graph's life: the step's inputs are static buffers that the caller
  fills with ``copy_`` between replays. What the step returns lives in
  the graph's private memory pool and the next replay overwrites it;
* no host sync and no host branch on a device value inside the step;
* warm-up calls first, on a side stream: they build the kernels, create
  the libraries' handles and settle the allocator before the capture.

A capture that fails raises; nothing falls back to the eager step.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import _build

#: calls before a capture: the first builds kernels and library handles,
#: the second runs on a settled allocator
WARMUP_STEPS = 2


class CapturedStep:
    """``body()`` captured in a CUDA graph; :meth:`replay` runs it again.

    ``warmup`` (default ``body``) runs :data:`WARMUP_STEPS` times on a
    side stream before the capture: a body that updates state in place
    passes its functional form there, so that warming up advances
    nothing a caller reads (a serving engine's warm-up, with every row
    idle, writes only the scratch page and idle rows' state, which an
    admission overwrites whole; a step with no pool and no kernel, the
    xLSTM family's, writes idle rows' state alone). Launch counts of the
    warm-up are dropped and those of the capture come back once per
    replay (``_build.held_launches``). ``out`` is what ``body`` returned
    at capture.

    The capture runs in ``thread_local`` mode: the worker threads of an
    in-situ session may issue CUDA work on their own streams meanwhile,
    which the default mode would refuse.
    """

    def __init__(self, body: Callable[[], Any], *,
                 warmup: Optional[Callable[[], Any]] = None,
                 device: str | torch.device = "cuda") -> None:
        with torch.cuda.device(torch.device(device)):
            loop = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(loop)
            with _build.held_launches(), torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    (warmup or body)()
            loop.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with _build.held_launches() as self.launches:
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    self.out = body()

    def replay(self) -> Any:
        """Run the captured step on the current stream; returns ``out``."""
        _build.replay(self.graph, self.launches)
        return self.out
