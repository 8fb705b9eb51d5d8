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
  the libraries' handles and settle the allocator before the capture;
  what they leave cached is handed back before the capture starts.

A capture that fails raises; nothing falls back to the eager step. The
graph is kept past its capture (``keep_graph=True``) long enough to count
its nodes (:func:`graph_nodes`), then instantiated; a graph that does not
instantiate raises with its node count.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import _build

#: calls before a capture: the first builds kernels and library handles,
#: the second runs on a settled allocator
WARMUP_STEPS = 2


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """The node count of a captured graph that kept its ``cudaGraph_t``
    (``keep_graph=True``), from the driver (``cuGraphGetNodes``)."""
    import ctypes

    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUDA error {err}")
    return n.value


class CapturedStep:
    """``body()`` captured in a CUDA graph; :meth:`replay` runs it again.

    ``warmup`` (default ``body``) runs :data:`WARMUP_STEPS` times on a
    side stream before the capture: a body that updates state in place
    passes a form that writes nothing there, so that warming up advances
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
            # held on the stream too: a backward's launches come from
            # autograd's own thread
            with _build.held_launches(side), torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    (warmup or body)()
            loop.wait_stream(side)
            # the capture allocates from the graph's private pool, and the
            # allocator frees no cached block while a capture is under way:
            # hand the warm-up's cached blocks back first (a full-width
            # train step's warm-up caches tens of GB)
            torch.cuda.empty_cache()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            capture = torch.cuda.Stream()
            with _build.held_launches(capture) as self.launches:
                with torch.cuda.graph(self.graph, stream=capture,
                                      capture_error_mode="thread_local"):
                    self.out = body()
            self.nodes = graph_nodes(self.graph)
            try:
                self.graph.instantiate()
            except RuntimeError as e:
                raise RuntimeError(f"the captured graph of {self.nodes} "
                                   f"nodes did not instantiate: {e}") from e

    def replay(self) -> Any:
        """Run the captured step on the current stream; returns ``out``."""
        _build.replay(self.graph, self.launches)
        return self.out
