"""PyTorch/CUDA port of the in-situ reproduction (``repro``), for one
NVIDIA H100.

The package mirrors ``src/repro/`` module for module and imports neither
``jax`` nor anything of ``repro``. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; every TPU kernel on
a ported path is a hand-written Hopper kernel under ``kernels/``, and CPU
tensors take that kernel's plain PyTorch version.
"""
