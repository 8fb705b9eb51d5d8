"""The unified codec registry: one ``Codec`` protocol for the whole port.

Consumers (serving snapshots, later the checkpoint pipeline) look codecs up
by name::

    from repro_torch.core import compression
    codec = compression.get("zlib")          # lossless framing
    blob = codec.encode(arr); out = codec.decode(blob)

A ``Codec`` is any object with ``name``, ``lossy``, ``encode(ndarray) ->
bytes`` and ``decode(bytes) -> ndarray``; lossy codecs additionally expose
``error_bound() -> float`` (relative-L2). Provider modules register at
import time; ``get``/``available`` lazily import the built-in providers.
The port registers the lossless codecs (the stdlib framings and
``delta``), the lossy ``spectral``/``spectral-coarse`` (whose work runs
on the card) and the host-only ``int8-ef`` wire codec of the cross-pod
gradient path.
"""
from __future__ import annotations

import importlib
from typing import Optional, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Codec(Protocol):
    name: str
    lossy: bool

    def encode(self, arr: np.ndarray) -> bytes: ...

    def decode(self, blob: bytes) -> np.ndarray: ...


_REGISTRY: dict[str, Codec] = {}

# modules that register codecs at import time (kept lazy: importing the
# registry must not drag in kernels until a codec is actually needed)
_PROVIDERS = ("repro_torch.core.codecs", "repro_torch.core.delta",
              "repro_torch.core.lossy", "repro_torch.optim.grad_compress")
_providers_loaded = False


def register(codec: Codec, *, replace: bool = False) -> Codec:
    """Add a codec to the registry (provider modules call this on import)."""
    if not replace and codec.name in _REGISTRY:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def _ensure_providers() -> None:
    global _providers_loaded
    if _providers_loaded:
        return
    _providers_loaded = True
    for mod in _PROVIDERS:
        importlib.import_module(mod)


def get(name: str) -> Codec:
    _ensure_providers()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; available: {available()}") from None


def available(*, lossy: Optional[bool] = None) -> list[str]:
    """Registered codec names, optionally filtered by losslessness."""
    _ensure_providers()
    return sorted(n for n, c in _REGISTRY.items()
                  if lossy is None or c.lossy == lossy)
