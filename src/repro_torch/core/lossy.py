"""Spectral lossy codec API: error-bounded tensor and tree compression.

Wraps the kernels (:mod:`repro_torch.kernels.ops`) with:
  * the lossy -> lossless two-stage pipeline of the paper's hybrid mode
    (the device produces dense int8 q + per-block scales; the host
    lossless codec then removes the zero runs — NEKO's lossy-on-GPU +
    Bzip2-on-host split)
  * ``RPLY`` frames, byte-identical to the JAX package's, so a checkpoint
    written by either package restores in the other
  * error-bound accounting: relative-L2 <= eps (threshold) + sqrt(B)/254
    (int8 quantization)

A policy decides which leaves may be lossy: by default only optimizer
*moments* (noise-dominated statistics) are lossy; weights stay lossless.

Devices: :func:`compress_tensor` runs where its tensor lives (a host array
goes to the ``device`` the caller names); :func:`decompress_tensor`
dequantizes on the ``device`` the caller names. Both default to the card.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import codecs, host, pytree
from repro_torch.kernels import ops, ref

PyTree = Any

LOSSY_MAGIC = b"RPLY"

# the dtype name tokens the JAX package writes (``jnp.dtype(x).name``)
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float16: "float16", torch.float64: "float64"}
_BY_NAME = {v: k for k, v in _NAMES.items()}


@dataclass(frozen=True)
class LossyStats:
    raw_bytes: int
    stored_bytes: int
    kept_fraction: float
    rel_l2_error: Optional[float] = None   # only when measure=True

    @property
    def ratio(self) -> float:
        if self.raw_bytes == 0:
            return 0.0
        return (self.raw_bytes - self.stored_bytes) / self.raw_bytes


def error_bound(eps: float) -> float:
    return ref.error_bound(eps)


def _as_tensor(x, device: str | torch.device) -> torch.Tensor:
    """A tensor stays where it is; a host array (bf16 as the tagged uint16
    host dtype) goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return host.to_tensor(np.asarray(x), host.resolve_device(device))


# ---------------------------------------------------------------------------
# single tensor: device lossy stage -> host lossless stage -> framed bytes
# ---------------------------------------------------------------------------

def _lossy_header(dtype: torch.dtype, n_elements: int, shape: tuple,
                  qlen: int, slen: int) -> bytes:
    dt = _NAMES[dtype].encode()
    return LOSSY_MAGIC + struct.pack("<B", len(dt)) + dt + struct.pack(
        "<qB", n_elements, len(shape)) + struct.pack(
        f"<{len(shape)}q", *shape) + struct.pack("<qq", qlen, slen)


def _raw_bytes(dtype: torch.dtype, shape: tuple) -> int:
    return (int(np.prod(shape)) if shape else 1) * dtype.itemsize


def _host(t) -> np.ndarray:
    """A tensor's host array (bf16 tagged); a host array as it is."""
    return host.to_numpy(t.cpu()) if isinstance(t, torch.Tensor) else t


def frame_compressed(c: ref.Compressed, lossless: str = "zlib",
                     pool=None) -> tuple[bytes, LossyStats]:
    """Host lossless stage: pack a device-produced Compressed into bytes
    (``q``/``scale`` may be tensors or host arrays). ``pool`` fans the
    lossless chunks of a large coefficient buffer out across the shared
    codec executor."""
    q = np.asarray(_host(c.q))
    scale = np.asarray(_host(c.scale))
    q_blob, _ = codecs.encode(q, lossless, pool=pool)
    s_blob, _ = codecs.encode(scale, lossless, pool=pool)
    shape = tuple(int(d) for d in c.shape)
    header = _lossy_header(c.dtype, c.n_elements, shape,
                           len(q_blob), len(s_blob))
    blob = header + q_blob + s_blob
    return blob, LossyStats(_raw_bytes(c.dtype, shape), len(blob),
                            float(np.mean(q != 0)) if q.size else 0.0)


def _frame_chunked_q(chunks, lossless: str, pool=None
                     ) -> tuple[bytes, float]:
    """Streamed host lossless stage for chunked int8 coefficients: each
    chunk is losslessly compressed as soon as it is on the host. The frame
    is byte-identical to ``codecs.encode(cat(chunks))`` because the chunks
    are cut at the codec's own chunk boundary."""
    _, comp, _ = codecs.compressor(lossless)
    use_pool = pool is not None and len(chunks) > 1
    nonzero = total = 0
    pending = []
    for ch in chunks:
        a = np.ascontiguousarray(_host(ch))
        nonzero += int(np.count_nonzero(a))
        total += a.size
        view = codecs._byte_view(a)
        pending.append(pool.submit(comp, view) if use_pool else comp(view))
    payloads = [p.result() for p in pending] if use_pool else pending
    n_blocks = sum(int(ch.shape[0]) for ch in chunks)
    blob = codecs.assemble_frame(lossless, np.int8, (n_blocks, ref.BLOCK),
                                 n_blocks * ref.BLOCK, codecs.DEFAULT_CHUNK,
                                 payloads)
    return blob, nonzero / max(total, 1)


def compress_tensor(x, eps: float = 1e-2, lossless: str = "zlib",
                    measure: bool = False, pool=None,
                    stream: bool | None = None, *,
                    device: str | torch.device = "cuda"
                    ) -> tuple[bytes, LossyStats]:
    """Device lossy stage + host lossless stage for one tensor.

    A tensor is compressed where it lives; a host array is first moved to
    ``device``. ``stream`` (default: auto — multi-chunk payloads without
    ``measure``) frames the int8 coefficients chunk by chunk. Output bytes
    are identical either way.
    """
    x = _as_tensor(x, device)
    if stream is None:
        stream = not measure and x.numel() > codecs.DEFAULT_CHUNK
    if stream and not measure:
        chunks, scale, n = ops.spectral_compress_chunked(
            x, eps, chunk_blocks=codecs.DEFAULT_CHUNK // ref.BLOCK)
        q_blob, kept = _frame_chunked_q(chunks, lossless, pool)
        s_blob, _ = codecs.encode(_host(scale), lossless, pool=pool)
        shape = tuple(int(d) for d in x.shape)
        header = _lossy_header(x.dtype, n, shape, len(q_blob), len(s_blob))
        blob = header + q_blob + s_blob
        return blob, LossyStats(_raw_bytes(x.dtype, shape), len(blob),
                                float(kept))
    c = ops.spectral_compress(x, eps)                # device lossy stage
    blob, st = frame_compressed(c, lossless, pool)   # host lossless stage
    if measure:
        st = LossyStats(st.raw_bytes, st.stored_bytes, st.kept_fraction,
                        ref.rel_l2_error(x, ops.spectral_decompress(c)))
    return blob, st


def _parse_frame(blob: bytes, pool=None) -> ref.Compressed:
    """An ``RPLY`` frame's Compressed, with host (numpy) q and scale. The
    ``bfloat16`` dtype token needs no ``ml_dtypes``."""
    if bytes(blob[:4]) != LOSSY_MAGIC:
        raise ValueError("bad lossy frame magic")
    off = 4
    (dtlen,) = struct.unpack_from("<B", blob, off)
    off += 1
    name = bytes(blob[off:off + dtlen]).decode()
    if name not in _BY_NAME:
        raise ValueError(f"lossy frame: unsupported dtype {name!r}")
    off += dtlen
    n_elements, ndim = struct.unpack_from("<qB", blob, off)
    off += 9
    shape = struct.unpack_from(f"<{ndim}q", blob, off)
    off += 8 * ndim
    qlen, slen = struct.unpack_from("<qq", blob, off)
    off += 16
    q = codecs.decode(blob[off:off + qlen], pool=pool)
    scale = codecs.decode(blob[off + qlen:off + qlen + slen], pool=pool)
    return ref.Compressed(q, scale, n_elements, tuple(shape), _BY_NAME[name])


def decompress_tensor(blob: bytes, pool=None, *,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Decode an ``RPLY`` frame and dequantize on ``device`` (the
    dequantise + inverse DCT kernel on the card)."""
    c = _parse_frame(blob, pool)
    dev = host.resolve_device(device)
    c = c._replace(q=torch.from_numpy(np.ascontiguousarray(c.q)).to(dev),
                   scale=torch.from_numpy(np.ascontiguousarray(c.scale)
                                          ).to(dev))
    return ops.spectral_decompress(c)


# ---------------------------------------------------------------------------
# pytree policy + walking
# ---------------------------------------------------------------------------

def moments_only_policy(path: tuple, leaf) -> bool:
    """Default: lossy for optimizer moment statistics, lossless for weights."""
    keys = "/".join(str(k) for k in path)
    return any(tok in keys for tok in ("mu", "nu", "m1", "m2", "moment"))


def compress_tree(tree: PyTree, eps: float = 1e-2, lossless: str = "zlib",
                  policy: Callable[[tuple, Any], bool] = moments_only_policy,
                  *, device: str | torch.device = "cuda",
                  ) -> tuple[dict[str, bytes], dict[str, Any]]:
    """Returns ({path: framed blob}, {path: stats}). Lossless leaves use
    codecs; host-array leaves that are lossy go to ``device``."""
    blobs: dict[str, bytes] = {}
    stats: dict[str, Any] = {}
    for path, leaf in pytree.flatten_with_path(tree):
        key = pytree.keystr(path)
        if policy(path, leaf):
            blob, st = compress_tensor(leaf, eps, lossless, device=device)
        else:
            arr = _host(leaf) if isinstance(leaf, torch.Tensor) \
                else np.asarray(leaf)
            blob, st = codecs.encode(arr, lossless)
        blobs[key] = blob
        stats[key] = st
    return blobs, stats


def decompress_blob(blob: bytes, pool=None, *,
                    device: str | torch.device = "cuda"):
    """A lossy frame decodes to a tensor on ``device``; a lossless frame to
    a host array (bf16 as the tagged uint16 host dtype)."""
    if bytes(blob[:4]) == LOSSY_MAGIC:
        return decompress_tensor(blob, pool, device=device)
    return codecs.decode(blob, pool=pool)


class SpectralLossyCodec:
    """Registry adapter: the device lossy stage + host lossless stage as one
    ``repro_torch.core.compression`` Codec (numpy in, numpy out; the work
    runs on ``device``). Roundtrip error is relative-L2 bounded by
    ``error_bound()``."""

    lossy = True

    def __init__(self, name: str = "spectral", eps: float = 1e-2,
                 lossless: str = "zlib",
                 device: str | torch.device = "cuda") -> None:
        self.name = name
        self.eps = eps
        self.lossless = lossless
        self.device = device

    def encode(self, arr) -> bytes:
        return compress_tensor(arr, self.eps, self.lossless,
                               device=self.device)[0]

    def decode(self, blob: bytes) -> np.ndarray:
        return _host(decompress_tensor(blob, device=self.device))

    def error_bound(self) -> float:
        return error_bound(self.eps)


from repro_torch.core import compression as _compression  # noqa: E402

_compression.register(SpectralLossyCodec())
_compression.register(SpectralLossyCodec("spectral-coarse", eps=1e-1))


def restore_tree(template: PyTree, blobs: dict[str, bytes], *,
                 device: str | torch.device = "cuda") -> PyTree:
    """Rebuild a tree (same structure as template) from framed blobs, as
    tensors on ``device`` in the template leaves' dtypes and shapes."""
    dev = host.resolve_device(device)
    out = {}
    for path, leaf in pytree.flatten_with_path(template):
        key = pytree.keystr(path)
        arr = decompress_blob(blobs[key], device=dev)
        t = arr if isinstance(arr, torch.Tensor) else host.to_tensor(arr, dev)
        if isinstance(leaf, torch.Tensor):
            t = t.to(leaf.dtype).reshape(leaf.shape)
        out[key] = t
    return pytree.unflatten_like(template, out, "blobs")
