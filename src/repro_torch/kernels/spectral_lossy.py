"""The spectral lossy codec's kernels: hand-written Hopper kernels and their
plain versions.

Four of the JAX package's Pallas kernels (``src/repro/kernels/
spectral_lossy.py``) sit on the hybrid checkpoint path and are ported here,
with the JAX signatures (less ``interpret``, and less the quantiser's and
the inverse's ``tile``, which on the card is the kernel's own):

  dct_hist_coarse_tiled  y = x . D^T and a 32-bin coarse (count, energy)
                         row per 8-row tile                     (save)
  hist_refine_tiled      a 16-bin fine row per tile, inside each block's
                         coarse bin                             (save)
  threshold_quant        zero |y| < t, int8-quantize with a per-block scale
                                                                (save)
  dequant_idct           x = (q * scale) . D                    (restore)

* CUDA tensors launch ``csrc/spectral_lossy.cu`` (CUDA C++ for ``sm_90a``,
  built by ``_build`` on first use and bound with ``ctypes``). Its header
  says what bounds each kernel on the card and what the design does about
  it. The histogram tile is fixed at 8 rows on the card.
* CPU tensors take the ``*_plain`` version: the same arithmetic from
  :mod:`repro_torch.kernels.ref`, with per-tile sums taken in float64 and
  rounded once (so the plain version is the exact sum the kernel's
  fixed-order f32 sums approach).

The choice is the tensors' device and nothing else: a CUDA call launches
the kernel or raises, it never falls back to the plain version. Every
launch adds one to the wrapper's ``launches`` counter.

The Pallas kernels' other four (``dct_hist``, ``dct_hist_tiled``,
``dct_hist_coarse``, ``hist_refine``) are not ported yet (ROADMAP.md,
queue 2); :func:`not_ported` is what a CUDA caller that would need one
gets.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import BLOCK, NBINS_COARSE, NBINS_FINE

HIST_TILE = 8      # blocks per histogram row (fixed on the card)
_BIN_SCALE = float(np.float32(ref._BIN_SCALE))


def not_ported(what: str) -> NotImplementedError:
    """The error for a CUDA path that needs a kernel not ported yet."""
    return NotImplementedError(
        f"{what} on a CUDA tensor needs the single-tensor spectral kernels "
        f"(dct_hist_coarse / hist_refine), not ported yet (ROADMAP.md, "
        f"queue 2: 'Spectral kernels still to port')")


def _check_blocks(xb: torch.Tensor, tile: int, name: str) -> None:
    if xb.dim() != 2 or xb.shape[1] != BLOCK:
        raise ValueError(
            f"{name}: expected a (n_blocks, {BLOCK}) blocked buffer, got "
            f"shape {tuple(xb.shape)}")
    if xb.shape[0] % tile:
        raise ValueError(
            f"{name}: n_blocks={xb.shape[0]} must be a multiple of the "
            f"{tile}-block tile (pad first)")


def _per_block(v, n_blocks: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A scalar or (n_blocks,) per-block value as an (n_blocks,) tensor."""
    v = torch.as_tensor(v, dtype=dtype, device=device)
    if v.dim() == 0 or v.numel() == 1:
        v = v.reshape(()).expand(n_blocks)
    if tuple(v.shape) != (n_blocks,):
        raise ValueError(f"expected a scalar or ({n_blocks},) per-block "
                         f"value, got shape {tuple(v.shape)}")
    return v


def _tile_sums(a2: torch.Tensor, bins: torch.Tensor, nbins: int,
               tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (count, energy) rows over bins in [0, nbins); elements with
    bin -1 count nowhere. Energies are summed in float64 and rounded once
    to f32; one pass per bin keeps it free of scatter atomics."""
    n_tiles = a2.shape[0] // tile
    a2 = a2.reshape(n_tiles, -1)
    bins = bins.reshape(n_tiles, -1)
    cnt = torch.empty((n_tiles, nbins), dtype=torch.float32, device=a2.device)
    eng = torch.empty_like(cnt)
    for b in range(nbins):
        m = bins == b
        cnt[:, b] = m.sum(1, dtype=torch.float32)
        eng[:, b] = torch.where(m, a2, 0.0).sum(1, dtype=torch.float64
                                                 ).to(torch.float32)
    return cnt, eng


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def dct_hist_coarse_tiled_plain(xb: torch.Tensor, tile: int = HIST_TILE):
    y = ref.dct_blocks(xb)
    a = torch.abs(y)
    coarse = torch.div(ref.bin_index(a), NBINS_FINE, rounding_mode="floor")
    cnt, eng = _tile_sums(a * a, coarse, NBINS_COARSE, tile)
    return y, cnt, eng


def hist_refine_tiled_plain(y: torch.Tensor, coarse: torch.Tensor,
                            tile: int = HIST_TILE):
    a = torch.abs(y)
    idx = ref.bin_index(a)
    c = coarse.to(torch.int32)[:, None]
    member = torch.div(idx, NBINS_FINE, rounding_mode="floor") == c
    fine = torch.where(member, idx - c * NBINS_FINE, -1)
    return _tile_sums(a * a, fine, NBINS_FINE, tile)


def threshold_quant_plain(y: torch.Tensor, t: torch.Tensor):
    return ref.quantize_blocks(y, t)


def dequant_idct_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return ref.idct_blocks(ref.dequantize_blocks(q, scale))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("spectral_lossy")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "spectral_dct_hist_coarse_tiled": [p, p, p, p, p, i, f, p],
        "spectral_hist_refine_tiled": [p, p, p, p, i, f, p],
        "spectral_threshold_quant": [p, p, p, p, i, p],
        "spectral_dequant_idct": [p, p, p, p, i, p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _basis(device: torch.device, transpose: bool) -> torch.Tensor:
    d = torch.from_numpy(ref.dct_matrix(BLOCK))
    return (d.T if transpose else d).contiguous().to(device)


def _device_of(name: str, *ts: torch.Tensor) -> str:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def _need(name: str, t: torch.Tensor, what: str, dtype: torch.dtype,
          align: int = 16) -> None:
    """The kernel reads rows as 16-byte vectors and per-block values as
    scalars: check dtype, contiguity and alignment."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} dtype {t.dtype} (kernel takes "
                        f"{dtype})")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: {what} must be contiguous and "
                         f"{align}-byte aligned")


def _launch(name: str, fn, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def dct_hist_coarse_tiled(xb: torch.Tensor, *, tile: int | None = None):
    """xb: (n_blocks, 256) f32, n_blocks a multiple of the tile ->
    (y (n_blocks, 256), counts (n_tiles, 32), energies (n_tiles, 32)).

    Per-tile coarse histograms for the fused multi-leaf dispatch: the
    caller sums tile rows back to per-leaf histograms (leaves are padded
    to tile multiples, so no tile straddles two leaves)."""
    tile = tile or HIST_TILE
    name = "dct_hist_coarse_tiled"
    _check_blocks(xb, tile, name)
    if _device_of(name, xb) == "cpu":
        return dct_hist_coarse_tiled_plain(xb, tile)
    if tile != HIST_TILE:
        raise ValueError(f"{name}: the kernel's tile is {HIST_TILE} rows, "
                         f"got tile={tile}")
    _need(name, xb, "xb", torch.float32)
    nb = xb.shape[0]
    y = torch.empty_like(xb)
    cnt = torch.empty((nb // tile, NBINS_COARSE), dtype=torch.float32,
                      device=xb.device)
    eng = torch.empty_like(cnt)
    with torch.cuda.device(xb.device):
        _launch(name, _lib().spectral_dct_hist_coarse_tiled, xb.data_ptr(),
                _basis(xb.device, True).data_ptr(), y.data_ptr(),
                cnt.data_ptr(), eng.data_ptr(), nb, _BIN_SCALE)
    dct_hist_coarse_tiled.launches += 1
    return y, cnt, eng


def hist_refine_tiled(y: torch.Tensor, coarse, *, tile: int | None = None):
    """y: (n_blocks, 256), coarse: (n_blocks,) int32 per-block coarse bin
    (or a scalar) -> (counts (n_tiles, 16), energies (n_tiles, 16)).

    Every block of a leaf carries the leaf's selected coarse bin; tile
    rows sum back to per-leaf fine histograms."""
    tile = tile or HIST_TILE
    name = "hist_refine_tiled"
    _check_blocks(y, tile, name)
    coarse = _per_block(coarse, y.shape[0], torch.int32, y.device)
    if _device_of(name, y, coarse) == "cpu":
        return hist_refine_tiled_plain(y, coarse, tile)
    if tile != HIST_TILE:
        raise ValueError(f"{name}: the kernel's tile is {HIST_TILE} rows, "
                         f"got tile={tile}")
    coarse = coarse.contiguous()
    _need(name, y, "y", torch.float32)
    _need(name, coarse, "coarse", torch.int32, 4)
    nb = y.shape[0]
    cnt = torch.empty((nb // tile, NBINS_FINE), dtype=torch.float32,
                      device=y.device)
    eng = torch.empty_like(cnt)
    with torch.cuda.device(y.device):
        _launch(name, _lib().spectral_hist_refine_tiled, y.data_ptr(),
                coarse.data_ptr(), cnt.data_ptr(), eng.data_ptr(), nb,
                _BIN_SCALE)
    hist_refine_tiled.launches += 1
    return cnt, eng


def threshold_quant(y: torch.Tensor, t):
    """``t`` is a scalar threshold or a per-block (n_blocks,) vector (one
    invocation then quantizes a packed multi-leaf buffer, each leaf with
    its own threshold) -> (q (n_blocks, 256) int8, scale (n_blocks,) f32).

    Any block count works: each block quantizes on its own, so the JAX
    wrapper's zero pad to its tile and slice back change nothing; the
    card's kernel (one warp per block) masks the ragged edge instead."""
    name = "threshold_quant"
    if y.dim() != 2 or y.shape[1] != BLOCK:
        raise ValueError(f"{name}: expected (n_blocks, {BLOCK}) "
                         f"coefficients, got shape {tuple(y.shape)}")
    nb = y.shape[0]
    t = _per_block(t, nb, torch.float32, y.device)
    if _device_of(name, y, t) == "cpu":
        return threshold_quant_plain(y, t)
    t = t.contiguous()
    _need(name, y, "y", torch.float32)
    _need(name, t, "t", torch.float32, 4)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=y.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        _launch(name, _lib().spectral_threshold_quant, y.data_ptr(),
                t.data_ptr(), q.data_ptr(), scale.data_ptr(), nb)
    threshold_quant.launches += 1
    return q, scale


def dequant_idct(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (n_blocks, 256) int8, scale: (n_blocks,) f32 -> (n_blocks, 256)
    f32 = (q * scale) . D. Any block count (rows past it are masked)."""
    name = "dequant_idct"
    if q.dim() != 2 or q.shape[1] != BLOCK:
        raise ValueError(f"{name}: expected (n_blocks, {BLOCK}) int8 "
                         f"coefficients, got shape {tuple(q.shape)}")
    if tuple(scale.shape) != (q.shape[0],):
        raise ValueError(f"{name}: scale shape {tuple(scale.shape)} for "
                         f"{q.shape[0]} blocks")
    if _device_of(name, q, scale) == "cpu":
        return dequant_idct_plain(q, scale)
    _need(name, q, "q", torch.int8, 4)
    _need(name, scale, "scale", torch.float32, 4)
    nb = q.shape[0]
    x = torch.empty((nb, BLOCK), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(name, _lib().spectral_dequant_idct, q.data_ptr(),
                scale.data_ptr(), _basis(q.device, False).data_ptr(),
                x.data_ptr(), nb)
    dequant_idct.launches += 1
    return x


KERNELS = (dct_hist_coarse_tiled, hist_refine_tiled, threshold_quant,
           dequant_idct)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


reset_launches()
