"""The spectral lossy codec's kernels: hand-written Hopper kernels and their
plain versions.

The JAX package's eight Pallas kernels of the codec (``src/repro/kernels/
spectral_lossy.py``) are ported here, with the JAX signatures (less
``interpret``, and less the quantiser's and the inverse's ``tile``, which
on the card is the kernel's own):

  dct_hist_coarse_tiled  y = x . D^T and a 32-bin coarse (count, energy)
                         row per 8-row tile          (hybrid save, fused)
  hist_refine_tiled      a 16-bin fine row per tile, inside each block's
                         coarse bin                  (hybrid save, fused)
  dct_hist_coarse        y = x . D^T and ONE 32-bin coarse histogram of
                         the whole tensor            (single-tensor save)
  hist_refine            ONE 16-bin fine histogram inside each block's
                         coarse bin                  (single-tensor save)
  dct_hist_tiled         y = x . D^T and a flat 512-bin (count, energy)
                         row per 8-row tile          (kernel roofline)
  dct_hist               y = x . D^T and ONE flat 512-bin histogram
                                                     (kernel roofline)
  threshold_quant        zero |y| < t, int8-quantize with a per-block scale
                                                     (every save)
  dequant_idct           x = (q * scale) . D         (restore)

* CUDA tensors launch ``csrc/spectral_lossy.cu`` (CUDA C++ for ``sm_90a``,
  built by ``_build`` on first use and bound with ``ctypes``). Its header
  says what bounds each kernel on the card and what the design does about
  it. The histogram tile is fixed at 8 rows on the card.
* CPU tensors take the ``*_plain`` version: the same arithmetic from
  :mod:`repro_torch.kernels.ref`, with per-tile sums taken in float64 and
  rounded once, and the single-tensor histograms the tile rows summed in
  float64 and rounded once (so the plain version is the exact sum the
  kernel's fixed-order sums approach).

The choice is the tensors' device and nothing else: a CUDA call launches
the kernel or raises, it never falls back to the plain version. Every
launch adds one to the wrapper's ``launches`` counter (thread-safe: the
checkpoint's workers launch concurrently).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import BLOCK, NBINS, NBINS_COARSE, NBINS_FINE

HIST_TILE = 8      # blocks per histogram row (fixed on the card)
_BIN_SCALE = float(np.float32(ref._BIN_SCALE))


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
    to f32. On the CPU that is one sequential ``bincount``; on the card,
    where ``bincount`` and ``index_add_`` add with atomics, one pass per
    bin."""
    n_tiles = a2.shape[0] // tile
    if a2.device.type == "cpu":
        key = bins.reshape(n_tiles, tile * BLOCK).long()
        key = key + torch.arange(n_tiles)[:, None] * nbins
        keep = bins.reshape(key.shape) >= 0
        size = n_tiles * nbins
        cnt = torch.bincount(key[keep], minlength=size)
        eng = torch.bincount(key[keep], weights=a2.reshape(key.shape)[keep]
                             .double(), minlength=size)
        return (cnt.to(torch.float32).reshape(n_tiles, nbins),
                eng.to(torch.float32).reshape(n_tiles, nbins))
    a2 = a2.reshape(n_tiles, tile * BLOCK)
    bins = bins.reshape(n_tiles, tile * BLOCK)
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


def dct_hist_tiled_plain(xb: torch.Tensor, tile: int = HIST_TILE):
    y = ref.dct_blocks(xb)
    a = torch.abs(y)
    cnt, eng = _tile_sums(a * a, ref.bin_index(a), NBINS, tile)
    return y, cnt, eng


def _sum_rows(cnt: torch.Tensor, eng: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile rows summed into one histogram, in float64, rounded once."""
    return (cnt.sum(0, dtype=torch.float64).to(torch.float32),
            eng.sum(0, dtype=torch.float64).to(torch.float32))


def dct_hist_coarse_plain(xb: torch.Tensor, tile: int = HIST_TILE):
    y, cnt, eng = dct_hist_coarse_tiled_plain(xb, tile)
    return (y, *_sum_rows(cnt, eng))


def hist_refine_plain(y: torch.Tensor, coarse: torch.Tensor,
                      tile: int = HIST_TILE):
    return _sum_rows(*hist_refine_tiled_plain(y, coarse, tile))


def dct_hist_plain(xb: torch.Tensor, tile: int = HIST_TILE):
    y, cnt, eng = dct_hist_tiled_plain(xb, tile)
    return (y, *_sum_rows(cnt, eng))


def threshold_quant_plain(y: torch.Tensor, t: torch.Tensor):
    return ref.quantize_blocks(y, t)


def dequant_idct_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return ref.idct_blocks(ref.dequantize_blocks(q, scale))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {name: (args, ctypes.c_int) for name, args in {
    "spectral_dct_hist_coarse_tiled": [_P, _P, _P, _P, _P, _I, _F, _P],
    "spectral_hist_refine_tiled": [_P, _P, _P, _P, _I, _F, _P],
    "spectral_dct_hist_coarse": [_P] * 6 + [_I, _F, _P],
    "spectral_hist_refine": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _F, _P],
    "spectral_refine_table": [_P, _F, _P],
    "spectral_refine_table_check": [_P, _P, _F, _P],
    "spectral_dct_hist_tiled": [_P, _P, _P, _P, _P, _I, _F, _P],
    "spectral_dct_hist": [_P] * 6 + [_I, _F, _P],
    "spectral_threshold_quant": [_P, _P, _P, _P, _I, _P],
    "spectral_dequant_idct": [_P, _P, _P, _P, _I, _P],
}.items()}
_SIGNATURES.update({name: ([], ctypes.c_size_t) for name in (
    "spectral_dct_hist_parts_bytes", "spectral_dct_hist_coarse_parts_bytes",
    "spectral_hist_refine_parts_bytes")})


def _lib() -> ctypes.CDLL:
    return _build.load("spectral_lossy", _SIGNATURES)


_BASES: dict[tuple[torch.device, bool], torch.Tensor] = {}


def _basis(device: torch.device, transpose: bool) -> torch.Tensor:
    """D (or D^T) on ``device``, made once per process. Its copy is waited
    for before any stream may read it: kernels on every worker's stream
    share it."""
    with _build.lock:
        b = _BASES.get((device, transpose))
        if b is None:
            d = torch.from_numpy(ref.dct_matrix(BLOCK))
            b = (d.T if transpose else d).contiguous().to(device)
            torch.cuda.current_stream(device).synchronize()
            _BASES[(device, transpose)] = b
        return b


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


def _kernel_tile(name: str, tile: int) -> None:
    if tile != HIST_TILE:
        raise ValueError(f"{name}: the kernel's tile is {HIST_TILE} rows, "
                         f"got tile={tile}")


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
    _kernel_tile(name, tile)
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
    _build.count_launch(dct_hist_coarse_tiled)
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
    _kernel_tile(name, tile)
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
    _build.count_launch(hist_refine_tiled)
    return cnt, eng


def dct_hist_coarse(xb: torch.Tensor, *, tile: int | None = None):
    """xb: (n_blocks, 256) f32, n_blocks a multiple of the tile ->
    (y (n_blocks, 256), counts (32,), energies (32,)).

    First pass of the single-tensor two-level selector: the DCT and ONE
    coarse (count, energy) histogram over the whole tensor. On the card it
    allocates y, the kernel's partial rows (one per persistent CTA's range,
    at most 264 of 32 bins) and the output, and no per-tile rows."""
    tile = tile or HIST_TILE
    name = "dct_hist_coarse"
    _check_blocks(xb, tile, name)
    if _device_of(name, xb) == "cpu":
        return dct_hist_coarse_plain(xb, tile)
    _kernel_tile(name, tile)
    _need(name, xb, "xb", torch.float32)
    nb = xb.shape[0]
    with torch.cuda.device(xb.device):
        lib = _lib()
        y = torch.empty_like(xb)
        parts = torch.empty(lib.spectral_dct_hist_coarse_parts_bytes() // 8,
                            dtype=torch.int64, device=xb.device)
        out = torch.empty((2, NBINS_COARSE), dtype=torch.float32,
                          device=xb.device)
        _launch(name, lib.spectral_dct_hist_coarse, xb.data_ptr(),
                _basis(xb.device, True).data_ptr(), y.data_ptr(),
                parts.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), nb,
                _BIN_SCALE)
    _build.count_launch(dct_hist_coarse)
    return y, out[0], out[1]


def _coarse_arg(name: str, coarse, nb: int, device: torch.device):
    """The kernel's view of a coarse bin for ``nb`` blocks on ``device``:
    (tensor to keep alive until the launch, pointer or None, element
    bytes, stride 0 or 1, value). A Python int or a value on the host is
    passed by value; a 0-d or one-element CUDA tensor by pointer with
    stride 0 (no copy, no read on the host); a per-block (nb,) int32 or
    int64 tensor by pointer with stride 1 (a copy on the card of one
    given on the host or in another dtype)."""
    if not isinstance(coarse, torch.Tensor):
        coarse = torch.as_tensor(coarse)
    if coarse.numel() != 1 and tuple(coarse.shape) != (nb,):
        raise ValueError(f"expected a scalar or ({nb},) per-block value, "
                         f"got shape {tuple(coarse.shape)}")
    if coarse.device.type == "cpu":
        if coarse.numel() == 1:
            return None, None, 0, 0, int(coarse.to(torch.int32))
        coarse = coarse.to(device)
    elif coarse.device != device:
        raise ValueError(f"{name}: coarse on {coarse.device}, y on {device}")
    if coarse.dtype not in (torch.int32, torch.int64):
        coarse = coarse.to(torch.int32)
    elem = coarse.element_size()
    if coarse.numel() == 1:
        return coarse, coarse.data_ptr(), elem, 0, 0
    _need(name, coarse, "coarse", coarse.dtype, elem)
    return coarse, coarse.data_ptr(), elem, 1, 0


_TABLES: dict[torch.device, torch.Tensor] = {}


def _refine_table(device: torch.device) -> torch.Tensor:
    """The refine kernel's membership table on ``device`` (per coarse bin,
    the least interval of |y| bit patterns holding all its members), made
    once per process on the card by a scan of every non-negative f32
    pattern with the kernel's own ``bin_index``, under the build lock. Its
    scan is waited for before any stream may read it."""
    table = _TABLES.get(device)
    if table is None:
        with _build.lock:
            table = _TABLES.get(device)
            if table is None:
                table = torch.empty(2 * NBINS_COARSE, dtype=torch.int32,
                                    device=device)
                _launch("hist_refine", _lib().spectral_refine_table,
                        table.data_ptr(), _BIN_SCALE)
                torch.cuda.current_stream(device).synchronize()
                _TABLES[device] = table
    return table


@functools.cache
def _refine_floats() -> int:
    """f32 words of ``hist_refine``'s one allocation: the 2 x 16 output,
    then the kernel's partial rows."""
    return 2 * NBINS_FINE + _lib().spectral_hist_refine_parts_bytes() // 4


def refine_table_errors(device) -> int:
    """How many of the 2^31 non-negative f32 bit patterns the refine
    kernel's membership table on ``device`` decides differently from the
    kernel's ``bin_index`` (0 for a right table; a check, not a launch of
    ``hist_refine``)."""
    device = torch.device(device)
    with torch.cuda.device(device):
        bad = torch.zeros(1, dtype=torch.int64, device=device)
        _launch("refine_table_errors", _lib().spectral_refine_table_check,
                _refine_table(device).data_ptr(), bad.data_ptr(), _BIN_SCALE)
        return int(bad.item())


def hist_refine(y: torch.Tensor, coarse, *, tile: int | None = None):
    """y: (n_blocks, 256), coarse: a scalar or per-block (n_blocks,) int32
    coarse bin -> (counts (16,), energies (16,)).

    Second pass of the single-tensor selector: ONE fine histogram of the
    16 fine bins inside each block's coarse bin; elements outside it add
    exactly 0. On the card a Python int, a 0-d or a one-element tensor is
    passed as it is (no per-block copy), and one allocation holds the
    output and the kernel's partial rows (one per range, at most 264 of 16
    bins); nothing on the card is read on the host."""
    tile = tile or HIST_TILE
    name = "hist_refine"
    _check_blocks(y, tile, name)
    nb = y.shape[0]
    if _device_of(name, y) == "cpu":
        return hist_refine_plain(
            y, _per_block(coarse, nb, torch.int32, y.device), tile)
    _kernel_tile(name, tile)
    _need(name, y, "y", torch.float32)
    # ``keep`` holds a copy the kernel reads until after the launch, so
    # that the allocation below cannot take its memory
    keep, ptr, elem, stride, value = _coarse_arg(name, coarse, nb, y.device)
    dev = y.device
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        lib = _lib()
        table = _refine_table(dev)
        n = _refine_floats()
        out = torch.empty(n, dtype=torch.float32, device=dev)
        base = out.data_ptr()
        _launch(name, lib.spectral_hist_refine, y.data_ptr(), ptr, elem,
                stride, value, table.data_ptr(), base + 2 * NBINS_FINE * 4,
                base, nb, _BIN_SCALE)
        del keep
    _build.count_launch(hist_refine)
    cnt, eng, _ = out.split((NBINS_FINE, NBINS_FINE, n - 2 * NBINS_FINE))
    return cnt, eng


def dct_hist_tiled(xb: torch.Tensor, *, tile: int | None = None):
    """xb: (n_blocks, 256) f32, n_blocks a multiple of the tile ->
    (y (n_blocks, 256), counts (n_tiles, 512), energies (n_tiles, 512)).

    The flat 512-bin pass, one row per tile."""
    tile = tile or HIST_TILE
    name = "dct_hist_tiled"
    _check_blocks(xb, tile, name)
    if _device_of(name, xb) == "cpu":
        return dct_hist_tiled_plain(xb, tile)
    _kernel_tile(name, tile)
    _need(name, xb, "xb", torch.float32)
    nb = xb.shape[0]
    y = torch.empty_like(xb)
    cnt = torch.empty((nb // tile, NBINS), dtype=torch.float32,
                      device=xb.device)
    eng = torch.empty_like(cnt)
    with torch.cuda.device(xb.device):
        _launch(name, _lib().spectral_dct_hist_tiled, xb.data_ptr(),
                _basis(xb.device, True).data_ptr(), y.data_ptr(),
                cnt.data_ptr(), eng.data_ptr(), nb, _BIN_SCALE)
    _build.count_launch(dct_hist_tiled)
    return y, cnt, eng


def dct_hist(xb: torch.Tensor, *, tile: int | None = None):
    """xb: (n_blocks, 256) f32, n_blocks a multiple of the tile ->
    (y (n_blocks, 256), counts (512,), energies (512,)).

    The flat 512-bin pass with ONE histogram of the whole tensor: the
    baseline the two-level pair (``dct_hist_coarse`` + ``hist_refine``)
    replaced. On the card it allocates y, the kernel's partial rows (one
    per persistent CTA's range, at most 264 of 512 bins) and the output,
    and no per-tile rows."""
    tile = tile or HIST_TILE
    name = "dct_hist"
    _check_blocks(xb, tile, name)
    if _device_of(name, xb) == "cpu":
        return dct_hist_plain(xb, tile)
    _kernel_tile(name, tile)
    _need(name, xb, "xb", torch.float32)
    nb = xb.shape[0]
    with torch.cuda.device(xb.device):
        lib = _lib()
        y = torch.empty_like(xb)
        parts = torch.empty(lib.spectral_dct_hist_parts_bytes() // 8,
                            dtype=torch.int64, device=xb.device)
        out = torch.empty((2, NBINS), dtype=torch.float32, device=xb.device)
        _launch(name, lib.spectral_dct_hist, xb.data_ptr(),
                _basis(xb.device, True).data_ptr(), y.data_ptr(),
                parts.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), nb,
                _BIN_SCALE)
    _build.count_launch(dct_hist)
    return y, out[0], out[1]


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
    _build.count_launch(threshold_quant)
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
    _need(name, q, "q", torch.int8)
    _need(name, scale, "scale", torch.float32, 4)
    nb = q.shape[0]
    x = torch.empty((nb, BLOCK), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(name, _lib().spectral_dequant_idct, q.data_ptr(),
                scale.data_ptr(), _basis(q.device, False).data_ptr(),
                x.data_ptr(), nb)
    _build.count_launch(dequant_idct)
    return x


KERNELS = (dct_hist_coarse_tiled, hist_refine_tiled, dct_hist_coarse,
           hist_refine, threshold_quant, dequant_idct, dct_hist_tiled,
           dct_hist)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


reset_launches()
