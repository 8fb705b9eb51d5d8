"""Plain-PyTorch oracle of the spectral lossy codec.

Pipeline (the NEKO-style physics-based lossy compression of the paper's
hybrid mode, recast for an accelerator):

  1. blockize: flatten + zero-pad the tensor to (n_blocks, B), B=256
  2. transform: orthonormal DCT-II per block, as a matrix product
  3. select:   keep only the most *energetic* coefficients, subject to a
               relative-L2 error budget eps — discarded energy <= eps^2 * total
  4. quantize: survivors -> int8 with a per-block scale

Selection is by *histogram threshold*, not by sort: one pass builds an
absolute log2-magnitude histogram of (count, energy) per bin; the threshold
is the largest bin edge whose below-edge cumulative energy fits the budget.
The two-level variant (a coarse 32-bin pass, then 16 fine bins inside the
one coarse bin that straddles the budget) lands on the same edge grid.

This module is the straight-line oracle — no tiling — with the same
numbers as the JAX package's ``kernels/ref.py``: the same float32 DCT
matrix, the same f32 bin formula, the same bin-edge table, the same eps>=1
drop-all clamp. The kernels' plain versions and the CPU path of
:mod:`repro_torch.kernels.ops` are built from it.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

BLOCK = 256            # spectral block size
NBINS = 512            # log2-magnitude histogram bins
NBINS_COARSE = 32      # two-level selection: coarse bins (groups of fine bins)
NBINS_FINE = 16        # fine bins per coarse bin; NBINS == COARSE * FINE
LOG2_LO = -40.0        # histogram range: 2^-40 .. 2^40 (abs magnitudes)
LOG2_HI = 40.0
_BIN_SCALE = NBINS / (LOG2_HI - LOG2_LO)   # 6.4, applied as an f32 scalar
# The JAX package always runs the codec compiled, and XLA rewrites the
# quantizer's ``amax / 127.0`` as ``amax * f32(1/127)``; the port writes
# that product so that scales (and frames) are bit-identical to its.
INV127 = float(np.float32(1.0) / np.float32(127.0))


class Compressed(NamedTuple):
    """Device-side lossy representation (dense; host lossless packs it)."""
    q: torch.Tensor       # (n_blocks, BLOCK) int8 quantized coefficients
    scale: torch.Tensor   # (n_blocks,) f32 per-block dequant scale
    n_elements: int       # original element count (for unpad)
    shape: tuple          # original shape
    dtype: torch.dtype    # original dtype


# ---------------------------------------------------------------------------
# DCT basis
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def dct_matrix(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II matrix D: y = D @ x, x = D.T @ y."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    return d.astype(np.float32)


def dct_tensor(device: torch.device | str, n: int = BLOCK) -> torch.Tensor:
    """:func:`dct_matrix` as an f32 tensor on ``device``."""
    return torch.from_numpy(dct_matrix(n)).to(device)


def blockize(x: torch.Tensor, block: int = BLOCK) -> tuple[torch.Tensor, int]:
    """Flatten + zero-pad to (n_blocks, block); returns (blocks, n_elements)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block), n


def unblockize(blocks: torch.Tensor, n: int, shape: tuple,
               dtype: torch.dtype) -> torch.Tensor:
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


_MIN_ROWS = 16


def _rows_times(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``a @ m`` with each row's result independent of how many rows come
    with it: PyTorch's CPU product sums along another path for fewer than
    16 rows, so shorter inputs are zero-padded to 16 rows and sliced back
    (a leaf's coefficients must not depend on what shares its buffer)."""
    n = a.shape[0]
    if 0 < n < _MIN_ROWS:
        a = torch.nn.functional.pad(a, (0, 0, 0, _MIN_ROWS - n))
        return (a @ m)[:n]
    return a @ m


def dct_blocks(xb: torch.Tensor) -> torch.Tensor:
    return _rows_times(xb, dct_tensor(xb.device, xb.shape[-1]).T)


def idct_blocks(yb: torch.Tensor) -> torch.Tensor:
    return _rows_times(yb, dct_tensor(yb.device, yb.shape[-1]))


# ---------------------------------------------------------------------------
# Selection: histogram threshold
# ---------------------------------------------------------------------------

def bin_index(a: torch.Tensor) -> torch.Tensor:
    """Flat 512-level bin index of absolute magnitudes ``a`` (int32).

    The one binning every selection path uses: the coarse pass derives its
    32 bins as ``bin_index(a) // NBINS_FINE``, so an element can never land
    in a coarse bin inconsistent with its fine bin. Exact zeros land in bin
    0 (they carry no energy). ``1e-38`` is itself a subnormal in f32.
    """
    lg = torch.where(a > 0, torch.log2(torch.clamp(a, min=1e-38)),
                     torch.tensor(LOG2_LO, dtype=a.dtype, device=a.device))
    return torch.clamp(((lg - LOG2_LO) * _BIN_SCALE).to(torch.int32),
                       0, NBINS - 1)


def _hist(idx: torch.Tensor, w: torch.Tensor, nbins: int) -> torch.Tensor:
    return torch.zeros(nbins, dtype=torch.float32, device=w.device
                       ).index_add_(0, idx.long(), w)


def energy_histogram(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute log2-|y| histogram -> (counts, energies), each (NBINS,)."""
    a = torch.abs(y.reshape(-1))
    idx = bin_index(a)
    return _hist(idx, torch.ones_like(a), NBINS), _hist(idx, a * a, NBINS)


def coarse_energy_histogram(y: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse 32-bin histogram -> (counts, energies), each (NBINS_COARSE,).
    Coarse bin j aggregates fine bins [16j, 16j+16)."""
    a = torch.abs(y.reshape(-1))
    idx = torch.div(bin_index(a), NBINS_FINE, rounding_mode="floor")
    return (_hist(idx, torch.ones_like(a), NBINS_COARSE),
            _hist(idx, a * a, NBINS_COARSE))


def refine_energy_histogram(y: torch.Tensor, coarse
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine histogram of the 16 bins inside coarse bin ``coarse``.
    Elements outside the coarse bin add exactly 0.0 to slot 0."""
    a = torch.abs(y.reshape(-1))
    idx = bin_index(a)
    member = torch.div(idx, NBINS_FINE, rounding_mode="floor") == coarse
    fine = torch.where(member, idx - coarse * NBINS_FINE, 0)
    w = member.to(torch.float32)
    return _hist(fine, w, NBINS_FINE), _hist(fine, a * a * w, NBINS_FINE)


# 2^(LOG2_LO + b * 80/512) for b = 0..NBINS, each rounded once to f32 — the
# values the JAX package's ``bin_edge`` gives (checked in the tests); an
# f32 ``pow`` rounds some edges a step away
_EDGES = (2.0 ** (LOG2_LO + np.arange(NBINS + 1) * ((LOG2_HI - LOG2_LO)
                                                     / NBINS))
          ).astype(np.float32)


def bin_edge(b) -> torch.Tensor:
    """Lower |y| edge of histogram bin b (int tensor or int), f32."""
    b = torch.as_tensor(b)
    return torch.from_numpy(_EDGES).to(b.device)[b.long()]


def threshold_from_histogram(energies: torch.Tensor, eps: float
                             ) -> torch.Tensor:
    """Largest bin edge whose below-edge cumulative energy <= eps^2 * total.

    Discarding every |y| < t then provably discards <= budget.
    """
    total = torch.sum(energies)
    budget = (eps * eps) * total
    below = torch.cat([energies.new_zeros(1), torch.cumsum(energies, 0)])
    ok = below[:NBINS + 1] <= budget + 1e-30
    c = torch.sum(ok.to(torch.int32)) - 1          # last edge within budget
    # budget >= total (eps >= 1, or no energy) drops everything
    # deterministically: the tie `cumsum(E)[-1] vs sum(E)` is otherwise
    # decided by fp summation order, which differs between selection paths
    c = torch.where(budget >= total, NBINS, c)
    return torch.where(c <= 0, torch.zeros((), device=c.device),
                       bin_edge(c))


def select_coarse(coarse_energies: torch.Tensor, eps: float):
    """First half of the two-level selector over (..., NBINS_COARSE) energy
    histograms (a leading batch dimension selects per leaf). Returns
    ``(C, Cc, base, budget)``:

      C       last coarse edge (0..32) whose below-edge energy fits the
              eps^2 budget — 32 means even the full energy fits (drop all)
      Cc      C clamped to a valid coarse *bin* index for the refine pass
      base    cumulative energy below coarse edge Cc
      budget  eps^2 * total energy
    """
    e = coarse_energies
    total = torch.sum(e, -1)
    budget = (eps * eps) * total
    below = torch.cat([e.new_zeros(e.shape[:-1] + (1,)), torch.cumsum(e, -1)],
                      -1)
    ok = below[..., :NBINS_COARSE + 1] <= (budget + 1e-30)[..., None]
    c = torch.sum(ok.to(torch.int32), -1) - 1      # >= 0: edge 0 always ok
    # the same drop-everything clamp as threshold_from_histogram
    c = torch.where(budget >= total, NBINS_COARSE, c)
    cc = torch.clamp(c, 0, NBINS_COARSE - 1)
    base = torch.gather(below, -1, cc.long()[..., None])[..., 0]
    return c, cc, base, budget


def select_fine(fine_energies: torch.Tensor, c: torch.Tensor, cc: torch.Tensor,
                base: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """Second half of the two-level selector: the fine edge inside coarse bin
    ``cc`` -> the threshold (the flat selector's edge grid). Batched like
    :func:`select_coarse`."""
    f = fine_energies
    cum = torch.cat([f.new_zeros(f.shape[:-1] + (1,)), torch.cumsum(f, -1)],
                    -1)[..., :NBINS_FINE]
    below = base[..., None] + cum
    ok = below <= (budget + 1e-30)[..., None]
    k = torch.clamp(torch.sum(ok.to(torch.int32), -1) - 1, min=0)
    edge = torch.where(c >= NBINS_COARSE, NBINS, cc * NBINS_FINE + k)
    return torch.where(edge <= 0, torch.zeros((), device=edge.device),
                       bin_edge(edge))


def threshold_two_level(y: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-level (coarse-32 then refine-16) threshold selection: the same
    quantized bin edge as ``threshold_from_histogram`` over the flat
    512-bin histogram, at O(elements x 48) binning cost."""
    _, ce = coarse_energy_histogram(y)
    c, cc, base, budget = select_coarse(ce, eps)
    _, fe = refine_energy_histogram(y, cc)
    return select_fine(fe, c, cc, base, budget)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def quantize_blocks(y: torch.Tensor, t) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero sub-threshold coeffs, int8-quantize survivors per block. ``t``
    is a scalar or a per-block (n_blocks,) threshold."""
    t = torch.as_tensor(t, dtype=torch.float32, device=y.device)
    if t.dim() == 1:
        t = t[:, None]
    kept = torch.where(torch.abs(y) >= t, y, torch.zeros((), device=y.device))
    amax = torch.amax(torch.abs(kept), dim=-1)                # (n_blocks,)
    scale = torch.where(amax > 0, amax * INV127,
                        torch.ones((), device=y.device))
    q = torch.clamp(torch.round(kept / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[:, None]


# ---------------------------------------------------------------------------
# End-to-end oracle codec
# ---------------------------------------------------------------------------

def compress(x: torch.Tensor, eps: float = 1e-2, *,
             selector: str = "histogram") -> Compressed:
    xb, n = blockize(x)
    y = dct_blocks(xb)
    if selector == "histogram":
        _, energies = energy_histogram(y)
        t = threshold_from_histogram(energies, eps)
    elif selector == "two_level":
        t = threshold_two_level(y, eps)
    else:
        raise ValueError(f"unknown selector {selector!r}")
    q, scale = quantize_blocks(y, t)
    return Compressed(q, scale, n, tuple(x.shape), x.dtype)


def decompress(c: Compressed) -> torch.Tensor:
    y = dequantize_blocks(c.q, c.scale)
    xb = idct_blocks(y)
    return unblockize(xb, c.n_elements, c.shape, c.dtype)


def rel_l2_error(x: torch.Tensor, xhat: torch.Tensor) -> float:
    num = torch.linalg.vector_norm((x.float() - xhat.float()).reshape(-1))
    den = torch.linalg.vector_norm(x.float().reshape(-1))
    return float(num / torch.clamp(den, min=1e-30))


def error_bound(eps: float) -> float:
    """Combined guarantee: threshold (<= eps) + int8 quantization.

    Quantization adds per-block L2 error <= (scale/2) * sqrt(B); with
    scale = max|y_b|/127 this is <= ||y_b|| * sqrt(B)/254 relative per block.
    """
    return eps + math.sqrt(BLOCK) / 254.0
