"""Per-kernel roofline placement on the card.

``kernel_report(fn, args)`` places one call of ``fn(*args)`` on the
compute/memory roofline of one H100 (the constants of
:mod:`repro_torch.roofline.analysis`):

  compute_s = flops / peak_flops    (each kernel's own rate from _COSTS:
                                     f32 FMA for the spectral kernels, TF32
                                     not allowed; the operands' dtype for
                                     paged attention; bf16 tensor cores
                                     for any other function)
  memory_s  = bytes / HBM_BW
  bound     = whichever ceiling is higher; intensity vs the ridge point
              (peak_flops / HBM_BW) tells the same story per byte.

The JAX package reads flops and bytes from XLA's cost analysis of the
compiled call. Here they come from :func:`kernel_cost` for the kernels the
port carries: the least work any implementation of each must do, counted
from its arguments' shapes (and, for paged attention, the valid lengths),
so that a redesigned kernel is measured against a bound that does not
move with it. For any other function, flops are counted over one call by
``torch.utils.flop_counter.FlopCounterMode`` and bytes as its tensor
inputs and outputs once each; the report's note says so.

``measure=True`` times the call: on CUDA tensors one warm-up call outside
the timer, then ``iters`` calls between two CUDA events; on CPU tensors
the host clock, and the note says that the fraction is not the card's.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from typing import Optional

import torch

from repro_torch.kernels.ref import BLOCK, NBINS, NBINS_COARSE, NBINS_FINE
from repro_torch.kernels.spectral_lossy import HIST_TILE
from repro_torch.roofline.analysis import (HBM_BW, PEAK_FLOPS_BF16,
                                           PEAK_FLOPS_F32)

RIDGE_INTENSITY = PEAK_FLOPS_BF16 / HBM_BW     # flops/byte at the roof knee


@dataclass
class KernelReport:
    name: str
    flops: float
    bytes_accessed: float
    intensity: float                  # flops per HBM byte
    ridge_intensity: float            # peak_flops / hbm_bw
    compute_s: float
    memory_s: float
    roofline_s: float                 # max(compute_s, memory_s)
    bound: str                        # "compute" | "memory"
    measured_s: Optional[float] = None
    achieved_fraction: Optional[float] = None   # roofline_s / measured_s
    note: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


# ---------------------------------------------------------------------------
# the least work of each kernel
# ---------------------------------------------------------------------------

_D_BYTES = BLOCK * BLOCK * 4       # the f32 DCT basis, read once
_PASS_FLOPS = 3                    # per element of a histogram or quantiser
                                   # pass: |y|, its square, one compare


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dct(x: torch.Tensor, in_bytes: int, extra_out: int = 0):
    """A 256-point DCT (or its inverse) of every block of x into f32: a
    256-long dot product (512 flops) per element; its input, its f32
    output and ``extra_out`` bytes more, and D once."""
    el = x.numel()
    return 2 * BLOCK * el, in_bytes + 4 * el + extra_out + _D_BYTES


def _rows(x: torch.Tensor, nbins: int) -> int:
    """Bytes of per-tile (count, energy) f32 rows over ``nbins`` bins."""
    return x.shape[0] // HIST_TILE * nbins * 2 * 4


def _pass(y: torch.Tensor, out_bytes: int):
    """A pass over f32 coefficients with one per-block operand (the coarse
    bin or the threshold, 4 bytes a block however the caller gave it)."""
    return _PASS_FLOPS * y.numel(), _nbytes(y) + 4 * y.shape[0] + out_bytes


def _paged(q, k_pages, v_pages, page_table, length):
    """One decode token's attention over the pages that hold valid
    positions (a row of length 0 weighs its whole table, so all its pages);
    scores and the PV product at 2 flops per multiply-add."""
    b, _, hq, d_k = q.shape
    _, ps, n_kv, _ = k_pages.shape
    d_v = v_pages.shape[3]
    el = q.element_size()
    width = page_table.shape[1]
    lens = [int(n) for n in length.tolist()]
    pages = sum(width if n == 0 else min(width, -(-n // ps)) for n in lens)
    tokens = sum(width * ps if n == 0 else n for n in lens)
    nbytes = (pages * ps * n_kv * (d_k + d_v) * el + q.numel() * el
              + b * hq * d_v * el + page_table.numel() * 4
              + length.numel() * 4)
    return 2 * hq * tokens * (d_k + d_v), nbytes


def _f32(*_) -> float:
    return PEAK_FLOPS_F32


def _dtype_rate(q, *_) -> float:
    """f32 FMA for f32 operands, the tensor cores' rate for 16-bit ones."""
    return PEAK_FLOPS_F32 if q.dtype == torch.float32 else PEAK_FLOPS_BF16


# name: (its least (flops, bytes), the peak rate of its arithmetic)
_COSTS = {
    "paged_decode_attention": (_paged, _dtype_rate),
    "dct_blocks": (lambda xb: _dct(xb, _nbytes(xb)), _f32),
    "dct_hist_coarse_tiled": (lambda xb: _dct(
        xb, _nbytes(xb), _rows(xb, NBINS_COARSE)), _f32),
    "dct_hist_coarse": (lambda xb: _dct(xb, _nbytes(xb), NBINS_COARSE * 8),
                        _f32),
    "dct_hist_tiled": (lambda xb: _dct(xb, _nbytes(xb), _rows(xb, NBINS)),
                       _f32),
    "dct_hist": (lambda xb: _dct(xb, _nbytes(xb), NBINS * 8), _f32),
    "hist_refine_tiled": (lambda y, coarse: _pass(y, _rows(y, NBINS_FINE)),
                          _f32),
    "hist_refine": (lambda y, coarse: _pass(y, NBINS_FINE * 8), _f32),
    "threshold_quant": (lambda y, t: _pass(y, y.numel() + 4 * y.shape[0]),
                        _f32),
    "dequant_idct": (lambda q, scale: _dct(q, _nbytes(q) + _nbytes(scale)),
                     _f32),
}
KERNELS = tuple(_COSTS)


def _slstm_fwd(gx, gr, c, n, m, c_out, n_out, m_out, pre, h):
    """One step: gx, gr and the state read; the state, p and h written;
    ~40 flops an element (the gates, exp twice, tanh, the sigmoid)."""
    ins = _nbytes(gx) + _nbytes(gr) + 3 * _nbytes(c)
    outs = 3 * _nbytes(c_out) + (_nbytes(pre) if pre is not None else 0) \
        + _nbytes(h)
    return 40 * c.numel(), ins + outs


def _slstm_bwd(pre, c, n, m, dh_out, dhr, dc, dn, dm, dpre, dgr):
    """One step back: p, the input state, h's cotangents and the carries
    read; the carries, dp (f32) and dgr written; ~80 flops an element."""
    opt = lambda t: _nbytes(t) if t is not None else 0
    ins = _nbytes(pre) + 3 * _nbytes(c) + opt(dh_out) + opt(dhr) \
        + 3 * _nbytes(dc)
    outs = 3 * _nbytes(dc) + _nbytes(dpre) + _nbytes(dgr)
    return 80 * c.numel(), ins + outs


#: kernels of the port with no Pallas counterpart (the sLSTM cell, whose
#: JAX step is fused by XLA), at the f32 rate of their arithmetic
PORT_COSTS = {
    "slstm_cell": (_slstm_fwd, _f32),
    "slstm_cell_bwd": (_slstm_bwd, _f32),
}
_ALL_COSTS = {**_COSTS, **PORT_COSTS}


def kernel_cost(name: str, *args) -> tuple[int, int]:
    """(flops, bytes) that any implementation of kernel ``name`` must at
    least spend on these arguments (the kernel's own, in its order; only
    their shapes and dtypes are read, and paged attention's lengths). Each
    input is read once and each output written once."""
    try:
        cost, _ = _ALL_COSTS[name]
    except KeyError:
        raise KeyError(f"no cost model for {name!r}; known: "
                       f"{', '.join(_ALL_COSTS)}") from None
    return cost(*args)


# ---------------------------------------------------------------------------
# placement and timing
# ---------------------------------------------------------------------------

def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _counted(fn, args) -> tuple[float, float, str]:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    flops = counter.get_total_flops()
    nbytes = (sum(_nbytes(t) for t in _tensors(args))
              + sum(_nbytes(t) for t in _tensors(out)))
    note = ("flops counted by FlopCounterMode over one call, bytes as its "
            "tensor inputs and outputs once")
    if flops == 0:
        note += ("; FlopCounterMode counted 0 flops (it counts matrix "
                 "products, convolutions and attention only)")
    return float(flops), float(nbytes), note


def _time_call(fn, args, iters: int) -> tuple[float, str]:
    cuda = [t for t in _tensors(args) if t.is_cuda]
    fn(*args)                          # warm-up outside the timer
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        stop.synchronize()
        return (start.elapsed_time(stop) / 1e3 / iters,
                f"measured on {torch.cuda.get_device_name(cuda[0].device)} "
                f"with CUDA events")
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return ((time.perf_counter() - t0) / iters,
            "measured off the card: achieved fraction is not hardware-honest")


def kernel_report(fn, args, *, name: str = "", measure: bool = False,
                  iters: int = 3,
                  flops_override: Optional[float] = None,
                  bytes_override: Optional[float] = None) -> KernelReport:
    """Place ``fn(*args)`` on the compute/memory roofline, at the peak rate
    of the kernel's arithmetic (``_COSTS``; bf16 for another function)."""
    name = name or getattr(fn, "__name__", "kernel")
    peak_flops = (_ALL_COSTS[name][1](*args) if name in _ALL_COSTS
                  else PEAK_FLOPS_BF16)
    notes = []
    flops = byts = None
    if flops_override is None or bytes_override is None:
        if name in _ALL_COSTS:
            flops, byts = map(float, kernel_cost(name, *args))
        else:
            flops, byts, note = _counted(fn, args)
            notes.append(note)
    flops = float(flops if flops_override is None else flops_override)
    byts = float(byts if bytes_override is None else bytes_override)
    compute_s = flops / peak_flops
    memory_s = byts / HBM_BW
    roofline_s = max(compute_s, memory_s)
    measured = achieved = None
    if measure:
        measured, note = _time_call(fn, args, iters)
        achieved = roofline_s / measured if measured > 0 else 0.0
        notes.append(note)
    return KernelReport(
        name=name, flops=flops, bytes_accessed=byts,
        intensity=flops / byts if byts > 0 else 0.0,
        ridge_intensity=peak_flops / HBM_BW, compute_s=compute_s,
        memory_s=memory_s, roofline_s=roofline_s,
        bound="compute" if compute_s >= memory_s else "memory",
        measured_s=measured, achieved_fraction=achieved,
        note="; ".join(notes))
