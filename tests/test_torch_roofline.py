"""The port's roofline (``repro_torch.roofline``) against the JAX
package's, on the CPU: the report's fields, the useful-FLOP model, the
cost model's DCT count against XLA's own count of the same product, and
the bounds the smoke has quoted since the kernels were ported (their
formulas are written out below as the smoke computed them, so that moving
them into the package changed no number)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.kernels import ref as JR
from repro.roofline import analysis as JA
from repro.roofline import kernels as JRK
from repro_torch.configs import base as TB
from repro_torch.kernels import ref as TR
from repro_torch.kernels import spectral_lossy as TK
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import kernels as RK

HBM = 3.35e12                      # H100 SXM, NVIDIA data sheet
F32 = 67e12
BF16 = 989e12

# ---------------------------------------------------------------------------
# the bound formulas as chip_smoke.py computed them before the cost model
# ---------------------------------------------------------------------------


def _dct_bound(nb, *, out_bytes, in_bytes):
    elems = nb * 256
    t_ops = 512 * elems / F32 * 1e3
    t_bytes = (in_bytes + out_bytes + 256 * 256 * 4) / HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _pass_bound(nbytes, flops):
    t_bytes = nbytes / HBM * 1e3
    t_ops = flops / F32 * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _paged_bound(q, k, v, table, length):
    b, _, hq, d_k = q.shape
    _, ps, n_kv, _ = k.shape
    d_v = v.shape[3]
    el = q.element_size()
    lens = [int(x) for x in length.tolist()]
    pages = sum(table.shape[1] if n == 0 else min(table.shape[1], -(-n // ps))
                for n in lens)
    nbytes = (pages * ps * n_kv * (d_k + d_v) * el + q.numel() * el
              + b * hq * d_v * el + table.numel() * 4 + length.numel() * 4)
    tokens = sum(table.shape[1] * ps if n == 0 else n for n in lens)
    flops = 2 * hq * tokens * (d_k + d_v)
    t_bytes = nbytes / HBM * 1e3
    t_ops = flops / (F32 if q.dtype == torch.float32 else BF16) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _old_bound(name, nb):
    el = nb * 256
    return {
        "dct_hist_coarse_tiled": lambda: _dct_bound(
            nb, in_bytes=4 * el, out_bytes=4 * el + nb // 8 * 32 * 8),
        "hist_refine_tiled": lambda: _pass_bound(
            4 * el + 4 * nb + nb // 8 * 16 * 8, 3 * el),
        "threshold_quant": lambda: _pass_bound(4 * el + 4 * nb + el + 4 * nb,
                                               3 * el),
        "dequant_idct": lambda: _dct_bound(nb, in_bytes=el + 4 * nb,
                                           out_bytes=4 * el),
        "dct_hist_coarse": lambda: _dct_bound(
            nb, in_bytes=4 * el, out_bytes=4 * el + 2 * 32 * 4),
        "hist_refine": lambda: _pass_bound(4 * el + 4 * nb + 2 * 16 * 4,
                                           3 * el),
        "dct_hist_tiled": lambda: _dct_bound(
            nb, in_bytes=4 * el, out_bytes=4 * el + nb // 8 * 512 * 2 * 4),
        "dct_hist": lambda: _dct_bound(nb, in_bytes=4 * el,
                                       out_bytes=4 * el + 512 * 2 * 4),
    }[name]()


def _args(name, nb):
    """The kernel's arguments at nb blocks, on the meta device (the cost
    model reads shapes and dtypes only)."""
    f32 = lambda *s: torch.empty(s, device="meta")          # noqa: E731
    blocks = f32(nb, TR.BLOCK)
    return {"hist_refine_tiled": (blocks, torch.empty(nb, dtype=torch.int32,
                                                      device="meta")),
            "hist_refine": (blocks, 17),
            "threshold_quant": (blocks, f32(nb)),
            "dequant_idct": (torch.empty((nb, TR.BLOCK), dtype=torch.int8,
                                         device="meta"), f32(nb))
            }.get(name, (blocks,))


def _bound(name, *args):
    rep = RK.kernel_report(None, args, name=name)
    return rep.roofline_s * 1e3, ("operations" if rep.bound == "compute"
                                  else "bytes")


PACKED = 1_050_928          # smollm-135m's packed moment buffer, in blocks
EMBED = 110_592             # its ['mu']['embed'] leaf


@pytest.mark.parametrize("name", [n for n in RK.KERNELS
                                  if n not in ("paged_decode_attention",
                                               "dct_blocks")])
@pytest.mark.parametrize("nb", [8, 1048, 4096, EMBED, PACKED])
def test_spectral_bounds_are_the_smokes_formulas(name, nb):
    assert _bound(name, *_args(name, nb)) == _old_bound(name, nb)
    # at no blocks only D is left to read (for the passes nothing: which
    # bound then names the tie is arbitrary)
    assert _bound(name, *_args(name, 0))[0] == _old_bound(name, 0)[0]


@pytest.mark.parametrize("lengths", [[64] * 8, [0, 1, 16, 17, 64, 64, 35, 63]])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_bound_is_the_smokes_formula(lengths, dtype):
    b, hq, n_kv, d, ps, pps = 8, 9, 3, 64, 16, 4
    args = (torch.empty((b, 1, hq, d), dtype=dtype, device="meta"),
            torch.empty((b * pps + 1, ps, n_kv, d), dtype=dtype,
                        device="meta"),
            torch.empty((b * pps + 1, ps, n_kv, d), dtype=dtype,
                        device="meta"),
            torch.empty((b, pps), dtype=torch.int32, device="meta"),
            torch.tensor(lengths, dtype=torch.int32))
    assert _bound("paged_decode_attention", *args) == _paged_bound(*args)


def test_bounds_reproduce_perf_md_rows_1_to_7():
    """PERF.md's table quotes these bounds (ms, at the shapes it states):
    row 1 at the serving shape, rows 2-5 at the packed moment buffer, rows
    6-7 at the embed leaf and summed over the 22 leaves of one save."""
    serve = (torch.empty((8, 1, 9, 64), dtype=torch.bfloat16, device="meta"),
             torch.empty((33, 16, 3, 64), dtype=torch.bfloat16,
                         device="meta"),
             torch.empty((33, 16, 3, 64), dtype=torch.bfloat16,
                         device="meta"),
             torch.empty((8, 4), dtype=torch.int32, device="meta"),
             torch.full((8,), 64, dtype=torch.int32))
    got = {"paged_decode_attention": _bound("paged_decode_attention", *serve)}
    for name in ("dct_hist_coarse_tiled", "hist_refine_tiled",
                 "threshold_quant", "dequant_idct"):
        got[name] = _bound(name, *_args(name, PACKED))
    for name in ("dct_hist_coarse", "hist_refine"):
        got[name] = _bound(name, *_args(name, EMBED))
    want = {"paged_decode_attention": (0.000123, "bytes"),
            "dct_hist_coarse_tiled": (2.056, "operations"),
            "hist_refine_tiled": (0.328, "bytes"),
            "threshold_quant": (0.404, "bytes"),
            "dequant_idct": (2.056, "operations"),
            "dct_hist_coarse": (0.216, "operations"),
            "hist_refine": (0.034, "bytes")}
    for name, (ms, by) in want.items():
        digits = len(repr(ms).split(".")[1])
        assert (round(got[name][0], digits), got[name][1]) == (ms, by), name
    # per save: the 22 moment leaves of full-width smollm-135m
    leaves = _moment_leaf_blocks()
    assert len(leaves) == 22 and sum(leaves) == PACKED
    per_save = {n: sum(_bound(n, *_args(n, nb))[0] for nb in leaves)
                for n in ("dct_hist_coarse", "hist_refine")}
    assert round(per_save["dct_hist_coarse"], 3) == 2.056
    assert round(per_save["hist_refine"], 3) == 0.322


@pytest.mark.parametrize("pps,ms", [(4, 0.000211), (256, 0.01254)])
def test_bounds_reproduce_perf_md_row_1h(pps, ms):
    """Row 1h: kernel 1 at hymba-1.5b's heads (25 query heads over 5 kv
    heads of 64), bf16, B = 8, every row at full length, on the serving
    table of 4 pages and on a 256-page one: bytes bound both."""
    b, ps = 8, 16
    meta = lambda shape, dtype=torch.bfloat16: torch.empty(
        shape, dtype=dtype, device="meta")
    args = (meta((b, 1, 25, 64)), meta((b * pps + 1, ps, 5, 64)),
            meta((b * pps + 1, ps, 5, 64)), meta((b, pps), torch.int32),
            torch.full((b,), ps * pps, dtype=torch.int32))
    got, by = _bound("paged_decode_attention", *args)
    digits = len(repr(ms).split(".")[1])
    assert (round(got, digits), by) == (ms, "bytes")


def _moment_leaf_blocks():
    from repro_torch.core import pytree
    from repro_torch.models import transformer

    cfg = TB.get("smollm-135m")
    out = []
    for _ in ("mu", "nu"):
        for _, s in pytree.flatten_with_path(transformer.param_spec(cfg)):
            nb = -(-math.prod(s.shape) // TR.BLOCK)
            out.append(nb + (-nb) % TK.HIST_TILE)
    return out


def test_flat_pair_bound_at_kernel_roofline_size():
    """``benchmarks/kernel_roofline.py``'s full size (4096 blocks): 5.37e8
    flops, bound by operations at 8.0 us."""
    for name in ("dct_hist", "dct_hist_tiled"):
        flops, nbytes = RK.kernel_cost(name, *_args(name, 4096))
        assert flops == 2 * 4096 * 256 ** 2
        assert round(_bound(name, *_args(name, 4096))[0] * 1e3, 2) == 8.01
        assert nbytes < 12e6


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_dct_cost_equals_xla_count_of_the_reference_product():
    xb = np.random.default_rng(0).standard_normal((256, JR.BLOCK)).astype(
        np.float32)
    rep = JRK.kernel_report(JR.dct_blocks, (jnp.asarray(xb),))
    flops, nbytes = RK.kernel_cost("dct_blocks", torch.from_numpy(xb))
    assert (flops, nbytes) == (rep.flops, rep.bytes_accessed)
    assert flops == 2 * 256 * 256 ** 2
    assert nbytes == (2 * 256 * 256 + 256 ** 2) * 4
    # every forward DCT kernel is that product plus its histogram rows
    for name, rows in (("dct_hist", 512 * 8), ("dct_hist_coarse", 32 * 8),
                       ("dct_hist_tiled", 32 * 512 * 8),
                       ("dct_hist_coarse_tiled", 32 * 32 * 8)):
        assert RK.kernel_cost(name, torch.from_numpy(xb)) == (
            flops, nbytes + rows)


def test_report_fields_equal_the_jax_dataclass():
    assert ([(f.name, f.default) for f in dataclasses.fields(RK.KernelReport)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JRK.KernelReport)])
    assert RK.RIDGE_INTENSITY == TA.PEAK_FLOPS_BF16 / TA.HBM_BW


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-4b", "smollm-135m",
                                  "qwen1.5-110b"])
@pytest.mark.parametrize("shape", sorted(TB.SHAPES))
def test_model_flops_equal_jax(arch, shape):
    cfg = TB.get(arch)
    assert cfg.n_active_params() == cfg.n_params()
    assert TA.model_flops(cfg, TB.SHAPES[shape]) == JA.model_flops(
        JB.get(arch), JB.SHAPES[shape])


def test_constants_are_the_h100s():
    assert (TA.HBM_BW, TA.PEAK_FLOPS_BF16, TA.PEAK_FLOPS_F32) == (
        3.35e12, 989e12, 67e12)
    assert "H100" in TA.DEVICE and "700 W" in TA.DEVICE


# ---------------------------------------------------------------------------
# kernel_report itself
# ---------------------------------------------------------------------------

def test_report_of_a_named_kernel_uses_the_cost_model_and_notes_the_cpu():
    xb = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, TR.BLOCK)).astype(np.float32))
    TK.reset_launches()
    rep = RK.kernel_report(TK.dct_hist, (xb,), measure=True, iters=2)
    assert rep.name == "dct_hist"
    assert (rep.flops, rep.bytes_accessed) == RK.kernel_cost("dct_hist", xb)
    assert rep.bound == "compute"
    assert rep.ridge_intensity == TA.PEAK_FLOPS_F32 / TA.HBM_BW
    assert rep.compute_s == rep.flops / TA.PEAK_FLOPS_F32
    assert rep.measured_s > 0
    assert rep.achieved_fraction == rep.roofline_s / rep.measured_s
    assert rep.note == ("measured off the card: achieved fraction is not "
                        "hardware-honest")
    assert TK.dct_hist.launches == 0      # the plain version ran
    assert RK.kernel_report(TK.dct_hist, (xb,)).note == ""


@pytest.mark.parametrize("dtype, peak", [(torch.bfloat16, BF16),
                                         (torch.float32, F32)])
def test_each_kernel_is_placed_at_the_rate_of_its_arithmetic(dtype, peak):
    """Paged attention at its operands' rate, the spectral kernels at the
    f32 FMA rate (TF32 is not allowed for the codec), any other function
    at the bf16 tensor cores' rate."""
    q = torch.empty((8, 1, 9, 64), dtype=dtype, device="meta")
    pages = torch.empty((33, 16, 3, 64), dtype=dtype, device="meta")
    args = (q, pages, pages, torch.empty((8, 4), dtype=torch.int32,
                                         device="meta"),
            torch.full((8,), 64, dtype=torch.int32))
    rep = RK.kernel_report(None, args, name="paged_decode_attention")
    assert rep.ridge_intensity == peak / HBM
    assert rep.compute_s == rep.flops / peak
    for name in RK.KERNELS:
        if name != "paged_decode_attention":
            rep = RK.kernel_report(None, _args(name, 64), name=name)
            assert rep.compute_s == rep.flops / F32, name
    rep = RK.kernel_report(torch.matmul, (torch.ones(8, 16, dtype=dtype),
                                          torch.ones(16, 4, dtype=dtype)))
    assert rep.ridge_intensity == BF16 / HBM


def test_report_of_another_function_counts_its_flops_and_says_so():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    rep = RK.kernel_report(torch.matmul, (a, b))
    assert rep.name == "matmul"
    assert rep.flops == 2 * 8 * 16 * 4
    assert rep.bytes_accessed == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert rep.bound == "memory" and "FlopCounterMode" in rep.note
    # no silent zero
    rep = RK.kernel_report(torch.clone, (a,))
    assert rep.flops == 0 and "counted 0 flops" in rep.note
    # overrides win, one at a time
    rep = RK.kernel_report(TK.dct_hist, (torch.zeros(8, TR.BLOCK),),
                           flops_override=1.0)
    assert rep.flops == 1.0
    assert rep.bytes_accessed == RK.kernel_cost(
        "dct_hist", torch.zeros(8, TR.BLOCK))[1]


def test_cost_of_an_unknown_kernel_names_the_known_ones():
    with pytest.raises(KeyError, match="dct_hist_tiled"):
        RK.kernel_cost("flash_attention", torch.zeros(1))
