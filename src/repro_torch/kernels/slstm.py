"""The sLSTM cell: a hand-written Hopper kernel for one time step, forward
and backward, and its plain version.

The JAX package has no Pallas kernel here: its sLSTM step
(``src/repro/models/xlstm.py::_slstm_step``) is plain jnp inside a
``lax.scan``, which XLA fuses into one loop body on the TPU. The port's
step is one kernel each way beside the recurrent product, which stays
``torch.bmm``; ``models/xlstm.py::SLSTMScan`` runs the time loop.

  slstm_cell      p = gx_t + gr (the four gate pre-activations), the
                  gates, the new state (c, n, m) and the step's h;
                  writes p for the backward
  slstm_cell_bwd  the step recomputed from p and its input state, then
                  the cotangents of p (f32, and in the recurrent weights'
                  dtype for the product's backward) and the carries
                  (dc, dn, dm), updated in place

Layouts (B rows, nh heads of dh, d = nh * dh): ``gx`` and ``p`` are
(B, 4d) f32 rows (views of (B, L, 4d) buffers at one step; gate-major:
i, f, z, o), ``gr`` and ``dgr`` are (nh, B, 4dh) in the weights' dtype
(the product's layout), the states and carries (B, nh, dh) f32, ``h`` and
its cotangent (B, d) rows in h's dtype (views of (B, L, d)), ``dhr``
(nh, B, dh) in the weights' dtype (the next step's product's cotangent).

* CUDA tensors launch ``csrc/slstm.cu`` (CUDA C++ for ``sm_90a``, built by
  ``_build`` on first use and bound with ``ctypes``), through the custom
  ops ``repro_torch::slstm_cell`` and ``repro_torch::slstm_cell_bwd``:
  their fake implementations let the dry run lower the xLSTM family on
  fake tensors (``launch/dryrun.py``), where a ``ctypes`` launch cannot
  run. Both write their outputs into the buffers given and return none.
* CPU tensors take the ``*_plain`` version: the JAX package's step as
  unfused torch ops (the forward the very ops the port's time loop ran
  before this kernel), and the backward as explicit formulas that follow
  JAX's autodiff of the step, ties of ``jnp.maximum`` included.

The choice is the tensors' device and nothing else: a CUDA call launches
the kernel or raises, it never falls back to the plain version. Fake
tensors (the dry run's) go to the custom op on either device. Every
launch adds one to the wrapper's ``launches`` counter.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

N_FLOOR = 1e-6          # n's floor in h = o * c / max(n, 1e-6)
_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _gates(p: torch.Tensor, nh: int, dh: int):
    """(B, 4d) pre-activations -> the four (B, nh, dh) gates i, f, z, o."""
    return p.view(-1, 4, nh, dh).unbind(1)


def _forward(gi, gf, gz, go, c, n, m):
    """The step as the JAX package writes it (``_slstm_step``), one torch
    op per jnp op."""
    m_new = torch.maximum(gf + m, gi)
    fs = torch.exp(gf + m - m_new)
    is_ = torch.exp(gi - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = fs * c + is_ * z
    n_new = fs * n + is_
    nd = torch.clamp(n_new, min=N_FLOOR)      # the value of jnp.maximum's
    h = o * c_new / nd
    return m_new, fs, is_, z, o, c_new, n_new, nd, h


def slstm_cell_plain(gx, gr, c, n, m, c_out, n_out, m_out, pre, h):
    nh, _, dh4 = gr.shape
    dh = dh4 // 4
    p4 = (gx.float().view(-1, 4, nh, dh).transpose(0, 1)
          + gr.float().view(nh, -1, 4, dh).permute(2, 1, 0, 3))
    if pre is not None:
        pre.view(-1, 4, nh, dh).copy_(p4.transpose(0, 1))
    gi, gf, gz, go = p4.unbind(0)
    m_new, _, _, _, _, c_new, n_new, _, hv = _forward(gi, gf, gz, go, c, n,
                                                      m)
    c_out.copy_(c_new)
    n_out.copy_(n_new)
    m_out.copy_(m_new)
    h.copy_(hv.to(h.dtype).reshape(h.shape))


def _max_share(x: torch.Tensor, y) -> torch.Tensor:
    """jnp.maximum(x, y)'s share of the cotangent that goes to x: 1 where
    x wins, 0.5 on a tie, 0 where y wins."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def slstm_cell_bwd_plain(pre, c, n, m, dh_out, dhr, dc, dn, dm, dpre, dgr):
    nh, _, dh4 = dgr.shape
    dh_ = dh4 // 4
    gi, gf, gz, go = _gates(pre, nh, dh_)
    m_new, fs, is_, z, o, c_new, n_new, nd, _ = _forward(gi, gf, gz, go, c,
                                                         n, m)
    # h's cotangent in h's dtype: the output's plus the product's
    h_dtype = dh_out.dtype if dh_out is not None else dhr.dtype
    g = torch.zeros_like(c, dtype=h_dtype)
    if dh_out is not None:
        g = g + dh_out.reshape(c.shape)
    if dhr is not None:
        g = g + dhr.transpose(0, 1).to(h_dtype)
    g = g.float()
    q = o * c_new
    dq = g / nd
    dnd = -g * q / (nd * nd)
    d_o = dq * c_new
    dcn = dc + dq * o
    dnn = dn + dnd * _max_share(n_new, N_FLOOR)
    dfs = dcn * c + dnn * n
    dis = dcn * z + dnn
    dz = dcn * is_
    dgz = dz * (1 - z * z)
    dgo = d_o * (o * (1 - o))
    tf = dfs * fs
    ti = dis * is_
    dmn = dm - tf - ti
    w = _max_share(gf + m, gi)
    da = tf + dmn * w
    dgi = ti + dmn * (1 - w)
    dc.copy_(dcn * fs)
    dn.copy_(dnn * fs)
    dm.copy_(da)
    dp = torch.stack([dgi, da, dgz, dgo], 0)              # (4, B, nh, dh)
    dpre.view(-1, 4, nh, dh_).copy_(dp.transpose(0, 1))
    dgr.view(nh, -1, 4, dh_).copy_(dp.permute(2, 1, 0, 3))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "slstm_cell_fwd": ([_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _L,
                        _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "slstm_cell_bwd": ([_P, _L, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _L,
                        _P, _L, _I, _I, _I, _I, _I, _P], ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("slstm", _SIGNATURES)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _rows(t: torch.Tensor, width: int, what: str) -> int:
    """The row stride of a (B, width) view whose last dim is dense."""
    if t.dim() != 2 or t.shape[1] != width or t.stride(1) != 1:
        raise ValueError(f"slstm: {what} must be (B, {width}) rows with a "
                         f"dense last dim, got {tuple(t.shape)} strides "
                         f"{t.stride()}")
    return t.stride(0)


def _need(t: torch.Tensor, what: str, dtype=None) -> None:
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"slstm: {what} dtype {t.dtype} (kernel takes "
                        f"{dtype})")
    if dtype is None and t.dtype not in _DTYPES:
        raise TypeError(f"slstm: {what} dtype {t.dtype} (kernel takes "
                        f"float32 or bfloat16)")


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


@torch.library.custom_op("repro_torch::slstm_cell",
                         mutates_args=("c_out", "n_out", "m_out", "pre", "h"),
                         device_types="cuda")
def _cell_op(gx: torch.Tensor, gr: torch.Tensor, c: torch.Tensor,
             n: torch.Tensor, m: torch.Tensor, c_out: torch.Tensor,
             n_out: torch.Tensor, m_out: torch.Tensor,
             pre: Optional[torch.Tensor], h: torch.Tensor) -> None:
    nh, b, dh4 = gr.shape
    dh = dh4 // 4
    d = nh * dh
    for t, what in ((c, "c"), (n, "n"), (m, "m"), (c_out, "c_out"),
                    (n_out, "n_out"), (m_out, "m_out")):
        _need(t, what, torch.float32)
        if not t.is_contiguous() or t.numel() != b * d:
            raise ValueError(f"slstm_cell: {what} must be a contiguous "
                             f"({b}, {nh}, {dh}) state")
    _need(gx, "gx", torch.float32)
    _need(gr, "gr")
    _need(h, "h")
    if not gr.is_contiguous():
        raise ValueError("slstm_cell: gr must be contiguous")
    gx_sb = _rows(gx, 4 * d, "gx")
    pre_sb = 0
    if pre is not None:
        _need(pre, "pre", torch.float32)
        pre_sb = _rows(pre, 4 * d, "pre")
    h_sb = _rows(h, d, "h")
    with torch.cuda.device(gx.device):
        _launch("slstm_cell", _lib().slstm_cell_fwd(
            gx.data_ptr(), gx_sb, gr.data_ptr(), c.data_ptr(), n.data_ptr(),
            m.data_ptr(), c_out.data_ptr(), n_out.data_ptr(),
            m_out.data_ptr(), _ptr(pre), pre_sb, h.data_ptr(), h_sb, b, nh,
            dh, int(gr.dtype == torch.bfloat16),
            int(h.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream))
    _build.count_launch(slstm_cell)


@_cell_op.register_fake
def _(gx, gr, c, n, m, c_out, n_out, m_out, pre, h) -> None:
    return None


@torch.library.custom_op("repro_torch::slstm_cell_bwd",
                         mutates_args=("dc", "dn", "dm", "dpre", "dgr"),
                         device_types="cuda")
def _cell_bwd_op(pre: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                 m: torch.Tensor, dh_out: Optional[torch.Tensor],
                 dhr: Optional[torch.Tensor], dc: torch.Tensor,
                 dn: torch.Tensor, dm: torch.Tensor, dpre: torch.Tensor,
                 dgr: torch.Tensor) -> None:
    nh, b, dh4 = dgr.shape
    dh = dh4 // 4
    d = nh * dh
    for t, what in ((c, "c"), (n, "n"), (m, "m"), (dc, "dc"), (dn, "dn"),
                    (dm, "dm")):
        _need(t, what, torch.float32)
        if not t.is_contiguous() or t.numel() != b * d:
            raise ValueError(f"slstm_cell_bwd: {what} must be a contiguous "
                             f"({b}, {nh}, {dh}) state")
    _need(pre, "pre", torch.float32)
    _need(dpre, "dpre", torch.float32)
    _need(dgr, "dgr")
    # dgr: (nh, B, 4dh), rows dense within a head, heads dgr.stride(0) apart
    if dgr.stride(2) != 1 or dgr.stride(1) != dh4:
        raise ValueError(f"slstm_cell_bwd: dgr strides {dgr.stride()}")
    h_bf16 = 0
    dh_sb = 0
    if dh_out is not None:
        _need(dh_out, "dh_out")
        dh_sb = _rows(dh_out, d, "dh_out")
        h_bf16 = int(dh_out.dtype == torch.bfloat16)
    if dhr is not None:
        _need(dhr, "dhr", dgr.dtype)
        if not dhr.is_contiguous() or tuple(dhr.shape) != (nh, b, dh):
            raise ValueError(f"slstm_cell_bwd: dhr must be a contiguous "
                             f"({nh}, {b}, {dh}) tensor")
        if dh_out is None:
            h_bf16 = int(dhr.dtype == torch.bfloat16)
    with torch.cuda.device(pre.device):
        _launch("slstm_cell_bwd", _lib().slstm_cell_bwd(
            pre.data_ptr(), _rows(pre, 4 * d, "pre"), c.data_ptr(),
            n.data_ptr(), m.data_ptr(), _ptr(dh_out), dh_sb, _ptr(dhr),
            dc.data_ptr(), dn.data_ptr(), dm.data_ptr(), dpre.data_ptr(),
            _rows(dpre, 4 * d, "dpre"), dgr.data_ptr(), dgr.stride(0), b, nh,
            dh, int(dgr.dtype == torch.bfloat16), h_bf16,
            torch.cuda.current_stream().cuda_stream))
    _build.count_launch(slstm_cell_bwd)


@_cell_bwd_op.register_fake
def _(pre, c, n, m, dh_out, dhr, dc, dn, dm, dpre, dgr) -> None:
    return None


def _route(name: str, *ts) -> str:
    """``plain`` for CPU tensors, ``op`` for CUDA tensors and for fake
    ones (the dry run's, on either device: the custom op's fake
    implementation stands for the kernel there, so a lowering issues the
    same ops on both)."""
    from torch._subclasses.fake_tensor import FakeTensor

    ts = [t for t in ts if t is not None]
    if isinstance(ts[0], FakeTensor):
        return "op"
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return "plain" if dev.type == "cpu" else "op"


def slstm_cell(gx, gr, c, n, m, c_out, n_out, m_out, pre, h) -> None:
    """One forward step (module docstring): reads ``gx`` (B, 4d) f32,
    ``gr`` (nh, B, 4dh) and the state ``c``, ``n``, ``m`` (B, nh, dh) f32;
    writes the new state into ``c_out``, ``n_out``, ``m_out``, the
    pre-activations into ``pre`` (B, 4d) f32 (or nowhere if None) and h
    into ``h`` (B, d) in its own dtype."""
    if _route("slstm_cell", gx, gr, c, n, m, c_out, n_out, m_out, pre,
              h) == "plain":
        return slstm_cell_plain(gx, gr, c, n, m, c_out, n_out, m_out, pre, h)
    torch.ops.repro_torch.slstm_cell(gx, gr, c, n, m, c_out, n_out, m_out,
                                     pre, h)


def slstm_cell_bwd(pre, c, n, m, dh_out, dhr, dc, dn, dm, dpre, dgr) -> None:
    """One backward step (module docstring): reads ``pre`` (B, 4d) f32,
    the step's input state ``c``, ``n``, ``m``, h's cotangents ``dh_out``
    (B, d) in h's dtype and ``dhr`` (nh, B, dh) in the weights' dtype
    (either may be None: zero); updates the carries ``dc``, ``dn``, ``dm``
    (B, nh, dh) f32 in place (on entry the cotangents of the new state,
    on return those of the input state); writes p's cotangent into
    ``dpre`` (B, 4d) f32 and into ``dgr`` (nh, B, 4dh) in the weights'
    dtype."""
    if _route("slstm_cell_bwd", pre, c, n, m, dh_out, dhr, dc, dn, dm,
              dpre, dgr) == "plain":
        return slstm_cell_bwd_plain(pre, c, n, m, dh_out, dhr, dc, dn, dm,
                                    dpre, dgr)
    torch.ops.repro_torch.slstm_cell_bwd(pre, c, n, m, dh_out, dhr, dc, dn,
                                         dm, dpre, dgr)


slstm_cell.launches = 0
slstm_cell_bwd.launches = 0
KERNELS = (slstm_cell, slstm_cell_bwd)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
