"""xLSTM blocks: chunkwise-parallel mLSTM + recurrent sLSTM.

mLSTM (matrix memory, exponential gating) is evaluated in an exact chunkwise
form. With log-gates lf_t = log sigmoid(f~_t), li_t = i~_t and within-chunk
cumulative decay b_t = sum_{s<=t} lf_s, the stepwise stabilizer unrolls to

    m_t = b_t + max(m_in, cummax_{s<=t}(li_s - b_s))

and every stepwise quantity becomes an einsum against the (L,L) intra-chunk
weight matrix W_{ts} = exp(b_t - b_s + li_s - m_t) [s<=t] plus one inter-chunk
term exp(b_t + m_in - m_t) carried by the chunk state (C, n, m). The chunk
scan is a Python loop over the chunks; decode is the same chunk at L = 1.

sLSTM (scalar memory, block-diagonal recurrence) is inherently sequential:
its input projection is one matmul over the whole sequence, and the
recurrent term and the gating run one step at a time in
:class:`SLSTMScan`, one autograd node over the sequence: a step is the
recurrent product (``torch.bmm``) and one cell kernel each way
(``kernels/slstm.py``; its plain version on the CPU).

Casts sit where the JAX package puts them: the gates, the stabilizers and
the states ``c``, ``n``, ``m`` in f32; ``silu`` and GELU in f32 and back to
the activations' dtype; the sLSTM recurrent product in the weights' dtype
before its cast to f32; the sLSTM ``h`` and the conv taps in the
activations' dtype. ``jax.nn.gelu`` is the tanh approximation and
``jnp.var`` the population variance (the mean of squared deviations), and
so are theirs here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import slstm as slstm_kernels
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import _causal_conv

NEG = -1e30


def _dims(cfg: ModelConfig):
    x = cfg.xlstm
    d = cfg.d_model
    di = int(x.m_proj_factor * d)      # mLSTM inner width
    nh = cfg.n_heads
    dh = di // nh
    return d, di, nh, dh


def _silu(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_spec(cfg: ModelConfig) -> dict:
    """One mLSTM layer's leaves, unstacked (``param_spec`` stacks them)."""
    d, di, nh, dh = _dims(cfg)
    k = cfg.xlstm.conv_kernel
    f32 = torch.float32
    return {
        "ln": ParamSpec((d,), ("embed",), dtype=f32, init="ones"),
        "up": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamSpec((k, di), ("conv", "mlp")),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros"),
        "wq": ParamSpec((di, di), ("mlp", "mlp")),
        "wk": ParamSpec((di, di), ("mlp", "mlp")),
        "wv": ParamSpec((di, di), ("mlp", "mlp")),
        "wif": ParamSpec((di, 2 * nh), ("mlp", "heads"), dtype=f32),
        "b_if": ParamSpec((2 * nh,), ("heads",), dtype=f32, init="zeros"),
        "gn": ParamSpec((di,), ("mlp",), dtype=f32, init="ones"),
        "down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _mlstm_qkvgates(p, x_in: torch.Tensor, cfg: ModelConfig,
                    conv_state: Optional[torch.Tensor] = None):
    """Shared projections. x_in: (B,L,d) already layer-normed."""
    d, di, nh, dh = _dims(cfg)
    xm, z = torch.chunk(x_in @ p["up"], 2, dim=-1)
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"], conv_state)
    xc = _silu(xc, x_in.dtype)
    b, l = x_in.shape[:2]
    q = (xc @ p["wq"]).reshape(b, l, nh, dh)
    k = (xc @ p["wk"]).reshape(b, l, nh, dh)
    v = (xm @ p["wv"]).reshape(b, l, nh, dh)
    gates = xm.float() @ p["wif"] + p["b_if"]
    li = gates[..., :nh]                                   # (B,L,nh) log input
    lf = F.logsigmoid(gates[..., nh:])                     # (B,L,nh) log forget
    k = k / math.sqrt(dh)
    return q, k, v, li, lf, z, new_conv


def _mlstm_chunk(q, k, v, li, lf, state):
    """Exact chunkwise mLSTM. q,k,v: (B,L,nh,dh); li,lf: (B,L,nh).

    state: (C (B,nh,dh,dh), n (B,nh,dh), m (B,nh)) stabilized.
    Returns (h (B,L,nh,dh), new state) as new tensors.
    """
    c_in, n_in, m_in = state
    l = q.shape[1]
    b = torch.cumsum(lf, dim=1)                            # (B,L,nh)
    # per-position stabilizer
    intra_max = torch.cummax(li - b, dim=1).values
    m_t = b + torch.maximum(m_in[:, None, :], intra_max)   # (B,L,nh)
    # intra-chunk weights W[t,s] = exp(b_t - b_s + li_s - m_t), s<=t
    lw = (b[:, :, None, :] - b[:, None, :, :]
          + li[:, None, :, :] - m_t[:, :, None, :])        # (B,t,s,nh)
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=q.device))
    w = torch.exp(torch.where(causal[None, :, :, None], lw,
                              torch.full_like(lw, NEG)))
    scores = torch.einsum("blhd,bshd->blsh", q, k)         # (B,t,s,nh)
    sw = scores.float() * w
    vf = v.float()
    kf = k.float()
    qf = q.float()
    h_intra = torch.einsum("blsh,bshd->blhd", sw, vf)
    den_intra = sw.sum(dim=2)                              # (B,t,nh)
    # inter-chunk term
    w_inter = torch.exp(b + m_in[:, None, :] - m_t)        # (B,L,nh)
    h_inter = torch.einsum("blhd,bhde->blhe", qf, c_in) * w_inter[..., None]
    den_inter = torch.einsum("blhd,bhd->blh", qf, n_in) * w_inter
    num = h_intra + h_inter
    den = den_intra + den_inter
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    # chunk-final state (stepwise state at t=L)
    m_out = m_t[:, -1, :]                                  # (B,nh)
    wc = torch.exp(b[:, -1:, :] - b + li - m_out[:, None, :])  # (B,s,nh)
    decay = torch.exp(b[:, -1, :] + m_in - m_out)          # (B,nh)
    c_out = (decay[:, :, None, None] * c_in
             + torch.einsum("bshd,bshe->bhde", wc[..., None] * kf, vf))
    n_out = (decay[:, :, None] * n_in
             + torch.einsum("bsh,bshd->bhd", wc, kf))
    return h.to(q.dtype), (c_out, n_out, m_out)


def _mlstm_out(p, x: torch.Tensor, h: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Group norm, the output gate and the down projection, residual."""
    d, di, nh, dh = _dims(cfg)
    h = _groupnorm(h, p["gn"], nh, cfg.norm_eps)
    h = h * _silu(z, h.dtype)
    return x + h @ p["down"]


def mlstm_mixer(p, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Full-sequence mLSTM via the chunk scan. x: (B,L,d) pre-norm residual
    input; with ``return_state`` also the final ``{'c','n','m','conv'}``."""
    d, di, nh, dh = _dims(cfg)
    x_in = rmsnorm({"scale": p["ln"]}, x, cfg.norm_eps)
    q, k, v, li, lf, z, conv_state = _mlstm_qkvgates(p, x_in, cfg)
    bsz, l = x.shape[:2]
    chunk = min(cfg.xlstm.chunk, l)
    if l % chunk:
        chunk = l
    state = (
        torch.zeros((bsz, nh, dh, dh), dtype=torch.float32, device=x.device),
        torch.zeros((bsz, nh, dh), dtype=torch.float32, device=x.device),
        torch.full((bsz, nh), NEG, dtype=torch.float32, device=x.device),
    )
    hs = []
    for i in range(l // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        h_i, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], li[:, sl],
                                  lf[:, sl], state)
        hs.append(h_i)
    h = (torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]).reshape(bsz, l, di)
    out = _mlstm_out(p, x, h, z, cfg)
    if return_state:
        c, n, m = state
        return out, {"c": c, "n": n, "m": m, "conv": conv_state}
    return out


def mlstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    d, di, nh, dh = _dims(cfg)
    k = cfg.xlstm.conv_kernel
    return {
        "c": (batch, nh, dh, dh),
        "n": (batch, nh, dh),
        "m": (batch, nh),
        "conv": (batch, k - 1, di),
    }


def mlstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state):
    """Single-step mLSTM. x: (B,1,d). Returns the output and the new state
    as new tensors (the caller writes them where the state lives)."""
    d, di, nh, dh = _dims(cfg)
    x_in = rmsnorm({"scale": p["ln"]}, x, cfg.norm_eps)
    q, k, v, li, lf, z, conv = _mlstm_qkvgates(
        p, x_in, cfg, conv_state=state["conv"])
    h, (c, n, m) = _mlstm_chunk(
        q, k, v, li, lf, (state["c"], state["n"], state["m"]))
    out = _mlstm_out(p, x, h.reshape(x.shape[0], 1, di), z, cfg)
    return out, {"c": c, "n": n, "m": m, "conv": conv}


def _groupnorm(h: torch.Tensor, scale: torch.Tensor, nh: int,
               eps: float) -> torch.Tensor:
    bsz, l, di = h.shape
    dh = di // nh
    hf = h.float().reshape(bsz, l, nh, dh)
    mu = torch.mean(hf, dim=-1, keepdim=True)
    # jnp.var: the population variance, as the mean of squared deviations
    var = torch.mean(torch.square(hf - mu), dim=-1, keepdim=True)
    hf = (hf - mu) * torch.rsqrt(var + eps)
    return (hf.reshape(bsz, l, di) * scale).to(h.dtype)


def mlstm_mixer_reference(p, x: torch.Tensor, cfg: ModelConfig):
    """Stepwise oracle for the chunkwise form (tests)."""
    d, di, nh, dh = _dims(cfg)
    x_in = rmsnorm({"scale": p["ln"]}, x, cfg.norm_eps)
    q, k, v, li, lf, z, _ = _mlstm_qkvgates(p, x_in, cfg)
    bsz, l = x.shape[:2]
    c = torch.zeros((bsz, nh, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((bsz, nh, dh), dtype=torch.float32, device=x.device)
    m = torch.full((bsz, nh), NEG, dtype=torch.float32, device=x.device)
    hs = []
    for t in range(l):
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        fs = torch.exp(lf[:, t] + m - m_new)
        is_ = torch.exp(li[:, t] - m_new)
        kt, vt, qt = k[:, t].float(), v[:, t].float(), q[:, t].float()
        kv = torch.einsum("bhd,bhe->bhde", kt, vt)
        c = fs[..., None, None] * c + is_[..., None, None] * kv
        n = fs[..., None] * n + is_[..., None] * kt
        m = m_new
        num = torch.einsum("bhd,bhde->bhe", qt, c)
        den = torch.einsum("bhd,bhd->bh", qt, n)
        h = num / torch.maximum(torch.abs(den), torch.exp(-m))[..., None]
        hs.append(h.reshape(bsz, di))
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _mlstm_out(p, x, h, z, cfg)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_spec(cfg: ModelConfig) -> dict:
    """One sLSTM layer's leaves, unstacked (``param_spec`` stacks them)."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    df = int(cfg.xlstm.s_proj_factor * d)
    f32 = torch.float32
    return {
        "ln": ParamSpec((d,), ("embed",), dtype=f32, init="ones"),
        # i, f, z, o input projection
        "w_gates": ParamSpec((d, 4 * d), ("embed", "mlp")),
        "r_gates": ParamSpec((4, nh, dh, dh),
                             (None, "heads", "head_dim", "head_dim"),
                             scale=1.0 / math.sqrt(dh)),
        "b_gates": ParamSpec((4 * d,), ("mlp",), dtype=f32, init="zeros"),
        "gn": ParamSpec((d,), ("embed",), dtype=f32, init="ones"),
        # post-mixer gated FFN (factor 4/3)
        "ffn_ln": ParamSpec((d,), ("embed",), dtype=f32, init="ones"),
        "ffn_gate": ParamSpec((d, df), ("embed", "mlp")),
        "ffn_up": ParamSpec((d, df), ("embed", "mlp")),
        "ffn_down": ParamSpec((df, d), ("mlp", "embed")),
    }


def _recurrent_weights(r_gates: torch.Tensor) -> torch.Tensor:
    """``r_gates`` (4, nh, dh, dh) as the (nh, dh, 4 dh) right operand of
    the step's batched product, made once before the time loop: an
    einsum would copy it into this layout at every step, and autograd
    would keep every copy for the backward (8 MB a step at xlstm-1.3b's
    width, 34 GB over 4096 steps)."""
    g, nh, dh, _ = r_gates.shape
    return r_gates.permute(1, 2, 0, 3).reshape(nh, dh, g * dh)


def _slstm_step(cfg: ModelConfig, gx: torch.Tensor, state: dict,
                r: torch.Tensor) -> dict:
    """One step of the plain time loop (the reference :class:`SLSTMScan`
    is held to): gx: (B,4d) pre-projected gate inputs (the input
    projection is one matmul over the whole sequence, outside the time
    loop); state: {'c','n','m','h'} (B,nh,dh); r: :func:`_recurrent_weights`
    of ``p["r_gates"]``. Returns the new state."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    # gr[g, b, h, e] = sum_d h[b, h, d] r_gates[g, h, d, e], the JAX
    # package's einsum("bhd,ghde->gbhe"), as one batched product per head
    gr = torch.bmm(h.to(r.dtype).transpose(0, 1), r).float()
    gr = gr.view(nh, -1, 4, dh).permute(2, 1, 0, 3)        # (4,B,nh,dh)
    gi, gf, gz, go = (gx.float().view(-1, 4, nh, dh).transpose(0, 1)
                      + gr).unbind(0)
    m_new = torch.maximum(gf + m, gi)
    fs = torch.exp(gf + m - m_new)
    is_ = torch.exp(gi - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = fs * c + is_ * z
    n_new = fs * n + is_
    # jnp.maximum, not clamp: a tie hands half the cotangent to each side
    nd = torch.maximum(n_new, torch.full_like(n_new, slstm_kernels.N_FLOOR))
    h_new = o * c_new / nd
    return {"c": c_new, "n": n_new, "m": m_new,
            "h": h_new.to(state["h"].dtype)}


def slstm_loop(cfg: ModelConfig, gx_all: torch.Tensor, r: torch.Tensor,
               state: dict, r_dtype: Optional[torch.dtype] = None
               ) -> tuple[torch.Tensor, dict]:
    """The plain time loop over (B,L,4d) gate inputs: ``(h (B,L,d) in
    h's dtype, final state)``. The reference of :class:`SLSTMScan`: the
    same arithmetic with one autograd node an op.

    ``r_dtype``: each step casts ``r`` to it. With ``r`` in f32 and
    ``r_dtype`` bf16 the forward is that of a bf16 ``r``, bit for bit,
    and autograd sums the steps' bf16 contributions to r's gradient in
    f32, where with a bf16 ``r`` it adds them in bf16, rounding the
    running sum L times."""
    bsz, l, _ = gx_all.shape
    hs = []
    # the steps' views in one op: its backward stacks the L gradients
    # once, where L ``gx_all[:, t]`` would each write a zero gradient of
    # gx_all's whole size and add it in (the same bits, L times the bytes)
    for gx in gx_all.unbind(1):
        state = _slstm_step(cfg, gx, state,
                            r if r_dtype is None else r.to(r_dtype))
        hs.append(state["h"])
    return torch.stack(hs, dim=1).reshape(bsz, l, -1), state


class SLSTMScan(torch.autograd.Function):
    """The sLSTM time loop over a whole sequence as one autograd node.

    ``apply(gx (B,L,4d) f32, r (nh,dh,4dh), c0, n0, m0 (B,nh,dh) f32, h0
    (B,nh,dh)) -> (h (B,L,d) in h0's dtype, c, n, m)`` (the final state's
    h is ``h[:, -1]``). Per step the forward issues the recurrent product
    ``torch.bmm(h_{t-1}, r)`` and one cell kernel
    (``kernels/slstm.py::slstm_cell``), and keeps for the backward only the
    step's input state (c, n, m in f32; h is the output, in its dtype) and
    its gate pre-activations (f32, written by the kernel: the product is
    not recomputed). The backward runs the steps in reverse, one cell
    kernel (``slstm_cell_bwd``) and ``dh_{t-1} = dgr_t . r^T``
    (``torch.bmm``) a step, then forms ``dr`` once, as one batched product
    of the stacked h_{t-1} and gate cotangents (accumulated in f32 by the
    product, rounded once to r's dtype). Without a gradient to feed it
    keeps nothing: the state alternates between two buffers.

    The buffers are made inside the function, so under a CUDA graph's
    capture they come from the graph's pool and keep their addresses.
    """

    @staticmethod
    def forward(ctx, gx, r, c0, n0, m0, h0):
        bsz, l, _ = gx.shape
        nh, dh, _ = r.shape
        d = nh * dh
        keep = any(ctx.needs_input_grad)
        f32 = dict(dtype=torch.float32, device=gx.device)
        # keep: the input state of steps 1..L-1; else two buffers in turn
        slots = torch.empty((3, max(l - 1, 0) if keep else min(l - 1, 2),
                             bsz, nh, dh), **f32)
        pre = torch.empty((bsz, l, 4 * d), **f32) if keep else None
        hs = torch.empty((bsz, l, d), dtype=h0.dtype, device=gx.device)
        final = [torch.empty((bsz, nh, dh), **f32) for _ in range(3)]
        c0, n0, m0 = (t.contiguous() for t in (c0, n0, m0))
        state = (c0, n0, m0)
        # every step's views in one op each (a slice a step would be one)
        gx_t, hs_t = gx.unbind(1), hs.unbind(1)
        pre_t = pre.unbind(1) if keep else (None,) * l
        outs = [slots[:, i].unbind(0) for i in range(slots.shape[1])]
        for t in range(l):
            hp = h0 if t == 0 else hs_t[t - 1].view(bsz, nh, dh)
            gr = torch.bmm(hp.to(r.dtype).transpose(0, 1), r)
            out = final if t == l - 1 else outs[t if keep else t % 2]
            slstm_kernels.slstm_cell(gx_t[t], gr, *state, *out, pre_t[t],
                                     hs_t[t])
            state = out
        if keep:
            ctx.save_for_backward(pre, slots, hs, c0, n0, m0, h0, r)
        return hs, final[0], final[1], final[2]

    @staticmethod
    def backward(ctx, dhs, dc_l, dn_l, dm_l):
        pre, slots, hs, c0, n0, m0, h0, r = ctx.saved_tensors
        bsz, l, d = hs.shape
        dhs = None if dhs is None else dhs.contiguous()
        nh, dh, dh4 = r.shape
        carry = []
        for g in (dc_l, dn_l, dm_l):
            carry.append(g.float().clone() if g is not None
                         else torch.zeros_like(c0))
        dgx = torch.empty_like(pre)
        # the gate cotangents, stacked (nh, L, B, 4dh) for dr's product
        dgr = torch.empty((nh, l, bsz, dh4), dtype=r.dtype, device=r.device)
        rt = r.transpose(1, 2)
        dhr = None
        pre_t, dgx_t, dgr_t = pre.unbind(1), dgx.unbind(1), dgr.unbind(1)
        dhs_t = (None,) * l if dhs is None else dhs.unbind(1)
        ins = [slots[:, i].unbind(0) for i in range(slots.shape[1])]
        for t in reversed(range(l)):
            state = (c0, n0, m0) if t == 0 else ins[t - 1]
            slstm_kernels.slstm_cell_bwd(pre_t[t], *state, dhs_t[t], dhr,
                                         *carry, dgx_t[t], dgr_t[t])
            dhr = torch.bmm(dgr_t[t], rt)                 # (nh, B, dh)
        # dr[h] = sum_{t,b} h_{t-1}[b,h]^T dgr_t[h,b]: one product
        hprev = torch.empty((nh, l, bsz, dh), dtype=r.dtype, device=r.device)
        hprev[:, 0].copy_(h0.transpose(0, 1))
        if l > 1:
            hprev[:, 1:].copy_(hs[:, :-1].view(bsz, l - 1, nh, dh)
                               .permute(2, 1, 0, 3))
        dr = torch.bmm(hprev.view(nh, l * bsz, dh).transpose(1, 2),
                       dgr.view(nh, l * bsz, dh4))
        dh0 = dhr.transpose(0, 1).to(h0.dtype)
        return (dgx, dr, *carry, dh0)


def slstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    s = (batch, nh, dh)
    return {"c": s, "n": s, "m": s, "h": s}


def slstm_mixer(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None):
    """Sequential sLSTM over (B,L,d); returns (y, final state)."""
    bsz, l, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    x_in = rmsnorm({"scale": p["ln"]}, x, cfg.norm_eps)
    if state is None:
        z = torch.zeros((bsz, nh, dh), dtype=torch.float32, device=x.device)
        state = {"c": z, "n": z, "m": z - 1e30, "h": z.to(x.dtype)}
    gx_all = x_in @ p["w_gates"] + p["b_gates"]            # (B,L,4d) f32
    r = _recurrent_weights(p["r_gates"])
    hs, c, n, m = SLSTMScan.apply(gx_all, r, state["c"], state["n"],
                                  state["m"], state["h"])
    state = {"c": c, "n": n, "m": m, "h": hs[:, -1].view(bsz, nh, dh)}
    h = hs.to(x.dtype)
    h = _groupnorm(h, p["gn"], nh, cfg.norm_eps)
    y = x + h
    # post FFN
    yn = rmsnorm({"scale": p["ffn_ln"]}, y, cfg.norm_eps)
    g = yn @ p["ffn_gate"]
    u = yn @ p["ffn_up"]
    hf = F.gelu(g.float(), approximate="tanh").to(y.dtype) * u
    return y + hf @ p["ffn_down"], state


def slstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """Single-step sLSTM (the mixer at L = 1 from ``state``)."""
    return slstm_mixer(p, x, cfg, state)
