"""The card's roofline constants and the model's useful FLOPs.

The JAX package's ``roofline/analysis.py`` divides by a TPU's constants.
The port runs on one NVIDIA H100 SXM, and these are its published peaks
(NVIDIA's data sheet, dense rates). They hold at the card's full power
limit of 700 W: a card set below it runs slower under load, so every
measurement placed against them names the card and its limit
(``nvidia-smi --query-gpu=name,power.limit``) beside it.

The three-term roofline of a compiled dry run (``parse_collectives``,
``RooflineReport``, ``analyze``) reads XLA's HLO and waits for the dry
run's port (ROADMAP.md, queue 1 item 9).
"""
from __future__ import annotations

DEVICE = "NVIDIA H100 SXM 80GB HBM3, 700 W power limit"
HBM_BW = 3.35e12            # B/s, HBM3 (DEVICE)
PEAK_FLOPS_BF16 = 989e12    # FLOP/s, bf16 on the tensor cores, dense (DEVICE)
PEAK_FLOPS_F32 = 67e12      # FLOP/s, f32 FMA outside the tensor cores: the
                            # spectral codec's rate, TF32 not allowed (DEVICE)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training (fwd+bwd), 2·N_active·D for
    forward-only kinds (prefill/decode), plus the causal attention term
    (4 flops per q·k pair fwd, 12 with backward)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    n = cfg.n_active_params()
    param_mult = 6.0 if shape.kind == "train" else 2.0
    attn_mult = 12.0 if shape.kind == "train" else 4.0
    base = param_mult * n * tokens
    hd = cfg.resolved_head_dim
    s_kv = shape.seq_len
    causal_frac = 0.5 if shape.kind != "decode" else 1.0
    attn = (attn_mult * cfg.n_layers * cfg.n_heads * hd * s_kv * causal_frac
            * tokens)
    return base + attn
