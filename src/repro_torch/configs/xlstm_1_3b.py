"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections instead of a separate
FFN. 48 blocks with one sLSTM per 8 (xLSTM[7:1] ratio). O(1) recurrent state:
runs the long_500k decode shape. The JAX package's dense 4096 x 4096 q/k/v
projections give 3.61 G parameters, not the published model's ~1.3 G; the
port mirrors them.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8, m_proj_factor=2.0, s_proj_factor=4.0 / 3.0,
                      chunk=128, conv_kernel=4),
    sub_quadratic=True,
    rules="pure_dp",
    source="arXiv:2405.04517",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=257,
        xlstm=XLSTMConfig(slstm_every=2, chunk=16, conv_kernel=4),
        sub_quadratic=True,
        rules="pure_dp",
        q_chunk=16,
        kv_chunk=16,
    )
