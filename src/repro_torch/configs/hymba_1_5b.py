"""hymba-1.5b [hybrid] — parallel attention + mamba heads, SWA + 3 global layers.

[arXiv:2411.13676; hf]. ssm_state=16. Sub-quadratic: 29/32 layers use sliding
window attention with a ring KV cache; 3 global layers keep full attention.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    swa_window=1024,
    n_global_layers=3,      # first/middle/last full-attention (hymba paper)
    sub_quadratic=True,
    rules="pure_dp",
    source="arXiv:2411.13676",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=257,
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2, chunk=16),
        swa_window=32,
        n_global_layers=1,
        sub_quadratic=True,
        rules="pure_dp",
        q_chunk=16,
        kv_chunk=16,
    )
