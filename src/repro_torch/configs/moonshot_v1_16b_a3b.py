"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]. GQA with kv=16 (MHA) and 48 layers,
as the JAX package's config has them (the published Moonlight-16B-A3B has
27 layers and MLA); 2 shared experts per the Moonlight family.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared_experts=2,
        first_dense=1,
        dense_d_ff=11264,
        capacity_factor=1.25,
        token_chunk=32768,
    ),
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=257,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_expert=96,
            n_shared_experts=2,
            first_dense=1,
            dense_d_ff=128,
            capacity_factor=2.0,
            token_chunk=64,
        ),
        q_chunk=16,
        kv_chunk=16,
    )
