"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

[arXiv:2412.19437; hf]. d_ff=2048 is the per-expert (moe) intermediate; the
first 3 layers are dense with d_ff 18432 (the published first_k_dense_replace).
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,        # MLA: per-head KV derived from the shared latent
    d_ff=2048,
    vocab_size=129280,
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_expert=2048,
        n_shared_experts=1,
        first_dense=3,
        dense_d_ff=18432,
        capacity_factor=1.25,
        token_chunk=32768,
    ),
    mtp_weight=0.3,
    source="arXiv:2412.19437",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke",
        family="moe",
        n_layers=3,            # 1 dense + 2 moe
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=257,
        mla=MLAConfig(q_lora=32, kv_lora=24, qk_nope=16, qk_rope=8, v_head=16),
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_expert=96,
            n_shared_experts=1,
            first_dense=1,
            dense_d_ff=128,
            capacity_factor=2.0,
            token_chunk=64,
        ),
        mtp_weight=0.3,
        q_chunk=16,
        kv_chunk=16,
    )
