"""qwen3-4b [dense] — qk_norm, GQA, explicit head_dim=128. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,          # Qwen3 family decouples head_dim from d_model/n_heads
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=257,
        head_dim=24,       # decoupled head_dim exercised in smoke too
        qk_norm=True,
        q_chunk=16,
        kv_chunk=16,
    )
