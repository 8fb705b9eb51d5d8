"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=257,
        tie_embeddings=True,
        q_chunk=16,
        kv_chunk=16,
    )
