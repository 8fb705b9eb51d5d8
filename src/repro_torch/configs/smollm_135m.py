"""smollm-135m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    rules="pure_dp",       # 135M: TP would waste the 'model' axis; run 256-way DP
    source="hf:HuggingFaceTB/SmolLM-135M",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_ff=96,
        vocab_size=257,
        tie_embeddings=True,
        rules="pure_dp",
        q_chunk=16,
        kv_chunk=16,
    )
