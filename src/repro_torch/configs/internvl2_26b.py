"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]. The backbone is the model; a training batch carries
precomputed patch embeddings (the ViT stub, ``data.pipeline.synth_batch``'s
``prefix``) prepended to the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vit",
    frontend_tokens=1024,   # patch embeddings per image tile set
    source="arXiv:2404.16821",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=257,
        frontend="vit",
        frontend_tokens=8,
        q_chunk=16,
        kv_chunk=16,
    )
