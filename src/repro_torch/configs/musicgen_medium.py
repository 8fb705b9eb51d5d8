"""musicgen-medium [audio] — decoder-only backbone over EnCodec tokens.

The EnCodec frontend is a STUB: a training batch carries precomputed frame
embeddings (the conditioning prefix, ``data.pipeline.synth_batch``'s
``prefix``) beside the codebook token ids. [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,         # MHA
    d_ff=6144,
    vocab_size=2048,       # EnCodec codebook size
    frontend="audio",
    frontend_tokens=64,    # conditioning frames prepended as embeddings
    source="arXiv:2306.05284",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        frontend="audio",
        frontend_tokens=4,
        q_chunk=16,
        kv_chunk=16,
    )
