"""Modality frontend stubs of the audio and vlm families.

The audio (``musicgen-medium``) and vlm (``internvl2-26b``) archs specify
the transformer backbone only: the EnCodec frame encoder and the InternViT
patch encoder are not reproduced, as in the JAX package. A training batch
carries *precomputed* frame or patch embeddings of shape
``(batch, frontend_tokens, d_model)``; these functions only splice them in
front of the token embeddings and keep the loss off those prefix slots.
Serving uses no prefix.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def splice_prefix(token_embeds: torch.Tensor, prefix_embeds: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prepend the modality embeddings (cast to the token embeddings'
    dtype); returns ``(hidden, loss_mask)``, the mask f32, zero over the
    prefix and one over the tokens."""
    b, s_tok, _ = token_embeds.shape
    s_pre = prefix_embeds.shape[1]
    h = torch.cat([prefix_embeds.to(token_embeds.dtype), token_embeds], dim=1)
    dev = token_embeds.device
    mask = torch.cat([torch.zeros((b, s_pre), dtype=torch.float32, device=dev),
                      torch.ones((b, s_tok), dtype=torch.float32, device=dev)],
                     dim=1)
    return h, mask


def frontend_embed_shape(cfg: ModelConfig, batch: int) -> tuple:
    return (batch, cfg.frontend_tokens, cfg.d_model)
