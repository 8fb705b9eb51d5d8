"""Structural HBM-traffic model (fusion-aware), per device per step.

Summing the bytes of every dispatched op (the dry run's ``bytes
accessed``, the counterpart of XLA's) treats every op as if its operands
streamed from HBM: with no fusion credit it overstates traffic many times
over and would mark every cell memory-bound. The roofline's memory term
instead uses this structural model of the traffic that must cross HBM
(weights streamed once per use, activations at remat boundaries,
optimizer state read and written, the KV cache streamed per token); the
summed op bytes stay in the report as ``hlo_memory_s``. The formula is
the JAX package's, term for term.

It assumes compute split over 'model' (``P_use / TP``, ``vocab / TP``), as
XLA's partitioner splits it. The port's sharded step shards its memory
(each block gathered inside its remat region, its gradient
reduce-scattered into the rank's shard) but not its compute yet: each
rank computes every row of its ('pod', 'data') slice on whole blocks
(ROADMAP queue 1, item 5.3's compute over 'model'), so on a mesh with
'model' > 1 the model is below what the port's step moves.

Terms (per device):
  train:   state shards r/w (params, mu, nu, grads)            8 x P/chips
           gathered weights, fwd + bwd reads                   2 x P_use/TP
           activations: ~8 passes x tokens_local x d x L x 2B  (remat: save
             boundary, recompute fwd, bwd read/write)
           logits + CE: ~6 passes x tokens_local x V/TP x 2B
  prefill: 1 x gathered weights + ~4 activation passes + cache write
  decode:  1 x gathered ACTIVE weights + full cache read + tiny vectors
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _mesh_sizes(mesh):
    return dict(mesh.shape)


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                          cache_bytes: int = 0) -> float:
    """``mesh``: anything with ``.shape``, an axis name -> size mapping (a
    ``sharding.MeshShape``)."""
    sizes = _mesh_sizes(mesh)
    chips = int(np.prod(list(sizes.values())))
    tp = sizes.get("model", 1)
    dp = max(chips // tp, 1)
    d = cfg.d_model
    L = cfg.n_layers
    P = 2.0 * cfg.n_params()            # bf16 total param bytes
    P_active = 2.0 * cfg.n_active_params()
    vocab_local = cfg.padded_vocab / tp * 2.0  # bf16 logits slice per tok

    if shape.kind == "train":
        tokens_local = shape.global_batch * shape.seq_len / dp
        state_io = 8.0 * P / chips                      # p,mu,nu r/w + g r/w
        weights_io = 2.0 * P_active / tp                # fwd + bwd streams
        act_io = 8.0 * tokens_local * d * 2.0 * L
        logits_io = 3.0 * tokens_local * vocab_local * 2.0   # fwd+bwd, f32ish
        return state_io + weights_io + act_io + logits_io
    if shape.kind == "prefill":
        tokens_local = shape.global_batch * shape.seq_len / dp
        weights_io = P_active / tp
        act_io = 4.0 * tokens_local * d * 2.0 * L
        cache_io = cache_bytes / chips
        return weights_io + act_io + cache_io
    # decode: one token per sequence
    tokens_local = shape.global_batch / dp if shape.global_batch >= dp else 1
    weights_io = P_active / tp
    cache_io = cache_bytes / chips                      # stream the cache
    act_io = 4.0 * tokens_local * d * 2.0 * L
    return weights_io + cache_io + act_io
