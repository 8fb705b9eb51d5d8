"""Config system: model configs, shape sets and the config registry.

Each architecture the port runs gets one module in this package defining
``CONFIG`` (the exact published numbers) and ``smoke()`` (a reduced config
of the same family for CPU tests). ``get(name)`` resolves either. The port
carries the dense, MoE, hybrid and ssm (xLSTM) families; the other
families of the JAX package are listed so that asking for one names the
ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert ffn hidden
    n_shared_experts: int = 0
    first_dense: int = 0          # leading dense layers (deepseek: 3)
    dense_d_ff: int = 0           # d_ff of those dense layers
    capacity_factor: float = 1.25
    token_chunk: int = 32768      # GShard dispatch group
    router_aux_weight: float = 0.001
    router_z_weight: float = 0.0001
    # split each chunk into n_groups dispatch groups, each routed and
    # dispatched on its own (the JAX package's DP-local variant)
    grouped_dispatch: bool = False
    n_groups: int = 16


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # one sLSTM block per this many blocks
    m_proj_factor: float = 2.0
    s_proj_factor: float = 4.0 / 3.0
    chunk: int = 128
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm (ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mtp_weight: float = 0.0       # deepseek multi-token-prediction loss weight
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid attention (hymba): sliding window on all but the global layers
    swa_window: int = 0           # 0 -> full attention everywhere
    n_global_layers: int = 0      # leading/middle/trailing full-attn layers
    # attention chunking (flash) — bounds prefill's live score memory
    q_chunk: int = 512
    kv_chunk: int = 1024
    # training: recompute each block in the backward pass instead of
    # keeping its activations (torch.utils.checkpoint per block)
    remat: bool = True
    rules: str = "default"        # sharding policy name (kept for parity)
    # which shapes this arch supports (long_500k only for sub-quadratic)
    sub_quadratic: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        from repro_torch.models import params as P  # local: avoids a cycle
        from repro_torch.models import transformer
        return P.param_count(transformer.param_spec(self))

    def n_active_params(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        total = self.n_params()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        n_moe_layers = self.n_layers - m.first_dense
        inactive = (m.n_experts - m.top_k) * per_expert * n_moe_layers
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# smoke-test shape (CPU, tiny)
SMOKE_SHAPE = ShapeConfig("smoke", "train", 64, 2)


ARCH_IDS: Sequence[str] = (
    "granite-3-2b",
    "qwen3-4b",
    "smollm-135m",
    "qwen1.5-110b",
    "musicgen-medium",
    "deepseek-v3-671b",
    "moonshot-v1-16b-a3b",
    "internvl2-26b",
    "hymba-1.5b",
    "xlstm-1.3b",
)

_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "qwen3-4b": "qwen3_4b",
    "smollm-135m": "smollm_135m",
    "qwen1.5-110b": "qwen1_5_110b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-1.3b": "xlstm_1_3b",
}

# archs whose family the port does not carry yet -> that family
_NOT_PORTED = {
    "musicgen-medium": "audio",
    "internvl2-26b": "vlm",
}


def get(name: str, smoke: bool = False) -> ModelConfig:
    import importlib

    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is of the {_NOT_PORTED[name]!r} family, which "
            f"the PyTorch port does not carry yet (ROADMAP.md, queue 1: "
            f"'Other model families')")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke() if smoke else mod.CONFIG
