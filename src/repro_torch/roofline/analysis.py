"""The card's roofline constants, the model's useful FLOPs, and the
three-term roofline of a dry-run cell (no card needed).

  compute    = FLOPs_per_device / PEAK_FLOPS_BF16
  memory     = bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / LINK_BW

The JAX package divides by a TPU's constants. The port runs on NVIDIA
H100 SXM cards, and these are their published peaks (NVIDIA's data
sheet, dense rates). They hold at the card's full power limit of 700 W:
a card set below it runs slower under load, so every measurement placed
against them names the card and its limit (``nvidia-smi
--query-gpu=name,power.limit``) beside it.

Collectives: for every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute, the per-device operand size times the
standard ring-algorithm wire multiplier:

  all-reduce       2 * s * (g-1)/g      (reduce-scatter + all-gather phases)
  all-gather       out * (g-1)/g        (each shard forwarded g-1 times)
  reduce-scatter   in * (g-1)/g
  all-to-all       s * (g-1)/g
  collective-permute  s                 (one hop)

The JAX package reads them from the compiled HLO (:func:`parse_collectives`,
kept here so that the same HLO text runs through both packages). The
port's dry run lowers the step on fake tensors, where no HLO exists: it
records each collective that ``distributed/sharding.py`` issues instead
(:func:`record_collectives`), as the same :class:`CollectiveOp`.
"""
from __future__ import annotations

import contextlib
import json
import re
from dataclasses import asdict, dataclass, field
from typing import Optional

DEVICE = "NVIDIA H100 SXM 80GB HBM3, 700 W power limit"
HBM_BW = 3.35e12            # B/s, HBM3 (DEVICE)
PEAK_FLOPS_BF16 = 989e12    # FLOP/s, bf16 on the tensor cores, dense (DEVICE)
PEAK_FLOPS_F32 = 67e12      # FLOP/s, f32 FMA outside the tensor cores: the
                            # spectral codec's rate, TF32 not allowed (DEVICE)
LINK_BW = 450e9             # B/s each way between two cards: NVLink 4, 900
                            # GB/s both directions (NVIDIA's H100 SXM data
                            # sheet)
HBM_BYTES = 80e9            # the card's memory, bytes (DEVICE: 80 GB)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all", "collective-permute")

# `%x.1 = bf16[16,1024]{1,0} all-gather(...)` — also matches tuple-less async
_OP_RE = re.compile(
    r"=\s*(?:\()?\s*(\w+)\[([\d,]*)\][^\s]*\s+"
    r"(all-reduce-start|all-reduce|all-gather-start|all-gather|"
    r"reduce-scatter|all-to-all|collective-permute-start|collective-permute)"
    r"\(")

_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


@dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: tuple               # the result's (an all-gather's: gathered)
    elem_bytes: int
    group_size: int
    wire_bytes: float

    @property
    def tensor_bytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * self.elem_bytes

    @property
    def operand_bytes(self) -> int:
        """Bytes one device hands to the collective: an all-gather's
        shard, a reduce-scatter's whole input, else the result's size."""
        if self.kind == "all-gather":
            return self.tensor_bytes // max(self.group_size, 1)
        if self.kind == "reduce-scatter":
            return self.tensor_bytes * self.group_size
        return self.tensor_bytes


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        first = m.group(1)
        return len([t for t in first.split(",") if t.strip() != ""])
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        # replica_groups=[G,g]<=[...]: G groups of g members
        return int(m.group(2))
    return default


def _wire_multiplier(kind: str, g: int) -> float:
    if kind.startswith("collective-permute"):
        return 1.0            # one hop, independent of any group annotation
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind.startswith("all-reduce"):
        return 2.0 * frac
    if kind.startswith("all-gather"):
        return frac           # applied to the (gathered) result size below
    if kind.startswith("reduce-scatter"):
        return frac           # applied to the (full) operand size
    if kind.startswith("all-to-all"):
        return frac
    return 1.0


def _wire(kind: str, size: int, g: int) -> float:
    """Wire bytes of a collective whose result is ``size`` bytes: an
    all-gather's result is the gathered tensor, a reduce-scatter's the
    shard (its operand is the shard times g)."""
    if kind.startswith("reduce-scatter"):
        return size * g * _wire_multiplier(kind, g)
    return size * _wire_multiplier(kind, g)


def parse_collectives(hlo_text: str, default_group: int = 1
                      ) -> list[CollectiveOp]:
    """The collectives of an HLO text (the JAX package's compiled step),
    each async pair counted once at its ``-start``."""
    ops: list[CollectiveOp] = []
    for line in hlo_text.splitlines():
        if not any(k in line for k in _COLLECTIVE_KINDS):
            continue
        if "-done" in line:          # async pair: count the -start only
            continue
        m = _OP_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        shape = tuple(int(d) for d in dims.split(",") if d) if dims else ()
        g = _group_size(line, default_group)
        if dtype not in _DTYPE_BYTES:
            # an element type of unknown width: kept with zero bytes, and
            # the report says the collective term is a lower bound
            ops.append(CollectiveOp(kind.replace("-start", ""), dtype, shape,
                                    0, g, 0.0))
            continue
        eb = _DTYPE_BYTES[dtype]
        n = 1
        for d in shape:
            n *= d
        ops.append(CollectiveOp(kind.replace("-start", ""), dtype, shape, eb,
                                g, _wire(kind, n * eb, g)))
    return ops


# ---------------------------------------------------------------------------
# the port's own lowering: collectives as they are issued
# ---------------------------------------------------------------------------

def _hlo_dtype(dtype) -> str:
    import torch

    names = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
             torch.int16: "s16", torch.float16: "f16",
             torch.bfloat16: "bf16", torch.int32: "s32",
             torch.float32: "f32", torch.int64: "s64",
             torch.float64: "f64"}
    return names.get(dtype, str(dtype).replace("torch.", ""))


def collective_op(kind: str, t, group_size: int) -> CollectiveOp:
    """The :class:`CollectiveOp` of one collective issued on ``t`` (the
    operand one rank hands over) over a group of ``group_size``: an
    all-gather's result is ``group_size`` operands stacked."""
    shape = tuple(int(s) for s in t.shape)
    if kind == "all-gather":
        shape = (group_size,) + shape
    eb = t.element_size()
    n = 1
    for d in shape:
        n *= d
    return CollectiveOp(kind, _hlo_dtype(t.dtype), shape, eb, group_size,
                        _wire(kind, n * eb, group_size))


@contextlib.contextmanager
def record_collectives():
    """Collect a :class:`CollectiveOp` for every call of
    ``distributed/sharding.py``'s ``all_gather`` (all-gather),
    ``all_reduce`` (all-reduce) and ``ring_shift`` (collective-permute)
    made on this process inside the block, in issue order. Their
    ``operand_bytes`` sum to what ``sharding.wire`` counts as ``sent``."""
    from repro_torch.distributed import sharding

    ops: list[CollectiveOp] = []

    def observe(kind, t, group_size):
        ops.append(collective_op(kind, t, group_size))

    sharding.observers.append(observe)
    try:
        yield ops
    finally:
        sharding.observers.remove(observe)


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float                    # structural model (see memory_model)
    collective_s: float
    model_flops_global: float
    useful_flops_ratio: float          # MODEL_FLOPS / (FLOPs * chips)
    bottleneck: str
    hlo_memory_s: float = 0.0          # unfused upper bound, reference only
    model_bytes_per_device: float = 0.0
    collectives_by_kind: dict = field(default_factory=dict)
    memory_per_device_bytes: Optional[dict] = None
    note: str = ""

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """useful-compute time / modelled step time (MFU-like, structural)."""
        if self.step_s <= 0 or self.chips <= 0:
            return 0.0
        ideal = self.model_flops_global / (self.chips * PEAK_FLOPS_BF16)
        return ideal / self.step_s

    def to_json(self) -> str:
        d = asdict(self)
        d["step_s"] = self.step_s
        d["roofline_fraction"] = self.roofline_fraction()
        return json.dumps(d, indent=1)


def analyze(*, arch: str, shape: str, mesh_desc: str, chips: int,
            cost: dict, model_flops_global: float, hlo_text: str = "",
            collectives: Optional[list] = None,
            memory_stats: Optional[dict] = None,
            default_group: int = 1,
            wire_bytes_override: Optional[float] = None,
            model_bytes_per_device: Optional[float] = None,
            note: str = "") -> RooflineReport:
    """The three-term report of one cell from its per-device ``cost``
    (``flops``, ``bytes accessed``) and its collectives: those parsed from
    ``hlo_text`` and those given in ``collectives`` (recorded by
    :func:`record_collectives`). ``note`` is prefixed to the report's."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    ops = parse_collectives(hlo_text, default_group) + list(collectives or [])
    wire = (wire_bytes_override if wire_bytes_override is not None
            else sum(o.wire_bytes for o in ops))
    by_kind: dict[str, dict] = {}
    unknown = [o for o in ops if o.elem_bytes == 0]
    for o in ops:
        e = by_kind.setdefault(o.kind, {"count": 0, "wire_bytes": 0.0,
                                        "tensor_bytes": 0})
        e["count"] += 1
        e["wire_bytes"] += o.wire_bytes
        e["tensor_bytes"] += o.tensor_bytes
        if o.elem_bytes == 0:
            e["unknown_dtype"] = e.get("unknown_dtype", 0) + 1
    notes = [note] if note else []
    if unknown:
        dts = ", ".join(sorted({o.dtype for o in unknown}))
        notes.append(f"{len(unknown)} collective op(s) with unknown dtype(s) "
                     f"[{dts}] counted with zero wire bytes — collective term "
                     "is a lower bound")
    compute_s = flops / PEAK_FLOPS_BF16
    hlo_memory_s = byts / HBM_BW
    mem_bytes = (model_bytes_per_device if model_bytes_per_device is not None
                 else byts)
    memory_s = mem_bytes / HBM_BW
    collective_s = wire / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = (model_flops_global / (flops * chips)) if flops > 0 else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        hlo_flops_per_device=flops, hlo_bytes_per_device=byts,
        wire_bytes_per_device=wire, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, model_flops_global=model_flops_global,
        useful_flops_ratio=useful, bottleneck=bottleneck,
        hlo_memory_s=hlo_memory_s,
        model_bytes_per_device=float(mem_bytes),
        collectives_by_kind=by_kind, memory_per_device_bytes=memory_stats,
        note="; ".join(notes))


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training (fwd+bwd), 2·N_active·D for
    forward-only kinds (prefill/decode), plus the causal attention term
    (4 flops per q·k pair fwd, 12 with backward)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    n = cfg.n_active_params()
    param_mult = 6.0 if shape.kind == "train" else 2.0
    attn_mult = 12.0 if shape.kind == "train" else 4.0
    base = param_mult * n * tokens
    hd = cfg.resolved_head_dim
    s_kv = shape.seq_len
    causal_frac = 0.5 if shape.kind != "decode" else 1.0
    attn = (attn_mult * cfg.n_layers * cfg.n_heads * hd * s_kv * causal_frac
            * tokens)
    return base + attn
