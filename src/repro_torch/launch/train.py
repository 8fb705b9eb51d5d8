"""Training: the train step factory (one device, or sharded across
processes) and the end-to-end loop.

The loop wires the substrate together: data prefetcher, the in-situ
session (gradient-health analytics + checkpointing, declared as one plan),
straggler monitor, restore-on-start. It runs on the card by default
(``device="cuda"``) and raises without CUDA; ``device="cpu"`` runs it on
the CPU at smoke size.

Shapes: ``smoke=True`` is the CPU smoke shape (2 x 64 tokens);
``smoke=False`` is :data:`FULL_SHAPE`, ``train_4k``'s sequence length of
4096 with the global batch of 256 cut to 4, so that one card and the
smoke's time limit hold it. A frontend arch (audio, vlm) adds its
``frontend_tokens`` precomputed embeddings in front of each row (the
batch's f32 ``prefix``, ``(B, frontend_tokens, d_model)``: 4 x 64 x 1536
for ``musicgen-medium``), so its logits span ``frontend_tokens + 4096``
positions a row; the loss skips the prefix.

The step: :func:`make_train_step` is the functional step (the eager
oracle and the CPU path). On CUDA the loop runs :func:`graph_train_step`,
the counterpart of the JAX package's ``jit_train_step(donate=True)``: the
same step captured once in a CUDA graph and replayed, writing the new
state into the old state's tensors.

In-situ placements: ``insitu_mode`` places the plan's tasks SYNC (the
loop waits for the whole chain), ASYNC (the loop pays only the hand-off
dispatch; the checkpoint's lossy stage then runs per leaf on the workers,
each on its own CUDA stream) or HYBRID (the lossy stage runs on the loop's
stream before the hand-off, one fused dispatch). All three run on the
card.

Families trained on the card at ``FULL_SHAPE``, eager and graphed: the
dense ``smollm-135m`` (30 layers; the smoke cuts it to 10),
``musicgen-medium`` (48 layers), ``hymba-1.5b`` (32 layers in
``tools/torch_family_train.py``, 4 in the smoke) and ``xlstm-1.3b``
(48 blocks in the tool, one super-block of 8 in the smoke), the last two
with a HYBRID save and a resume. The MoE/MLA archs (``moonshot-v1-16b-a3b``,
``deepseek-v3-671b``) train on the card at their smoke configs only, and
``internvl2-26b`` not at all: their full-width states do not fit one
card (ROADMAP item 5).

Placement: :func:`state_spec` / :func:`batch_abstract` give meta-device
stand-ins of the state and the batch, :func:`state_shardings` /
:func:`batch_shardings` their DTensor placements on a ``DeviceMesh``
under the logical-axis rules (``distributed/sharding.py``); an elastic
restore (``Session.restore(elastic=True, make_shardings=...)``) places a
checkpoint under them. The loop records its mesh geometry (one device:
``(1, 1)`` over ``('data', 'model')``) with every checkpoint, and with
``default_train_plan(fault=True)`` beats a ``health`` stream each step
for the ``fault`` preset.

The sharded step: :func:`jit_train_step` steps a state of DTensors
placed under :func:`state_shardings` — parameters and moments FSDP over
'data', TP/EP over 'model', replicated over 'pod' — with the batch's rows
over ('pod', 'data'), one process a mesh device. It runs eagerly, with no
collective inside a CUDA graph. The model gets each rank's shards
(``distributed/sharding.py::ShardedLeaf``) and a ``BlockGather``: the
leaves outside the block stacks (``embed``, ``final_norm``, MTP) are
gathered whole before the forward, as the JAX package's are; each block
is gathered whole inside its remat region (``models/transformer.py::
_run_blocks``), so a whole block lives only during its forward and its
recompute in the backward. Autograd's leaves are the shards, and each
gradient comes back as the rank's shard: summed in f32 and
reduce-scattered over the mesh dims that split the rows (all-reduced
where a dim splits the rows but not the leaf), divided by their ranks,
chunked over 'model'. No whole list of parameters or gradients exists.
The global norm sums each leaf's squares layer by layer in flatten
order (``optim/adamw.py::global_norm``'s order, which the one-device
step shares): where no dim splits the rows every rank squares each
whole gradient before it takes its shard, so (1, 2) is the one-device
step bit for bit; elsewhere each shard is counted once and the sums are
all-reduced. AdamW then runs in place on the rank's own shards of
params, moments and masters (``optim.adamw.update_``). With
``grad_compress`` other than ``none`` and more than one pod, each pod's
gradient is exact within the pod and crosses the pods through
``optim/grad_compress.py``'s ring with error feedback (the residual in
the state's ``ef``, its leading axis over 'pod'), the embedding gathers
hoisted out and reduced exactly, as the JAX package's
``_pod_ring_grads`` does. The collectives stage through host buffers on
a gloo group, so two processes can share one card
(``distributed/sharding.py``). :func:`gather_state` gathers a sharded
state whole on every rank (what a save emits).

What the sharded step does not do yet: split the compute over 'model'.
Each rank computes every row of its ('pod', 'data') slice on whole
blocks (tensor, expert and vocabulary parallelism are the next slice,
ROADMAP item 5.3), so 'model' shards memory but not matmuls.
``StepConfig`` has no ``remat``: the JAX package's field is read
nowhere; remat follows ``cfg.remat``. Every config has it on; without
it (the dry run's tests lower the step so, for fewer ops) autograd keeps
each gathered block for the backward, a whole copy of the blocks.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import base as configs
from repro_torch.core import host
from repro_torch.core.graphs import CapturedStep
from repro_torch.core.pytree import flatten_with_path, keystr, leaves, \
    tree_map, unflatten_like
from repro_torch.distributed import sharding
from repro_torch.models import params as P_lib
from repro_torch.models import transformer
from repro_torch.optim import grad_compress

PyTree = Any

#: train_4k's sequence length; its global batch of 256 cut to 4 (one card)
FULL_SHAPE = configs.ShapeConfig(
    "train_4k_b4", "train", configs.SHAPES["train_4k"].seq_len, 4)

#: the mesh ``train_loop`` steps on: one device
LOOP_MESH = sharding.abstract_mesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_state(cfg: configs.ModelConfig, seed: int | torch.Generator,
               opt_cfg: optim.AdamWConfig, *,
               device: str | torch.device = "cuda",
               ef_residual: bool = False) -> dict:
    """Seeded random parameters (from ``seed``'s CPU generator, or the
    generator given) and zero AdamW moments on ``device``.
    ``ef_residual`` adds ``grad_compress.ef_init(params)``, shaped like
    the parameters as in the JAX package; the sharded step's residual
    carries a leading pod axis (``state_spec(ef_pods=n)``)."""
    dev = host.resolve_device(device)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    params = P_lib.materialize(gen, transformer.param_spec(cfg), dev)
    ostate = optim.init(params, opt_cfg)
    state = {"params": params, "mu": ostate.mu, "nu": ostate.nu,
             "count": ostate.count}
    if opt_cfg.master_weights:
        state["master"] = ostate.master
    if ef_residual:
        state["ef"] = grad_compress.ef_init(params)
    return state


def state_spec(cfg: configs.ModelConfig, *, master: bool = False,
               ef_pods: int = 0) -> dict:
    """Meta-device stand-ins of the training state (the restore template
    and what placement rules are evaluated on): bf16 moments, an int32
    step count, f32 masters with ``master``, a per-pod bf16 residual with
    a leading pod axis with ``ef_pods``."""
    pspec = transformer.param_spec(cfg)
    params = P_lib.abstract(pspec)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    mom = lambda: tree_map(lambda t: meta(t.shape, torch.bfloat16), params)
    state = {"params": params, "mu": mom(), "nu": mom(),
             "count": meta((), torch.int32)}
    if master:
        state["master"] = tree_map(lambda t: meta(t.shape, torch.float32),
                                   params)
    if ef_pods:
        state["ef"] = tree_map(
            lambda t: meta((ef_pods,) + tuple(t.shape), torch.bfloat16),
            params)
    return state


def state_shardings(cfg: configs.ModelConfig, mesh, rules=None, *,
                    master: bool = False, ef_residual: bool = False) -> dict:
    """DTensor placements of the training state on ``mesh`` (a
    ``DeviceMesh`` with axis names): params and both moments under the
    logical-axis ``rules`` (default ``sharding.DEFAULT_RULES``), the count
    replicated, the residual's leading axis over 'pod'."""
    rules = rules if rules is not None else sharding.DEFAULT_RULES
    pspec = transformer.param_spec(cfg)
    axes = P_lib.logical_axes(pspec)
    abstract = P_lib.abstract(pspec)
    pspecs = sharding.tree_partition_specs(abstract, axes, rules, mesh)
    place = lambda specs: tree_map(
        lambda _, sp: sharding.placements(sp, mesh), abstract, specs)
    pshard = place(pspecs)
    out = {"params": pshard, "mu": pshard, "nu": pshard,
           "count": sharding.placements((), mesh)}
    if master:
        out["master"] = pshard
    if ef_residual:
        out["ef"] = place(tree_map(lambda _, sp: ("pod",) + tuple(sp),
                                   abstract, pspecs))
    return out


def batch_shardings(cfg: configs.ModelConfig, shape: configs.ShapeConfig,
                    mesh, rules=None) -> dict:
    """DTensor placements of a batch on ``mesh``: rows over the data axes
    (and 'model' under the pure-DP rules)."""
    extra = sharding.batch_over_model(rules) if rules is not None else False
    bspec = sharding.batch_spec(mesh, shape.global_batch, extra_model=extra)
    pl = sharding.placements(bspec, mesh)
    out = {"tokens": pl, "labels": pl}
    if cfg.frontend:
        out["prefix"] = pl
    return out


def batch_abstract(cfg: configs.ModelConfig, shape: configs.ShapeConfig
                   ) -> dict:
    """Meta-device stand-ins of a batch: int32 tokens and labels, and a
    frontend arch's prefix embeddings (f32, as ``synth_batch`` makes
    them)."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    out = {"tokens": meta((b, s), torch.int32),
           "labels": meta((b, s), torch.int32)}
    if cfg.frontend:
        out["prefix"] = meta((b, cfg.frontend_tokens, cfg.d_model),
                             torch.float32)
    return out


def state_from_numpy(tree: PyTree, device: str | torch.device = "cuda"
                     ) -> dict:
    """A JAX-package train state (params, mu, nu, count — numpy leaves,
    e.g. after ``jax.device_get``) as the port's state on ``device``: same
    keys, shapes, dtypes and bits (bf16 through a uint16 view)."""
    dev = host.resolve_device(device)
    return tree_map(lambda a: host.to_tensor(np.asarray(a), dev), tree)


# ---------------------------------------------------------------------------
# step factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepConfig:
    opt: optim.AdamWConfig = dataclasses.field(
        default_factory=optim.AdamWConfig)
    grad_compress: str = "none"      # none | bf16 | int8 (cross-pod wire)
    lr_peak: float = 3e-4
    lr_warmup: int = 100
    lr_total: int = 10000


def _loss_grads_lr(cfg: configs.ModelConfig, step_cfg: StepConfig,
                   state: dict, batch: dict):
    """``(loss, grads, lr, gnorm, AdamWState)`` of one one-device step:
    loss and grads by autograd, the warmup-cosine schedule at the state's
    step count, the gradient's global norm."""
    params = state["params"]
    flat = flatten_with_path(params)
    live = {keystr(p): t.detach().requires_grad_(True) for p, t in flat}
    loss = transformer.train_loss(
        unflatten_like(params, live, "params"), cfg, batch)
    grads = torch.autograd.grad(loss, list(live.values()))
    grads = unflatten_like(params, dict(zip(live, grads)), "grads")
    lr = optim.schedules.warmup_cosine(
        state["count"], peak=step_cfg.lr_peak, warmup=step_cfg.lr_warmup,
        total=step_cfg.lr_total)
    ostate = optim.AdamWState(state["count"], state["mu"], state["nu"],
                              state.get("master"))
    gnorm = optim.adamw.global_norm(grads, transformer.layer_depths(cfg))
    return loss, grads, lr, gnorm, ostate


def make_train_step(cfg: configs.ModelConfig, step_cfg: StepConfig
                    ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """Returns ``train_step(state, batch) -> (new_state, metrics)`` for one
    device: loss and grads by autograd, the warmup-cosine schedule at the
    state's step count, then AdamW. The inputs are left as they were.
    The sharded step is :func:`jit_train_step`'s."""

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        loss, grads, lr, gnorm, ostate = _loss_grads_lr(cfg, step_cfg,
                                                        state, batch)
        new_params, new_ostate = optim.update(grads, ostate, state["params"],
                                              step_cfg.opt, lr=lr,
                                              gnorm=gnorm)
        new_state = dict(state)
        new_state.update(params=new_params, mu=new_ostate.mu,
                         nu=new_ostate.nu, count=new_ostate.count)
        if new_ostate.master is not None:
            new_state["master"] = new_ostate.master
        return new_state, {"loss": loss.detach().float(),
                           "grad_norm": gnorm, "lr": lr}

    return train_step


#: the token-embedding table: the leaf whose gathers the pod ring hoists
EMBED_KEY = "['embed']['embedding']"


def _moe_chunk(cfg: configs.ModelConfig, tokens: int) -> int:
    """``moe_ffn``'s chunk for a token list of ``tokens``."""
    chunk = min(cfg.moe.token_chunk, tokens)
    return tokens if tokens % chunk else chunk


class ShardedTrainStep:
    """The train step across the processes of ``mesh`` (a ``DeviceMesh``
    with axis names over every rank of the default process group, one
    device each); see the module docstring. ``step(state, batch) ->
    (new_state, metrics)`` takes and returns DTensors under
    :func:`state_shardings` / :func:`batch_shardings`; ``metrics`` are
    plain tensors, equal on every rank.

    The loss is the global batch's: the mean of the ranks' masked means.
    That needs every rank to hold as many unmasked tokens, which the
    batches of :func:`batch_shardings` do (no user mask; the prefix and
    MTP masks are per row), and, for an MoE arch, a rank's token chunks
    to be chunks of the global token list (checked). Under the pod ring
    each pod's loss, MoE aux included, is its own, and the loss is their
    mean.

    The new state is written into the input's local tensors, and the
    input's DTensors are returned (the JAX package's step donates its
    state). ``ring_probe``, where set, is called
    after the pod ring with ``(keys, pre, reduced)``: the leaves' keys,
    this rank's ring inputs (after error feedback) and outputs.
    """

    def __init__(self, cfg: configs.ModelConfig, step_cfg: StepConfig,
                 mesh, *, shape: Optional[configs.ShapeConfig] = None):
        import torch.distributed as dist

        if step_cfg.grad_compress not in grad_compress.METHODS:
            raise ValueError(f"unknown grad-compression method "
                             f"{step_cfg.grad_compress!r}")
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the sharded step's mesh of {mesh.size()} "
                             f"devices must span the default group's "
                             f"{dist.get_world_size()} ranks")
        self.cfg, self.step_cfg, self.mesh = cfg, step_cfg, mesh
        self.shape = shape
        self.sizes, self.names = sharding.mesh_geometry(mesh)
        self.n_pods = grad_compress.pod_size(mesh, "pod")
        self.use_ring = (step_cfg.grad_compress != "none"
                         and self.n_pods > 1)
        self.pod_dim = (self.names.index("pod") if "pod" in self.names
                        else None)
        self.ring_probe: Optional[Callable] = None
        flat = flatten_with_path(transformer.param_spec(cfg))
        #: per parameter leaf in flatten order: its whole shape, its
        #: leading layer axes, and whether a block stack holds it
        self.shapes = [tuple(spec.shape) for _, spec in flat]
        self.depths = leaves(transformer.layer_depths(cfg))
        self.in_blocks = [k for k, (path, _) in enumerate(flat)
                          if path[0] in transformer.BLOCK_STACKS]

    # -- collectives over mesh dims ------------------------------------------

    def _sum(self, t: torch.Tensor, dims) -> torch.Tensor:
        for i in dims:
            t = sharding.all_reduce(t, "sum", self.mesh.get_group(i))
        return t

    def _mean(self, t: torch.Tensor, dims) -> torch.Tensor:
        """The mean over the ranks along ``dims``, summed in f32, in
        ``t``'s dtype."""
        if not dims:
            return t
        k = math.prod(self.sizes[i] for i in dims)
        return (self._sum(t.float(), dims) / k).to(t.dtype)

    def _check_rows(self, batch: dict, rows: dict, row_dims) -> None:
        b_glob, seq = batch["tokens"].shape
        if self.shape is not None and (b_glob, seq) != (
                self.shape.global_batch, self.shape.seq_len):
            raise ValueError(f"batch of {b_glob} x {seq} tokens, the step "
                             f"was made for {self.shape}")
        if not row_dims:
            return
        b_loc = rows["tokens"].shape[0]
        if (self.cfg.family == "moe" and _moe_chunk(self.cfg, b_loc * seq)
                != _moe_chunk(self.cfg, b_glob * seq)):
            raise ValueError(
                f"a rank's {b_loc} x {seq} tokens are not chunks of the "
                f"global {b_glob} x {seq} (token_chunk "
                f"{self.cfg.moe.token_chunk}): MoE capacity would differ")

    @staticmethod
    def _write(tree: PyTree, new_locals: list) -> None:
        """``new_locals`` (flatten order) into the local tensors of the
        DTensors of ``tree``."""
        with torch.no_grad():
            for t, new in zip(leaves(tree), new_locals):
                t.to_local().copy_(new)

    # -- the step --------------------------------------------------------------

    def _grads(self, params: PyTree, by_key: dict, gather, rows: dict
               ) -> tuple[torch.Tensor, dict, dict]:
        """Loss and gradients of this rank's rows: ``{(leaf, layer
        index): gradient}`` of each autograd leaf of ``gather`` (its shard
        of a leaf or of a block's slice of one); under the pod ring also
        the cotangents of the hoisted embedding gathers. ``by_key``: the
        model's leaves by key, a block stack's as ``ShardedLeaf``."""
        cfg = self.cfg
        tree = unflatten_like(params, by_key, "params")
        if not self.use_ring:
            loss = transformer.train_loss(tree, cfg, rows, gather=gather)
            ids = list(gather.leaves)
            return loss, dict(zip(ids, torch.autograd.grad(
                loss, [gather.leaves[i] for i in ids]))), {}
        table = by_key[EMBED_KEY].detach()
        tok = rows["tokens"].long()
        hoisted = {"h0": table[tok]}
        if cfg.family == "moe" and cfg.mtp_weight > 0:
            hoisted["mtp_cur"] = table[tok]
            hoisted["mtp_emb"] = table[rows["labels"].long()]
        hoisted = {k: v.requires_grad_(True) for k, v in hoisted.items()}
        mtp_pre = ((hoisted["mtp_cur"], hoisted["mtp_emb"])
                   if "mtp_cur" in hoisted else None)
        loss = transformer.train_loss(tree, cfg, rows, h0=hoisted["h0"],
                                      mtp_pre=mtp_pre, gather_free=True,
                                      gather=gather)
        ids = list(gather.leaves)
        outs = torch.autograd.grad(
            loss, [gather.leaves[i] for i in ids] + list(hoisted.values()),
            materialize_grads=True)
        return (loss, dict(zip(ids, outs[:len(ids)])),
                dict(zip(hoisted, outs[len(ids):])))

    def _gather_cotangent(self, dgath: dict, rows: dict, shape: tuple,
                          row_dims) -> torch.Tensor:
        """The embedding table's (of ``shape``) gradient through the
        hoisted gathers, exact: scattered in f32, summed over every rank
        that splits the rows and divided by their count (the mean over
        pods of each pod's mean)."""
        demb = torch.zeros(shape, dtype=torch.float32,
                           device=dgath["h0"].device)
        for name, idx in (("h0", "tokens"), ("mtp_cur", "tokens"),
                          ("mtp_emb", "labels")):
            if name in dgath:
                demb.index_add_(0, rows[idx].long().reshape(-1),
                                dgath[name].reshape(-1, shape[-1]).float())
        return self._sum(demb, row_dims) / math.prod(
            self.sizes[i] for i in row_dims)

    def _first_layer(self, k: int, index: tuple) -> int:
        """The flat (row-major) number of the first layer of leaf ``k``'s
        slice at ``index``."""
        shape, depth = self.shapes[k], self.depths[k]
        flat = 0
        for i, n in zip(index, shape):
            flat = flat * n + i
        return flat * math.prod(shape[len(index):depth])

    def _squares(self, table: dict, k: int, index: tuple, g) -> None:
        """Leaf ``k``'s per-layer sums of squares from ``g``, the whole
        gradient of its slice at ``index``, into ``table`` by ``(k, flat
        layer)``. A block's slice is summed as a slice of the one-device
        step's stacked gradient is (contiguous)."""
        first = self._first_layer(k, index)
        x = g.contiguous() if index else g
        for j, sq in enumerate(optim.adamw.layer_square_sums(
                x, self.depths[k] - len(index))):
            table[(k, first + j)] = sq

    def _owns(self, pls: tuple) -> bool:
        """Whether this rank's shard of a leaf placed so is the one counted
        in the global norm: the first of the ranks that hold it."""
        coord = self.mesh.get_coordinate()
        return all(coord[i] == 0 for i, pl in enumerate(pls)
                   if self.sizes[i] > 1 and not pl.is_shard())

    def _stack(self, grads: dict, locs: list) -> list:
        """Each leaf's gradient from its slices' (``(leaf, layer index) ->
        gradient``, emptied on the way): a stacked leaf's in layer
        order."""
        by_leaf: list = [dict() for _ in locs]
        for (k, index), g in grads.items():
            by_leaf[k][index] = g
        grads.clear()
        out = []
        for k, loc in enumerate(locs):
            parts, by_leaf[k] = by_leaf[k], None
            if () in parts:
                out.append(parts.pop(()))
                continue
            n = math.prod(self.shapes[k][:self.depths[k]])
            if len(parts) != n:
                raise RuntimeError(f"leaf {k}: {len(parts)} of its {n} "
                                   f"layers have a gradient")
            out.append(torch.stack([parts[i] for i in sorted(parts)])
                       .reshape(loc.shape))
        return out

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        import torch.distributed as dist

        mesh = self.mesh
        params = state["params"]
        flat = flatten_with_path(params)
        keys = [keystr(p) for p, _ in flat]
        pls = [tuple(t.placements) for _, t in flat]
        locs = [t.to_local() for _, t in flat]
        del flat
        rows = {k: v.to_local() for k, v in batch.items()}
        row_dims = [i for i, pl in enumerate(batch["tokens"].placements)
                    if pl.is_shard() and self.sizes[i] > 1]
        self._check_rows(batch, rows, row_dims)
        if self.use_ring and self.pod_dim not in row_dims:
            raise ValueError("the pod ring needs the batch's rows split "
                             "over 'pod'")
        # the gradient is exact over the row-splitting dims, within a pod
        # under the ring ('model' replicates the rows: never reduced)
        exact_dims = [i for i in row_dims
                      if not (self.use_ring and i == self.pod_dim)]
        # where no dim splits the rows, every rank sees each slice's whole
        # gradient (the one-device step's) before it takes its shard, and
        # squares it there for the norm
        squares = None if row_dims else {}
        on_whole = (None if squares is None else
                    lambda s, g: self._squares(squares, s.key, s.index, g))
        gather = sharding.BlockGather(mesh, exact_dims, on_whole=on_whole)
        shards = [sharding.ShardedLeaf(t, pl, k)
                  for k, (t, pl) in enumerate(zip(locs, pls))]
        # the leaves outside the block stacks are gathered here, whole for
        # the step; a block's inside its remat region (``_run_blocks``)
        outside = [k for k in range(len(keys)) if k not in self.in_blocks]
        by_key = {keys[k]: shards[k] for k in self.in_blocks}
        by_key.update(zip((keys[k] for k in outside),
                          gather([shards[k] for k in outside])))
        loss, grads, dgath = self._grads(params, by_key, gather, rows)
        del by_key, shards
        if squares is not None:
            # the leaves that no collective touched: whole here
            for (k, index), g in grads.items():
                if (k, self._first_layer(k, index)) not in squares:
                    self._squares(squares, k, index, g)
        del gather
        loss = self._mean(loss.detach().float(), row_dims)
        local = self._stack(grads, locs)
        new_res = None
        if self.use_ring:
            ef = state.get("ef")
            if ef is not None:
                local = grad_compress.ef_pre(
                    local, [e.to_local()[0] for e in leaves(ef)])
            reduced = grad_compress.tree_reduce(
                local, method=self.step_cfg.grad_compress,
                group=mesh.get_group(self.pod_dim), n=self.n_pods,
                amax_group=dist.group.WORLD)
            if self.ring_probe is not None:
                self.ring_probe(keys, local, reduced)
            if ef is not None:
                new_res = [r[None] for r in
                           grad_compress.ef_post(local, reduced)]
            i = keys.index(EMBED_KEY)
            demb = self._gather_cotangent(dgath, rows, self.shapes[i],
                                          row_dims)
            reduced[i] = (reduced[i].float() + sharding.local_shard(
                demb, pls[i], mesh)).to(reduced[i].dtype)
            local = reduced
        if squares is not None:
            gnorm = torch.sqrt(optim.adamw.sum_squares(
                [[squares[(k, j)] for j in range(
                    math.prod(self.shapes[k][:self.depths[k]]))]
                 for k in range(len(keys))]))
        else:
            # each shard counted once, by the first rank that holds it
            sq = optim.adamw.sum_squares(
                [optim.adamw.layer_square_sums(g, self.depths[k])
                 if self._owns(pls[k]) else [] for k, g in enumerate(local)])
            if not torch.is_tensor(sq):
                sq = torch.zeros((), dtype=torch.float32,
                                 device=local[0].device)
            gnorm = torch.sqrt(sharding.all_reduce(sq, "sum",
                                                   dist.group.WORLD))
        count = state["count"].to_local()
        step_cfg = self.step_cfg
        lr = optim.schedules.warmup_cosine(
            count, peak=step_cfg.lr_peak, warmup=step_cfg.lr_warmup,
            total=step_cfg.lr_total)
        loc = lambda tree: [t.to_local() for t in leaves(tree)]
        master = state.get("master")
        ostate = optim.AdamWState(count, loc(state["mu"]), loc(state["nu"]),
                                  loc(master) if master is not None
                                  else None)
        # into the state's own tensors, one leaf at a time
        optim.adamw.update_(local, ostate, locs, step_cfg.opt, lr=lr,
                            gnorm=gnorm)
        if new_res is not None:
            self._write(state["ef"], new_res)
        new_state = dict(state)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics


def jit_train_step(cfg: configs.ModelConfig, mesh, step_cfg: StepConfig,
                   shape: configs.ShapeConfig, *, rules=None):
    """The sharded step (:class:`ShardedTrainStep`) and the placements of
    its inputs: ``(step, state_shardings, batch_shardings, ef)``, as the
    JAX package's ``jit_train_step`` returns them (``ef``: the state
    carries the pod ring's residual, under ``int8`` on a mesh with a 'pod'
    axis). The step runs eagerly and writes the new state into the old
    one's tensors, as the JAX package's default ``donate=True`` gives its
    buffers away."""
    rules = rules if rules is not None else sharding.DEFAULT_RULES
    _, names = sharding.mesh_geometry(mesh)
    ef = step_cfg.grad_compress == "int8" and "pod" in names
    st_sh = state_shardings(cfg, mesh, rules,
                            master=step_cfg.opt.master_weights,
                            ef_residual=ef)
    b_sh = batch_shardings(cfg, shape, mesh, rules)
    step = ShardedTrainStep(cfg, step_cfg, mesh, shape=shape)
    return step, st_sh, b_sh, ef


def gather_state(state: PyTree) -> PyTree:
    """Every DTensor leaf of ``state`` gathered whole, in flatten order
    (a collective: every rank of the mesh calls it at the same point);
    other leaves as they are."""
    from torch.distributed.tensor import DTensor

    out = {}
    for path, t in flatten_with_path(state):
        if isinstance(t, DTensor):
            t = sharding.gather_full(t.to_local(), tuple(t.placements),
                                     t.device_mesh)
        out[keystr(path)] = t
    return unflatten_like(state, out, "state")


def inplace_train_step(cfg: configs.ModelConfig, step_cfg: StepConfig,
                       state: dict) -> Callable[[dict], dict]:
    """``step(batch) -> metrics``: :func:`make_train_step`'s step with its
    update written into ``state``'s own tensors (``optim.adamw.update_``,
    one leaf at a time), so that every leaf keeps its storage from step to
    step (what a captured graph needs) and no second copy of the state is
    made (the JAX package's step donates its buffers). The same bits as
    :func:`make_train_step`."""

    def step(batch: dict) -> dict:
        loss, grads, lr, gnorm, ostate = _loss_grads_lr(cfg, step_cfg,
                                                        state, batch)
        optim.adamw.update_(grads, ostate, state["params"], step_cfg.opt,
                            lr=lr, gnorm=gnorm)
        return {"loss": loss.detach().float(), "grad_norm": gnorm, "lr": lr}

    return step


def graph_train_step(cfg: configs.ModelConfig, step_cfg: StepConfig,
                     state: dict, batch: dict) -> Callable[[dict], dict]:
    """The counterpart of the JAX package's ``jit_train_step`` with
    ``donate=True``: returns ``step(batch) -> metrics``, one replay of
    :func:`inplace_train_step` captured in a CUDA graph, which updates
    ``state`` (on the card) in place.

    ``batch`` gives the static batch buffers their shapes and dtypes;
    each ``step(batch)`` copies its batch (host arrays or tensors of the
    same shapes) into them before the replay. The warm-up runs the
    step's arithmetic on a side stream, each leaf's update dropped as it
    is made (``optim.adamw.dry_update``), so it advances nothing and
    holds no second state (21.6 GB at full-width xlstm-1.3b, beside a
    restored state and its allocator's leftovers). ``metrics`` are the
    graph's static outputs: the next step overwrites them.
    """
    dev = host.resolve_device(leaves(state)[0].device)
    static = {k: torch.as_tensor(v).to(dev, copy=True)
              for k, v in batch.items()}
    body = inplace_train_step(cfg, step_cfg, state)

    def warmup() -> None:
        _, grads, lr, gnorm, ostate = _loss_grads_lr(cfg, step_cfg, state,
                                                     static)
        optim.adamw.dry_update(grads, ostate, state["params"],
                               step_cfg.opt, lr=lr, gnorm=gnorm)

    graph = CapturedStep(lambda: body(static), warmup=warmup, device=dev)

    def step(batch: dict) -> dict:
        if batch.keys() != static.keys():
            raise ValueError(f"batch keys {sorted(batch)} != the captured "
                             f"step's {sorted(static)}")
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if v.shape != static[k].shape:
                raise ValueError(f"batch[{k!r}] shape {tuple(v.shape)} != "
                                 f"the captured {tuple(static[k].shape)}")
            static[k].copy_(v)
        return graph.replay()

    step.nodes = graph.nodes
    return step


# ---------------------------------------------------------------------------
# end-to-end loop
# ---------------------------------------------------------------------------

def default_train_plan(*, insitu_mode: str = "async",
                       ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
                       analytics_every: int = 10, p_i: int = 2,
                       device: str | torch.device = "cuda",
                       fault: bool = False,
                       fault_hosts: Optional[list] = None,
                       fault_grace_s: float = 30.0) -> dict:
    """The training loop's declarative in-situ plan, in plain-dict form.

    Two streams: ``grads`` (per-step gradient/param summaries, bound to the
    ``grad_health`` preset) and ``train_state`` (the full checkpointable
    state, bound to the ``checkpoint`` preset when ``ckpt_dir`` is given;
    its lossy stage and restore run on ``device``). ``fault=True`` adds a
    third, ``health`` (per-step heartbeat + step time), bound to the
    ``fault`` preset over ``fault_hosts`` (default ``[0]``) — failed-host
    detection and straggler mitigation run on it."""
    plan: dict = {
        "streams": ["grads", "train_state"],
        "workers": p_i,
        "tasks": {
            "analytics": {"stream": "grads", "preset": "grad_health",
                          "every": analytics_every,
                          "placement": insitu_mode},
        },
    }
    if ckpt_dir:
        plan["tasks"]["checkpoint"] = {
            "stream": "train_state", "preset": "checkpoint",
            "every": ckpt_every, "placement": insitu_mode,
            "options": {"directory": ckpt_dir, "device": str(device)},
        }
    if fault:
        # sync + every=1: heartbeats must not be shed by backpressure, and
        # mitigation decisions should land on the step that triggered them
        plan["streams"].append("health")
        plan["tasks"]["fault"] = {
            "stream": "health", "preset": "fault", "every": 1,
            "placement": "sync", "pipelined": False,
            "options": {"hosts": list(fault_hosts or [0]),
                        "grace_s": fault_grace_s},
        }
    return plan


def train_loop(arch: str, *, steps: int = 50, smoke: bool = True,
               insitu_mode: str = "async", ckpt_dir: Optional[str] = None,
               ckpt_every: int = 20, seed: int = 0,
               analytics_every: int = 10, p_i: int = 2,
               plan: Optional[Any] = None,
               sink_faults: Optional[dict] = None,
               on_session: Optional[Callable[[Any], None]] = None,
               log: Callable[[str], None] = print,
               device: str | torch.device = "cuda",
               cuda_graph: bool = True) -> dict:
    """End-to-end training with the in-situ stack declared as a plan.

    All in-situ work — analytics and checkpointing — is one
    :class:`~repro_torch.core.session.InSituPlan` driven through a single
    :class:`~repro_torch.core.session.Session`; the loop's only in-situ
    calls are ``session.emit``. ``plan`` replaces the default workflow;
    ``sink_faults`` maps task names to fault hooks
    (``PipelineRuntime.inject_sink_fault``); ``on_session`` runs once with
    the live session before the first step. With a checkpoint on disk the
    loop restores it ("resumed from step N") and then, as the JAX
    package's loop does, counts its steps from 0 again.

    The state is bf16 parameters (f32 norms) with bf16 moments, random
    from ``seed`` (through ``params.weight_generator``: a full-width model
    of any family but dense draws on the card's generator); the shapes
    are in the module docstring. A frontend arch's batch carries its
    ``prefix`` embeddings, a static f32 buffer of the captured step like
    the tokens. On CUDA the
    step is :func:`graph_train_step`, captured at the first step (after a
    restore, so that the restored state becomes its static buffers);
    ``cuda_graph=False`` steps eagerly there, and the CPU always does.
    Every arch runs here; the module docstring names those that have
    trained on the card, and at which depth.
    """
    from repro_torch.core.session import InSituPlan, Session
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.pipeline import Prefetcher, batch_spec_for
    from repro_torch.distributed.fault import StragglerMonitor

    dev = host.resolve_device(device)
    cfg = configs.get(arch, smoke=smoke)
    shape = configs.SMOKE_SHAPE if smoke else FULL_SHAPE
    step_cfg = StepConfig()
    tm = Telemetry()

    if plan is None:
        plan = default_train_plan(
            insitu_mode=insitu_mode, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, analytics_every=analytics_every, p_i=p_i,
            device=dev)
    if not isinstance(plan, InSituPlan):
        plan = InSituPlan.from_dict(plan)

    state = init_state(cfg, P_lib.weight_generator(cfg, seed, dev, smoke),
                       step_cfg.opt, device=dev)
    step_fn = make_train_step(cfg, step_cfg)
    use_graph = cuda_graph and dev.type == "cuda"
    graph_step = None

    # ONE session: analytics and checkpointing share the staging ring and
    # the p_i worker pool (the paper's single p_o/p_i split)
    with Session(plan, telemetry=tm, raise_on_error=True) as session:
        for task_name, hook in (sink_faults or {}).items():
            session.runtime.inject_sink_fault(task_name, hook)
        if on_session is not None:
            on_session(session)
        # record the mesh geometry with every save, so that a later
        # restore(elastic=True) can plan the remesh from the manifest
        session.set_checkpoint_meta({"arch": cfg.name}, mesh=LOOP_MESH)
        if session.latest_checkpoint_step() is not None:
            start, state = session.restore(state)
            log(f"resumed from step {start}")

        pf = Prefetcher(batch_spec_for(cfg, shape), depth=2, seed=seed,
                        telemetry=tm)
        mon = StragglerMonitor()
        losses = []
        try:
            for i in range(steps):
                batch = next(pf)
                if use_graph and graph_step is None:
                    t0 = time.perf_counter()
                    graph_step = graph_train_step(cfg, step_cfg, state,
                                                  batch)
                    log(f"captured the train step in "
                        f"{time.perf_counter() - t0:.2f}s "
                        f"({graph_step.nodes} graph nodes; "
                        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} "
                        f"GiB allocated, the graph's pool included)")
                if not use_graph:
                    batch = {k: torch.from_numpy(v).to(dev)
                             for k, v in batch.items()}
                t0 = time.perf_counter()
                with session.step_span(i):
                    if use_graph:
                        metrics = graph_step(batch)
                    else:
                        state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])
                step_s = time.perf_counter() - t0
                mon.observe(0, step_s)
                losses.append(loss)
                if "health" in session.streams:
                    # single-process loop: host 0's beat + step time; a
                    # multi-host launcher emits {"hosts": {h: s}} instead
                    session.emit("health", i, {"host": 0, "step_s": step_s})
                # a custom plan may declare only a subset of the default
                # streams — offer each payload only where declared
                if "grads" in session.streams:
                    params_now = state["params"]
                    # a copy on the loop's stream: under a graph the
                    # next replay rewrites the parameters in place
                    session.emit("grads", i, lambda p=params_now: {
                        "params": leaves(p)[0].to(torch.float32,
                                                  copy=True)})
                if "train_state" in session.streams:
                    session.emit("train_state", i, lambda s=state: s)
                if i % 10 == 0:
                    log(f"step {i} loss {loss:.4f} "
                        f"lr {float(metrics['lr']):.2e}")
        finally:
            pf.close()
    n_analytics = sum(1 for r in session.results if r.task == "analytics")
    return {"losses": losses, "telemetry": tm,
            "insitu_results": n_analytics,
            "session_report": session.report(),
            "straggler_report": mon.report()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--insitu", default="async",
                    choices=["sync", "async", "hybrid"],
                    help="placement of the in-situ tasks: sync (the loop "
                         "waits for them), async (workers, per-leaf lossy "
                         "stage on their own streams) or hybrid (the lossy "
                         "stage on the device before the hand-off)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the moments are saved "
                         "lossy); a checkpoint there is resumed from")
    ap.add_argument("--full", action="store_true",
                    help="full published widths at batch 4 x 4096 tokens "
                         "(a CUDA card)")
    args = ap.parse_args()
    out = train_loop(args.arch, steps=args.steps, smoke=not args.full,
                     insitu_mode=args.insitu, ckpt_dir=args.ckpt_dir,
                     device=args.device)
    print("final loss:", out["losses"][-1])
    print("in-situ results:", out["insitu_results"])


if __name__ == "__main__":
    main()
