"""Logical-axis -> mesh-axis placement rules (FSDP / TP / EP / SP).

The model substrate annotates every parameter dim with a *logical* axis
name (see models/params.py). This module turns those names into a per-dim
*spec* against a mesh, with divisibility fallbacks: a logical axis is only
mapped onto a mesh axis when the dim size is divisible by the mesh-axis
size; otherwise the dim is replicated. That keeps a single production mesh
(16x16 or 2x16x16) valid for every arch — the 9-head arch simply
replicates its attention weights where the 128-head arch
tensor-parallelizes them.

A spec is a plain tuple, one entry per tensor dim: ``None`` (replicated),
a mesh-axis name, or a tuple of mesh-axis names (the dim split over
several, major first). It equals the JAX package's ``PartitionSpec``
entry for entry. The rules need only a mesh's axis names and sizes, so
they run on a device-free :class:`MeshShape` (the counterpart of
``abstract_mesh``) as well as on a real
``torch.distributed.device_mesh.DeviceMesh``; :func:`tree_shardings`
turns specs into DTensor placements on the latter (``Shard(dim)`` or
``Replicate()`` per mesh dim) and :func:`distribute_tree` places a tree of
logically complete tensors under them.

No counterpart here: ``shard_map``, ``mesh_context`` and ``constrain``.
They wrap JAX's manual-partitioning API, its ambient mesh and XLA's
sharding hints; the port places tensors explicitly.

What XLA's partitioner inserts in the JAX package's sharded step, the
port issues itself (the last section): :func:`gather_full` and
:func:`local_shard` move a leaf between its DTensor shard and the whole
tensor, over :func:`all_gather`, :func:`all_reduce`,
:func:`reduce_scatter` and :func:`ring_shift`. Those pick their path by
the group's backend name on every call: NCCL takes device tensors as
they are; gloo takes host tensors, so a device tensor is staged through a
host buffer there (two processes on one card cannot share an NCCL
group). :data:`wire` counts the bytes handed to the backend and the bytes
staged.

:class:`BlockGather` is what the sharded step hands the model in place
of whole parameters: each :class:`ShardedLeaf` (a rank's shard of a
leaf, or of one layer's slice of a stacked leaf) becomes the whole
tensor only where the model asks for it, inside a block's remat region,
and its gradient comes back as the rank's shard: reduce-scattered over
the mesh dims that split the rows, chunked over those that only shard
the leaf.

Rule sets are small data, so per-arch overrides and variants are plain
dicts.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from repro_torch.core.pytree import tree_map

PyTree = Any
Spec = tuple


@dataclass(frozen=True)
class MeshShape:
    """A device-free mesh: axis names and sizes, nothing placed."""
    sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axis names "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as the JAX package's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))


def abstract_mesh(sizes: Sequence[int], names: Sequence[str]) -> MeshShape:
    """The device-free mesh the rules are evaluated on in tests and plans."""
    return MeshShape(tuple(int(s) for s in sizes), tuple(names))


def mesh_geometry(mesh: Any) -> tuple[tuple, tuple]:
    """``(sizes, axis_names)`` of a :class:`MeshShape` or a ``DeviceMesh``
    (which must carry ``mesh_dim_names``)."""
    if isinstance(mesh, MeshShape):
        return mesh.sizes, mesh.axis_names
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("the placement rules need a mesh with axis names "
                         "(DeviceMesh(..., mesh_dim_names=...))")
    return tuple(int(s) for s in mesh.mesh.shape), tuple(names)


# Baseline rules: logical axis -> mesh axis (or tuple of mesh axes), None =
# replicate. FSDP shards the model dimension over 'data'; TP shards
# vocab/heads/mlp/expert over 'model'. 'pod' stays pure DP for params (no
# cross-pod param collectives on the slow inter-pod link).
DEFAULT_RULES: dict[str, Any] = {
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "e_mlp": None,
    "layers": None,
    "lora": None,
    "state": None,
    "conv": None,
    None: None,
}

# Variant: fully-sharded params over both axes (zero-1 style).
FSDP_TP_RULES = dict(DEFAULT_RULES)

# Variant for small models where TP is wasteful: everything FSDP over the
# flattened ('data','model') axes pair on the largest dim, batch over the
# whole mesh (pure data parallel + ZeRO-3).
PURE_DP_RULES = dict(
    DEFAULT_RULES,
    vocab=("data", "model"),
    embed=("data", "model"),
    heads=None,
    kv_heads=None,
    mlp=None,
    expert=None,
)

RULE_SETS = {
    "default": DEFAULT_RULES,
    "pure_dp": PURE_DP_RULES,
}


def batch_over_model(rules) -> bool:
    """pure_dp rules want activations batch-sharded over 'model' too."""
    return rules is PURE_DP_RULES or rules == PURE_DP_RULES


def _axes_sizes(mesh: Any) -> dict[str, int]:
    sizes, names = mesh_geometry(mesh)
    return dict(zip(names, sizes))


def _resolve_dim(dim: int, logical: str | None, rules: Mapping,
                 mesh_sizes: dict):
    """Map one logical dim to mesh axes, dropping axes that don't divide."""
    target = rules.get(logical, None)
    if target is None:
        return None
    if isinstance(target, str):
        target = (target,)
    kept = []
    prod = 1
    for ax in target:
        size = mesh_sizes.get(ax, 1)
        if dim % (prod * size) == 0:
            kept.append(ax)
            prod *= size
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def spec_for(shape: Sequence[int], axes: Sequence[str | None],
             rules: Mapping, mesh: Any) -> Spec:
    sizes = _axes_sizes(mesh)
    used: set[str] = set()
    parts = []
    for dim, logical in zip(shape, axes):
        resolved = _resolve_dim(dim, logical, rules, sizes)
        # one mesh axis may appear at most once in a spec
        if resolved is not None:
            flat = (resolved,) if isinstance(resolved, str) else resolved
            flat = tuple(a for a in flat if a not in used)
            if not flat:
                resolved = None
            else:
                used.update(flat)
                resolved = flat if len(flat) > 1 else flat[0]
        parts.append(resolved)
    return tuple(parts)


def tree_partition_specs(abstract_tree: PyTree, axes_tree: PyTree,
                         rules: Mapping, mesh: Any) -> PyTree:
    """A spec per leaf of a param tree (abstract or concrete): the tree of
    ``abstract_tree`` with each leaf replaced by its spec tuple."""
    return tree_map(lambda leaf, axes: spec_for(tuple(leaf.shape), axes,
                                                rules, mesh),
                    abstract_tree, axes_tree)


def placements(spec: Spec, mesh: Any) -> tuple:
    """DTensor placements of one spec: per mesh dim ``Shard(d)`` for the
    tensor dim ``d`` its axis shards, else ``Replicate()``. A dim split
    over several mesh axes must name them in the mesh's order (DTensor
    shards a dim over mesh dims major first)."""
    from torch.distributed.tensor import Replicate, Shard

    _, names = mesh_geometry(mesh)
    out: list = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} takes mesh axes {axes} "
                             f"out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def tree_shardings(abstract_tree: PyTree, axes_tree: PyTree, rules: Mapping,
                   mesh: Any) -> PyTree:
    """DTensor placements (:func:`placements`) per leaf of a param tree."""
    specs = tree_partition_specs(abstract_tree, axes_tree, rules, mesh)
    return tree_map(lambda _, s: placements(s, mesh), abstract_tree, specs)


def distribute_tree(tree: PyTree, mesh: Any, shardings: PyTree) -> PyTree:
    """Each logically complete leaf of ``tree`` as a DTensor on ``mesh``
    under its placements in ``shardings`` (a tree of the same structure).
    Every rank holds the whole leaf (a checkpoint restores it so), so
    each takes its own slice and nothing is sent (``src_data_rank=None``);
    re-placing a leaf under a shrunken mesh *is* merging its old TP
    shards."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, pl: distribute_tensor(
        t, mesh, list(pl), src_data_rank=None), tree, shardings)


def dp_axes(mesh: Any) -> tuple:
    """Mesh axes used for the batch dim: ('pod','data') when pod exists."""
    _, names = mesh_geometry(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh: Any, batch: int, extra_model: bool = False) -> Spec:
    """Spec for (batch, seq, ...) activations (its first entry; the rest
    replicate). When the per-(pod,data) batch still divides over 'model'
    and the arch policy asks for it (pure-DP small models), the batch dim
    may also take 'model'."""
    axes = list(dp_axes(mesh))
    sizes = _axes_sizes(mesh)
    prod = 1
    kept = []
    for a in axes:
        if batch % (prod * sizes[a]) == 0:
            kept.append(a)
            prod *= sizes[a]
    if extra_model and "model" in sizes and batch % (prod * sizes["model"]) == 0:
        kept.append("model")
    if not kept:
        return ()
    return (tuple(kept) if len(kept) > 1 else kept[0],)


# ---------------------------------------------------------------------------
# the sharded step's collectives
# ---------------------------------------------------------------------------

class WireStats:
    """Bytes and calls by key since :meth:`reset` (every key of ``keys``
    starts at 0)."""

    def __init__(self, keys: Sequence[str]):
        self.keys = tuple(keys)
        self.reset()

    def reset(self) -> None:
        self.bytes = dict.fromkeys(self.keys, 0)
        self.calls = dict.fromkeys(self.keys, 0)

    def add(self, key: str, nbytes: int) -> None:
        self.bytes[key] += nbytes
        self.calls[key] += 1

    def as_dict(self) -> dict:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls)}


#: what this process's collectives moved: ``sent``, the operand bytes
#: handed to the backend (an all-gather counts its one input, a ring shift
#: its one payload), and ``staged``, the bytes copied between the card and
#: host buffers for the gloo backend
wire = WireStats(("sent", "staged"))

#: callables ``(kind, operand, group_size)`` told of every collective this
#: process issues, before it is issued (``kind``: all-gather, all-reduce,
#: reduce-scatter or collective-permute; a reduce-scatter's operand is its
#: result, one rank's chunk): the dry run's record
#: (``roofline/analysis.py::record_collectives``)
observers: list = []


def _observe(kind: str, t, group) -> None:
    if observers:
        import torch.distributed as dist

        n = dist.get_world_size(group)
        for fn in list(observers):
            fn(kind, t, n)


def _stage(group, t) -> bool:
    """Whether ``t`` goes through a host buffer on ``group``'s backend:
    gloo moves host tensors only; NCCL moves card tensors only; the
    ``fake`` backend (the dry run's, on fake tensors) moves nothing, so
    nothing is staged."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend == "fake":
        return False
    if backend == "gloo":
        return t.device.type != "cpu"
    if backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"an NCCL group takes CUDA tensors, not "
                             f"{t.device}")
        return False
    raise ValueError(f"no collective path for backend {backend!r}")


def _to_wire(group, t):
    t = t.detach().contiguous()
    if _stage(group, t):
        wire.add("staged", t.numel() * t.element_size())
        return t.cpu(), True
    return t, False


def _from_wire(t, device, staged: bool):
    if staged:
        wire.add("staged", t.numel() * t.element_size())
        return t.to(device)
    return t


def all_gather(t, group) -> list:
    """Every rank's ``t`` on ``group``, in group-rank order."""
    import torch
    import torch.distributed as dist

    _observe("all-gather", t, group)
    src, staged = _to_wire(group, t)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    wire.add("sent", src.numel() * src.element_size())
    return [_from_wire(o, t.device, staged) for o in out]


_OPS = {"sum": "SUM", "max": "MAX"}


def all_reduce(t, op: str, group):
    """A new tensor: ``t`` reduced with ``op`` (``sum`` or ``max``) over
    ``group``."""
    import torch.distributed as dist

    _observe("all-reduce", t, group)
    src, staged = _to_wire(group, t)
    buf = src if staged else src.clone()
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    wire.add("sent", buf.numel() * buf.element_size())
    return _from_wire(buf, t.device, staged)


@dataclass(frozen=True)
class _Shaped:
    """What an observer reads of an operand, without a tensor (a
    reduce-scatter is observed by its result, made later)."""
    shape: tuple
    dtype: Any
    itemsize: int

    def element_size(self) -> int:
        return self.itemsize


def _reduce_scatter_single(out, src, group) -> None:
    import torch.distributed as dist

    # torch 2.13 names it reduce_scatter_single and warns (FutureWarning)
    # on reduce_scatter_tensor, which is the only name in torch 2.11
    fn = getattr(dist, "reduce_scatter_single", None)
    if fn is None:
        fn = dist.reduce_scatter_tensor
    fn(out, src, group=group)


def reduce_scatter(t, group, dim: int = 0):
    """A new tensor: this rank's chunk along ``dim`` (its group rank's, as
    ``chunk`` numbers them) of the sum of ``t`` over ``group``. On gloo,
    :func:`all_reduce` of the staged tensor, then the chunk, bit for bit
    (gloo's own reduce-scatter splits the leading dim only, and sums
    another dim's chunks in another order); the bytes staged and sent are
    a reduce-scatter's: the whole tensor out, the chunk back."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    shape = list(t.shape)
    shape[dim] //= n
    _observe("reduce-scatter", _Shaped(tuple(shape), t.dtype,
                                       t.element_size()), group)
    if dist.get_backend(group) == "gloo":
        src, staged = _to_wire(group, t)
        buf = src if staged else src.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        wire.add("sent", buf.numel() * buf.element_size())
        i = dist.get_group_rank(group, dist.get_rank())
        out = buf.chunk(n, dim)[i].clone(
            memory_format=torch.contiguous_format)
        return _from_wire(out, t.device, staged)
    x = t.movedim(dim, 0) if dim else t
    src, staged = _to_wire(group, x)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _reduce_scatter_single(out, src, group)
    wire.add("sent", src.numel() * src.element_size())
    return out.movedim(0, dim).contiguous() if dim else out


def ring_shift(t, group):
    """One ring hop on ``group``: ``t`` goes to group rank ``(i + 1) % n``;
    returns what group rank ``(i - 1) % n`` sent."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    _observe("collective-permute", t, group)
    src, staged = _to_wire(group, t)
    recv = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group,
                                                            (i + 1) % n),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group,
                                                             (i - 1) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    wire.add("sent", src.numel() * src.element_size())
    return _from_wire(recv, t.device, staged)


def gather_full(local, placements: Sequence, mesh):
    """The whole tensor of which ``local`` is this rank's shard under
    ``placements`` on ``mesh``: an all-gather over each mesh dim that
    shards it (of more than one device), the minor mesh dim first (a dim
    split over several mesh dims is split major first)."""
    import torch

    sizes = tuple(mesh.mesh.shape)
    out = local
    for i in reversed(range(len(placements))):
        pl = placements[i]
        if pl.is_shard() and sizes[i] > 1:
            out = torch.cat(all_gather(out, mesh.get_group(i)), dim=pl.dim)
    return out


def local_shard(full, placements: Sequence, mesh):
    """This rank's shard of ``full`` under ``placements`` on ``mesh`` (a
    view; the inverse of :func:`gather_full`)."""
    coord = mesh.get_coordinate()
    sizes = tuple(mesh.mesh.shape)
    out = full
    for i, pl in enumerate(placements):
        if pl.is_shard() and sizes[i] > 1:
            out = out.chunk(sizes[i], dim=pl.dim)[coord[i]]
    return out


# ---------------------------------------------------------------------------
# parameters gathered where the model uses them
# ---------------------------------------------------------------------------

class ShardedLeaf:
    """A rank's shard of a parameter leaf, or of one layer's slice of a
    stacked one, handed to the model in place of the whole tensor.

    ``local`` is the shard (a view of the leaf's local tensor),
    ``placements`` its DTensor placements (a stacked leaf's shard dims,
    shifted past the layer indices taken), ``key`` the leaf's place in
    flatten order, ``index`` the layer indices taken and ``offset`` the
    start of a range taken along the next layer axis. Indexing takes
    along the leading layer axes, which no rule shards (``layers``:
    None), as the model takes a block from a stacked tree."""

    __slots__ = ("local", "placements", "key", "index", "offset")

    def __init__(self, local, placements: Sequence, key: int,
                 index: tuple = (), offset: int = 0):
        self.local, self.placements = local, tuple(placements)
        self.key, self.index, self.offset = key, index, offset

    @property
    def shape(self):
        return self.local.shape

    def __getitem__(self, i):
        from torch.distributed.tensor import Shard

        if any(pl.is_shard() and pl.dim == 0 for pl in self.placements):
            raise ValueError(f"leaf {self.key}: its leading axis is "
                             f"sharded, not a layer axis")
        if isinstance(i, slice):
            start, _, step = i.indices(self.local.shape[0])
            if step != 1:
                raise ValueError("a layer range takes every layer")
            return ShardedLeaf(self.local[i], self.placements, self.key,
                               self.index, self.offset + start)
        if not 0 <= i < self.local.shape[0]:
            raise IndexError(i)
        pls = tuple(Shard(pl.dim - 1) if pl.is_shard() else pl
                    for pl in self.placements)
        return ShardedLeaf(self.local[i], pls, self.key,
                           self.index + (self.offset + i,))


@functools.cache
def _gather_leaves():
    """The autograd Function of :meth:`BlockGather.__call__`, made on first
    use (the rules above need no torch)."""
    import torch

    class GatherLeaves(torch.autograd.Function):
        """Forward: each shard whole (:func:`gather_full`). Backward: each
        whole gradient as the shard's (:meth:`BlockGather.reduce`)."""

        @staticmethod
        def forward(ctx, gather, shards, *locals_):
            ctx.gather, ctx.shards = gather, shards
            out = []
            for t, s in zip(locals_, shards):
                w = gather_full(t, s.placements, gather.mesh)
                # a shard that is only reduced is its whole tensor
                out.append(t.view_as(t) if w is t else w)
            return tuple(out)

        @staticmethod
        def backward(ctx, *grads):
            gather, shards = ctx.gather, ctx.shards
            return (None, None) + tuple(gather.reduce(g, s)
                                        for g, s in zip(grads, shards))

    return GatherLeaves


class BlockGather:
    """``gather(tree) -> tree``: each :class:`ShardedLeaf` of ``tree`` as
    the whole tensor, every other leaf as it is; what the sharded step
    hands the model (``transformer.forward``'s ``gather``).

    Autograd sees one leaf a shard (:meth:`leaf`: made on first use and
    reused, so that a block's remat recompute gathers the same leaf
    again), and gradients come back as the shard's, mesh dim by mesh dim
    in :func:`local_shard`'s order (:meth:`reduce`):

    * a dim of ``exact_dims`` (it splits the rows: the gradient is a mean
      over its ranks) that shards the leaf: :func:`reduce_scatter` in f32;
    * a dim of ``exact_dims`` that does not shard it: :func:`all_reduce`
      in f32;
    * a dim that shards the leaf but does not split the rows ('model'):
      the rank's chunk, no collective;
    * any other dim (one of size 1, 'pod' under the pod ring): nothing.

    The sum is divided by the ranks of ``exact_dims`` once and cast back
    to the gradient's dtype: the mean that the JAX package's partitioner
    takes. A shard that no dim of more than one rank shards or reduces is
    the whole tensor already and bypasses the gather. ``on_whole(shard,
    grad)``, where given, is told of each gathered gradient before it is
    reduced: the whole gradient of that shard's slice where no dim splits
    the rows."""

    def __init__(self, mesh, exact_dims: Sequence[int] = (),
                 on_whole=None):
        self.mesh = mesh
        self.sizes = tuple(int(s) for s in mesh.mesh.shape)
        self.coord = mesh.get_coordinate()
        self.exact = frozenset(i for i in exact_dims if self.sizes[i] > 1)
        self.scale = math.prod(self.sizes[i] for i in self.exact)
        self.on_whole = on_whole
        #: ``(key, index) -> `` the autograd leaf of that shard
        self.leaves: dict = {}

    def moves(self, shard: ShardedLeaf) -> bool:
        """Whether a collective or a chunk touches ``shard``'s leaf."""
        return any(self.sizes[i] > 1 and (pl.is_shard() or i in self.exact)
                   for i, pl in enumerate(shard.placements))

    def leaf(self, shard: ShardedLeaf):
        key = (shard.key, shard.index)
        t = self.leaves.get(key)
        if t is None:
            t = shard.local.detach().requires_grad_(True)
            self.leaves[key] = t
        return t

    def __call__(self, tree: PyTree) -> PyTree:
        from repro_torch.core.pytree import flatten_with_path, keystr, \
            unflatten_like

        flat = flatten_with_path(tree)
        out = {keystr(p): (self.leaf(v) if isinstance(v, ShardedLeaf)
                           else v) for p, v in flat}
        moved = [(keystr(p), v) for p, v in flat
                 if isinstance(v, ShardedLeaf) and self.moves(v)]
        if moved:
            shards = [s for _, s in moved]
            whole = _gather_leaves().apply(self, shards,
                                           *[out[k] for k, _ in moved])
            for (k, _), w in zip(moved, whole):
                out[k] = w
        return unflatten_like(tree, out, "gathered tree")

    def reduce(self, g, shard: ShardedLeaf):
        """The gradient of ``shard`` from ``g``, its whole tensor's."""
        if self.on_whole is not None:
            self.on_whole(shard, g)
        out, fresh = g, False
        for i, pl in enumerate(shard.placements):
            if self.sizes[i] == 1:
                continue
            group = self.mesh.get_group(i)
            if i in self.exact:
                x = out.float()
                out = (reduce_scatter(x, group, pl.dim) if pl.is_shard()
                       else all_reduce(x, "sum", group))
                fresh = True
            elif pl.is_shard():
                out = out.chunk(self.sizes[i], dim=pl.dim)[self.coord[i]]
        if self.exact:
            return (out / self.scale).to(g.dtype)
        # a chunk is a view: a copy lets the whole gradient go
        return out if fresh else out.clone()
