"""Dry run: lower every (arch x shape x mesh) cell on fake tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both]
        [--grad-compress none|bf16|int8] [--rules default|pure_dp]
        [--moe-grouped [--n-groups N]] [--tag T]

For each cell this driver, on one process that plays rank 0 of the
production mesh and needs no card:

1. starts the default process group on the ``fake`` backend (a
   ``FakeStore``; rank 0 of 256 or 512) and builds the production
   ``DeviceMesh`` over it (``launch/mesh.py``);
2. builds the state (``train.state_spec``) or the weights and the cache
   under ``FakeTensorMode``: rank 0's shards, placed as DTensors under
   ``state_shardings`` / ``batch_shardings``; nothing is allocated;
3. lowers the cell: a train cell runs one ``ShardedTrainStep`` call
   (``launch/train.py``), whose collectives the fake backend takes and
   drops; a decode or prefill cell runs ``serving/engine.py``'s
   ``make_decode`` / ``make_prefill`` on the rank's rows, with whole
   weights and those rows' cache (the port serves with replicas and has
   no sharded decode: the report's note says so);
4. records, for rank 0: FLOPs (``FlopCounterMode``); the bytes read and
   written, summed over every dispatched op but views and collectives
   (the unfused upper bound, the counterpart of XLA's "bytes accessed");
   the collectives (``roofline.analysis.record_collectives``); the
   argument bytes (the rank's state and batch shards, or its weights,
   cache and tokens); the peak of the live bytes of every storage the
   ops make beside the arguments (each storage counted from the op that
   makes it to the moment Python and autograd let it go); and the
   structural memory model's bytes (``roofline/memory_model.py``);
5. writes ``roofline.analysis.analyze``'s report, with those, to
   ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<tag>].json``.

``--moe-grouped`` lowers the MoE archs with grouped dispatch
(``MoEConfig.grouped_dispatch``, ``--n-groups`` groups a chunk), as the
JAX package's option does: ``run_cell``'s ``cfg_overrides`` takes
``moe_*`` keys into ``cfg.moe`` and the rest into the config, and
``tag`` names the variant's report.

A lowering that raises is a FAIL; so is a per-rank peak above the card's
80 GB ("over memory"), as an out-of-memory at compile is in the JAX
package's dry run. The CLI prints every cell and exits non-zero when any
failed. Every operation is counted at full depth (the port's loops run in
Python), unless that lowering would take longer than
:data:`DEPTH_BUDGET_S` (judged from the first depth variant's time a
layer): then ``roofline/extrapolate.py``'s depth variants are lowered
and every number is fitted to the full depth. The report says which
(``depth``).

The fake tensors' device is the meshes' (``launch/mesh.py::device_type``):
``cuda`` where a card is visible, else ``cpu`` (autograd cannot run on
fake CUDA tensors where torch has no CUDA). Kernel wrappers send fake
tensors to their custom ops' fake implementations on either device, so a
lowering issues the same ops on both.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch

from repro_torch.configs import base as configs
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import extrapolate, memory_model

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
#: a cell is lowered at full depth unless that would take longer than this
#: (seconds); then its depth variants are lowered and fitted to it
DEPTH_BUDGET_S = 120.0
REPLICA_NOTE = ("serving cell: each rank holds whole weights and its rows' "
                "cache (the port serves with replicas, no sharded decode)")


def mesh_desc(sizes) -> str:
    return "x".join(str(s) for s in sizes)


# ---------------------------------------------------------------------------
# what a lowering records
# ---------------------------------------------------------------------------

def _tensors(obj, out=None) -> list:
    """The tensors in nested lists, tuples and dicts."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: ops that move no bytes: they only describe memory
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh"}


class _Traffic:
    """A dispatch mode (made by :func:`_traffic_mode`) that sums the bytes
    read and written by every op (its tensor inputs and outputs once
    each; views, allocations and collectives excluded) and follows the
    live bytes of every storage the ops make, with their peak."""

    def __init__(self):
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is let go."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        nb = st.nbytes()
        self._seen.add(key)
        self.live += nb
        self.peak = max(self.peak, self.live)

        def release(key=key, nb=nb):
            self._seen.discard(key)
            self.live -= nb

        weakref.finalize(st, release)

    def record(self, func, args, kwargs, out) -> None:
        if func.namespace == "prim":          # metadata queries
            return
        self.ops += 1
        name = func.__name__.split(".")[0]
        if (func.namespace not in ("c10d", "_c10d_functional")
                and not func.is_view and name not in _NO_TRAFFIC):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self.hold(t)


def _traffic_mode(traffic: _Traffic):
    from torch.utils._python_dispatch import TorchDispatchMode

    device = torch.ops.prim.device.default

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is device:              # a metadata query, the most
                return func(*args)          # frequent dispatch by far
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            traffic.record(func, args, kwargs, out)
            return out

    return Mode()


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group on the ``fake`` backend: rank 0 of
    ``world``; destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own default process "
                           "group; one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, placements, sizes) -> tuple:
    out = list(shape)
    for pl, n in zip(placements, sizes):
        if pl.is_shard():
            out[pl.dim] //= n
    return tuple(out)


def _fake_dtensors(abstract, shardings, mesh, sizes, device):
    """Rank 0's shard of each meta leaf of ``abstract`` as a fake tensor,
    wrapped as a DTensor under its placements in ``shardings``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.pytree import tree_map

    def leaf(t, pl):
        local = torch.empty(_local_shape(t.shape, pl, sizes), dtype=t.dtype,
                            device=device)
        return DTensor.from_local(local, mesh, list(pl), run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tree_map(leaf, abstract, shardings)


def _fake_like(abstract, device):
    from repro_torch.core.pytree import tree_map

    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), abstract)


def _rows(shape: configs.ShapeConfig, mesh_shape) -> int:
    """The batch rows one rank takes: the global batch over the data
    axes that divide it."""
    spec = sharding.batch_spec(mesh_shape, shape.global_batch)
    if not spec:
        return shape.global_batch
    axes = (spec[0],) if isinstance(spec[0], str) else spec[0]
    return shape.global_batch // math.prod(mesh_shape.shape[a] for a in axes)


def _lower(cfg, shape, world, new_mesh, *, grad_compress, rules):
    """One lowering of ``cfg`` at ``shape`` on the mesh ``new_mesh()``
    builds in a fake world of ``world`` ranks: ``(flops, bytes,
    collectives, argument_bytes, peak_bytes, note, (sizes, names))`` of
    rank 0."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.pytree import leaves
    from repro_torch.launch import train as T
    from repro_torch.models import params as P_lib
    from repro_torch.models import transformer
    from repro_torch.serving import engine, kvcache

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    traffic = _Traffic()
    note = ""
    device = mesh_lib.device_type()
    with fake_world(world):
        mesh = new_mesh()
        sizes, names = tuple(mesh.mesh.shape), mesh.mesh_dim_names
        mesh_shape = sharding.abstract_mesh(sizes, names)
        with fake:
            if shape.kind == "train":
                step_cfg = T.StepConfig(grad_compress=grad_compress)
                step, st_sh, b_sh, ef = T.jit_train_step(
                    cfg, mesh, step_cfg, shape, rules=rules)
                n_pods = dict(zip(names, sizes)).get("pod", 0)
                st = T.state_spec(cfg, master=step_cfg.opt.master_weights,
                                  ef_pods=n_pods if ef else 0)
                state = _fake_dtensors(st, st_sh, mesh, sizes, device)
                batch = _fake_dtensors(T.batch_abstract(cfg, shape), b_sh,
                                       mesh, sizes, device)
                args = [t.to_local() for t in leaves((state, batch))]
                run = lambda: step(state, batch)
            else:
                rows = _rows(shape, mesh_shape)
                params = _fake_like(
                    P_lib.abstract(transformer.param_spec(cfg)), device)
                if shape.kind == "decode":
                    cache = kvcache.init_cache(cfg, rows, shape.seq_len,
                                               device=device)
                    tokens = torch.empty((rows, 1), dtype=torch.int32,
                                         device=device)
                    lengths = torch.empty((rows,), dtype=torch.int32,
                                          device=device)
                    fn = engine.make_decode(cfg)
                    args = leaves((params, cache)) + [tokens, lengths]
                    run = lambda: fn(params, cache, tokens, lengths)
                else:
                    tokens = torch.empty((rows, shape.seq_len),
                                         dtype=torch.int32, device=device)
                    fn = engine.make_prefill(cfg, max_len=shape.seq_len,
                                             last_only=True)
                    args = leaves(params) + [tokens]
                    run = lambda: fn(params, tokens)
                note = REPLICA_NOTE
            arg_bytes = sum(_nbytes(t) for t in args)
            for t in args:
                traffic.hold(t)
            base_live = traffic.live
            del args
            with roofline.record_collectives() as ops, \
                    FlopCounterMode(display=False) as flops, \
                    _traffic_mode(traffic):
                out = run()
                del out, run
    peak = arg_bytes + (traffic.peak - base_live)
    return (float(flops.get_total_flops()), float(traffic.bytes), list(ops),
            arg_bytes, peak, note, (sizes, names))


def lower_cell(cfg, shape: configs.ShapeConfig, world: int, new_mesh, *,
               grad_compress: str = "none", rules=None,
               depth: str = "full") -> dict:
    """Lower one cell (module docstring) on the mesh that ``new_mesh()``
    builds in a fake world of ``world`` ranks (``launch/mesh.py``'s
    builders) and return what rank 0 records: ``flops``, ``bytes``,
    ``collectives`` (:class:`CollectiveOp` list), ``wire_bytes``,
    ``argument_bytes``, ``peak_bytes``, ``note``, ``mesh`` (sizes, axis
    names), ``lower_s`` and ``depth``.

    ``depth``: ``full`` lowers the config as it is; ``variants`` lowers
    ``extrapolate.depth_variants`` and fits every number to the full
    depth (the collectives list is then empty: only their wire bytes are
    fitted); ``auto`` lowers the first variant and goes on with the
    variants when the full depth would take more than
    :data:`DEPTH_BUDGET_S` by its time a layer, else lowers the full
    depth."""
    t0 = time.perf_counter()
    lower = lambda c: _lower(c, shape, world, new_mesh,
                             grad_compress=grad_compress, rules=rules)

    def record(got, how):
        fl, by, ops, arg, peak, note, geo = got
        return {"flops": fl, "bytes": by, "collectives": ops,
                "wire_bytes": sum(o.wire_bytes for o in ops),
                "argument_bytes": arg, "peak_bytes": peak, "note": note,
                "mesh": geo, "lower_s": time.perf_counter() - t0,
                "depth": how}

    if depth == "full":
        return record(lower(cfg), "full")
    variants, full = extrapolate.depth_variants(cfg)
    samples = []
    for i, (vcfg, counts) in enumerate(variants):
        t1 = time.perf_counter()
        got = lower(vcfg)
        if i == 0 and depth == "auto":
            per_layer = (time.perf_counter() - t1) / vcfg.n_layers
            if per_layer * cfg.n_layers <= DEPTH_BUDGET_S:
                return record(lower(cfg), "full")
        fl, by, ops, arg, peak, note, geo = got
        samples.append((counts, (fl, by, sum(o.wire_bytes for o in ops),
                                 arg, peak)))
    fit = [extrapolate.solve_and_extrapolate(
        [(c, v[i]) for c, v in samples], full) for i in range(5)]
    return {"flops": fit[0], "bytes": fit[1], "collectives": [],
            "wire_bytes": fit[2], "argument_bytes": fit[3],
            "peak_bytes": fit[4], "note": note, "mesh": geo,
            "lower_s": time.perf_counter() - t0,
            "depth": f"extrapolated from {len(samples)} depth variants"}


class OverMemory(RuntimeError):
    """A cell whose per-rank peak does not fit the card."""


def override(cfg: configs.ModelConfig, cfg_overrides: dict | None
             ) -> configs.ModelConfig:
    """``cfg`` with ``cfg_overrides``: a ``moe_<field>`` key sets that
    field of ``cfg.moe`` (ignored for an arch without MoE), any other key
    the config's own field."""
    if not cfg_overrides:
        return cfg
    moe_kw = {k[4:]: v for k, v in cfg_overrides.items()
              if k.startswith("moe_")}
    top = {k: v for k, v in cfg_overrides.items()
           if not k.startswith("moe_")}
    if moe_kw and cfg.moe is not None:
        top["moe"] = dataclasses.replace(cfg.moe, **moe_kw)
    return dataclasses.replace(cfg, **top)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             grad_compress: str = "none", rules=None,
             cfg_overrides: dict | None = None, tag: str = "") -> dict:
    """Lower one cell on the production mesh (``launch/mesh.py::
    make_production_mesh``) of ``arch``'s config with ``cfg_overrides``
    (:func:`override`) and write its report (module docstring; ``tag``
    suffixes its name). Raises :class:`OverMemory` (after writing the
    report) when the per-rank peak exceeds the card's memory."""
    from repro_torch.serving import kvcache

    cfg = override(configs.get(arch), cfg_overrides)
    shape = configs.SHAPES[shape_name]
    rec = lower_cell(
        cfg, shape, math.prod(mesh_lib.production_geometry(multi_pod)[0]),
        lambda: mesh_lib.make_production_mesh(multi_pod=multi_pod),
        grad_compress=grad_compress, rules=rules, depth="auto")
    sizes, names = rec["mesh"]
    mesh_shape = sharding.abstract_mesh(sizes, names)
    chips = math.prod(sizes)
    cache_b = (kvcache.cache_bytes(cfg, shape.global_batch, shape.seq_len)
               if shape.kind in ("decode", "prefill") else 0)
    mem_model = memory_model.analytic_memory_bytes(cfg, shape, mesh_shape,
                                                   cache_bytes=cache_b)
    fits = rec["peak_bytes"] <= roofline.HBM_BYTES
    report = roofline.analyze(
        arch=arch, shape=shape.name, mesh_desc=mesh_desc(sizes), chips=chips,
        cost={"flops": rec["flops"], "bytes accessed": rec["bytes"]},
        collectives=rec["collectives"],
        wire_bytes_override=(None if rec["collectives"]
                             else rec["wire_bytes"]),
        model_flops_global=roofline.model_flops(cfg, shape),
        memory_stats={"argument_bytes": rec["argument_bytes"],
                      "peak_bytes": rec["peak_bytes"], "fits": fits,
                      "card_bytes": roofline.HBM_BYTES},
        default_group=chips, model_bytes_per_device=mem_model,
        note=rec["note"])
    out = json.loads(report.to_json())
    out.update(lower_s=rec["lower_s"], depth=rec["depth"],
               grad_compress=grad_compress, n_layers=cfg.n_layers, tag=tag)
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = (ARTIFACTS
            / f"{arch}__{shape.name}__{mesh_desc(sizes)}{suffix}.json")
    path.write_text(json.dumps(out, indent=1))
    if not fits:
        raise OverMemory(f"over memory: per-rank peak {rec['peak_bytes']:,} "
                         f"B > {roofline.HBM_BYTES:,.0f} B (arguments "
                         f"{rec['argument_bytes']:,} B)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--rules", default="default",
                    choices=list(sharding.RULE_SETS))
    ap.add_argument("--moe-grouped", action="store_true",
                    help="grouped MoE dispatch (MoEConfig.grouped_dispatch)")
    ap.add_argument("--n-groups", type=int, default=16,
                    help="dispatch groups a chunk under --moe-grouped")
    ap.add_argument("--tag", default="",
                    help="suffix of each report's file name")
    args = ap.parse_args()
    rules = sharding.RULE_SETS[args.rules]
    overrides = ({"moe_grouped_dispatch": True,
                  "moe_n_groups": args.n_groups}
                 if args.moe_grouped else None)

    archs = [args.arch] if args.arch else list(configs.ARCH_IDS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    t_all = time.perf_counter()
    for arch in archs:
        shapes = ([args.shape] if args.shape
                  else [s.name for s in configs.cells(arch)])
        for shape_name in shapes:
            for multi in meshes:
                desc = (f"{arch} x {shape_name} x "
                        f"{mesh_desc(mesh_lib.production_geometry(multi)[0])}")
                try:
                    out = run_cell(arch, shape_name, multi,
                                   grad_compress=args.grad_compress,
                                   rules=rules, cfg_overrides=overrides,
                                   tag=args.tag)
                    mem = out["memory_per_device_bytes"]
                    print(f"OK   {desc}: step={out['step_s'] * 1e3:.2f}ms "
                          f"bottleneck={out['bottleneck']} "
                          f"frac={out['roofline_fraction']:.3f} "
                          f"flops={out['hlo_flops_per_device']:.4e} "
                          f"wire={out['wire_bytes_per_device']:.4e}B "
                          f"peak={mem['peak_bytes'] / 1e9:.2f}GB "
                          f"lower={out['lower_s']:.1f}s ({out['depth']})",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((desc, e))
                    print(f"FAIL {desc}: {type(e).__name__}: {e}",
                          flush=True)
                    if not isinstance(e, OverMemory):
                        traceback.print_exc()
    print(f"dry run: {len(failures)} of the cells failed, "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed")
    print("all dry-run cells passed")


if __name__ == "__main__":
    main()
