"""The port's placement rules against the JAX package's (CPU).

* ``spec_for`` / ``tree_partition_specs`` equal to the JAX package's
  ``PartitionSpec``s entry for entry, leaf for leaf, for every arch of
  ``ARCH_IDS`` on the (16, 16) and (2, 16, 16) meshes under both rule
  sets; ``batch_spec``, ``cache_partition_spec``, ``param_bytes``,
  ``cache_bytes``, ``state_spec`` and ``batch_abstract`` likewise; the
  cases of ``tests/test_sharding_rules.py`` on the port.
* Specs as DTensor placements (``Shard(dim)`` / ``Replicate()`` per mesh
  dim), and ``state_shardings`` built from the same specs.
* The remesh drill across CPU processes (gloo, ``torch_remesh_ranks.py``):
  a smoke ``smollm-135m`` state placed on (2, 2) by 4 ranks and saved,
  restored elastically by 2 ranks ((1, 2), merge factor 1, the JAX
  package's plan) and by 1 ((1, 1), merge factor 2), each rank's local
  shards against the full leaf's slices and ``merge_model_shards`` of
  the old shards against the new leaf.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as JCFG
from repro.distributed import fault as JF
from repro.distributed import sharding as JSH
from repro.launch import train as JTR
from repro.models import params as JP
from repro.models import transformer as JTM
from repro.serving import kvcache as JKV
from repro_torch.configs import base as TCFG
from repro_torch.core import pytree
from repro_torch.distributed import fault as TF
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import train as TTR
from repro_torch.models import params as TP
from repro_torch.models import transformer as TTM
from repro_torch.serving import kvcache as TKV

TESTS = Path(__file__).resolve().parent
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = ("default", "pure_dp")


def _meshes(name):
    sizes, names = MESHES[name]
    return JSH.abstract_mesh(sizes, names), TSH.abstract_mesh(sizes, names)


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_specs(abstract, specs, path=()) -> dict:
    """What ``specs`` holds at each leaf of the (tensor) tree ``abstract``
    (spec tuples, placements), by leaf key."""
    if isinstance(abstract, dict):
        return {k: v for key in abstract
                for k, v in _port_specs(abstract[key], specs[key],
                                        path + (key,)).items()}
    if isinstance(abstract, (list, tuple)):
        return {k: v for i, a in enumerate(abstract)
                for k, v in _port_specs(a, specs[i], path + (i,)).items()}
    return {pytree.keystr(path): specs}


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", JCFG.ARCH_IDS)
def test_tree_partition_specs_equal_the_jax_packages(arch, mesh, rules):
    jmesh, tmesh = _meshes(mesh)
    jspec = JTM.param_spec(JCFG.get(arch))
    tspec = TTM.param_spec(TCFG.get(arch))
    want = _jax_specs(JSH.tree_partition_specs(
        JP.abstract(jspec), JP.logical_axes(jspec), JSH.RULE_SETS[rules],
        jmesh))
    abstract = TP.abstract(tspec)
    got = _port_specs(abstract, TSH.tree_partition_specs(
        abstract, TP.logical_axes(tspec), TSH.RULE_SETS[rules], tmesh))
    assert got == want
    assert TP.param_bytes(tspec) == JP.param_bytes(jspec)
    shapes = {pytree.keystr(p): tuple(t.shape)
              for p, t in pytree.flatten_with_path(abstract)}
    assert all(t.device.type == "meta"
               for t in pytree.leaves(abstract))
    jshapes, _ = jax.tree_util.tree_flatten_with_path(JP.abstract(jspec))
    assert shapes == {jax.tree_util.keystr(p): tuple(s.shape)
                      for p, s in jshapes}


@pytest.mark.parametrize("arch", JCFG.ARCH_IDS)
def test_cache_specs_and_bytes_equal_the_jax_packages(arch):
    jcfg, tcfg = JCFG.get(arch), TCFG.get(arch)
    for mesh in MESHES:
        jmesh, tmesh = _meshes(mesh)
        for batch, max_len in ((128, 32768), (8, 4096), (1, 100)):
            want = JKV.cache_partition_spec(jcfg, batch, max_len, jmesh)
            got = TKV.cache_partition_spec(tcfg, batch, max_len, tmesh)
            abstract = TKV.cache_spec(tcfg, batch, max_len)
            assert _port_specs(abstract, got) == _jax_specs(want)
    for batch, max_len in ((128, 32768), (1, 100)):
        assert TKV.cache_bytes(tcfg, batch, max_len) == \
            JKV.cache_bytes(jcfg, batch, max_len)
        jflat, _ = jax.tree_util.tree_flatten_with_path(
            JKV.cache_spec(jcfg, batch, max_len))
        tflat = pytree.flatten_with_path(TKV.cache_spec(tcfg, batch, max_len))
        assert [(pytree.keystr(p), tuple(t.shape), str(t.dtype)[6:])
                for p, t in tflat] == [
            (jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
            for p, s in jflat]


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_spec_and_dp_axes_equal_the_jax_packages(mesh):
    jmesh, tmesh = _meshes(mesh)
    assert TSH.dp_axes(tmesh) == JSH.dp_axes(jmesh)
    for batch in (1, 2, 3, 16, 32, 256, 512, 1024):
        for extra in (False, True):
            assert TSH.batch_spec(tmesh, batch, extra) == tuple(
                JSH.batch_spec(jmesh, batch, extra))


@pytest.mark.parametrize("arch", ["smollm-135m", "musicgen-medium",
                                  "moonshot-v1-16b-a3b"])
def test_state_spec_and_batch_abstract_match_the_jax_packages(arch):
    for master, ef in ((False, 0), (True, 2)):
        want = JTR.state_spec(JCFG.get(arch, smoke=True), master=master,
                              ef_pods=ef)
        got = TTR.state_spec(TCFG.get(arch, smoke=True), master=master,
                             ef_pods=ef)
        jflat, _ = jax.tree_util.tree_flatten_with_path(want)
        assert [(pytree.keystr(p), tuple(t.shape), str(t.dtype)[6:])
                for p, t in pytree.flatten_with_path(got)] == [
            (jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
            for p, s in jflat]
    jb = JTR.batch_abstract(JCFG.get(arch), JCFG.SMOKE_SHAPE)
    tb = TTR.batch_abstract(TCFG.get(arch), TCFG.SMOKE_SHAPE)
    assert {k: tuple(v.shape) for k, v in tb.items()} == \
        {k: tuple(v.shape) for k, v in jb.items()}
    # the port's frontend prefix is f32, as its synth_batch draws it
    assert {k: str(v.dtype) for k, v in tb.items()} == {
        k: "torch.float32" if k == "prefix" else "torch.int32" for k in tb}


# -- the cases of tests/test_sharding_rules.py on the port ---------------------

MESH = TSH.abstract_mesh((16, 16), ("data", "model"))
POD_MESH = TSH.abstract_mesh((2, 16, 16), ("pod", "data", "model"))


def test_divisible_dims_shard():
    assert TSH.spec_for((2048, 8192), ("embed", "mlp"), TSH.DEFAULT_RULES,
                        MESH) == ("data", "model")


def test_indivisible_dims_replicate():
    assert TSH.spec_for((576, 9, 64), ("embed", "heads", "head_dim"),
                        TSH.DEFAULT_RULES, MESH) == ("data", None, None)


def test_mesh_axis_used_once_per_spec():
    rules = dict(TSH.DEFAULT_RULES, heads="model", mlp="model")
    spec = TSH.spec_for((32, 9728), ("heads", "mlp"), rules, MESH)
    flat = [a for part in spec if part for a in
            (part if isinstance(part, tuple) else (part,))]
    assert len(flat) == len(set(flat))
    assert spec == tuple(JSH.spec_for(
        (32, 9728), ("heads", "mlp"), dict(JSH.DEFAULT_RULES, heads="model",
                                           mlp="model"),
        JSH.abstract_mesh((16, 16), ("data", "model"))))


def test_tuple_rule_partial_divisibility():
    assert TSH.spec_for((49152,), ("vocab",), TSH.PURE_DP_RULES, MESH) == (
        ("data", "model"),)


def test_pod_never_shards_params():
    pspec = TTM.param_spec(TCFG.get("granite-3-2b"))
    abstract = TP.abstract(pspec)
    specs = _port_specs(abstract, TSH.tree_partition_specs(
        abstract, TP.logical_axes(pspec), TSH.DEFAULT_RULES, POD_MESH))
    for s in specs.values():
        for part in s:
            assert "pod" not in (part if isinstance(part, tuple)
                                 else (part,))


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_every_arch_has_valid_specs(arch):
    pspec = TTM.param_spec(TCFG.get(arch))
    abstract = TP.abstract(pspec)
    specs = TSH.tree_partition_specs(abstract, TP.logical_axes(pspec),
                                     TSH.DEFAULT_RULES, MESH)
    sizes = MESH.shape
    by_key = _port_specs(abstract, specs)
    for path, leaf in pytree.flatten_with_path(abstract):
        s = by_key[pytree.keystr(path)]
        assert len(s) == leaf.dim()
        for dim, part in zip(leaf.shape, s):
            if part is None:
                continue
            parts = part if isinstance(part, tuple) else (part,)
            assert dim % int(np.prod([sizes[a] for a in parts])) == 0, (
                arch, pytree.keystr(path), s)


def test_batch_spec_divisibility():
    assert TSH.batch_spec(POD_MESH, 256) == (("pod", "data"),)
    assert TSH.batch_spec(POD_MESH, 2) == ("pod",)
    assert TSH.batch_spec(POD_MESH, 1) == ()
    assert TSH.batch_spec(MESH, 32) == ("data",)


def test_cache_seq_fallback_for_indivisible_kv_heads():
    specs = TKV.cache_partition_spec(TCFG.get("qwen1.5-110b"), 128, 32768,
                                     MESH)
    assert specs["kv"]["k"][2] == "model"


def test_cache_kv_heads_shard_when_divisible():
    specs = TKV.cache_partition_spec(TCFG.get("moonshot-v1-16b-a3b"), 128,
                                     32768, MESH)
    assert specs["kv"]["k"][3] == "model"


# -- specs as DTensor placements ---------------------------------------------

def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = TSH.abstract_mesh((2, 2), ("data", "model"))
    assert TSH.placements(("model", "data"), mesh) == (Shard(1), Shard(0))
    assert TSH.placements((None, "model"), mesh) == (Replicate(), Shard(1))
    assert TSH.placements((("data", "model"), None), mesh) == (
        Shard(0), Shard(0))
    assert TSH.placements((), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        TSH.placements((("model", "data"),), mesh)
    assert TSH.mesh_geometry(mesh) == ((2, 2), ("data", "model"))
    with pytest.raises(ValueError):
        TSH.abstract_mesh((2,), ("data", "model"))


def test_state_shardings_are_the_specs_placements():
    cfg = TCFG.get("smollm-135m", smoke=True)
    mesh = TSH.abstract_mesh((2, 2), ("data", "model"))
    pspec = TTM.param_spec(cfg)
    abstract = TP.abstract(pspec)
    specs = _port_specs(abstract, TSH.tree_partition_specs(
        abstract, TP.logical_axes(pspec), TSH.DEFAULT_RULES, mesh))
    sh = TTR.state_shardings(cfg, mesh, master=True)
    for part in ("params", "mu", "nu", "master"):
        got = _port_specs(abstract, sh[part])
        assert got == {k: TSH.placements(s, mesh) for k, s in specs.items()}
    assert sh["count"] == TSH.placements((), mesh)
    pod = TSH.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    ef = TTR.state_shardings(cfg, pod, ef_residual=True)["ef"]
    from torch.distributed.tensor import Shard
    assert all(pl[0] == Shard(0) for pl in _port_specs(abstract, ef).values())
    bs = TTR.batch_shardings(cfg, TCFG.SMOKE_SHAPE, mesh)
    assert bs == {k: TSH.placements(("data",), mesh)
                  for k in ("tokens", "labels")}


# -- the remesh drill across CPU processes -----------------------------------

DRILL_TIMEOUT_S = 60.0


def _ranks(phase: str, world: int, d: Path, deadline: float) -> None:
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_remesh_ranks.py"),
         "--phase", phase, "--rank", str(r), "--world", str(world),
         "--dir", str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline -
                                               time.monotonic()))
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _slice(full: torch.Tensor, placements: list, coord: list,
           sizes: tuple) -> torch.Tensor:
    """The local shard a rank at ``coord`` of a mesh of ``sizes`` holds of
    ``full`` under ``placements`` (``Shard(d)`` strings), mesh dims
    major first."""
    out = full
    for pl, c, n in zip(placements, coord, sizes):
        if pl.startswith("S("):
            out = torch.chunk(out, n, dim=int(pl[2:-1]))[c]
    return out


def test_remesh_drill_across_gloo_processes(tmp_path):
    """(2, 2) on 4 ranks -> (1, 2) on 2 (merge 1) and (1, 1) on 1 (merge
    2); every local shard is its slice of the full leaf."""
    deadline = time.monotonic() + DRILL_TIMEOUT_S
    sys.path.insert(0, str(TESTS))
    import torch_remesh_ranks as drv
    cfg, state = drv.smoke_state()
    _ranks("save", 4, tmp_path, deadline)
    _ranks("restore", 2, tmp_path, deadline)
    _ranks("restore", 1, tmp_path, deadline)
    assert time.monotonic() < deadline

    from repro_torch.core.session import Session
    with Session(drv._plan(str(tmp_path / "ck"))) as s:
        step, full = s.restore(TTR.state_spec(cfg))
    full = {pytree.keystr(p): t for p, t in pytree.flatten_with_path(full)}
    start = {pytree.keystr(p): t for p, t in pytree.flatten_with_path(state)}
    old = [torch.load(tmp_path / f"old_rank{r}.pt") for r in range(4)]
    old_mesh = TSH.abstract_mesh((2, 2), ("data", "model"))
    old_pl = _port_specs(TTR.state_spec(cfg), TTR.state_shardings(
        cfg, old_mesh))
    for world, merge in ((2, 1), (1, 2)):
        want = JF.plan_elastic_remesh((2, 2), ("data", "model"), world)
        assert want.model_merge_factor == merge
        for r in range(world):
            got = torch.load(tmp_path / f"new{world}_rank{r}.pt")
            assert got["step"] == step == 5
            assert got["plan"] == (want.old_shape, want.new_shape,
                                   want.axis_names, want.model_merge_factor)
            for key, local in got["local"].items():
                want_local = _slice(full[key], got["placements"][key],
                                    got["coord"], want.new_shape)
                assert torch.equal(local, want_local), (world, r, key)
                if not key.startswith(("['mu']", "['nu']")):
                    assert torch.equal(local, _slice(
                        start[key], got["placements"][key], got["coord"],
                        want.new_shape)), (world, r, key)
    # the old shards of rank (i, j) = 2 i + j are the old slices, and
    # merging the model shards of each data row, then the rows, gives the
    # one-rank restore's leaf (params: the saved state itself)
    one = torch.load(tmp_path / "new1_rank0.pt")["local"]
    for key, t in start.items():
        pl = [str(x) for x in old_pl[key]]
        for r in range(4):
            assert torch.equal(old[r][key],
                               _slice(t, pl, [r // 2, r % 2], (2, 2)))
        if pl[1].startswith("S("):
            rows = [TF.merge_model_shards(
                [old[2 * i][key], old[2 * i + 1][key]], 2,
                axis=int(pl[1][2:-1]))[0] for i in range(2)]
        else:
            rows = [old[2 * i][key] for i in range(2)]
        merged = (torch.cat(rows, dim=int(pl[0][2:-1]))
                  if pl[0].startswith("S(") else rows[0])
        assert torch.equal(merged, t), key
        if not key.startswith(("['mu']", "['nu']")):
            assert torch.equal(merged, one[key]), key
