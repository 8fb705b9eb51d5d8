"""The port's dry run (``launch/dryrun.py``, ``launch/mesh.py``,
``configs.cells``, ``roofline/{analysis,extrapolate,memory_model}.py``)
against the JAX package's pure functions, and its lowering on fake
tensors against real gloo steps (CPU).

* The HLO parser, the wire math and the report run through both packages
  on the same HLO text (``tests/test_roofline.py``'s cases): flops, bytes
  and wire bytes equal; the times each package's own constants.
* ``cells``, ``depth_variants``, ``solve_and_extrapolate``,
  ``slstm_recurrent_flops`` and ``analytic_memory_bytes`` equal between
  the packages for every arch (and shape, and production mesh).
* The lowering: the depth variants fitted to the full depth give the
  FLOPs of the full-depth lowering (one smoke config of each family); the
  sLSTM's counted recurrent products are ``slstm_recurrent_flops``; the
  collectives recorded on the fake backend are, kind for kind and shape
  for shape, those of a real gloo step on the same mesh, and their
  operand bytes ``sharding.wire``'s ``sent`` (worlds of 2 and 4, the
  rank machinery of ``tests/torch_shard_ranks.py``).
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.roofline import analysis as JR
from repro.roofline import extrapolate as JE
from repro.roofline import memory_model as JM
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis as TR
from repro_torch.roofline import extrapolate as TE
from repro_torch.roofline import memory_model as TM
from repro_torch.serving import kvcache

TESTS = Path(__file__).resolve().parent
HLO = (TESTS / "test_roofline.py").read_text().split('HLO = """')[1] \
    .split('"""')[0]
UNKNOWN = ("%ar = f8e8m0[4096]{0} all-reduce(%x), "
           "replica_groups={{0,1,2,3}}, to_apply=%add")
PACKAGES = {"repro": JR, "repro_torch": TR}


# ---------------------------------------------------------------------------
# the collective roofline, the same HLO text through both packages
# ---------------------------------------------------------------------------

def _ops(mod, text, group):
    return [(o.kind, o.dtype, o.shape, o.elem_bytes, o.group_size,
             o.wire_bytes, o.tensor_bytes)
            for o in mod.parse_collectives(text, default_group=group)]


@pytest.mark.parametrize("group", [1, 99, 256])
@pytest.mark.parametrize("text", [HLO, UNKNOWN], ids=["hlo", "unknown"])
def test_parse_collectives_equal(text, group):
    assert _ops(TR, text, group) == _ops(JR, text, group)


def test_parse_kinds_groups_wire_and_async_pairs():
    ops = {o.kind: o for o in TR.parse_collectives(HLO, default_group=99)}
    assert sorted(ops) == ["all-gather", "all-reduce", "all-to-all",
                           "collective-permute", "reduce-scatter"]
    assert [ops[k].group_size for k in ("all-gather", "all-reduce",
                                        "reduce-scatter", "all-to-all")] \
        == [16, 16, 4, 2]
    assert ops["all-gather"].wire_bytes == pytest.approx(
        2048 * 1024 * 2 * 15 / 16)
    assert ops["all-reduce"].wire_bytes == pytest.approx(2 * 256 * 4 * 15 / 16)
    assert ops["reduce-scatter"].wire_bytes == pytest.approx(
        64 * 8 * 4 * 4 * 3 / 4)
    assert ops["collective-permute"].wire_bytes == pytest.approx(1024)
    # async pairs once; an all-gather's operand is its result over g
    assert len(TR.parse_collectives(HLO)) == 5
    assert ops["all-gather"].operand_bytes == 128 * 1024 * 2


@pytest.mark.parametrize("text", [HLO, UNKNOWN], ids=["hlo", "unknown"])
def test_report_equal_but_for_each_packages_constants(text):
    kw = dict(arch="x", shape="train_4k", mesh_desc="16x16", chips=256,
              cost={"flops": 1e12, "bytes accessed": 1e9}, hlo_text=text,
              model_flops_global=0.7 * 1e12 * 256)
    rep = {name: mod.analyze(**kw) for name, mod in PACKAGES.items()}
    j, t = rep["repro"], rep["repro_torch"]
    for f in ("hlo_flops_per_device", "hlo_bytes_per_device",
              "wire_bytes_per_device", "model_flops_global",
              "useful_flops_ratio", "collectives_by_kind", "note"):
        assert getattr(t, f) == getattr(j, f), f
    for name, mod in PACKAGES.items():
        r = rep[name]
        assert r.compute_s == pytest.approx(1e12 / mod.PEAK_FLOPS_BF16)
        assert r.memory_s == pytest.approx(1e9 / mod.HBM_BW)
    assert t.collective_s == pytest.approx(t.wire_bytes_per_device
                                           / TR.LINK_BW)
    assert TR.LINK_BW == 450e9 and TR.PEAK_FLOPS_BF16 == 989e12
    assert t.bottleneck == j.bottleneck == "compute"
    assert 0.0 < t.roofline_fraction() <= 1.0
    if text is UNKNOWN:
        assert "f8e8m0" in t.note and "lower bound" in t.note
        assert t.collectives_by_kind["all-reduce"]["unknown_dtype"] == 1


def test_recorded_collectives_are_ops_of_the_same_math():
    """``collective_op`` of an issued collective: an all-gather's result
    is g operands, its wire (g-1) operands; an all-reduce's 2 (g-1)/g."""
    t = torch.empty((3, 5), dtype=torch.bfloat16)
    ag = TR.collective_op("all-gather", t, 4)
    assert (ag.shape, ag.dtype, ag.operand_bytes) == ((4, 3, 5), "bf16", 30)
    assert ag.wire_bytes == pytest.approx(30 * 3)
    ar = TR.collective_op("all-reduce", t.float(), 4)
    assert ar.wire_bytes == pytest.approx(2 * 60 * 3 / 4)
    cp = TR.collective_op("collective-permute", t.to(torch.int8), 2)
    assert cp.wire_bytes == 15 and cp.dtype == "s8"


# ---------------------------------------------------------------------------
# cells, depth variants, extrapolation, the memory model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_cells_equal(arch):
    got = [dataclasses.asdict(s) for s in tbase.cells(arch)]
    assert got == [dataclasses.asdict(s) for s in jbase.cells(arch)]


def _variant_fields(cfg):
    moe = cfg.moe.first_dense if cfg.moe is not None else None
    return (cfg.n_layers, cfg.n_global_layers, moe)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_depth_variants_extrapolation_and_slstm_flops_equal(arch):
    tv, tfull = TE.depth_variants(tbase.get(arch))
    jv, jfull = JE.depth_variants(jbase.get(arch))
    assert tfull == jfull
    assert [(_variant_fields(c), n) for c, n in tv] == \
        [(_variant_fields(c), n) for c, n in jv]
    rng = np.random.default_rng(len(arch))
    samples = [(n, float(rng.uniform(1, 1e12))) for _, n in tv]
    assert TE.solve_and_extrapolate(samples, tfull) == \
        JE.solve_and_extrapolate(samples, jfull)
    for shape in tbase.SHAPES:
        for train in (False, True):
            assert TE.slstm_recurrent_flops(
                tbase.get(arch), tbase.SHAPES[shape], train) == \
                JE.slstm_recurrent_flops(jbase.get(arch),
                                         jbase.SHAPES[shape], train)


class _Mesh:
    """All the JAX package's memory model reads of a mesh: ``.shape``."""

    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_analytic_memory_bytes_equal(arch):
    for shape in tbase.SHAPES:
        for sizes, names in map(mesh_lib.production_geometry,
                                (False, True)):
            m = _Mesh(sizes, names)
            sh = tbase.SHAPES[shape]
            cache = (kvcache.cache_bytes(tbase.get(arch), sh.global_batch,
                                         sh.seq_len)
                     if sh.kind != "train" else 0)
            assert TM.analytic_memory_bytes(
                tbase.get(arch), tbase.SHAPES[shape], m, cache) == \
                JM.analytic_memory_bytes(jbase.get(arch),
                                         jbase.SHAPES[shape], m, cache)
            assert TM.analytic_memory_bytes(
                tbase.get(arch), tbase.SHAPES[shape],
                sharding.abstract_mesh(sizes, names), cache) == \
                TM.analytic_memory_bytes(tbase.get(arch),
                                         tbase.SHAPES[shape], m, cache)


# ---------------------------------------------------------------------------
# meshes and the fake world
# ---------------------------------------------------------------------------

def test_meshes_on_the_fake_backend():
    import torch.distributed as dist

    with D.fake_world(256):
        m = mesh_lib.make_production_mesh()
        assert tuple(m.mesh.shape) == (16, 16)
        assert m.mesh_dim_names == ("data", "model")
        assert dist.get_backend(m.get_group(1)) == "fake"
        with pytest.raises(ValueError, match="512"):
            mesh_lib.make_production_mesh(multi_pod=True)
        h = mesh_lib.make_host_mesh(512, 4)
        assert tuple(h.mesh.shape) == (256, 1)
        # the fake backend stages nothing: no host buffer on a fake world
        assert not sharding._stage(m.get_group(0), torch.empty(2))
    assert not dist.is_initialized()
    with D.fake_world(512):
        m = mesh_lib.make_production_mesh(multi_pod=True)
        assert m.mesh_dim_names == ("pod", "data", "model")


_IMPORT_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("repro.") or m.endswith("fake_pg"))
print(bad)
"""

# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------

#: a short train shape (the smoke shape's 2 rows): the lowering's cost is
#: its op count
SHORT = tbase.ShapeConfig("short", "train", 16, 2)
#: one arch of each family, split over three processes about even in time
DEPTH_GROUPS = (("deepseek-v3-671b",), ("hymba-1.5b",),
                ("xlstm-1.3b", "musicgen-medium", "smollm-135m",
                 "internvl2-26b"))
FAMILY_ARCHS = sum(DEPTH_GROUPS, ())


def deeper(arch: str):
    """The smoke config one block deeper than its deepest depth variant
    (whose own depth is one of its variants'), remat off (fewer ops to
    lower; the count is linear either way)."""
    cfg = tbase.get(arch, smoke=True)
    if cfg.family == "ssm":
        n = 3 * cfg.xlstm.slstm_every
    elif cfg.family in ("moe", "hybrid"):
        n = 4
    else:
        n = 3
    return dataclasses.replace(cfg, n_layers=n, remat=False)


#: each family's config (arch, n_layers; remat off) lowered at the short
#: shape at full depth and through its depth variants, in a process of its
#: own; prints {arch: [full, variants]} with the numbers the test reads
_DEPTH_PROBE = r"""
import dataclasses, json, sys
from repro_torch.configs import base
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh
cases, seq, batch = json.loads(sys.argv[1])
shape = base.ShapeConfig("short", "train", seq, batch)
out = {}
for arch, n in cases:
    cfg = dataclasses.replace(base.get(arch, smoke=True), n_layers=n,
                              remat=False)
    out[arch] = [{k: r[k] for k in ("flops", "argument_bytes", "depth")}
                 for r in (D.lower_cell(cfg, shape, 1, mesh.make_host_mesh,
                                        depth=how)
                           for how in ("full", "variants"))]
print(json.dumps(out))
"""

WIRE_MESHES = {"1x2": ((1, 2), ("data", "model"), "none"),
               "2x1": ((2, 1), ("data", "model"), "none"),
               "pod2x1x1_int8": ((2, 1, 1), ("pod", "data", "model"), "int8"),
               "2x2": ((2, 2), ("data", "model"), "none")}
WIRE_ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The processes first, all at once: one real step of each wire case
    on gloo CPU worlds of 2 and 4 (its collectives recorded), an import of
    every module of the port, and each family's smoke config lowered at
    full depth and through its depth variants (:data:`_DEPTH_PROBE`);
    meanwhile, here, the same wire cases lowered on the fake backend."""
    d = tmp_path_factory.mktemp("wire")
    cases = [{"name": n, "arch": WIRE_ARCH, "mesh": list(m[0]),
              "axes": list(m[1]), "method": m[2], "seq": SHORT.seq_len,
              "remat": False} for n, m in WIRE_MESHES.items()]
    (d / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               OMP_NUM_THREADS="1")
    spawn = lambda cmd, env: subprocess.Popen(
        cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    procs = [spawn([sys.executable, str(TESTS / "torch_shard_ranks.py"),
                    "--phase", "wire", "--rank", str(r), "--world", str(w),
                    "--dir", str(d), "--cases", str(d / "cases.json")], env)
             for w in (2, 4) for r in range(w)]
    probe = spawn([sys.executable, "-c", _IMPORT_PROBE],
                  {"PYTHONPATH": str(TESTS.parent / "src"),
                   "PATH": "/usr/bin:/bin"})
    lowerings = [spawn([sys.executable, "-c", _DEPTH_PROBE, json.dumps(
        [[[a, deeper(a).n_layers] for a in group], SHORT.seq_len,
         SHORT.global_batch])], env) for group in DEPTH_GROUPS]
    deadline = time.monotonic() + 120.0
    try:
        cfg = dataclasses.replace(tbase.get(WIRE_ARCH, smoke=True),
                                  remat=False)
        wire = {n: D.lower_cell(cfg, SHORT, math.prod(m[0]),
                                functools.partial(mesh_lib.make_mesh, *m[:2]),
                                grad_compress=m[2])
                for n, m in WIRE_MESHES.items()}
        outs = []
        for p in procs + [probe] + lowerings:
            out, _ = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            assert p.returncode == 0, out[-4000:]
            outs.append(out)
    finally:
        for p in procs + [probe] + lowerings:
            if p.poll() is None:
                p.kill()
                p.wait()
    real = {}
    for w in (2, 4):
        real.update(json.loads((d / f"wire_{w}.json").read_text()))
    depth = {}
    for out in outs[len(procs) + 1:]:
        depth.update(json.loads(out.strip().splitlines()[-1]))
    return {"wire": wire, "real": real, "depth": depth,
            "imports": outs[len(procs)].strip()}


def test_importing_the_port_starts_no_fake_world(runs):
    assert runs["imports"] == "[]"


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_extrapolated_flops_equal_the_full_depth_count(runs, arch):
    """dense, MoE (with leading dense layers), hybrid, ssm, audio, vlm:
    counted FLOPs are linear in the block counts, so the fit of the depth
    variants is the full-depth count (to float rounding); so are the
    argument bytes."""
    full, fit = runs["depth"][arch]
    assert full["depth"] == "full" and fit["depth"].startswith("extrap")
    _, counts = TE.depth_variants(deeper(arch))
    assert all(v[0].n_layers < deeper(arch).n_layers
               for v in TE.depth_variants(deeper(arch))[0]), counts
    assert fit["flops"] == pytest.approx(full["flops"], rel=1e-9)
    assert fit["argument_bytes"] == pytest.approx(full["argument_bytes"],
                                                  rel=1e-9)
    assert full["flops"] > 0


def test_counted_slstm_products_are_slstm_recurrent_flops():
    """The scan's forward counts one recurrent product a step; with the
    backward (dh a step, dR as one product over the steps) three."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import xlstm as X

    cfg = tbase.get("xlstm-1.3b", smoke=True)
    one = dataclasses.replace(cfg, n_layers=cfg.xlstm.slstm_every)
    nh, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    b, l = 2, 24
    gx = torch.randn(b, l, 4 * cfg.d_model, requires_grad=True)
    rg = torch.randn(4, nh, dh, dh, requires_grad=True)
    z = torch.zeros(b, nh, dh)
    for train in (False, True):
        with FlopCounterMode(display=False) as fc:
            hs, *_ = X.SLSTMScan.apply(gx, X._recurrent_weights(rg), z, z,
                                       z - 1e30, z)
            if train:
                torch.autograd.grad(hs.sum(), [gx, rg])
        shape = tbase.ShapeConfig("s", "train" if train else "prefill", l, b)
        assert fc.get_total_flops() == TE.slstm_recurrent_flops(one, shape,
                                                                train)


@pytest.mark.parametrize("case", list(WIRE_MESHES))
def test_lowered_collectives_equal_a_real_gloo_step(runs, case):
    got = [[o.kind, o.dtype, list(o.shape), o.group_size, o.wire_bytes,
            o.operand_bytes] for o in runs["wire"][case]["collectives"]]
    want = runs["real"][case]["ops"]
    assert got == want
    wire = runs["real"][case]["wire"]
    assert sum(o[5] for o in got) == wire["bytes"]["sent"]
    assert len(got) == wire["calls"]["sent"]
    assert wire["bytes"]["staged"] == 0
    kinds = {o[0] for o in got}
    # the int8 pod ring shifts its payload; FSDP / TP gather parameters
    assert ("collective-permute" in kinds) == case.endswith("int8")
    assert ("all-gather" in kinds) == (not case.endswith("int8"))


def test_over_memory_is_a_failure_with_its_bytes(tmp_path, monkeypatch):
    """A cell whose per-rank peak exceeds the card fails, with its bytes,
    after its report is written (here against a card of 1 GB: smollm's
    decode_32k holds 8 rows of a 32768-position cache a rank)."""
    monkeypatch.setattr(D, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(TR, "HBM_BYTES", 1e9)
    with pytest.raises(D.OverMemory, match="over memory: per-rank peak"):
        D.run_cell("smollm-135m", "decode_32k", False)
    rep = json.loads((tmp_path / "smollm-135m__decode_32k__16x16.json")
                     .read_text())
    mem = rep["memory_per_device_bytes"]
    assert mem["fits"] is False and mem["peak_bytes"] > 1e9
    assert rep["hlo_flops_per_device"] > 0 and rep["depth"] == "full"
    assert "replicas" in rep["note"]


# ---------------------------------------------------------------------------
# the sharded step's memory, the reference's options
# ---------------------------------------------------------------------------

#: the growth check's mesh: 'data' > 1 splits the rows and shards the
#: parameters, as FSDP does
GROWTH_MESH = ((4, 1), ("data", "model"))
TINY = tbase.ShapeConfig("tiny", "train", 64, 2)


def _block_param_bytes(cfg) -> int:
    """The bytes of one block of ``cfg``'s ``blocks`` stack, whole."""
    from repro_torch.core.pytree import leaves
    from repro_torch.models import transformer

    return sum(math.prod(s.shape[1:]) * s.dtype.itemsize
               for s in leaves(transformer.param_spec(cfg)["blocks"]))


def test_sharded_step_peak_grows_by_a_blocks_share_only():
    """Full-width smollm-135m at 4 and 8 blocks, lowered on a (4, 1) mesh
    of a fake world at 2 x 64 tokens: each added block raises the
    per-rank peak by less than its whole parameters plus gradients (7.08
    MB each). It adds a quarter of the block's parameters, moments and
    gradient (measured 7.08 MB a block, the state's own growth 5.31 MB);
    gathering every block whole before the forward and reducing whole
    gradients added 17.7 MB a block."""
    peaks = {}
    for n in (4, 8):
        cfg = dataclasses.replace(tbase.get("smollm-135m"), n_layers=n)
        assert cfg.remat
        peaks[n] = D.lower_cell(
            cfg, TINY, math.prod(GROWTH_MESH[0]),
            functools.partial(mesh_lib.make_mesh, *GROWTH_MESH))["peak_bytes"]
    per_block = (peaks[8] - peaks[4]) / 4
    assert 0 < per_block < 2 * _block_param_bytes(cfg), (peaks, per_block)


def test_dry_run_lowers_grouped_moonshot(tmp_path, monkeypatch):
    """``run_cell(cfg_overrides=, tag=)`` as the JAX package's: the
    ``moe_*`` keys reach ``cfg.moe`` (every MoE layer lowered runs grouped
    dispatch with 16 groups), another key the config (2 of moonshot's 48
    layers), the tag the report's name. train_4k's logits alone (16 x
    4096 rows of a 163,840-entry vocabulary a rank, f32) put the cell
    over the card's memory at any depth: the report is written first."""
    from repro_torch.models import moe as moe_lib

    monkeypatch.setattr(D, "ARTIFACTS", tmp_path)
    seen = []
    moe_ffn = moe_lib.moe_ffn
    monkeypatch.setattr(moe_lib, "moe_ffn", lambda p, x, cfg, *a, **k: (
        seen.append((cfg.moe.grouped_dispatch, cfg.moe.n_groups)),
        moe_ffn(p, x, cfg, *a, **k))[1])
    try:
        D.run_cell("moonshot-v1-16b-a3b", "train_4k", False,
                   cfg_overrides={"moe_grouped_dispatch": True,
                                  "moe_n_groups": 16, "n_layers": 2},
                   tag="grouped")
    except D.OverMemory:
        pass
    rep = json.loads((tmp_path / "moonshot-v1-16b-a3b__train_4k__16x16"
                                 "__grouped.json").read_text())
    assert rep["tag"] == "grouped" and rep["n_layers"] == 2
    assert rep["hlo_flops_per_device"] > 0
    # every call: the forward and the remat recompute of the one MoE
    # layer, in the first depth variant's lowering and the full depth's
    assert seen == [(True, 16)] * 4, seen
    dense = D.override(tbase.get("smollm-135m"), {"moe_n_groups": 4,
                                                  "n_layers": 3})
    assert dense.moe is None and dense.n_layers == 3


def test_dry_run_cli_passes_the_grouped_options(monkeypatch, capsys):
    got = []

    def run_cell(arch, shape, multi, **kw):
        got.append((arch, shape, multi, kw))
        return {"step_s": 1.0, "bottleneck": "compute",
                "roofline_fraction": 0.5, "hlo_flops_per_device": 1.0,
                "wire_bytes_per_device": 0.0,
                "memory_per_device_bytes": {"peak_bytes": 1e9},
                "lower_s": 0.0, "depth": "full"}

    monkeypatch.setattr(D, "run_cell", run_cell)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "moonshot-v1-16b-a3b", "--shape", "train_4k",
        "--mesh", "single", "--moe-grouped", "--n-groups", "8", "--tag",
        "g8"])
    D.main()
    assert len(got) == 1
    _, _, multi, kw = got[0]
    assert not multi and kw["tag"] == "g8"
    assert kw["cfg_overrides"] == {"moe_grouped_dispatch": True,
                                   "moe_n_groups": 8}
    assert "all dry-run cells passed" in capsys.readouterr().out
