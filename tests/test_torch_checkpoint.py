"""The port's checkpoints against the JAX package's, on the CPU, and the
port's crash consistency.

* A HYBRID checkpoint written by either package restores in the other:
  lossless leaves bitwise, lossy moment leaves within ``error_bound(eps)``
  relative L2 of what was saved (the int8 spectral codec's guarantee).
* The stored leaf blobs are byte-identical between the packages for the
  same state (the manifest differs only in the meta each run records),
  and so are the files of both layouts: v2 shards at the same
  byte-balanced boundaries for any ``shard_count``, v1 per-leaf files
  under the same names. Checkpoints cross both ways in both layouts.
* The write options of the JAX package's config (``shard_count``,
  ``format``, ``leaf_parallel``, ``chunk_parallel``) with its validation;
  a plan that sets them builds in the port; none changes a stored byte.
* The kill points of ``tests/test_checkpoint_crash.py``, for the v2 layout
  the port writes: a crash at any stage of the commit protocol leaves the
  previous step restorable, and a restarted manager clears the debris.
"""
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JConfig
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import serialization as JS
from repro.configs import base as jbase
from repro.core.runtime import Placement as JPlacement
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.checkpoint import (CheckpointConfig, CheckpointCorruptError,
                                    CheckpointManager, serialization as TS)
from repro_torch.core import pytree
from repro_torch.core.runtime import Placement
from repro_torch.kernels.ref import error_bound
from repro_torch.launch.train import state_from_numpy

EPS = 1e-2


def _jax_state(seed=0):
    cfg = jbase.get("smollm-135m", smoke=True)
    params = JP.materialize(jax.random.PRNGKey(seed), JT.param_spec(cfg))
    rng = np.random.default_rng(seed)
    mom = lambda s: jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * s,
                              jnp.bfloat16), params)
    return {"params": params, "mu": mom(1e-3),
            "nu": jax.tree.map(jnp.abs, mom(1e-6)),
            "count": jnp.asarray(7, jnp.int32)}


def _port(jstate):
    return state_from_numpy(jax.device_get(jstate), "cpu")


def _flat_np(tree):
    """keystr -> f32/int numpy of a JAX tree or a port tree."""
    if any(isinstance(x, torch.Tensor) for x in pytree.leaves(tree)):
        return {pytree.keystr(p): (t.float() if t.is_floating_point()
                                   else t).numpy()
                for p, t in pytree.flatten_with_path(tree)}
    return {jax.tree_util.keystr(p): np.asarray(
                l.astype(jnp.float32) if jnp.issubdtype(l.dtype, jnp.floating)
                else l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_restored(got, want):
    got, want = _flat_np(got), _flat_np(want)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if "'mu'" in key or "'nu'" in key:
            num = np.linalg.norm((g - w).reshape(-1))
            den = max(np.linalg.norm(w.reshape(-1)), 1e-30)
            assert num / den <= error_bound(EPS), key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _port_save(directory, state, step=3, **kw):
    kw.setdefault("mode", Placement.HYBRID)
    mgr = CheckpointManager(CheckpointConfig(str(directory), every=1,
                                             device="cpu", **kw))
    mgr.save(step, state)
    mgr.wait_idle()
    mgr.finish()
    return os.path.join(str(directory), f"step_{step:09d}")


def _jax_save(directory, state, step=3, mode=JPlacement.HYBRID, **kw):
    mgr = JManager(JConfig(str(directory), mode=mode, every=1, **kw))
    mgr.save(step, state)
    mgr.wait_idle()
    mgr.finish()
    return os.path.join(str(directory), f"step_{step:09d}")


def _blobs(d):
    man = JS.read_manifest(d)
    out = {}
    for key, ent in man["leaves"].items():
        with open(os.path.join(d, ent["file"]), "rb") as f:
            f.seek(ent.get("offset", 0))
            out[key] = f.read(ent["bytes"])
    return man, out


def test_port_hybrid_checkpoint_restores_in_jax(tmp_path):
    jstate = _jax_state()
    d = _port_save(tmp_path, _port(jstate))
    restored = JS.read_state(d, jstate)
    _check_restored(restored, jstate)
    assert restored["mu"]["embed"]["embedding"].dtype == jnp.bfloat16


def test_jax_hybrid_checkpoint_restores_in_port(tmp_path):
    jstate = _jax_state(1)
    d = _jax_save(tmp_path, jstate)
    template = _port(jstate)
    restored = TS.read_state(d, template, "cpu")
    _check_restored(restored, jstate)
    for (_, a), (_, b) in zip(pytree.flatten_with_path(restored),
                              pytree.flatten_with_path(template)):
        assert a.dtype == b.dtype and a.shape == b.shape


def test_jax_v1_checkpoint_restores_in_port(tmp_path):
    jstate = _jax_state(2)
    d = _jax_save(tmp_path, jstate, mode=JPlacement.SYNC, format=1)
    assert "offset" not in next(iter(JS.read_manifest(d)["leaves"].values()))
    _check_restored(TS.read_state(d, _port(jstate), "cpu"), jstate)


def test_jax_multi_shard_checkpoint_restores_in_port(tmp_path):
    """The port writes one shard but reads the JAX package's several."""
    jstate = _jax_state(5)
    d = _jax_save(tmp_path, jstate, shard_count=3)
    files = {e["file"] for e in JS.read_manifest(d)["leaves"].values()}
    assert len(files) > 1
    _check_restored(TS.read_state(d, _port(jstate), "cpu"), jstate)


def test_port_writes_one_shard(tmp_path):
    d = _port_save(tmp_path, _port(_jax_state(6)))
    entries = JS.read_manifest(d)["leaves"].values()
    assert {e["file"] for e in entries} == {"shard_000.bin"}
    ends = sorted((e["offset"], e["offset"] + e["bytes"]) for e in entries)
    assert ends[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))
    assert os.path.getsize(os.path.join(d, "shard_000.bin")) == ends[-1][1]


@pytest.mark.parametrize("mode", ["hybrid", "sync"])
def test_leaf_blobs_byte_identical_between_packages(tmp_path, mode):
    """HYBRID: every leaf. SYNC compresses each moment leaf on its own, and
    for a leaf of fewer than 16 blocks XLA's CPU product sums the DCT in
    another order than PyTorch's: there the lossless leaves are identical
    and the lossy ones are held to their bound by the restore tests."""
    jstate = _jax_state(3)
    jd = _jax_save(tmp_path / "jax", jstate, mode=JPlacement(mode))
    td = _port_save(tmp_path / "port", _port(jstate), mode=Placement(mode))
    jman, jblobs = _blobs(jd)
    tman, tblobs = _blobs(td)
    assert set(jblobs) == set(tblobs)
    for key in jblobs:
        same = mode == "hybrid" or not jman["leaves"][key]["lossy"]
        if same:
            assert tblobs[key] == jblobs[key], key
        for f in ("bytes", "lossy", "raw_bytes", "bf16")[0 if same else 1:]:
            assert tman["leaves"][key][f] == jman["leaves"][key][f], (key, f)
    assert sum(e["lossy"] for e in tman["leaves"].values()) == \
        2 * len(jax.tree.leaves(jstate["params"]))


def test_async_mirror_and_retention(tmp_path):
    state = _port(_jax_state(4))
    mgr = CheckpointManager(CheckpointConfig(
        str(tmp_path / "ck"), mode=Placement.ASYNC, every=2, keep=2,
        device="cpu", mirror=f"file://{tmp_path / 'mirror'}"))
    for step in range(7):
        mgr.maybe_save(step, state)
    mgr.wait_idle()
    mgr.finish()
    assert mgr.list_steps() == [4, 6]
    assert mgr.mirror_stats["steps"] == 4 and mgr.mirror_stats["failures"] == 0
    step, restored = mgr.restore(state)
    assert step == 6
    _check_restored(restored, state)


# ---------------------------------------------------------------------------
# kill points of the commit protocol (v2 layout)
# ---------------------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((64, 32), generator=g),
              "b": torch.zeros((32,))}
    mom = {k: torch.zeros(v.shape, dtype=torch.bfloat16)
           for k, v in params.items()}
    return {"params": params, "opt": {"mu": mom, "nu": dict(mom)}}


def _mgr(directory, **kw):
    return CheckpointManager(CheckpointConfig(
        str(directory), mode=Placement.SYNC, every=1, device="cpu", **kw))


def _backdate(path, age_s=3600):
    t = time.time() - age_s
    for p in [path] + [os.path.join(path, n) for n in os.listdir(path)]:
        os.utime(p, (t, t))


@pytest.mark.parametrize("kill", ["before_manifest", "before_rename"])
def test_crash_before_publish_previous_step_restores(tmp_path, kill):
    state = _state()
    mgr = _mgr(tmp_path)
    mgr.save(1, state)
    tmp = tmp_path / ".tmp_step_000000002"
    shutil.copytree(tmp_path / "step_000000001", tmp)
    if kill == "before_manifest":          # blobs written, no manifest
        os.remove(tmp / "manifest.json")
    else:                                  # manifest tmp never renamed in
        os.replace(tmp / "manifest.json", tmp / "manifest.json.tmp")
    _backdate(tmp)
    assert mgr.list_steps() == [1]
    step, _ = mgr.restore(state)
    assert step == 1
    m2 = _mgr(tmp_path)                    # a restart sweeps the debris
    assert not tmp.exists()
    assert m2.list_steps() == [1]


def test_sweep_spares_fresh_tmp_dirs_of_a_live_writer(tmp_path):
    state = _state()
    _mgr(tmp_path).save(1, state)
    fresh = tmp_path / ".tmp_step_000000002"
    shutil.copytree(tmp_path / "step_000000001", fresh)
    _mgr(tmp_path)
    assert fresh.exists()                  # could be in-flight: kept
    _backdate(fresh)
    _mgr(tmp_path)
    assert not fresh.exists()              # genuinely stale: swept


def test_crash_mid_commit_recovers_displaced_step(tmp_path):
    state = _state()
    mgr = _mgr(tmp_path)
    mgr.save(5, state)
    os.replace(tmp_path / "step_000000005",
               tmp_path / ".old_step_000000005")
    assert mgr.list_steps() == []          # mid-commit: step invisible...
    m2 = _mgr(tmp_path)
    assert m2.list_steps() == [5]          # ...until recovery republishes it
    step, restored = m2.restore(state)
    assert step == 5
    assert torch.equal(restored["params"]["w"], state["params"]["w"])


def test_crash_after_commit_drops_stale_aside_copy(tmp_path):
    _mgr(tmp_path).save(5, _state())
    shutil.copytree(tmp_path / "step_000000005",
                    tmp_path / ".old_step_000000005")
    m2 = _mgr(tmp_path)
    assert not (tmp_path / ".old_step_000000005").exists()
    assert m2.list_steps() == [5]


def test_resave_same_step_never_deletes_the_only_copy(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(7, _state())
    mgr.save(7, _state(seed=1))
    assert not (tmp_path / ".old_step_000000007").exists()
    step, restored = mgr.restore(_state(seed=1))
    assert step == 7
    assert torch.equal(restored["params"]["w"], _state(1)["params"]["w"])


def test_truncated_or_missing_shard_raises_corrupt_error(tmp_path):
    state = _state()
    mgr = _mgr(tmp_path)
    mgr.save(1, state)
    shard = tmp_path / "step_000000001" / "shard_000.bin"
    shard.write_bytes(shard.read_bytes()[:-16])
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        mgr.restore(state)
    os.remove(shard)
    with pytest.raises(CheckpointCorruptError, match="missing shard"):
        mgr.restore(state)


def test_template_leaf_missing_from_manifest_raises_keyerror(tmp_path):
    state = _state()
    mgr = _mgr(tmp_path)
    mgr.save(1, state)
    grown = dict(state)
    grown["extra"] = torch.zeros((4,))
    with pytest.raises(KeyError, match="extra.*tree shape drifted"):
        mgr.restore(grown)


def test_async_saves_survive_manager_restart_with_debris(tmp_path):
    state = _state()
    m1 = CheckpointManager(CheckpointConfig(str(tmp_path), mode=Placement.ASYNC,
                                            every=1, device="cpu"))
    m1.save(1, state)
    m1.save(2, state)
    m1.runtime.drain()
    shutil.copytree(tmp_path / "step_000000002",
                    tmp_path / ".tmp_step_000000003")
    _backdate(tmp_path / ".tmp_step_000000003")
    os.replace(tmp_path / "step_000000001",
               tmp_path / ".old_step_000000001")
    m2 = CheckpointManager(CheckpointConfig(str(tmp_path), mode=Placement.ASYNC,
                                            every=1, device="cpu"))
    assert m2.list_steps() == [1, 2]
    step, _ = m2.restore(state)
    assert step == 2
    m2.finish()


def test_config_validation_and_card_default(tmp_path):
    with pytest.raises(ValueError, match="every"):
        CheckpointConfig(str(tmp_path), every=0)
    with pytest.raises(ValueError, match="keep"):
        CheckpointConfig(str(tmp_path), keep=-1)
    assert CheckpointConfig(str(tmp_path)).device == "cuda"



# ---------------------------------------------------------------------------
# write layouts and options: v1, multi-shard v2, serial encode
# ---------------------------------------------------------------------------

def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n != "manifest.json"}


@pytest.mark.parametrize("layout", [{"shard_count": 3}, {"format": 1}])
def test_port_checkpoint_layouts_restore_in_jax(tmp_path, layout):
    jstate = _jax_state(7)
    d = _port_save(tmp_path, _port(jstate), **layout)
    man = JS.read_manifest(d)
    ents = man["leaves"].values()
    if "format" in layout:
        assert man["format"] == 1 and all("offset" not in e for e in ents)
        assert {e["file"] for e in ents} == {JS._fname(k)
                                             for k in man["leaves"]}
    else:
        assert man["format"] == 2
        assert {e["file"] for e in ents} == {"shard_000.bin",
                                             "shard_001.bin", "shard_002.bin"}
    _check_restored(JS.read_state(d, jstate), jstate)


def test_jax_v1_and_multi_shard_restore_in_port_from_a_manager(tmp_path):
    """The port's manager (not only ``read_state``) restores both layouts
    the JAX package writes, whatever its own config's layout."""
    jstate = _jax_state(8)
    for name, kw in (("v1", {"format": 1}), ("shards", {"shard_count": 3})):
        _jax_save(tmp_path / name, jstate, **kw)
        mgr = CheckpointManager(CheckpointConfig(
            str(tmp_path / name), every=1, device="cpu", mode=Placement.SYNC))
        step, restored = mgr.restore(_port(jstate))
        mgr.finish()
        assert step == 3
        _check_restored(restored, jstate)


@pytest.mark.parametrize("layout", [{"shard_count": 3}, {"shard_count": 50},
                                    {"format": 1}])
def test_layout_files_byte_identical_between_packages(tmp_path, layout):
    """HYBRID saves of the same state: every file but the manifest is the
    same bytes under the same name (shard boundaries follow the same
    leaf order and byte budget; ``shard_count`` is clamped to the number
    of leaves), and the manifests' leaf tables are equal."""
    jstate = _jax_state(9)
    jd = _jax_save(tmp_path / "jax", jstate, **layout)
    td = _port_save(tmp_path / "port", _port(jstate), **layout)
    jfiles, tfiles = _files(jd), _files(td)
    assert list(tfiles) == list(jfiles)
    if layout.get("shard_count") == 3:
        assert len(tfiles) == 3
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    assert JS.read_manifest(td)["leaves"] == JS.read_manifest(jd)["leaves"]


def test_write_encoded_shards_rule_matches_jax(tmp_path):
    """The rollover rule on hand-made blobs: a shard closes once it holds
    ceil(total / shard_count) bytes; shard_count is an upper bound."""
    sizes = [5, 1, 9, 2, 2, 7, 1]
    enc = {f"k{i}": (bytes([i]) * n, {"bytes": n}) for i, n in
           enumerate(sizes)}
    for count in (1, 2, 3, 4, 7, 9):
        a = JS.write_encoded_shards(str(tmp_path / f"j{count}"), enc, count)
        b = TS.write_encoded_shards(str(tmp_path / f"t{count}"), enc, count)
        assert a == b, count
        assert _files(str(tmp_path / f"j{count}")) == \
            _files(str(tmp_path / f"t{count}"))
    assert TS.write_encoded_shards(str(tmp_path / "empty"), {}, 3) == {}
    v1 = TS.write_encoded(str(tmp_path / "v1"), enc)
    assert v1 == JS.write_encoded(str(tmp_path / "v1j"), enc)


def test_write_blobs_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    # a lossy leaf of 64 blocks: frames are byte-identical from 56 blocks
    # up (below, XLA's CPU DCT sums in another order; ROADMAP)
    host = {"['a']": rng.standard_normal((64, 40)).astype(np.float32),
            "['mu']": rng.standard_normal((64, 256)).astype(np.float32)}
    kw = dict(lossy_policy=lambda k: "mu" in k, shard_count=2)
    a = JS.write_blobs(host, str(tmp_path / "j"), **kw)
    b = TS.write_blobs(host, str(tmp_path / "t"), device="cpu", **kw)
    assert a == b
    assert _files(str(tmp_path / "j")) == _files(str(tmp_path / "t"))
    enc = TS.encode_blobs(host, device="cpu", **{"lossy_policy":
                                                 kw["lossy_policy"]})
    assert list(enc) == list(host)
    assert {k: e for k, (_, e) in enc.items()} == {
        k: {f: v for f, v in a[k].items() if f not in ("file", "offset")}
        for k in a}


@pytest.mark.parametrize("mode", ["sync", "async", "hybrid"])
def test_serial_encode_matches_leaf_parallel(tmp_path, mode):
    """leaf_parallel (and chunk_parallel) only change scheduling: stored
    bytes are identical, as in the JAX package."""
    state = _port(_jax_state(10))
    outs = {}
    for name, kw in (("fan", {}),
                     ("serial", {"leaf_parallel": False}),
                     ("serial_nochunk", {"leaf_parallel": False,
                                         "chunk_parallel": False})):
        d = _port_save(tmp_path / name, state, mode=Placement(mode), **kw)
        outs[name] = _files(d)
    assert outs["fan"] == outs["serial"] == outs["serial_nochunk"]


def test_serial_encode_stage_is_a_plain_stage(tmp_path):
    from repro_torch.core.runtime import FanoutStage, Stage

    fan = CheckpointManager(CheckpointConfig(str(tmp_path / "a"),
                                             device="cpu"))
    ser = CheckpointManager(CheckpointConfig(str(tmp_path / "b"),
                                             device="cpu",
                                             leaf_parallel=False))
    assert isinstance(fan._task.host_stages[0], FanoutStage)
    assert isinstance(ser._task.host_stages[0], Stage)
    assert ser._codec_pool() is not None
    nochunk = CheckpointConfig(str(tmp_path / "c"), device="cpu",
                               chunk_parallel=False)
    assert CheckpointManager(nochunk)._codec_pool() is None
    for m in (fan, ser):
        m.finish()


def test_config_validation_rejects_bad_values(tmp_path):
    """The JAX package's checks, with its wording, and the port's
    defaults equal to its defaults."""
    for Cfg in (JConfig, CheckpointConfig):
        with pytest.raises(ValueError, match="every") as a:
            Cfg(str(tmp_path), every=0)
        with pytest.raises(ValueError, match="keep"):
            Cfg(str(tmp_path), keep=-1)
        with pytest.raises(ValueError, match="format") as b:
            Cfg(str(tmp_path), format=3)
        with pytest.raises(ValueError, match="shard_count") as c:
            Cfg(str(tmp_path), shard_count=0)
        if Cfg is JConfig:
            want = (str(b.value), str(c.value))
        else:
            assert (str(b.value), str(c.value)) == want
    j, t = JConfig(str(tmp_path)), CheckpointConfig(str(tmp_path))
    for f in ("chunk_parallel", "format", "shard_count", "leaf_parallel",
              "every", "keep", "lossless", "lossy_eps", "lossy_moments",
              "p_i", "staging_capacity", "mirror"):
        assert getattr(t, f) == getattr(j, f), f


def test_jax_plan_with_write_options_builds_in_port(tmp_path):
    """A plan of the JAX package that sets the four write options builds
    and saves in the port (it used to be refused as a bad checkpoint
    option); an option neither package has is still refused."""
    from repro.core import session as JSess
    from repro_torch.core import session as TSess

    opts = {"directory": str(tmp_path / "ck"), "shard_count": 2,
            "format": 2, "leaf_parallel": False, "chunk_parallel": False}
    d = {"streams": ["train_state"],
         "tasks": {"ckpt": {"stream": "train_state", "preset": "checkpoint",
                            "every": 1, "placement": "sync",
                            "options": opts}}}
    JSess.InSituPlan.from_dict(d)
    plan = TSess.InSituPlan.from_dict(d)
    assert plan.to_dict() == JSess.InSituPlan.from_dict(d).to_dict()
    d["tasks"]["ckpt"]["options"] = {**opts, "device": "cpu"}
    state = _port(_jax_state(11))
    with TSess.Session(d, raise_on_error=True) as s:
        cfg = s.checkpoint.cfg
        assert (cfg.shard_count, cfg.format, cfg.leaf_parallel,
                cfg.chunk_parallel) == (2, 2, False, False)
        s.emit("train_state", 0, state)
    files = _files(str(tmp_path / "ck" / "step_000000000"))
    assert list(files) == ["shard_000.bin", "shard_001.bin"]
    d["tasks"]["ckpt"]["options"] = {**opts, "typo": 1}
    with pytest.raises(TSess.PlanError, match="bad checkpoint option"):
        TSess.Session(d)
