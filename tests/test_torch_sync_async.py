"""The SYNC and ASYNC checkpoint placements of the port against the JAX
package's, on the CPU, and the repairs their worker threads needed.

* ``train_loop(insitu_mode="sync" | "async")`` on the smoke config writes
  lossy leaf blobs that are ``repro``'s ``encode_leaf`` of the same host
  array, and its checkpoints restore in ``repro``; a ``repro`` SYNC
  checkpoint restores in the port. The blob rule is
  ``tests/test_torch_spectral_single.py``'s: bitwise where the two
  packages' DCTs of the leaf are bitwise equal (XLA's CPU product of 56
  rows and more); below that, XLA sums the DCT in another order and the
  frames agree in everything but q within one step and scales within
  rtol 1e-5.
* The runtime charges the loop as the JAX package's does: SYNC to
  ``sync_stall_s``, ASYNC to ``handoff_dispatch_s``, on the same plan.
* Kernel builds and launch counts are safe from several threads (the
  per-leaf encode and the leaf-parallel restore launch from workers).
"""
import os
import stat
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JConfig
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import serialization as JS
from repro.core.runtime import Placement as JPlacement
from repro.core.session import InSituPlan as JPlan
from repro.core.session import Session as JSession
from repro.kernels import ref as JR
from repro_torch.checkpoint import serialization as TS
from repro_torch.checkpoint.manager import default_lossy_policy
from repro_torch.configs import base as tbase
from repro_torch.core import lossy as TL
from repro_torch.core import pytree
from repro_torch.core.session import Every, InSituPlan, Placement, Session, \
    TaskSpec
from repro_torch.kernels import _build
from repro_torch.kernels import ref as TR
from repro_torch.kernels import spectral_lossy as TK
from repro_torch.launch import train as TT
from test_torch_checkpoint import _check_restored, _jax_state, _port

ARCH = "smollm-135m"
_jdct = jax.jit(JR.dct_blocks)


def _same_dct(arr: np.ndarray) -> bool:
    """Whether the two packages' DCTs of this leaf are bitwise equal."""
    xb, _ = TR.blockize(torch.from_numpy(np.ascontiguousarray(arr)))
    xb = torch.nn.functional.pad(xb, (0, 0, 0, (-xb.shape[0]) % 8))
    return np.array_equal(TR.dct_blocks(xb).numpy(),
                          np.asarray(_jdct(xb.numpy())))


def _assert_blob_is_jaxs(key, port_blob, arr):
    """``port_blob`` against ``repro``'s encode of the same bf16 leaf."""
    bits = arr.view(np.uint16)
    want, ent = JS.encode_leaf(key, bits, lossy_policy=default_lossy_policy,
                               bf16_keys={key})
    assert ent["lossy"]
    widened = (bits.astype(np.uint32) << 16).view(np.float32)
    if _same_dct(widened):
        assert port_blob == want, key
        return True
    assert widened.size < 56 * TR.BLOCK, key
    got_c, want_c = TL._parse_frame(port_blob), TL._parse_frame(want)
    assert (got_c.n_elements, got_c.shape, got_c.dtype) == \
        (want_c.n_elements, want_c.shape, want_c.dtype)
    dq = np.abs(got_c.q.astype(np.int16) - want_c.q.astype(np.int16))
    assert dq.max() <= 1, key
    np.testing.assert_allclose(got_c.scale, want_c.scale, rtol=1e-5, atol=0)
    return False


def _blobs(d):
    man = TS.read_manifest(d)
    out = {}
    for key, ent in man["leaves"].items():
        with open(os.path.join(d, ent["file"]), "rb") as f:
            f.seek(ent["offset"])
            out[key] = f.read(ent["bytes"])
    return man, out


def _jax_template():
    from repro import optim as JO
    from repro.configs import base as jbase
    from repro.models import params as JP
    from repro.models import transformer as JT
    cfg = jbase.get(ARCH, smoke=True)
    params = JP.materialize(jax.random.PRNGKey(0), JT.param_spec(cfg))
    ost = JO.init(params, JO.AdamWConfig())
    return {"params": params, "mu": ost.mu, "nu": ost.nu,
            "count": ost.count}


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_train_loop_placements_write_jaxs_blobs_and_restore_across(
        tmp_path, mode):
    emitted: dict[int, dict] = {}

    def keep(step, payload):
        emitted[step] = {pytree.keystr(p): np.array(a) for p, a in
                         pytree.flatten_with_path(payload)}

    base = InSituPlan.from_dict(TT.default_train_plan(
        insitu_mode=mode, ckpt_dir=str(tmp_path), ckpt_every=3,
        device="cpu"))
    probe = TaskSpec(name="probe", stream="train_state", trigger=Every(3),
                     placement=Placement.SYNC, sink=keep)
    plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                      workers=base.workers)
    out = TT.train_loop(ARCH, steps=7, plan=plan, device="cpu",
                        log=lambda _: None)
    rep = out["session_report"]
    assert rep["errors"] == [] and rep["checkpoint"]["saves"] == 3
    assert np.isfinite(out["losses"]).all()
    if mode == "sync":
        assert rep["sync_stall_s"] > 0
    else:
        assert rep["handoff_dispatch_s"] > 0
    n_lossy = n_bitwise = 0
    for step in (3, 6):
        d = str(tmp_path / f"step_{step:09d}")
        man, blobs = _blobs(d)
        for key, ent in man["leaves"].items():
            arr = emitted[step][key]
            if not ent["lossy"]:
                continue
            n_lossy += 1
            n_bitwise += _assert_blob_is_jaxs(key, blobs[key], arr)
        # restores in repro: params as emitted, moments within bound
        restored = JS.read_state(d, _jax_template())
        for p, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
            key = jax.tree_util.keystr(p)
            got = np.asarray(leaf)
            want = emitted[step][key]
            if key.startswith("['mu']") or key.startswith("['nu']"):
                g = got.astype(np.float32)
                w = (want.view(np.uint16).astype(np.uint32) << 16
                     ).view(np.float32)
                num = np.linalg.norm((g - w).reshape(-1))
                assert num <= TR.error_bound(1e-2) * max(
                    np.linalg.norm(w.reshape(-1)), 1e-30), key
            else:
                assert np.array_equal(got.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8)), key
    n_leaves = len(pytree.leaves(TT.init_state(
        tbase.get(ARCH, smoke=True), 0, TT.StepConfig().opt,
        device="cpu")["params"]))
    assert n_lossy == 2 * 2 * n_leaves
    assert n_bitwise >= 2 * 2          # the embedding moments at least


def test_jax_sync_checkpoint_restores_in_port(tmp_path):
    jstate = _jax_state(8)
    mgr = JManager(JConfig(str(tmp_path), mode=JPlacement.SYNC, every=1))
    mgr.save(4, jstate)
    mgr.wait_idle()
    mgr.finish()
    d = str(tmp_path / "step_000000004")
    assert any(e["lossy"] for e in JS.read_manifest(d)["leaves"].values())
    _check_restored(TS.read_state(d, _port(jstate), "cpu"), jstate)


def _placement_run(session_cls, plan_cls, state, mode, directory, **opts):
    plan = plan_cls.from_dict({
        "streams": ["train_state"], "workers": 2,
        "tasks": {"checkpoint": {
            "stream": "train_state", "preset": "checkpoint", "every": 2,
            "placement": mode,
            "options": {"directory": str(directory), **opts}}}})
    with session_cls(plan) as session:
        for i in range(5):
            with session.step_span(i):
                time.sleep(0.005)
            session.emit("train_state", i, lambda: state)
    return session.report()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_placements_charge_the_loop_as_jax_does(tmp_path, mode):
    """``tests/test_session.py``'s fig02 semantics on the checkpoint
    preset, through both packages on the same plan."""
    jstate = _jax_state(9)
    t_rep = _placement_run(Session, InSituPlan, _port(jstate), mode,
                           tmp_path / "port", device="cpu")
    j_rep = _placement_run(JSession, JPlan, jstate, mode, tmp_path / "jax")
    assert set(j_rep) <= set(t_rep)
    for rep in (t_rep, j_rep):
        assert rep["checkpoint"]["saves"] == 3 and rep["n_errors"] == 0
        if mode == "sync":
            assert rep["sync_stall_s"] > 0
            assert rep["handoff_dispatch_s"] == 0
            assert rep["async_overlapped_s"] == 0
        else:
            assert rep["handoff_dispatch_s"] > 0
            assert rep["sync_stall_s"] == 0
            assert rep["async_overlapped_s"] > 0


def test_slice_entry_points_need_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core import compression

    x = np.linspace(0, 1, 3000, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compression.get("spectral").encode(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compression.get("spectral-coarse").encode(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.compress_tree({"mu": x})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.train_loop(ARCH, steps=1, insitu_mode="sync",
                      ckpt_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.train_loop(ARCH, steps=1, insitu_mode="async",
                      ckpt_dir=str(tmp_path / "b"))
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "c"), every=1,
                                             mode=Placement.SYNC))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgr.save(0, {"mu": torch.from_numpy(x)})
    # and each runs on the CPU when told so
    codec = TL.SpectralLossyCodec(device="cpu")
    assert codec.decode(codec.encode(x)).shape == x.shape
    blobs, _ = TL.compress_tree({"mu": x}, device="cpu")
    assert blobs["['mu']"][:4] == TL.LOSSY_MAGIC
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "d"), every=1,
                                             mode=Placement.SYNC,
                                             device="cpu"))
    mgr.save(0, {"mu": torch.from_numpy(x)})
    mgr.finish()
    assert mgr.list_steps() == [0]


# ---------------------------------------------------------------------------
# the repairs: concurrent builds, thread-safe launch counts
# ---------------------------------------------------------------------------

_STUB_NVCC = """#!/bin/sh
# a stand-in compiler: logs its call, takes a moment, writes its -o file
echo "$@" >> "{log}"
sleep 0.3
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
printf 'stub library\\n' > "$out"
"""


def test_concurrent_first_build_compiles_each_source_once(tmp_path,
                                                          monkeypatch):
    cuda_home = tmp_path / "cuda"
    (cuda_home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = cuda_home / "bin" / "nvcc"
    nvcc.write_text(_STUB_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(cuda_home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = ["spectral_lossy", "paged_attention"]
    results: list = []
    errors: list = []

    def worker():
        try:
            results.append(_build.build(names))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(results) == 8
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in calls) == \
        ["paged_attention.cu", "spectral_lossy.cu"]
    for name in names:
        lib = _build.target(name)
        assert lib.parent == tmp_path / "build"
        assert lib.read_text() == "stub library\n"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()
                  if ".tmp" in p.name) == []
    # one compile each: every other thread found the library built
    assert sum(1 for r in results for v in r.values() if v > 0) == 2


def test_launch_counter_loses_no_count_across_threads():
    TK.reset_launches()

    def bump():
        for _ in range(10_000):
            _build.count_launch(TK.threshold_quant)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert TK.threshold_quant.launches == 80_000
    TK.reset_launches()
    assert TK.threshold_quant.launches == 0
