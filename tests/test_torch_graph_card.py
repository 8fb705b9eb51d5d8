"""Captured CUDA-graph steps against the eager steps, on the card. Every
test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (run it there with ``--noconftest``; see
README.md, "PyTorch/CUDA port").

A replay runs the eager step's kernels in the same order on the same
inputs, so the gates are bitwise: logits, token streams, losses and
states. Also: a hand-off's copy is not overtaken by the replays after
it, and a capture goes through while a worker thread runs the spectral
kernels on its own stream.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import base as configs
from repro_torch.core import pytree
from repro_torch.core.graphs import CapturedStep
from repro_torch.core.runtime import _start_d2h, default_handoff
from repro_torch.data.pipeline import batch_spec_for, synth_batch
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PK
from repro_torch.launch import train as T
from repro_torch.models import params as P
from repro_torch.models import transformer
from repro_torch.serving.engine import Request
from repro_torch.serving.pages import PagedServingEngine

ARCH = "smollm-135m"
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _flat(state):
    return {pytree.keystr(p): t for p, t in pytree.flatten_with_path(state)}


def _requests(cfg, seed):
    rng = np.random.default_rng(seed)
    max_new = [5, 17, 3, 9, 12, 2, 20, 7, 4, 11, 30, 6, 25, 14, 8, 19]
    return [Request(i, rng.integers(0, cfg.vocab_size, 8 + i % 5),
                    max_new=n) for i, n in enumerate(max_new)]


def test_decode_graph_equals_eager_over_40_steps(cuda):
    """A graphed engine and an eager one take the same traffic in step:
    admissions and completions between the steps, 40 steps. Every step's
    logits of the active rows and every token stream are bitwise equal,
    and the kernel counts once per layer per step on either engine."""
    cfg = configs.get(ARCH, smoke=True)
    _graph_equals_eager(cfg, cuda, paged_layers=cfg.n_layers)


def test_hybrid_decode_graph_equals_eager_over_40_steps(cuda):
    """The same for hymba's smoke config, whose rows carry state besides
    their pages (SWA rings of 32 slots, wrapped by the longer requests,
    and SSM state): the graphed engine's warm-up and finished requests
    leave idle rows' state behind, which an admission overwrites whole.
    The kernel counts once per global layer per step."""
    cfg = configs.get("hymba-1.5b", smoke=True)
    _graph_equals_eager(cfg, cuda, paged_layers=cfg.n_global_layers)


def test_xlstm_decode_graph_equals_eager_over_40_steps(cuda):
    """The same for xlstm's smoke config, whose rows carry only recurrent
    state (mLSTM ``c``/``n``/``m``/``conv``, sLSTM ``c``/``n``/``m``/``h``,
    written in place) and whose pool is empty: the kernel never runs, and
    the state after the 40 steps is bitwise equal too."""
    cfg = configs.get("xlstm-1.3b", smoke=True)
    graphed, eager = _graph_equals_eager(cfg, cuda, paged_layers=0)
    assert graphed.pool == {} and eager.pool == {}
    rows = torch.tensor([r for r, a in enumerate(graphed.active)
                         if a is not None], device=cuda)
    want = _flat(eager.state)
    for key, t in _flat(graphed.state).items():
        ax = 2 if key.startswith("['mlstm']") else 1   # the batch axis
        assert torch.equal(_bits(t.index_select(ax, rows)),
                           _bits(want[key].index_select(ax, rows))), key


def _graph_equals_eager(cfg, cuda, *, paged_layers):
    params = P.materialize(torch.Generator().manual_seed(0),
                           transformer.param_spec(cfg), cuda)
    kw = dict(num_pages=17, page_size=16, max_reqs=4, prompt_len=16,
              max_len=64, device=cuda)
    graphed = PagedServingEngine(cfg, params, cuda_graph=True, **kw)
    eager = PagedServingEngine(cfg, params, cuda_graph=False, **kw)
    assert graphed._graph is not None and eager._graph is None
    reqs = {e: _requests(cfg, 3) for e in (graphed, eager)}
    pending = {e: list(r) for e, r in reqs.items()}
    PK.paged_decode_attention.launches = 0
    steps = 0
    for _ in range(40):
        for e in (graphed, eager):
            while pending[e] and e.admit(pending[e][0]):
                pending[e].pop(0)
        rows = [r for r, a in enumerate(graphed.active) if a is not None]
        assert rows == [r for r, a in enumerate(eager.active)
                        if a is not None]
        if not rows:
            break
        graphed.step()
        eager.step()
        steps += 1
        assert torch.equal(_bits(graphed.logits[rows]),
                           _bits(eager.logits[rows]))
    assert steps == 40
    for a, b in zip(reqs[graphed], reqs[eager]):
        assert a.out == b.out, f"request {a.rid} diverged"
    assert sum(r.done for r in reqs[graphed]) >= 8
    torch.cuda.synchronize()
    assert PK.paged_decode_attention.launches == 2 * steps * paged_layers
    return graphed, eager


def _train_setup(dev, seed=0):
    cfg = configs.get(ARCH, smoke=True)
    step_cfg = T.StepConfig()
    spec = batch_spec_for(cfg, configs.SMOKE_SHAPE)
    batches = [synth_batch(spec, i) for i in range(3)]
    state = T.init_state(cfg, seed, step_cfg.opt, device=dev)
    return cfg, step_cfg, batches, state


def test_train_graph_equals_eager_three_steps(cuda):
    cfg, step_cfg, batches, state = _train_setup(cuda)
    ref = pytree.tree_map(lambda t: t.clone(), state)
    ptrs = {k: t.data_ptr() for k, t in _flat(state).items()}
    fn = T.make_train_step(cfg, step_cfg)
    step = T.graph_train_step(cfg, step_cfg, state, batches[0])
    assert int(state["count"]) == 0            # the warm-up advanced nothing
    for b in batches:
        m = step(b)
        ref, m_ref = fn(ref, {k: torch.from_numpy(v).to(cuda)
                              for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m[k], m_ref[k]), k
    assert {k: t.data_ptr() for k, t in _flat(state).items()} == ptrs
    got, want = _flat(state), _flat(ref)
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    assert int(state["count"]) == 3
    with pytest.raises(ValueError, match="shape"):
        step({k: v[:1] for k, v in batches[0].items()})


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b",
                                  "moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_family_train_graph_equals_eager_three_steps(cuda, arch):
    """The hybrid, xLSTM and MoE/MLA smoke configs: three replays of the
    captured train step equal three eager steps bit for bit (metrics and
    every state leaf), the state keeping its storage."""
    cfg = configs.get(arch, smoke=True)
    step_cfg = T.StepConfig()
    spec = batch_spec_for(cfg, configs.SMOKE_SHAPE)
    batches = [synth_batch(spec, i) for i in range(3)]
    state = T.init_state(cfg, 0, step_cfg.opt, device=cuda)
    ref = pytree.tree_map(lambda t: t.clone(), state)
    ptrs = {k: t.data_ptr() for k, t in _flat(state).items()}
    fn = T.make_train_step(cfg, step_cfg)
    step = T.graph_train_step(cfg, step_cfg, state, batches[0])
    assert int(state["count"]) == 0
    for b in batches:
        m = step(b)
        ref, m_ref = fn(ref, {k: torch.from_numpy(v).to(cuda)
                              for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m[k], m_ref[k]), (arch, k)
    assert {k: t.data_ptr() for k, t in _flat(state).items()} == ptrs
    got, want = _flat(state), _flat(ref)
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), (arch, k)
    assert int(state["count"]) == 3


@pytest.mark.parametrize("snapshot", [True, False])
def test_handoff_is_not_overtaken_by_replays(cuda, snapshot):
    """Emit the state after a step, replay twice, then materialize: the
    host copy equals a device copy taken right after the emitting step
    (with ``snapshot`` a clone at dispatch; without, the loop's stream
    waits for the copy)."""
    cfg, step_cfg, batches, state = _train_setup(cuda)
    step = T.graph_train_step(cfg, step_cfg, state, batches[0])
    step(batches[0])
    want = {k: t.clone() for k, t in _flat(state).items()}
    token = _start_d2h(state, snapshot=snapshot)
    step(batches[1])
    step(batches[2])
    got = _flat(default_handoff(token))
    for k, w in want.items():
        w = _bits(w).cpu().numpy()
        assert np.array_equal(got[k].view(w.dtype).reshape(w.shape), w), k
    assert int(state["count"]) == 3


def test_capture_while_a_worker_compresses(cuda):
    """A worker thread runs ``spectral_compress`` on its own stream while
    the main thread warms up and captures a train step: the capture goes
    through (``thread_local`` capture mode), the replay equals the eager
    step, and every compression the worker made equals one made alone."""
    x = torch.randn(64 * 1024, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    want = ops.spectral_compress(x, 1e-2)
    torch.cuda.synchronize()
    results, errors, stop = [], [], threading.Event()

    def work():
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                while not stop.is_set() or not results:
                    c = ops.spectral_compress(x, 1e-2)
                    s.synchronize()
                    results.append(c)
        except Exception as e:          # reported below, never swallowed
            errors.append(e)

    cfg, step_cfg, batches, state = _train_setup(cuda)
    ref = pytree.tree_map(lambda t: t.clone(), state)
    worker = threading.Thread(target=work)
    worker.start()
    try:
        step = T.graph_train_step(cfg, step_cfg, state, batches[0])
    finally:
        stop.set()
        worker.join(timeout=120)
    assert not worker.is_alive()
    assert not errors, errors
    assert results
    for c in results:
        assert torch.equal(c.q, want.q) and torch.equal(c.scale, want.scale)
    m = step(batches[0])
    _, m_ref = T.make_train_step(cfg, step_cfg)(
        ref, {k: torch.from_numpy(v).to(cuda) for k, v in batches[0].items()})
    assert torch.equal(m["loss"], m_ref["loss"])


def test_captured_step_counts_each_replay(cuda):
    """``CapturedStep`` on a bare kernel call: the warm-up's launches are
    dropped, and each replay adds the captured one once."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 1, 3, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((5, 8, 1, 16), np.float32))
    args = [t.to(cuda) for t in (q, k, k.clone())] + [
        torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda),
        torch.tensor([9, 16], dtype=torch.int32, device=cuda)]
    PK.paged_decode_attention.launches = 0
    g = CapturedStep(lambda: PK.paged_decode_attention(*args), device=cuda)
    assert PK.paged_decode_attention.launches == 0
    for n in range(1, 4):
        out = g.replay()
        assert PK.paged_decode_attention.launches == n
    torch.cuda.synchronize()
    assert torch.equal(out, PK.paged_decode_attention(*args))


def test_a_failed_capture_raises(cuda):
    """A step that syncs the host inside the capture raises; nothing steps
    eagerly in its place. Run in a process of its own, so that the failed
    capture leaves nothing behind for the other tests."""
    code = ("import torch\n"
            "from repro_torch.core.graphs import CapturedStep\n"
            "x = torch.ones(4, device='cuda')\n"
            "try:\n"
            "    CapturedStep(lambda: float(x.sum()))\n"
            "except RuntimeError as e:\n"
            "    print('raised:', str(e).splitlines()[0])\n"
            "else:\n"
            "    print('captured')\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("raised:"), out.stdout
