"""Hydration, the dense engine's graph and the tcp:// mirror, on the card.
Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (run it there with ``--noconftest``; see
README.md, "PyTorch/CUDA port").

* ``from_snapshot`` / ``load_snapshot`` into a graphed paged engine write
  the snapshot into the captured buffers in place (their addresses do not
  move), and the replays then decode what an eager engine hydrated from
  the same leaves decodes, bit for bit, over 20 steps;
* the dense engine's captured step against its eager step, bit for bit;
* a ``StreamSink`` sending chain frames from the in-situ worker thread
  while the loop replays: every frame arrives, the mirrored chain
  restores, and the tokens are the eager loop's.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import base as configs
from repro_torch.core.runtime import default_handoff
from repro_torch.kernels import paged_attention as PK
from repro_torch.launch import consume
from repro_torch.launch.serve import default_serve_plan, serve_loop
from repro_torch.models import params as P
from repro_torch.models import transformer
from repro_torch.serving import snapshot as S
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.pages import PagedServingEngine

ARCH = "smollm-135m"
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _params(cfg, dev):
    return P.materialize(torch.Generator().manual_seed(0),
                         transformer.param_spec(cfg), dev)


def _requests(cfg, seed, max_new=(5, 17, 3, 9, 12, 2, 20, 7)):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, 8 + i % 5),
                    max_new=n) for i, n in enumerate(max_new)]


def _buffers(e):
    return [e.pool["kv"]["k"], e.pool["kv"]["v"], e.page_table, e.lengths,
            e.tokens]


def _leaves(engine):
    """The engine's snapshot as a store restores it."""
    store = S.SnapshotStore()
    pay = engine.snapshot_payload()
    store.publish("kv_pages", 0, default_handoff(pay["cache"]),
                  version=pay["version"], chunk_hints=pay["chunk_hints"])
    return store.restore("kv_pages")[1]


def test_hydrated_graph_replays_equal_an_eager_replica(cuda):
    cfg = configs.get(ARCH, smoke=True)
    params = _params(cfg, cuda)
    kw = dict(num_pages=33, page_size=16, max_reqs=4, prompt_len=16,
              max_len=64, device=cuda)
    producer = PagedServingEngine(cfg, params, **kw)
    for r in _requests(cfg, 1, max_new=(12, 17, 10, 15)):
        assert producer.admit(r)
    for _ in range(3):
        producer.step()
    leaves = _leaves(producer)

    graphed = PagedServingEngine.from_snapshot(cfg, params, leaves,
                                               device=cuda)
    eager = PagedServingEngine.from_snapshot(cfg, params, leaves,
                                             device=cuda, cuda_graph=False)
    assert graphed._graph is not None and eager._graph is None
    ptrs = [b.data_ptr() for b in _buffers(graphed)]

    def lockstep():
        """Step both replicas until their requests finish (at most 20
        steps); logits bitwise every step; returns both token streams."""
        live = [[a for a in e.active if a is not None]
                for e in (graphed, eager)]
        assert len(live[0]) == 4
        PK.paged_decode_attention.launches = 0
        steps = 0
        while steps < 20 and any(a is not None for a in eager.active):
            graphed.step()
            eager.step()
            steps += 1
            assert torch.equal(graphed.logits, eager.logits)
        assert PK.paged_decode_attention.launches == 2 * steps * cfg.n_layers
        return [[list(r.out) for r in rows] for rows in live]

    first = lockstep()
    assert first[0] == first[1]
    # the warm path: write the same snapshot back into the captured
    # buffers and replay again — the same continuation
    graphed.load_snapshot(leaves)
    eager.load_snapshot(leaves)
    assert [b.data_ptr() for b in _buffers(graphed)] == ptrs
    assert lockstep() == first
    assert graphed.prefill_tokens == producer.prefill_tokens


def test_dense_graph_step_equals_eager(cuda):
    cfg = configs.get(ARCH, smoke=True)
    params = _params(cfg, cuda)
    kw = dict(slots=3, prompt_len=16, max_len=64, device=cuda)
    graphed = ServingEngine(cfg, params, cuda_graph=True, **kw)
    eager = ServingEngine(cfg, params, cuda_graph=False, **kw)
    assert graphed._graph is not None and eager._graph is None
    reqs = {e: _requests(cfg, 2) for e in (graphed, eager)}
    pending = {e: list(r) for e, r in reqs.items()}
    for _ in range(40):
        for e in (graphed, eager):
            while pending[e] and e.admit(pending[e][0]):
                pending[e].pop(0)
        if not any(a is not None for a in eager.active):
            break
        graphed.step()
        eager.step()
        assert torch.equal(graphed.logits, eager.logits)
        assert torch.equal(graphed.cache["kv"]["k"], eager.cache["kv"]["k"])
    assert [r.out for r in reqs[graphed]] == [r.out for r in reqs[eager]]
    assert all(r.done for r in reqs[graphed])


def test_mirror_sends_from_the_worker_while_the_loop_replays(cuda):
    source = consume.transport.StreamSource(port=0)
    out = {}
    t = threading.Thread(target=lambda: out.update(consume.consume_loop(
        source, idle_timeout_s=2.0, log=lambda *_: None)))
    t.start()
    try:
        kw = dict(n_requests=8, max_new=12, device=cuda, seed=0,
                  log=lambda *_: None)
        plan = default_serve_plan(snapshot_every=2, base_every=4,
                                  snapshot_to=source.address)
        served = serve_loop(ARCH, plan=plan, **kw)
        bare = serve_loop(ARCH, plan={"streams": ["kv_pages"]},
                          cuda_graph=False, **kw)
        t.join(60)
    finally:
        source.close()
    assert not t.is_alive()
    snap = served["session_report"]["tasks"]["kv_snapshot"]
    assert snap["mirror_failures"] == 0 and snap["mirror_frames"] >= 1
    assert out["snapshot_frames"] == snap["mirror_frames"]
    assert ([r.out for r in served["requests"]]
            == [r.out for r in bare["requests"]])
    step, leaves = out["store"].restore("kv_pages")
    assert step >= 0 and "['meta']" in leaves
