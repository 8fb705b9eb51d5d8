"""The in-place step bodies that the port captures in CUDA graphs (CPU).

On CUDA the paged engine replays a graph of its decode step and the
training loop one of its train step (``core/graphs.py``). A capture asks
two things of the step, and this file holds both on the CPU, where the
step runs eagerly through the same bodies:

* every device buffer keeps its storage: the engine's tokens, lengths,
  page table and pool across steps, admissions, completions and prefix
  registration; every train-state leaf across steps of
  ``inplace_train_step`` (checked by ``data_ptr()``);
* the in-place bodies give the bits of the functional ones they wrap:
  ``make_paged_decode`` plus the greedy argmax, and ``make_train_step``.
  Both still match the JAX package as ``test_torch_serving.py`` and
  ``test_torch_train.py`` hold it: equal greedy token streams; losses
  rtol 1e-5 and params rtol 1e-4 / atol 1e-6 (f32 on both sides, the same
  math summed in other orders; see ``test_torch_train.py``).

Also ``_build``'s launch counting under replay, on a stub wrapper and a
stub graph. The graphs themselves run only on the card
(``tests/test_torch_graph_card.py``).
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import base as jbase
from repro.models import params as JP
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro.serving import pages as JPG
from repro_torch.configs import base as tbase
from repro_torch.core import pytree
from repro_torch.data.pipeline import batch_spec_for, synth_batch
from repro_torch.kernels import _build
from repro_torch.launch import train as TT
from repro_torch.models import params as TP
from repro_torch.serving import engine as TE
from repro_torch.serving import pages as TPG

ARCH = "smollm-135m"
STEP = TT.StepConfig()
ENGINE = dict(num_pages=9, page_size=16, max_reqs=2, prompt_len=24,
              max_len=64)


def _jax_f32_params(seed=0):
    cfg = jbase.get(ARCH, smoke=True)
    prm = JP.materialize(jax.random.PRNGKey(seed), JT.param_spec(cfg))
    return (dataclasses.replace(cfg, dtype="float32"),
            JP.cast_tree(prm, jnp.float32))


def _port(jprm):
    tcfg = dataclasses.replace(tbase.get(ARCH, smoke=True), dtype="float32")
    return tcfg, TP.from_numpy_tree(jax.device_get(jprm), "cpu")


def _requests(cls, vocab, seed, max_new, prefix=None, first_rid=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(max_new):
        tail = rng.integers(0, vocab, size=4 if prefix is not None else 8)
        prompt = tail if prefix is None else np.concatenate([prefix, tail])
        out.append(cls(first_rid + i, prompt.astype(np.int32), max_new=n))
    return out


def _buffers(eng):
    """Every device buffer a captured decode step reads or writes."""
    bufs = {"tokens": eng.tokens, "lengths": eng.lengths,
            "page_table": eng.page_table}
    for path, leaf in pytree.flatten_with_path(eng.pool):
        bufs[f"pool{pytree.keystr(path)}"] = leaf
    return bufs


def _ptrs(eng):
    return {k: (t.data_ptr(), tuple(t.shape))
            for k, t in _buffers(eng).items()}


def test_cpu_engine_steps_eagerly_whatever_cuda_graph_says():
    _, jprm = _jax_f32_params()
    tcfg, tprm = _port(jprm)
    for flag in (True, False):
        eng = TPG.PagedServingEngine(tcfg, tprm, device="cpu",
                                     cuda_graph=flag, **ENGINE)
        assert eng._graph is None and eng.logits is None


def test_engine_buffers_keep_their_storage():
    """Steps, admissions (shared-prefix ones included), completions,
    prefix registration and its removal all write the engine's device
    buffers in place."""
    _, jprm = _jax_f32_params()
    tcfg, tprm = _port(jprm)
    eng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **ENGINE)
    want = _ptrs(eng)
    prefix = (np.random.default_rng(7).integers(0, tcfg.vocab_size, size=16)
              .astype(np.int32))
    key = eng.register_prefix(prefix)
    assert _ptrs(eng) == want
    reqs = (_requests(TE.Request, tcfg.vocab_size, 3, [2, 5, 3], prefix)
            + _requests(TE.Request, tcfg.vocab_size, 4, [4, 1], first_rid=3))
    pending = list(reqs)
    completions = 0
    for _ in range(64):
        while pending and eng.admit(pending[0]):
            pending.pop(0)
            assert _ptrs(eng) == want
        if not pending and all(a is None for a in eng.active):
            break
        active = sum(a is not None for a in eng.active)
        eng.step()
        completions += active - sum(a is not None for a in eng.active)
        assert _ptrs(eng) == want
    assert all(r.done for r in reqs) and completions == len(reqs)
    assert eng.unregister_prefix(key)
    assert _ptrs(eng) == want
    assert eng.page_stats()["used_pages"] == 0


def test_engine_step_gives_the_functional_decode_bits():
    """Each step equals ``make_paged_decode`` + argmax run on copies of
    the engine's buffers, bit for bit: logits, next tokens, lengths and
    the pool."""
    _, jprm = _jax_f32_params()
    tcfg, tprm = _port(jprm)
    eng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **ENGINE)
    for r in _requests(TE.Request, tcfg.vocab_size, 5, [12, 12]):
        assert eng.admit(r)
    decode = TPG.make_paged_decode(tcfg, ENGINE["page_size"])
    clone = lambda tree: pytree.tree_map(lambda t: t.clone(), tree)
    for _ in range(8):
        pool = clone(eng.pool)
        logits, pool, _, lengths = decode(
            eng.params, pool, eng.state, eng.page_table.clone(),
            eng.tokens.clone(), eng.lengths.clone())
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        eng.step()
        assert torch.equal(eng.logits, logits)
        assert torch.equal(eng.tokens[:, 0], nxt)
        assert torch.equal(eng.lengths, lengths)
        for (_, a), (_, b) in zip(pytree.flatten_with_path(eng.pool),
                                  pytree.flatten_with_path(pool)):
            assert torch.equal(a, b)
        assert [r.out[-1] for r in eng.active] == nxt.tolist()


@pytest.mark.parametrize("shared_prefix", [False, True])
def test_in_place_engine_token_streams_match_jax(shared_prefix):
    """The in-place step (built with the default ``cuda_graph=True``,
    which the CPU ignores) against the JAX engine's jitted step, with
    requests queueing on rows and pages."""
    jcfg, jprm = _jax_f32_params()
    tcfg, tprm = _port(jprm)
    prefix = (np.random.default_rng(7).integers(0, jcfg.vocab_size, size=16)
              .astype(np.int32) if shared_prefix else None)
    max_new = [3, 9, 5, 2, 7]
    ja = _requests(JE.Request, jcfg.vocab_size, 11, max_new, prefix)
    tb = _requests(TE.Request, tcfg.vocab_size, 11, max_new, prefix)
    jeng = JPG.PagedServingEngine(jcfg, jprm, **ENGINE)
    teng = TPG.PagedServingEngine(tcfg, tprm, device="cpu", **ENGINE)
    if shared_prefix:
        assert jeng.register_prefix(prefix) == teng.register_prefix(prefix)
    jeng.run(ja, max_steps=96)
    teng.run(tb, max_steps=96)
    for ra, rb in zip(ja, tb):
        assert ra.done and rb.done
        assert ra.out == rb.out, f"request {ra.rid} diverged"
    assert teng.page_stats() == jeng.page_stats()


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _batch(step):
    spec = batch_spec_for(tbase.get(ARCH, smoke=True), tbase.SMOKE_SHAPE)
    return {k: torch.from_numpy(v) for k, v in synth_batch(spec, step).items()}


def _state(seed=0, master=False):
    cfg = tbase.get(ARCH, smoke=True)
    opt = dataclasses.replace(STEP.opt, master_weights=master)
    return cfg, dataclasses.replace(STEP, opt=opt), \
        TT.init_state(cfg, seed, opt, device="cpu")


def _flat(state):
    return {pytree.keystr(p): t for p, t in pytree.flatten_with_path(state)}


@pytest.mark.parametrize("master", [False, True])
def test_inplace_train_step_keeps_storage_and_bits(master):
    """Three steps of the in-place body against three of the functional
    step from a copy of the same state: every leaf keeps its storage and
    ends bitwise equal; the metrics are equal."""
    cfg, step_cfg, state = _state(master=master)
    ref = pytree.tree_map(lambda t: t.clone(), state)
    ptrs = {k: t.data_ptr() for k, t in _flat(state).items()}
    body = TT.inplace_train_step(cfg, step_cfg, state)
    fn = TT.make_train_step(cfg, step_cfg)
    for i in range(3):
        m = body(_batch(i))
        ref, m_ref = fn(ref, _batch(i))
        assert {k: t.data_ptr() for k, t in _flat(state).items()} == ptrs
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m[k], m_ref[k]), k
    got, want = _flat(state), _flat(ref)
    assert got.keys() == want.keys()
    if master:
        assert any(k.startswith("['master']") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(state["count"]) == 3


@pytest.mark.parametrize("master", [False, True])
def test_a_dropped_step_frees_its_tensors_without_the_collector(master):
    """What a step makes dies with its last reference, with the garbage
    collector off: the capture's warm-up drops the functional step's new
    state and then hands the allocator's cached blocks back, which frees
    nothing still held by a reference cycle (a whole second state on the
    card). Weak references to the new state's leaves and to the gradients
    the step's AdamW read, then the outputs dropped. After one step first:
    the process's first call through ``torch.utils.checkpoint`` imports
    ``torch._dynamo``, which keeps that call's frames."""
    import gc
    import weakref

    cfg, step_cfg, state = _state(master=master)
    fn = TT.make_train_step(cfg, step_cfg)
    fn(state, _batch(0))
    grads = []
    update = TT.optim.update
    spy = lambda g, *a, **kw: (grads.extend(pytree.leaves(g)),
                               update(g, *a, **kw))[1]
    gc.collect()
    gc.disable()
    try:
        TT.optim.update = spy
        new_state, metrics = fn(state, _batch(0))
        TT.optim.update = update
        refs = [weakref.ref(t) for t in pytree.leaves(new_state) + grads]
        refs = [r for r in refs if r() is not None]
        assert len(refs) > len(pytree.leaves(state))
        del new_state, metrics, grads
        assert [r for r in refs if r() is not None] == []
    finally:
        TT.optim.update = update
        gc.enable()


def test_inplace_train_step_matches_jax():
    """Five in-place steps against five of the JAX package's jitted step
    from the same f32 state (tolerances as ``test_torch_train.py``)."""
    jcfg = jbase.get(ARCH, smoke=True)
    params = jax.tree.map(lambda x: x.astype(jnp.float32), JP.materialize(
        jax.random.PRNGKey(2), JT.param_spec(jcfg)))
    ost = JO.init(params, JO.AdamWConfig())
    jstate = {"params": params, "mu": ost.mu, "nu": ost.nu,
              "count": jnp.asarray(50, jnp.int32)}
    tstate = TT.state_from_numpy(jax.device_get(jstate), "cpu")

    @jax.jit
    def jstep(state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: JT.train_loss(p, jcfg, batch))(state["params"])
        lr = JO.schedules.warmup_cosine(
            state["count"], peak=STEP.lr_peak, warmup=STEP.lr_warmup,
            total=STEP.lr_total)
        o = JO.AdamWState(state["count"], state["mu"], state["nu"], None)
        p, o = JO.update(grads, o, state["params"], JO.AdamWConfig(), lr=lr)
        return {"params": p, "mu": o.mu, "nu": o.nu, "count": o.count}, loss

    body = TT.inplace_train_step(tbase.get(ARCH, smoke=True), STEP, tstate)
    jl, tl = [], []
    for i in range(5):
        b = _batch(i)
        jstate, loss = jstep(jstate, {k: jnp.asarray(v.numpy())
                                      for k, v in b.items()})
        jl.append(float(loss))
        tl.append(body(b)["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = {jax.tree_util.keystr(p): np.asarray(x, np.float32) for p, x in
            jax.tree_util.tree_flatten_with_path(jstate["params"])[0]}
    got = {pytree.keystr(p): t.float().numpy()
           for p, t in pytree.flatten_with_path(tstate["params"])}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert int(tstate["count"]) == int(jstate["count"]) == 55


# ---------------------------------------------------------------------------
# launch counts under replay
# ---------------------------------------------------------------------------

def _stub_wrapper():
    def wrapper():
        _build.count_launch(wrapper)
    wrapper.launches = 0
    return wrapper


class _StubGraph:
    def __init__(self, body):
        self.body = body        # what the capture recorded
        self.replays = 0

    def replay(self):
        self.replays += 1       # a real replay launches without the host


def test_replay_counts_the_captured_launches_once_per_replay():
    a, b = _stub_wrapper(), _stub_wrapper()
    a()                                      # an eager launch counts
    with _build.held_launches() as warm:     # warm-up: dropped
        a(), a(), b()
    assert warm == {a: 2, b: 1}
    assert (a.launches, b.launches) == (1, 0)
    with _build.held_launches() as ticks:    # capture: held for replays
        a(), b(), b()
    assert ticks == {a: 1, b: 2}
    assert (a.launches, b.launches) == (1, 0)
    graph = _StubGraph(lambda: None)
    for _ in range(5):
        _build.replay(graph, ticks)
    assert graph.replays == 5
    assert (a.launches, b.launches) == (1 + 5, 10)
    a()
    assert a.launches == 7


def test_held_launches_hold_only_this_threads_and_do_not_nest():
    w = _stub_wrapper()
    with _build.held_launches() as ticks:
        t = threading.Thread(target=w)      # a worker's launch counts
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        w()
        with pytest.raises(RuntimeError, match="nest"):
            with _build.held_launches():
                pass
    assert ticks == {w: 1} and w.launches == 1
    with _build.held_launches():            # closed again: usable
        w()
    assert w.launches == 1
