"""The port's layers and attention against the JAX package (CPU, f32).

Same numpy inputs (seeded) through both packages. Tolerance rtol/atol
1e-5 for elementwise layers and attention (f32 throughout; the two
frameworks sum in different orders), 1e-4 for the matmul-heavy MLP and
unembedding (longer dot products), exact for gathers and scatters (pure
data movement).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)
MM_TOL = dict(rtol=1e-4, atol=1e-4)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rmsnorm(rng):
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    jx, tx = _both(x)
    js, ts = _both(scale)
    _close(TL.rmsnorm({"scale": ts}, tx, 1e-5),
           JL.rmsnorm({"scale": js}, jx, 1e-5), **TOL)


def test_rope(rng):
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    jx, tx = _both(x)
    jp, tp = _both(pos)
    _close(TL.rope_frequencies(16, 10000.0),
           JL.rope_frequencies(16, 10000.0), rtol=1e-6, atol=0)
    _close(TL.apply_rope(tx, tp, 10000.0), JL.apply_rope(jx, jp, 10000.0),
           rtol=1e-5, atol=1e-4)


def test_mlp(rng):
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("w_gate", (24, 40)), ("w_up", (24, 40)),
                      ("w_down", (40, 24)))}
    jx, tx = _both(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(TL.mlp(tp, tx), JL.mlp(jp, jx), **MM_TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(rng, tied):
    vocab, padded, d = 250, 256, 16
    emb = rng.standard_normal((padded, d)).astype(np.float32)
    toks = rng.integers(0, vocab, size=(2, 6)).astype(np.int32)
    jp = {"embedding": jnp.asarray(emb)}
    tp = {"embedding": torch.from_numpy(emb)}
    if not tied:
        un = rng.standard_normal((d, padded)).astype(np.float32)
        jp["unembed"], tp["unembed"] = _both(un)
    jt, tt = _both(toks)
    h_j, h_t = JL.embed(jp, jt), TL.embed(tp, tt)
    _close(h_t, h_j, rtol=0, atol=0)
    _close(TL.unembed(tp, h_t, vocab), JL.unembed(jp, h_j, vocab), **MM_TOL)


@pytest.mark.parametrize("q_offset,sq,sk,chunk", [
    (0, 32, 32, 8),       # chunked causal prefill
    (0, 12, 12, 8),       # shapes that do not tile: one chunk
    (16, 16, 32, 8),      # continuation: suffix queries over prefix+suffix
])
def test_flash_attention(rng, q_offset, sq, sk, chunk):
    q = rng.standard_normal((2, sq, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 8)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kw = dict(causal=True, q_offset=q_offset, q_chunk=chunk, kv_chunk=chunk)
    out_t = TA.flash_attention(tq, tk, tv, **kw)
    _close(out_t, JA.flash_attention(jq, jk, jv, **kw), **TOL)
    _close(out_t, TA.reference_attention(tq, tk, tv, q_offset=q_offset),
           **TOL)


def test_decode_attention(rng):
    q = rng.standard_normal((3, 1, 6, 16)).astype(np.float32)
    k = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    length = np.asarray([0, 7, 20], np.int32)
    args = list(zip(*(_both(a) for a in (q, k, v, length))))
    _close(TA.decode_attention(*args[1]), JA.decode_attention(*args[0]),
           **TOL)


def test_gather_and_scatter_token(rng):
    ps, n, d = 4, 2, 3
    pages = rng.standard_normal((7, ps, n, d)).astype(np.float32)
    table = np.asarray([[5, 1, 4], [2, 6, 3]], np.int32)
    new = rng.standard_normal((2, n, d)).astype(np.float32)
    lengths = np.asarray([5, 13], np.int32)     # row 1 clamps to its last page
    (jp, tp), (jt, tt), (jn, tn), (jl, tl) = map(_both,
                                                 (pages, table, new, lengths))
    _close(TA.gather_pages(tp, tt), JA.gather_pages(jp, jt), rtol=0, atol=0)
    want = JA.scatter_token(jp, jn, jt, jl, ps)
    got = TA.scatter_token(tp.clone(), tn, tt, tl, ps)
    _close(got, want, rtol=0, atol=0)
