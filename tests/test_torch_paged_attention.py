"""The port's paged decode attention against the JAX package (CPU).

The plain version (the wrapper's path for CPU tensors) is held against the
Pallas kernel in interpret mode and against the JAX gather path in f32 at
rtol/atol 1e-5 — the accumulation order differs (one full-row softmax vs
per-page online softmax), nothing else. The wrapper's argument checks,
which guard the CUDA kernel, run here on CPU tensors. The kernel itself is
held against the plain version on the card by
``tests/test_torch_paged_attention_card.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as JPK
from repro.models import attention as JA
from repro_torch.kernels import paged_attention as PK
from repro_torch.models import attention as TA

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, *, b, hq, n_kv, d_k, d_v, ps, pps, lengths):
    num_pages = b * pps + 1
    k = rng.standard_normal((num_pages, ps, n_kv, d_k)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, n_kv, d_v)).astype(np.float32)
    q = rng.standard_normal((b, 1, hq, d_k)).astype(np.float32)
    # rows own disjoint, shuffled pages; page 0 (scratch) is never mapped
    table = (1 + rng.permutation(b * pps)).reshape(b, pps).astype(np.int32)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _lengths(ps, pps):
    full = ps * pps
    return [0, 1, ps, ps + 1, full]


CASES = [
    # (G, ps, d_k, d_v)
    (1, 8, 16, 16),
    (3, 8, 16, 8),
    (1, 16, 8, 16),
    (3, 16, 16, 16),
]


@pytest.mark.parametrize("group,ps,d_k,d_v", CASES)
def test_plain_matches_pallas_and_gather(group, ps, d_k, d_v):
    rng = np.random.default_rng(group * 100 + ps + d_k + d_v)
    n_kv, pps = 2, 3
    q, k, v, table, lengths = _case(
        rng, b=5, hq=n_kv * group, n_kv=n_kv, d_k=d_k, d_v=d_v, ps=ps,
        pps=pps, lengths=_lengths(ps, pps))
    port = PK.paged_decode_attention(*map(torch.from_numpy,
                                          (q, k, v, table, lengths)))
    assert port.dtype == torch.float32 and tuple(port.shape) == (
        5, 1, n_kv * group, d_v)
    jargs = tuple(map(jnp.asarray, (q, k, v, table, lengths)))
    pallas = np.asarray(JPK.paged_decode_attention(*jargs, interpret=True))
    gather = np.asarray(JA.paged_decode_attention(*jargs, use_kernel=False))
    np.testing.assert_allclose(port.numpy(), pallas, **F32_TOL)
    np.testing.assert_allclose(port.numpy(), gather, **F32_TOL)


def test_length_zero_is_uniform_mean_over_table():
    """At length 0 every score is NEG_INF and p = 1 everywhere: the output
    is the mean of V over the whole table, as both JAX paths give."""
    rng = np.random.default_rng(3)
    q, k, v, table, _ = _case(rng, b=2, hq=3, n_kv=1, d_k=8, d_v=8, ps=4,
                              pps=2, lengths=[0, 0])
    out = PK.paged_decode_attention(
        *map(torch.from_numpy, (q, k, v, table, np.zeros(2, np.int32))))
    for r in range(2):
        rows = v[table[r]].reshape(-1, 1, 8)            # (pps*ps, N, Dv)
        np.testing.assert_allclose(out[r, 0].numpy(),
                                   np.repeat(rows.mean(0), 3, 0), **F32_TOL)


def test_model_dispatch_takes_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    args = tuple(map(torch.from_numpy, _case(
        rng, b=2, hq=4, n_kv=2, d_k=8, d_v=8, ps=4, pps=2, lengths=[3, 8])))
    before = PK.paged_decode_attention.launches
    out = TA.paged_decode_attention(*args)
    torch.testing.assert_close(out, PK.paged_decode_attention_plain(*args),
                               rtol=0, atol=0)
    assert PK.paged_decode_attention.launches == before   # no launch on CPU


def _ok_args():
    rng = np.random.default_rng(5)
    return list(map(torch.from_numpy, _case(
        rng, b=2, hq=6, n_kv=2, d_k=8, d_v=4, ps=4, pps=2, lengths=[1, 8])))


@pytest.mark.parametrize("mutate,err", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), TypeError),
    (lambda a: a.__setitem__(3, a[3].long()), TypeError),
    (lambda a: a.__setitem__(4, a[4].long()), TypeError),
    (lambda a: a.__setitem__(1, a[1].transpose(0, 1)), ValueError),
    (lambda a: a.__setitem__(0, a[0].reshape(2, 6, 1, 8)), ValueError),
    (lambda a: a.__setitem__(1, a[1][..., :4].contiguous()), ValueError),
    (lambda a: a.__setitem__(2, a[2][:, :2].contiguous()), ValueError),
    (lambda a: a.__setitem__(0, a[0][:, :, :5].contiguous()), ValueError),
    (lambda a: a.__setitem__(3, a[3][:1].contiguous()), ValueError),
    (lambda a: a.__setitem__(4, a[4][:1].contiguous()), ValueError),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    args = _ok_args()
    PK.check_args(*args)                     # the unmutated call is valid
    mutate(args)
    with pytest.raises(err):
        PK.check_args(*args)


def _misaligned(t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("mutate", [
    # a 6 x 4-byte head row is off the kernel's 16-byte page copies
    lambda a: (a.__setitem__(0, a[0][..., :6].contiguous()),
               a.__setitem__(1, a[1][..., :6].contiguous())),
    lambda a: a.__setitem__(2, _misaligned(a[2])),
])
def test_kernel_wrapper_refuses_pages_off_16_bytes(mutate):
    args = _ok_args()
    PK.check_args(*args)
    mutate(args)
    with pytest.raises(ValueError, match="16"):
        PK.check_args(*args)


def test_wrapper_refuses_devices_without_a_kernel():
    args = [a.to("meta") for a in _ok_args()]
    with pytest.raises(ValueError, match="no kernel"):
        PK.paged_decode_attention(*args)
