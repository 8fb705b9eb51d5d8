"""The Hopper paged-decode-attention kernel against its plain version, on
the card. Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (run it there with ``--noconftest``; see
README.md, "PyTorch/CUDA port").

Tolerances:

* f32: rtol/atol 1e-5 — the kernel accumulates each score over the head
  dim in another order and runs an online softmax over pages; nothing
  else differs (no TF32, no fast math).
* bf16: atol 3.2e-2. Outputs are softmax averages of V rows, |out| < 4,
  where one bf16 step is 2^-6; the plain path rounds the scores and p to
  bf16 before the PV product (``decode_attention``) while the kernel keeps
  f32 until the output, so they may differ by a couple of bf16 steps.
  ``chip_smoke.py`` on an H100 measured at most one step (7.8e-3) at the
  serving and 4096-token shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PK

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 3.2e-2

CASES = [
    # (G, ps, d_k, d_v)
    (1, 8, 16, 16),
    (3, 8, 16, 8),
    (1, 16, 8, 16),
    (3, 16, 16, 16),
    (3, 16, 64, 64),          # the serving shape's heads
    (2, 5, 24, 40),           # odd page size, Dk != Dv
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(rng, *, b, hq, n_kv, d_k, d_v, ps, pps, lengths, dtype, dev):
    num_pages = b * pps + 1
    k = rng.standard_normal((num_pages, ps, n_kv, d_k)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, n_kv, d_v)).astype(np.float32)
    q = rng.standard_normal((b, 1, hq, d_k)).astype(np.float32)
    table = (1 + rng.permutation(b * pps)).reshape(b, pps).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), t(table),
            t(np.asarray(lengths, np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,ps,d_k,d_v", CASES)
def test_kernel_matches_plain_on_card(cuda, dtype, group, ps, d_k, d_v):
    rng = np.random.default_rng(11)
    n_kv, pps = 3, 4
    full = ps * pps
    args = _case(rng, b=6, hq=n_kv * group, n_kv=n_kv, d_k=d_k, d_v=d_v,
                 ps=ps, pps=pps, lengths=[0, 1, ps, ps + 1, full, full + 5],
                 dtype=getattr(torch, dtype), dev=cuda)
    before = PK.paged_decode_attention.launches
    out = PK.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert PK.paged_decode_attention.launches == before + 1
    ref = PK.paged_decode_attention_plain(*args)
    tol = F32_TOL if dtype == "float32" else dict(rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_kernel_refuses_shared_memory_overflow(cuda):
    rng = np.random.default_rng(12)
    args = _case(rng, b=1, hq=1, n_kv=1, d_k=256, d_v=256, ps=128, pps=1,
                 lengths=[1], dtype=torch.float32, dev=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        PK.paged_decode_attention(*args)


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices(cuda):
    rng = np.random.default_rng(13)
    args = list(_case(rng, b=1, hq=3, n_kv=1, d_k=8, d_v=8, ps=4, pps=1,
                      lengths=[2], dtype=torch.float32, dev=cuda))
    args[3] = args[3].cpu()
    with pytest.raises(ValueError, match="several devices"):
        PK.paged_decode_attention(*args)
