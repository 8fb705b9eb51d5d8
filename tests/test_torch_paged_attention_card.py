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

The kernel splits each row's page table (``split_plan``) and combines the
splits in a fixed order, so a call gives the same bits every time, and a
CUDA-graph replay the eager call's.
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


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("group,ps,d_k,d_v", [(3, 16, 64, 64), (2, 5, 24, 40)])
def test_split_edges_match_plain_on_card(cuda, dtype, width, group, ps, d_k,
                                         d_v):
    """Long tables, several splits a row: lengths on and beside the first
    two split edges, and splits wholly past the length."""
    rng = np.random.default_rng(14)
    n_kv, b = 3, 11
    n_splits, per = PK.split_plan(width, ps, b, n_kv)
    assert n_splits > 1
    edge, full = per * ps, ps * width
    lengths = [0, 1, edge - 1, edge, edge + 1, 2 * edge, 2 * edge + 1,
               full // 2 + 3, full - 1, full, full + 7]
    args = _case(rng, b=b, hq=n_kv * group, n_kv=n_kv, d_k=d_k, d_v=d_v,
                 ps=ps, pps=width, lengths=lengths,
                 dtype=getattr(torch, dtype), dev=cuda)
    out = PK.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = PK.paged_decode_attention_plain(*args)
    tol = F32_TOL if dtype == "float32" else dict(rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def _long_case(rng, width, dev):
    ps, full = 16, 16 * width
    return _case(rng, b=8, hq=9, n_kv=3, d_k=64, d_v=64, ps=ps, pps=width,
                 lengths=[0, 1, ps + 1, 100, full // 2 + 3, full - 1, full,
                          full], dtype=torch.bfloat16, dev=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 64, 256])
def test_same_bits_every_call(cuda, width):
    args = _long_case(np.random.default_rng(15), width, cuda)
    first = _bits(PK.paged_decode_attention(*args)).clone()
    for _ in range(4):
        assert torch.equal(_bits(PK.paged_decode_attention(*args)), first)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 256])
def test_cuda_graph_replay_equals_eager(cuda, width):
    """One call captured in a CUDA graph: no host sync or allocation in the
    C side, the split plan from shapes alone. A replay equals the eager
    call bit for bit, also after the lengths change in place, and adds
    nothing to the launch count (only a wrapper call counts)."""
    rng = np.random.default_rng(16)
    args = _long_case(rng, width, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PK.paged_decode_attention(*args)          # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = PK.paged_decode_attention(*args)
    for lengths in (None, [5, 16 * width, 0, 17, 33, 16 * width - 1, 1, 2]):
        if lengths is not None:
            args[4].copy_(torch.tensor(lengths, dtype=torch.int32))
        before = PK.paged_decode_attention.launches
        graph.replay()
        torch.cuda.synchronize()
        assert PK.paged_decode_attention.launches == before
        eager = PK.paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(_bits(static_out), _bits(eager))


# moonshot-v1-16b-a3b's serving shape: 16 kv heads of 128, one query head
# each; in bf16 at page 16 one page of all heads is 128 KB, so the split
# kernel takes them in groups (head_group)
MOONSHOT = dict(hq=16, n_kv=16, d_k=128, d_v=128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ps", [("bfloat16", 16), ("float32", 16),
                                      ("float32", 8)])
@pytest.mark.parametrize("width", [4, 64])
def test_moonshot_shape_matches_plain_on_card(cuda, dtype, ps, width):
    rng = np.random.default_rng(17)
    full = ps * width
    lengths = [0, 1, ps, ps + 1, full // 2 + 3, full - 1, full, full]
    args = _case(rng, b=8, ps=ps, pps=width, lengths=lengths,
                 dtype=getattr(torch, dtype), dev=cuda, **MOONSHOT)
    _, per = PK.split_plan(width, ps, 8, 16)
    n_h = PK.head_group(16, 1, 128, 128, ps, args[0].element_size(), per)
    assert n_h < 16
    out = PK.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = PK.paged_decode_attention_plain(*args)
    tol = F32_TOL if dtype == "float32" else dict(rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [4, 256])
def test_head_groups_with_one_round_size_give_one_result(cuda, dtype, width):
    """A head group changes which bytes a CTA stages; a head's arithmetic
    depends only on the pages of a round (one online-softmax step), which
    the staging picks. At smollm's heads (3 of 64, one group by the plan)
    and at moonshot's (16 of 128, page 8), every two groups that fit with
    the same pages a round give the same bits."""
    rng = np.random.default_rng(18)
    compared = 0
    for shape, ps in ((dict(hq=9, n_kv=3, d_k=64, d_v=64), 16),
                      (MOONSHOT, 8)):
        full = ps * width
        args = _case(rng, b=8, ps=ps, pps=width,
                     lengths=[0, 1, ps + 1, full // 2, full - 1, full, full,
                              3], dtype=getattr(torch, dtype), dev=cuda,
                     **shape)
        n_kv, group = shape["n_kv"], shape["hq"] // shape["n_kv"]
        _, per = PK.split_plan(width, ps, 8, n_kv)
        by_round: dict = {}
        for n_h in range(1, n_kv + 1):
            rp, _, total = PK.staging(n_h, group, shape["d_k"],
                                      shape["d_v"], ps,
                                      args[0].element_size(), per)
            if n_kv % n_h or total > PK.MAX_SMEM_BYTES:
                continue
            got = _bits(PK.paged_decode_attention(*args, n_h=n_h)).clone()
            if rp in by_round:
                assert torch.equal(got, by_round[rp]), (shape, n_h, rp)
                compared += 1
            else:
                by_round[rp] = got
    assert compared >= 2


# hymba-1.5b's global layers: 25 query heads over 5 kv heads of 64 (a group
# of 5). One group holds all 5 kv heads, so a CTA carries 25 query heads,
# more than its 16 warps: a warp takes two heads in turn
HYMBA = dict(hq=25, n_kv=5, d_k=64, d_v=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width", [4, 256])
def test_hymba_shape_matches_plain_on_card(cuda, dtype, width):
    rng = np.random.default_rng(23)
    ps, full = 16, 16 * width
    lengths = [0, 1, ps, ps + 1, full // 2 + 3, full - 1, full, full]
    args = _case(rng, b=8, ps=ps, pps=width, lengths=lengths,
                 dtype=getattr(torch, dtype), dev=cuda, **HYMBA)
    out = PK.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = PK.paged_decode_attention_plain(*args)
    tol = F32_TOL if dtype == "float32" else dict(rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(_bits(PK.paged_decode_attention(*args)), _bits(out))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 68, 256])
def test_hymba_head_group_and_smem_mirror_the_source(cuda, width):
    """At hymba's heads the plan keeps one group of all 5 kv heads, and
    the Python staging it reads has the source's shared-memory bytes for
    every group that divides 5."""
    _, c_bytes = PK._entry()
    _, per = PK.split_plan(width, 16, 8, 5)
    for elem in (2, 4):
        assert PK.head_group(5, 5, 64, 64, 16, elem, per) == 5
        for n_h in (1, 5):
            args = (n_h, 5, 64, 64, 16, elem, per)
            assert c_bytes(*args) == PK.smem_bytes(*args), args


@pytest.mark.cuda
def test_smem_bytes_mirror_the_source(cuda):
    """``smem_bytes`` (Python, what the head-group choice reads) equals the
    source's ``paged_decode_attention_smem_bytes`` over the shapes the
    port serves and the tests use."""
    _, c_bytes = PK._entry()
    for n_h in (1, 2, 3, 4, 8, 16):
        for group, d_k, d_v in ((1, 128, 128), (3, 64, 64), (2, 24, 40)):
            for ps in (5, 8, 16, 32, 64):
                for elem in (2, 4):
                    for per in (1, 2, 4, 8, 256):
                        args = (n_h, group, d_k, d_v, ps, elem, per)
                        assert c_bytes(*args) == PK.smem_bytes(*args), args
