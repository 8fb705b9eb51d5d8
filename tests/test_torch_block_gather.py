"""The sharded step's parameters gathered block by block
(``distributed/sharding.py``: ``reduce_scatter``, ``ShardedLeaf``,
``BlockGather``) and the global norm that both train steps sum in one
order (``optim/adamw.py``), on the CPU.

* ``reduce_scatter`` on gloo worlds of 2 and 4 (``tests/
  torch_shard_ranks.py --phase scatter``): bit for bit ``all_reduce``
  then ``local_shard``, along dims 0 and 1 and on a tensor past the
  backend's chunking, recorded as one ``reduce-scatter`` whose operand
  bytes are what ``sharding.wire`` counts as sent.
* With remat (``--phase remat``) each block is gathered again in the
  backward's recompute; without it the gathered block is kept for the
  backward and gathered once. Both steps' state, loss and norm are equal
  bit for bit, on (2, 1), (1, 2) and (2, 2).
* ``ShardedLeaf`` indexing as the model takes blocks from a stack, and
  ``global_norm``'s layer-by-layer sums.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.distributed import sharding
from repro_torch.optim import adamw

TESTS = Path(__file__).resolve().parent
DEADLINE_S = 120.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both phases on worlds of 2 and 4, every rank at once."""
    d = tmp_path_factory.mktemp("block_gather")
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_shard_ranks.py"), "--phase",
         phase, "--rank", str(r), "--world", str(w), "--dir", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for phase in ("scatter", "remat") for w in (2, 4) for r in range(w)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return d


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_is_all_reduce_then_local_shard(ranks, world):
    for r in range(world):
        got = json.loads((ranks / f"scatter_{world}_rank{r}.json")
                         .read_text())
        for name, case in got.items():
            assert case["equal"], (world, r, name)
            assert case["shape"] == case["want_shape"], (world, r, name)
            assert case["contiguous"], (world, r, name)
            assert len(case["ops"]) == 1, case["ops"]
            kind, shape, group, operand = case["ops"][0]
            assert (kind, shape, group) == ("reduce-scatter",
                                            case["shape"], world)
            assert operand == case["sent"] == case["input_bytes"]


@pytest.mark.parametrize("world", [2, 4])
def test_remat_gathers_each_block_again_and_matches_no_remat(ranks, world):
    got = json.loads((ranks / f"remat_{world}.json").read_text())
    assert len(got) == (2 if world == 2 else 1)
    for mesh, case in got.items():
        assert case["differ"] == [], (mesh, case["differ"])
        assert case["loss"][0] == case["loss"][1], mesh
        assert case["grad_norm"][0] == case["grad_norm"][1], mesh
        on, off = case["kinds"]
        # the forward gathers the outside leaves and each block once;
        # with remat the recompute gathers each block again
        assert on["all-gather"] > off["all-gather"] > 0, (mesh, on, off)
        assert on.get("reduce-scatter", 0) == off.get("reduce-scatter", 0)
        assert ("reduce-scatter" in on) == mesh.startswith("2"), (mesh, on)


def test_sharded_leaf_indexes_layers_as_the_model_takes_blocks():
    from torch.distributed.tensor import Replicate, Shard

    local = torch.arange(4 * 3 * 2 * 5).reshape(4, 3, 2, 5)
    leaf = sharding.ShardedLeaf(local, (Shard(3), Replicate()), key=7)
    assert leaf.shape == local.shape
    run = leaf[1:3]                   # a run of layers, then one of them
    one = run[1]
    assert one.key == 7 and one.index == (2,)
    assert torch.equal(one.local, local[2])
    assert one.placements[0].dim == 2 and not one.placements[1].is_shard()
    sub = leaf[3][2]                  # two layer axes (xLSTM's mLSTM stack)
    assert sub.index == (3, 2) and torch.equal(sub.local, local[3, 2])
    assert sub.placements[0].dim == 1
    with pytest.raises(ValueError, match="leading axis is sharded"):
        sharding.ShardedLeaf(local, (Shard(0),), key=0)[0]


def test_global_norm_sums_each_layer_in_order():
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, 5, generator=gen),
            "b": torch.randn(6, generator=gen).to(torch.bfloat16),
            "c": torch.randn(2, 2, 3, generator=gen)}
    depths = {"a": 1, "b": 0, "c": 2}
    want = torch.sqrt(sum(
        sum(torch.sum(torch.square(s.float())) for s in slices)
        for slices in (list(tree["a"].unbind(0)), [tree["b"]],
                       list(tree["c"].reshape(4, 3).unbind(0)))))
    assert torch.equal(adamw.global_norm(tree, depths), want)
    assert [len(adamw.layer_square_sums(tree[k], depths[k]))
            for k in "abc"] == [3, 1, 4]
    # the same norm as the whole-leaf sum, to rounding
    torch.testing.assert_close(adamw.global_norm(tree, depths),
                               adamw.global_norm(tree), rtol=1e-6, atol=0)
