"""The port's serving driver end to end on the CPU (smoke config).

``serve_loop(device="cpu")`` must serve every request, return every page,
publish snapshots through the default in-situ plan, and report with the
JAX package's keys, so tools that read one report read the other.
"""
import pytest

from repro.launch.serve import serve_loop as jax_serve_loop
from repro_torch.launch.serve import default_serve_plan, serve_loop


@pytest.fixture(scope="module")
def served():
    lines = []
    out = serve_loop("smollm-135m", n_requests=6, max_new=6, slots=2,
                     device="cpu", log=lines.append)
    return out, lines


def test_serves_every_request_and_returns_every_page(served):
    out, lines = served
    assert all(r.done and len(r.out) == 6 for r in out["requests"])
    assert any(ln.startswith("page pool: 0/16 pages in use at exit")
               for ln in lines), lines
    assert any(ln.startswith("served 6/6 requests") for ln in lines), lines


def test_publishes_snapshots_without_errors(served):
    out, _ = served
    rep = out["session_report"]
    assert rep["n_errors"] == 0
    snap = rep["tasks"]["kv_snapshot"]
    assert snap["publishes"] > 0 and snap["bases"] >= 1
    assert out["insitu_results"] == snap["publishes"] + snap["stale_skipped"]


def test_report_has_the_jax_packages_keys(served):
    out, _ = served
    ref = jax_serve_loop("smollm-135m", n_requests=2, max_new=2, slots=1,
                         log=lambda _: None)
    assert set(out) == set(ref)
    assert set(out["session_report"]) == set(ref["session_report"])
    assert set(out["session_report"]["tasks"]["kv_snapshot"]) == \
        set(ref["session_report"]["tasks"]["kv_snapshot"])


def test_prefix_requests_share_pages():
    lines = []
    out = serve_loop("smollm-135m", n_requests=3, max_new=4, slots=2,
                     prefix_len=16, device="cpu", log=lines.append)
    assert all(r.done for r in out["requests"])
    assert out["prefix_stats"]["hits"] == 3
    assert out["prefix_stats"]["shared_tokens"] == 3 * 16


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_serves_the_frontend_archs(arch):
    """The frontend families serve their dense backbone token-only (no
    prefix embeddings, as in the JAX package): every request served, every
    page back but the pinned prefix's one, no in-situ error, and the
    shared prefix mapped for each request."""
    lines = []
    out = serve_loop(arch, n_requests=3, max_new=4, slots=2, prefix_len=16,
                     device="cpu", log=lines.append)
    assert all(r.done and len(r.out) == 4 for r in out["requests"])
    assert any(ln.startswith("page pool: 1/16 pages in use at exit")
               for ln in lines), lines
    assert out["session_report"]["n_errors"] == 0
    assert out["prefix_stats"]["hits"] == 3


def test_serves_hymba_with_a_snapshot_chain(tmp_path):
    """The hybrid family through ``serve_loop``: every request served, every
    page back, and the default plan's chain (persisted here) restores
    with the per-row ``state`` leaves beside the global pool."""
    from repro_torch.serving.snapshot import SnapshotStore

    lines = []
    plan = default_serve_plan(snapshot_dir=str(tmp_path / "chain"))
    out = serve_loop("hymba-1.5b", n_requests=5, max_new=6, slots=2,
                     plan=plan, device="cpu", log=lines.append)
    assert all(r.done and len(r.out) == 6 for r in out["requests"])
    assert any(ln.startswith("page pool: 0/16 pages in use at exit")
               for ln in lines), lines
    rep = out["session_report"]
    assert rep["n_errors"] == 0
    assert rep["tasks"]["kv_snapshot"]["publishes"] > 0
    _, leaves = SnapshotStore(str(tmp_path / "chain")).restore("kv_pages")
    assert "['pool']['global_kv']['k']" in leaves
    assert "['state']['ssm_swa']['h']" in leaves


def test_hymba_refuses_a_shared_prefix():
    """A system prompt of a page or more is registered for sharing, which
    the hybrid family's per-row state refuses, in both packages."""
    with pytest.raises(ValueError, match="recurrent state"):
        serve_loop("hymba-1.5b", n_requests=2, max_new=2, prefix_len=16,
                   device="cpu", log=lambda _: None)
    with pytest.raises(ValueError, match="recurrent state"):
        jax_serve_loop("hymba-1.5b", n_requests=2, max_new=2, prefix_len=16,
                       log=lambda _: None)


def test_serves_xlstm_with_a_persisted_chain(tmp_path):
    """The ssm family through ``serve_loop``: every request served, every
    reserved page back, and the default plan's chain (persisted here,
    one chain kept) restores with the per-row mLSTM/sLSTM ``state`` leaves
    and no ``pool`` key; the shared prefix is refused in both packages."""
    from repro_torch.serving.snapshot import SnapshotStore

    lines = []
    plan = default_serve_plan(snapshot_dir=str(tmp_path / "chain"))
    plan["tasks"]["kv_snapshot"]["options"]["keep_chains"] = 1
    out = serve_loop("xlstm-1.3b", n_requests=5, max_new=6, slots=2,
                     plan=plan, device="cpu", log=lines.append)
    assert all(r.done and len(r.out) == 6 for r in out["requests"])
    assert any(ln.startswith("page pool: 0/16 pages in use at exit")
               for ln in lines), lines
    rep = out["session_report"]
    assert rep["n_errors"] == 0
    assert rep["tasks"]["kv_snapshot"]["publishes"] > 0
    _, leaves = SnapshotStore(str(tmp_path / "chain")).restore("kv_pages")
    assert not any(k.startswith("['pool']") for k in leaves)
    assert leaves["['state']['mlstm']['c']"].shape[:3] == (2, 1, 4)
    assert "['state']['slstm']['h']" in leaves
    for loop in (serve_loop, jax_serve_loop):
        kw = {"device": "cpu"} if loop is serve_loop else {}
        with pytest.raises(ValueError, match="recurrent state"):
            loop("xlstm-1.3b", n_requests=2, max_new=2, prefix_len=16,
                 log=lambda _: None, **kw)
