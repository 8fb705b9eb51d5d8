"""The port's four examples, run on the CPU as their users run them on
the card (``--device cpu``, smoke sizes), each in its own process with a
time limit, as ``tests/test_torch_stream_tools.py`` runs the tools. Each
must exit 0 and print what the JAX package's original prints; the
compression demo prints the original's very lines."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=240, pythonpath=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    run = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    return run.stdout


def test_quickstart_runs_the_three_placements():
    out = _run("torch_quickstart.py", "--device", "cpu")
    lines = [ln for ln in out.splitlines() if ": wall=" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == ["sync", "async",
                                                          "hybrid"]
    assert all(ln.endswith("results=5") for ln in lines)
    sync, asyn = (dict(kv.split("=") for kv in ln.split(": ")[1].split())
                  for ln in lines[:2])
    assert float(sync["stall"].rstrip("s")) > 0
    assert float(asyn["stall"].rstrip("s")) == 0


def test_compression_demo_prints_the_originals_lines():
    got = _run("torch_compression_demo.py", "--device", "cpu")
    want = _run("compression_demo.py", pythonpath=str(ROOT / "src"))
    assert "weights bit-exact = True" in got
    assert got.splitlines() == want.splitlines()


def test_serve_example_serves_requests():
    out = _run("torch_serve_insitu.py", "--device", "cpu", "--requests",
               "4", "--max-new", "4")
    lines = [ln for ln in out.splitlines() if ln.startswith("request ")]
    assert [ln.split(":")[0] for ln in lines] == [f"request {i}"
                                                  for i in range(4)]
    assert "served 4/4 requests" in out


@pytest.mark.parametrize("drill,passed", [
    (["--insitu", "hybrid", "--steps", "12"], "checkpoints: 1 saves"),
    (["--inject-sink-faults", "--steps", "21"], "sink-fault drill passed"),
    (["--stream-drill", "--steps", "20"], "stream drill passed")])
def test_train_example_and_its_drills(tmp_path, drill, passed):
    out = _run("torch_train_insitu.py", "--device", "cpu", "--ckpt-dir",
               str(tmp_path / "ck"), *drill)
    assert passed in out
    if "--insitu" in drill:
        assert "first loss" in out and "stragglers: []" in out
        assert (tmp_path / "ck" / "step_000000000" / "manifest.json").exists()
