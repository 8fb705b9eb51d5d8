"""The port's two-process stream tools, run on the CPU as their users run
them on the card: ``tools/torch_hydrate_smoke.py`` (a cold replica
hydrates over ``tcp://`` mid-serve and decodes in lockstep) and
``tools/torch_stream_smoke.py`` (a consumer process tails the chain,
restores it bit-identically and steers the server). Each exits 0 only
when all of its own gates hold."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("tool,passed", [
    ("torch_hydrate_smoke.py", "hydrate smoke passed"),
    ("torch_stream_smoke.py", "stream smoke passed")])
def test_stream_tool_passes_on_the_cpu(tool, passed):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                          "--device", "cpu"], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    assert passed in run.stdout
