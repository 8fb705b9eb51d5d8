"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback for entry points that default to the card."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.") or m == "ml_dtypes")
print(len(names), bad)
"""


def test_every_module_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         check=True).stdout.split(maxsplit=1)
    n_modules, bad = int(out[0]), out[1].strip()
    assert n_modules >= 55          # every module of the port imported
    assert bad == "[]", f"port pulled in {bad}"


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.configs import base
    from repro_torch.serving.pages import PagedServingEngine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_loop("smollm-135m")
    cfg = base.get("smollm-135m", smoke=True)
    spec = transformer.param_spec(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.materialize(torch.Generator(), spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedServingEngine(cfg, {}, num_pages=5, max_len=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.from_numpy_tree({"w": np.zeros(3, np.float32)})

    # the training slice's entry points
    from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                        serialization)
    from repro_torch.core import lossy
    from repro_torch.core.runtime import Placement
    from repro_torch.launch.train import init_state, state_from_numpy, \
        train_loop
    from repro_torch.optim import AdamWConfig

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop("smollm-135m", steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(cfg, 0, AdamWConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"count": np.zeros((), np.int32)})
    state = {"w": torch.zeros(4)}
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), every=1,
                                             mode=Placement.SYNC))
    mgr.save(1, state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgr.restore(state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serialization.read_state(str(tmp_path / "step_000000001"), state)
    blob, _ = lossy.compress_tensor(torch.zeros(300), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lossy.decompress_tensor(blob)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lossy.compress_tensor(np.zeros(300, np.float32))
