"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback for entry points that default to the card."""
import subprocess
import sys
from pathlib import Path

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
    assert n_modules >= 25          # every module of the slice was imported
    assert bad == "[]", f"port pulled in {bad}"


def test_entry_points_default_to_the_card():
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
