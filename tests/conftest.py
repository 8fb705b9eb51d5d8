"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 CPU device
(the 512-device override belongs to launch/dryrun.py ONLY)."""
import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def tiny_params(arch: str, seed: int = 0):
    from repro.configs import base
    from repro.models import params as P, transformer

    cfg = base.get(arch, smoke=True)
    prm = P.materialize(jax.random.PRNGKey(seed), transformer.param_spec(cfg))
    return cfg, prm


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one); run on "
        "the card with `python -m pytest -m cuda tests/test_torch_*.py`")
