"""Shared fixtures. NOTE: no XLA_FLAGS here by design — unit tests and
benches must see the real single CPU device; multi-device tests spawn
subprocesses with their own flags (see tests/test_distributed.py)."""

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tier1: fast core subset (scripts/verify.sh runs it first)")
    config.addinivalue_line(
        "markers",
        "slow: multi-minute model/distributed smoke tests")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (repro_torch kernels); skips elsewhere")


@pytest.fixture(scope="session")
def walk_data():
    """Z-normalized random-walk collection [512, 128] (paper's Rand)."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=(512, 128)), axis=1).astype(np.float32)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-9)
    return x


@pytest.fixture(scope="session")
def walk_queries(walk_data):
    rng = np.random.default_rng(1)
    idx = rng.choice(walk_data.shape[0], 6, replace=False)
    return (walk_data[idx]
            + 0.1 * rng.normal(size=(6, walk_data.shape[1]))
            ).astype(np.float32)
