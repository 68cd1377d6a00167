"""Shared test fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see the real single CPU device; multi-device tests spawn subprocesses
with their own flags (see test_distributed.py)."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips with a reason where there is none")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
