import os

# Smoke tests and benches must see the real single CPU device — the 512-way
# placeholder override belongs to launch/dryrun.py ONLY.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")
