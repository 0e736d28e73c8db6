import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers",
        "property: randomized property-based differential test "
        "(hypothesis-driven when installed, fixed-seed fallback otherwise)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's CUDA kernels have no CPU "
        "mode); skips where there is none")
