import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs the port's CUDA kernels on an NVIDIA GPU; skips without one",
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _reset_moe_warned():
    """Reset the MoE layer's one-time-warning dedup set around every test.

    Warning-behavior tests (``gd_collapse``, expert-replication) assert that
    the *first* call warns; without this reset they order-depend on whoever
    tripped the same warning key earlier in the suite. Guarded on the module
    already being imported so jax-free test runs stay import-light (a test
    that can trip the warning has necessarily imported the module).
    """
    import sys

    dispatch = sys.modules.get("repro.models.dispatch")
    if dispatch is None:
        yield
        return
    saved = set(dispatch._WARNED)
    dispatch._WARNED.clear()
    yield
    dispatch._WARNED.clear()
    dispatch._WARNED.update(saved)
