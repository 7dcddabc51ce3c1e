"""The benchmark's tests. Those marked ``chip`` need a CUDA device and
skip without one; the decision is taken inside the ``cuda`` fixture,
never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    """Each test process computes on two threads: with several pytest
    workers, torch's default thread per core oversubscribes the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
