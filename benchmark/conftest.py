"""pytest settings of the benchmark's own tests (``python3 -m pytest
benchmark``): the ``cuda`` marker for tests that need the card, which
decide inside the ``card`` fixture whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with the CUDA toolkit; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
