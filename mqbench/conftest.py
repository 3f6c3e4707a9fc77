"""pytest settings of the benchmark's own tests (`python -m pytest mqbench`).

`card`: a test that needs an NVIDIA GPU. Whether there is one is decided
inside the `card` fixture when the test runs, never while a module is
imported, so every worker collects the same tests.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.cuda.get_device_name(0)
