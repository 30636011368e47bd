"""The benchmark's CPU tests (`python -m pytest portbench/tests -q`).
Tests marked `card` need a CUDA card and skip without one; whether there
is a card is decided inside the fixture, never while a module is
imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on a CPU-only machine)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)
