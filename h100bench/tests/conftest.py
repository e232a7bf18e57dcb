"""The benchmark's tests: `card` marks a test that needs an H100; the
`card` fixture skips it, with the reason, where none is present."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (an H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")
