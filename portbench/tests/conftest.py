"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
repository root. Tests marked `card` need an NVIDIA card; each decides so in
its fixture and skips here with the reason."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the H100)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false here")
    return "cuda"
