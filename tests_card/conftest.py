"""The port's tests that need a CUDA card, marked `card`: they skip
without one.  They import neither JAX nor the JAX package, so they run on
a machine with a card and PyTorch alone:

    python3 -m pytest -q -m card tests_card
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
