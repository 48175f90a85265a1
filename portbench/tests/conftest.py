"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that need the card (run there: python -m pytest portbench/tests -m cuda)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one (run: python -m pytest -m cuda)"
    )


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
