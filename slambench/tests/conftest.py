import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips here with a reason (run on the chip)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided in the fixture, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
