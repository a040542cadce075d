import sys
from pathlib import Path

import pytest

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch finds no CUDA device")


@pytest.fixture
def card():
    """The CUDA device, or a skip where torch finds none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch finds no CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    """The harness's CPU runs use two threads, so that they take little from
    the test files that other workers run beside them."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)
