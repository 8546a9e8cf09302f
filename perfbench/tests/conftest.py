"""The benchmark's own tests: `python -m pytest perfbench/tests` (CPU);
on a card machine the tests marked `card` run too."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    """One intra-op thread a test: the CPU is shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
