import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Whole runs on the CPU with a few torch threads, so that they do not
    crowd the other test workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
