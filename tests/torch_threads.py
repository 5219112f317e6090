"""A fixture for the PyTorch port's test files: one intra-op thread while a
file's tests run, restored afterwards. The suite runs in several worker
processes at once; torch's default of one thread per core in each of them
oversubscribes the cores and makes the port's small CPU tests many times
slower."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
