"""A fixture for the PyTorch port's test files: one intra-op thread for
torch and for numpy's BLAS while a file's tests run, restored afterwards.
The suite runs in several worker processes at once; a thread per core in
each of them oversubscribes the cores and makes the port's small CPU tests
many times slower (a 0.5 s FAD, two 1024-wide eigendecompositions, took
64 s under six workers with numpy's eight BLAS threads each)."""
import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:      # without it numpy's BLAS keeps its own thread count
    threadpool_limits = None


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with (threadpool_limits(1) if threadpool_limits else contextlib.nullcontext()):
        yield
    torch.set_num_threads(n)
