"""The port's tests run their CPU work on one intra-op thread.

A test module takes the fixture with
``from torch_threads import one_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU work here is many small ops: one intra-op thread
    keeps them fast while pytest-xdist runs several workers on the
    host's cores (the thread count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
