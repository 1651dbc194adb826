"""One CPU thread for the port's float parity tests.

PyTorch's CPU products go through a threaded BLAS whose split of a product
across threads, and with it the order of the partial sums, changes from
process to process (more so under several pytest-xdist workers on a few
cores). A last-bit change can put a near-zero LeakyReLU pre-activation on
the other branch and move a gradient past a parity tolerance. On one
thread the plain versions give the same bits in every process.

A test file that compares the port's floats with the JAX package imports
the fixture, which pins the count for the whole module and restores it
after:

    from torch_threads import one_cpu_thread  # noqa: F401
"""
import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    """torch (and its BLAS) on one CPU thread; the old count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    with one_thread():
        yield
