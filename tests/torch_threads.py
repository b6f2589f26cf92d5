"""Torch's intra-op threads for the port's CPU tests.

The tests run in several pytest-xdist workers on one host. Each worker's
torch takes, by default, as many threads as the host has cores, so the
workers' toy fits (thousands of small ops a fit) fight for the cores and run
many times slower than alone. A test module imports `worker_threads`, an
autouse fixture that gives torch the worker's share of the cores for the
module and restores the count afterwards:

    from torch_threads import worker_threads  # noqa: F401
"""
import os

import pytest
import torch


def worker_thread_count() -> int:
    """The cores of the host over the xdist workers, at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def worker_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(worker_thread_count())
    yield
    torch.set_num_threads(n)
