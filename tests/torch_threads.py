"""One intra-op thread for the port's CPU tests.

The port's tests run eager PyTorch on small tensors, where intra-op
threads gain nothing; under `pytest -n 6` every worker's pool would take
one thread per core, and the workers' threads then contend for the cores:
the port's test files ran ~3x slower in wall time (and ~4.5x in CPU time)
than with one thread per worker on an 8-core machine. A test module that
imports `one_intraop_thread` runs with one thread, restored after it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intraop_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
