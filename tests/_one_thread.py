"""An autouse fixture that runs each test of a file on one torch CPU thread.

With two threads, the first vectorised sqrt or exp after a process's first
GEMM was seen to come back at reduced accuracy (relative 2e-4) in one
thread's share of the elements on some CPU builds of torch (MKL 2024.2),
which a 1e-5 gate then reads as a fault of the code under test. A file
imports the fixture into its namespace to use it:

    from _one_thread import one_thread  # noqa: F401

A ``torch.set_num_threads(1)`` at import would not hold: other test files
set two threads at their import, and a pytest worker imports every file it
runs before the first test.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One thread for the test, then the previous count again."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
