"""One torch intra-op thread for the port's test files.

Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an
autouse fixture scoped to the module, so that every test of that file
runs with torch held to one intra-op thread and the process's count comes
back when the file is done. The port's CPU tests are made of many small
torch ops (models of kernels' arithmetic, plain versions at small
shapes). Under pytest-xdist, several workers, each with torch's default
pool of one thread a core, oversubscribe the host, and those small ops
stall on the pool. The JAX side's threads are not touched.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch held to one intra-op thread for the module's tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
