"""One intra-op thread for PyTorch in the port's test modules.

The tier-1 run puts several test workers on one box, beside the reference's
wall-clock tests (``tests/distributed/test_cli_sharded.py::
test_scaling_harness`` gates a throughput ratio). PyTorch's default of one
intra-op thread per core in every worker oversubscribes the cores; the
port's tests run small grids and lose nothing with one thread. A module
imports ``torch_threads`` to use it: the fixture is module-scoped and
autouse, and puts the caller's setting back after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
