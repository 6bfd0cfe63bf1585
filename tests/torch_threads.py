"""One torch thread for each of the port's CPU test modules.

The tier-1 run puts six pytest workers on the machine's cores. With torch's
default of one thread per core in each of them, the port's CPU tests
oversubscribe the CPU, and the JAX package's sharding tests
(tests/test_parallel.py, the longest file and so the run's critical path)
wait for cores. A module imports `one_torch_thread` to run its tests on one
torch thread; the count is restored when the module ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
