"""One intra-op torch thread for a test module (import the fixture into the
module: it is autouse). The port's CPU tests run small tensors; with the
default thread count, torch's OpenMP threads spin while the suite's workers
share the cores, and a test's CPU time grows far past what it computes."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
