"""A fixture for the port's CPU tests that run heavy torch work.

A parallel test run (pytest-xdist) has several workers share the machine's
cores. torch's intra-op thread pool then stalls at every parallel region
while its threads wait for a core: a test of 2 s alone ran for 712 s beside
busy workers. One intra-op thread is as fast for these small shapes and
does not stall."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
