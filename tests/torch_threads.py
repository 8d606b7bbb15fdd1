"""``one_torch_thread``: a test's torch work on one intra-op thread.

The tier-1 run has six xdist workers on a machine of eight cores. Full-width
models on the CPU in each worker, each with one OpenMP thread per core, wait
on each other's descheduled threads; on one thread each they do not. The
fixture restores the count the test found."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
