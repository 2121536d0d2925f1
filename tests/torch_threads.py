"""One PyTorch thread a process for the port's CPU tests.

The test suite runs in several worker processes on a few cores. PyTorch's
default pool, a thread a core in each process, spins against the other
processes' threads, and then even the tiny tensors of these tests take
milliseconds an operation (a two-epoch CLI run at the tiny widths took 21
s with the pool against 0.6 s in one thread). Each port test module
imports ``one_torch_thread``: an autouse fixture of module scope, so that
the module's own fixtures run in one thread too, which restores the
process's count when the module is done."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
