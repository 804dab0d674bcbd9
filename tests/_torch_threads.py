"""An autouse fixture that the port's CPU tests import: each test runs
torch on one thread and gets the process's count back after.  Their
tensors are small, and the suite runs in parallel workers, each of which
would otherwise start a thread a core for every torch operation and
oversubscribe the machine.

Not a test module (no ``test_`` prefix); a test file takes the fixture
with ``from _torch_threads import torch_one_thread  # noqa: F401``."""
import pytest
import torch


@pytest.fixture(autouse=True)
def torch_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
