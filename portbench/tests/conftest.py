"""The benchmark's CPU tests run their small cells on one thread each
(restored after every test): the suite runs in several worker processes
at once, and a torch process takes every core by default."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
