"""A fixture that runs a test with one torch intra-op thread.

The suite runs in several worker processes at once; a torch CPU op that
spreads over every core then contends with the other workers' threads and
runs tens of times slower (a tiny eval recipe: 3.4 s on one thread, 106 s
on eight with five busy neighbours). One thread keeps each test's time
close to its time alone.
"""
import pytest
import torch


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
