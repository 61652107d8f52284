"""A fixture for the port's CPU tests that run heavy PyTorch work.

The suite runs as six pytest-xdist workers on the machine's cores, and
PyTorch's default of one intra-op thread a core oversubscribes them
several times over (a 15 s bench smoke took 490 s that way). Import
``few_threads`` into a test module to run its tests on two threads.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)
