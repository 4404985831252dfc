"""The port's CPU ops on one thread, for a whole test module.

Imported into a test module, ``one_thread`` is autouse there: its module
fixtures and tests run torch on one thread. The suite runs several
workers on the machine's cores; a torch op on every core in each of them
oversubscribes the cores and stalls (the flagship's tiny forwards took
tens of times their time alone).
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
