"""
One torch CPU thread for a test module (import ``one_torch_thread``
into it).  The tier-1 run takes six pytest workers on the machine's
cores, and each worker's torch would run its CPU ops on a thread a
core: parallel regions then wait on threads the other workers hold, and
a module of many small ops (the forest's fit and walks) ran 10-40x
slower than alone.  On one thread it runs as fast as alone.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
