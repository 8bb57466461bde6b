"""One PyTorch intra-op thread for the port's tests of many small ops.

The trainers' steps are small matrix products and elementwise ops.  With
several test workers on a few cores, torch's intra-op thread pool only
contends with the other workers: a step that takes about a millisecond on
one thread took over 100 ms on eight under that load.  Import the fixture
into a test module to run the module on one thread (restored after it).
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
