"""Pytest settings of the benchmark's own tests (``test_portbench_*.py``).

``chip`` marks a test that needs a CUDA card; such a test skips itself
inside its body when there is none, never while it is collected.  Every
test here runs on one torch thread: the tests run beside other workers.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips itself without one")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device a ``chip`` test runs on; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda:0"
