"""Settings of the benchmark's own tests.

The harness and the reference are held on the CPU at tiny widths; tests
that need the card carry the ``card`` marker and take the ``cuda_device``
fixture, which decides at run time, never at import, and skips without a
card. Run them on the card with ``python3 -m pytest benchmark/tests -m
card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
