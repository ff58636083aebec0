"""Tests of the port's benchmark.  Tests that need a GPU carry the
``card`` marker and ask for the ``card`` fixture, which skips them where
there is none (decided when the test runs, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA GPU; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    return torch.device("cuda", 0)
