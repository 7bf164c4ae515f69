"""Settings of the benchmark's own tests (run from the checkout's root:
python -m pytest portbench/tests -q --confcutdir=portbench).

Tests that need an NVIDIA card carry the `cuda` marker and decide in a
fixture, never at import, whether one is there."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
