"""Tests of the benchmark: its reference, its harness, its check.

They run on the CPU at small sizes. A test that needs a CUDA card takes
the `card` marker and the `card` fixture, which skips it where
torch.cuda has no device; none decides at import time.

    python -m pytest benchmark/tests -q
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")
