"""Settings of the benchmark's own tests (run them with
``python -m pytest perfbench/tests -q`` from the root of a checkout)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "needs_cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    """Skips the test on a host without a CUDA device; decided here, when
    the test runs, never when the module is imported."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def on_cpu(monkeypatch):
    """The program's plain PyTorch versions on the CPU."""
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
