"""The benchmark's CPU tests: run from the repository's root with

    python -m pytest -q bench_port/tests

Tests that need a card are marked ``card`` and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
