"""Tests of the benchmark harness.  They run on the CPU at tiny sizes,
through the program's plain versions; the tests marked ``chip`` run the
committed cells on a CUDA card and skip without one:

    python3 -m pytest portbench/tests -q            # on the CPU
    python3 -m pytest portbench/tests -q -m chip    # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA device; skips the test without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")
    return torch.device("cuda", 0)
