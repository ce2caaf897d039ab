"""Test settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them here with a reason; the decision is made inside
the fixture, never while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
