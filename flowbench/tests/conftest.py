"""The benchmark's tests.  ``card`` marks a test that needs a CUDA card;
the ``card`` fixture skips it elsewhere, deciding when the test runs and
never while the module is imported (so every worker collects the same
tests).  On the card: ``python3 -m pytest flowbench/tests -m card``."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# a tiny size for the CPU rehearsals: every part of a run, small shapes
TINY = {"traffic": {"frame": [60, 90], "bucket": [64, 96], "pool_pairs": 4,
                    "clients": 2, "warm_requests": 1, "check_calls": 1,
                    "pool_batches": 4, "warm_steps": 3,
                    "recipe": {"batch_size": 2, "image_size": [64, 96]}}}
