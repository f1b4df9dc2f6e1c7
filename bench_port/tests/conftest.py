"""The benchmark's tests.  Run them with ``python -m pytest bench_port/tests``
from the root of the repository; those marked ``card`` need an NVIDIA card
and skip elsewhere (on the card: ``python -m pytest bench_port/tests -m
card``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json with its particle count cut to a CPU
    test's size, its pose limits those of that size."""
    from bench_port.lib import registry
    from bench_port.tests.helpers import TEST_POSE_LIMITS

    def make(workload, n=500):
        cell = registry.cell(registry.benchmark(), workload)
        cell["cfg"]["N"] = n
        cell["limits"].update({k: v for k, v in TEST_POSE_LIMITS.items()
                               if k in cell["limits"]})
        return cell

    return make


@pytest.fixture
def kernel_path(monkeypatch):
    """Every product at a test's size takes the large-pair path, whose row
    log-partitions the kernel gives on the card (its plain version here)."""
    from incrementalinference_torch.ops import product

    monkeypatch.setattr(product, "LARGE_PAIR_THRESHOLD", 1)
