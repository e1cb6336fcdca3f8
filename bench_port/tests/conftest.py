"""The benchmark's tests: on the CPU at tiny sizes, except those marked
``chip``, which need the card and skip here. Run them with

    python3 -m pytest bench_port/tests -q -p no:cacheprovider

(on the card the ``chip`` tests run too). Nothing here imports JAX."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR), str(BENCH_DIR / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
