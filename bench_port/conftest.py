"""pytest settings of the benchmark's own tests (``bench_port/tests/``).

Tests that need a CUDA card carry the marker ``card`` and take the fixture
``card``, which skips them where there is none. Run them on the card with
``python3 -m pytest bench_port/tests -m card``; here the rest run on the CPU.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the chip with `pytest bench_port/tests -m card`")
    return torch.device("cuda")
