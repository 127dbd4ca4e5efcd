"""Test settings of the benchmark's own tests (``port_bench/tests``), which
``pytest tests/`` does not collect. Run them from the checkout's root:

    python -m pytest port_bench/tests -q -p no:cacheprovider
    python -m pytest port_bench/tests -q -p no:cacheprovider -m card   # on the card

Tests marked ``card`` need an NVIDIA card; their fixture ``card`` decides
whether there is one and skips them with a reason where there is none.
"""
import sys
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs TF32, which only the card has")
    return torch.device("cuda", 0)
