"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root. Tests marked ``card`` need an NVIDIA card; the fixture
``card`` decides, inside the test, and skips where there is none."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest -m card "
                    "portbench/tests` on the card's machine")
    return torch.device("cuda")


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: this test is of a machine without one")
