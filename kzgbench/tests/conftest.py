"""The benchmark's own tests (CPU, plus the control on the card).

    python3 -m pytest kzgbench/tests -q -p no:cacheprovider

Tests that need a CUDA card are marked `gpu`; the `card` fixture decides
at run time whether one is there and skips them without one.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="session")
def setup64():
    """The mainnet setup with its first 64 monomial points."""
    from kzgbench.reference import setup

    return setup.load(os.path.join(ROOT, "tests", "trusted_setup.txt"), n_monomial=64)


@pytest.fixture(scope="session")
def setup_full():
    """The mainnet setup with every monomial point."""
    from kzgbench.reference import setup

    return setup.load(os.path.join(ROOT, "tests", "trusted_setup.txt"), n_monomial=4096)
