"""The benchmark's own tests: on the CPU at tiny sizes, the card-only ones
marked ``cuda`` and skipped, decided inside the ``card`` fixture, where
there is no card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
