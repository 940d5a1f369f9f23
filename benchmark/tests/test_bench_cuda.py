"""On the card: a tiny cell runs through the harness and is correct."""

import pytest

from benchmark.drive import run_cell
from benchmark.tests.helpers import tiny_catalog


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels have no CPU form)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-exact.batch", "tiny-folded.serve"])
def test_a_tiny_cell_is_correct_on_the_card(card, cell, tmp_path):
    out = run_cell(cell, 2**31 + 3, 1.0, True, device=card, catalog=tiny_catalog(str(tmp_path)),
                   log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
